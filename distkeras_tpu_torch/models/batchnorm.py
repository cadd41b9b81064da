"""Keras' ``BatchNormalization`` as a ``torch.nn`` module, and its
synchronized form for data parallelism.

Counterpart of ``keras/src/layers/normalization/batch_normalization.py``
as the reference runs it (``keras.applications.ResNet50``'s BNs, the
BN models of its tests):

- per channel along ``axis``; the output is ``(x - mean) * rsqrt(var +
  epsilon) * gamma + beta``, computed in f32 on bf16 inputs and cast
  back (the layer's input dtype is its output dtype);
- training mode normalizes by the batch's mean and **biased** variance
  and moves ``moving = moving * momentum + batch * (1 - momentum)``
  (Keras' momentum: 0.99 is torch's ``momentum=0.01``).  Torch's
  ``running_var`` takes the unbiased variance, so ``F.batch_norm``
  writes its batch statistics into scratch buffers (momentum 1.0) and
  the layer moves its own buffers from them, the variance rescaled by
  ``(n - 1) / n``: one pass of statistics a call;
- ``gamma`` / ``beta`` are the parameters and ``moving_mean`` /
  ``moving_variance`` the buffers (the adapter's ``tv`` / ``ntv``, in
  Keras' order); the update writes the buffers in place, so under
  ``functional_call`` it lands in the ``ntv`` bound to them.

Inside :func:`synchronized` (the data-parallel trainers' steps) with a
group of more than one rank, the batch statistics are the global
batch's: the sum and the centered sum of squares are summed over the
group with ``sum_over_group``, whose backward carries every rank's
terms, so ``num_workers`` ranks of ``batch_size`` rows train as one
device on the global batch, as the reference's sharded ``jnp.mean``
does.  Every rank must hold the same number of rows.  At world 1 (or
with no group) the layer takes its local path, and nothing is
exchanged.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from distkeras_tpu_torch.parallel.collectives import sum_over_group

_MESH = [None]   # the mesh of the running synchronized step, or None


@contextlib.contextmanager
def synchronized(mesh):
    """Batch statistics over ``mesh``'s group inside the block (``None``,
    a mesh without a group, or one rank: local statistics)."""
    prev = _MESH[0]
    _MESH[0] = mesh if mesh is not None and mesh.group is not None \
        and mesh.size > 1 else None
    try:
        yield
    finally:
        _MESH[0] = prev


class KerasBatchNorm(nn.Module):
    """``keras.layers.BatchNormalization(axis, momentum, epsilon)``."""

    def __init__(self, channels: int, axis: int = -1,
                 momentum: float = 0.99, epsilon: float = 1e-3):
        super().__init__()
        self.axis = axis
        self.momentum = momentum
        self.epsilon = epsilon
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))
        self.register_buffer("moving_mean", torch.zeros(channels))
        self.register_buffer("moving_variance", torch.ones(channels))

    def _shape(self, x):
        """Per-channel vectors broadcast along ``axis``."""
        shape = [1] * x.dim()
        shape[self.axis] = -1
        return shape

    def forward(self, x):
        channels_first = x.movedim(self.axis, 1)
        if not self.training:
            return F.batch_norm(channels_first, self.moving_mean,
                                self.moving_variance, self.gamma, self.beta,
                                False, 0.0, self.epsilon
                                ).movedim(1, self.axis)
        mesh = _MESH[0]
        if mesh is None:
            n = x.numel() // x.shape[self.axis]
            mean = torch.zeros_like(self.moving_mean)
            var = torch.ones_like(self.moving_variance)
            out = F.batch_norm(channels_first, mean, var, self.gamma,
                               self.beta, True, 1.0, self.epsilon
                               ).movedim(1, self.axis)
            var = var * ((n - 1) / n)         # unbiased -> biased
        else:
            dims = [d for d in range(x.dim()) if d != self.axis % x.dim()]
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            n = (xf.numel() // xf.shape[self.axis]) * mesh.size
            mean = sum_over_group(xf.sum(dims), mesh) / n
            d = xf - mean.reshape(self._shape(x))
            var = sum_over_group((d * d).sum(dims), mesh) / n
            inv = torch.rsqrt(var + self.epsilon) * self.gamma
            out = (xf * inv.reshape(self._shape(x))
                   + (self.beta - mean * inv).reshape(self._shape(x))
                   ).to(x.dtype)
        m = self.momentum
        with torch.no_grad():
            self.moving_mean.copy_(self.moving_mean * m
                                   + mean.detach() * (1.0 - m))
            self.moving_variance.copy_(self.moving_variance * m
                                       + var.detach() * (1.0 - m))
        return out

"""The zoo models' base: Keras' mixed-precision policy as a constructor
argument, and Keras' initializers by layer kind.

``policy`` replaces Keras' global mixed-precision policy:
``"float32"``, or ``"mixed_bfloat16"`` (f32 weights, the layers
computing in bf16 under ``torch.autocast``, bf16 logits out; BatchNorm
computes in f32 and casts back, as Keras' does).  Weights start as
Keras' do (glorot-uniform kernels, zero biases, an ``Embedding``
uniform in +-0.05, the LSTM's orthogonal recurrent kernel and unit
forget bias, BatchNorm's ones / zeros), drawn from
``np.random.default_rng(seed)``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn

from distkeras_tpu_torch.models.batchnorm import KerasBatchNorm
from distkeras_tpu_torch.models.rnn import (FusedLSTM, orthogonal,
                                            unit_forget_bias)
from distkeras_tpu_torch.utils.serialization import (keras_numpy_from_module,
                                                     module_from_keras_numpy)

POLICIES = ("float32", "mixed_bfloat16")


class KerasModule(nn.Module):
    """Base: the policy, and Keras' initialization."""

    def __init__(self, name: str, policy: str):
        super().__init__()
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; known: "
                             f"{list(POLICIES)}")
        self.name = name
        self.policy = policy

    def _compute(self, x):
        """The layers' compute dtype: autocast to bf16 under the mixed
        policy, nothing under float32."""
        if self.policy == "mixed_bfloat16":
            return torch.autocast(x.device.type, dtype=torch.bfloat16)
        return contextlib.nullcontext()

    def _init_weights(self, seed):
        """Keras' initializers by layer kind, drawn in parameter order
        on Keras-layout arrays."""
        rng = np.random.default_rng(seed)
        layers = []
        for layer in self.modules():
            layers += [(layer, n) for n in layer._parameters
                       if layer._parameters[n] is not None]
        tv, ntv = keras_numpy_from_module(self)
        module_from_keras_numpy(self, [_keras_init(layer, n, w, rng)
                                       for (layer, n), w in zip(layers, tv)],
                                ntv)


def _glorot(shape, rng):
    """Keras' glorot-uniform on a Keras-layout kernel (receptive field x
    in x out)."""
    rf = int(np.prod(shape[:-2]))
    limit = np.sqrt(6.0 / (rf * shape[-2] + rf * shape[-1]))
    return rng.uniform(-limit, limit, shape).astype(np.float32)


def _keras_init(layer, name, w, rng):
    if isinstance(layer, nn.Embedding):
        return rng.uniform(-0.05, 0.05, w.shape).astype(np.float32)
    if isinstance(layer, FusedLSTM):
        if name == "recurrent_kernel":
            return orthogonal(w.shape, rng)
        if name == "bias":
            return unit_forget_bias(layer.units)
    if isinstance(layer, KerasBatchNorm):
        return (np.ones_like(w) if name == "gamma" else np.zeros_like(w))
    if w.ndim >= 2:
        return _glorot(w.shape, rng)
    return np.zeros_like(w)

"""Keras-layout LSTMs: ``FusedLSTM`` and the stock layer's counterpart.

Counterpart of ``distkeras_tpu/models/rnn.py``.  Both modules hold
exactly Keras' three trainable variables, in Keras' order and layout:
``kernel [E, 4H]``, ``recurrent_kernel [H, 4H]`` and ``bias [4H]``, gate
order i|f|g|o, so weights interchange with ``keras.layers.LSTM`` and the
reference's ``FusedLSTM`` as they are.

- :class:`FusedLSTM` has the reference's structure: the input
  projection of every timestep hoisted into one ``[T*B, E] @ [E, 4H]``
  product with the bias folded in, then a loop over T holding one
  ``[B, H] @ [H, 4H]`` product and the gates.
- :class:`LSTM` (``zoo.imdb_lstm(fused=False)``, the stock Keras layer)
  runs torch's fused LSTM (cuDNN on the card) on the same variables:
  ``weight_ih = kernel.T``, ``weight_hh = recurrent_kernel.T``,
  ``bias_ih = bias`` and a ``bias_hh`` of zeros made per call, which is
  no variable of the module (torch's two biases would be a fourth
  variable Keras does not have).

Under autocast (the zoo's ``mixed_bfloat16``) both compute in the
autocast dtype, as Keras' layers compute in bf16.  Init (``zoo``):
glorot-uniform kernel, orthogonal recurrent kernel, and
``unit_forget_bias`` (the bias's f-slice 1).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def orthogonal(shape, rng) -> np.ndarray:
    """Keras' ``Orthogonal`` initializer (gain 1) from a numpy
    generator."""
    rows, cols = int(np.prod(shape[:-1])), shape[-1]
    a = rng.normal(0.0, 1.0, (max(rows, cols), min(rows, cols)))
    q, r = np.linalg.qr(a)
    q = q * np.sign(np.diag(r))
    if rows < cols:
        q = q.T
    return q.reshape(shape).astype(np.float32)


def unit_forget_bias(units: int) -> np.ndarray:
    b = np.zeros(4 * units, np.float32)
    b[units:2 * units] = 1.0   # the forget gate opens at init
    return b


class FusedLSTM(nn.Module):
    """LSTM with the input projection hoisted out of the recurrence.

    Args:
      units: hidden size H.
      return_sequences: return ``[B, T, H]`` instead of the final
        ``[B, H]``.
      input_dim: E, the input's feature width (torch modules are built
        at construction; Keras builds on the first call).
    """

    def __init__(self, units: int, return_sequences: bool = False, *,
                 input_dim: int):
        super().__init__()
        if units < 1:
            raise ValueError(f"units must be >= 1, got {units}")
        self.units = units
        self.return_sequences = return_sequences
        self.kernel = nn.Parameter(torch.zeros(input_dim, 4 * units))
        self.recurrent_kernel = nn.Parameter(torch.zeros(units, 4 * units))
        self.bias = nn.Parameter(torch.from_numpy(unit_forget_bias(units)))

    def _check(self, x):
        if x.dim() != 3:
            raise ValueError(
                f"{type(self).__name__} expects [batch, time, features], "
                f"got {tuple(x.shape)}")

    def forward(self, x):
        self._check(x)
        u = self.units
        b, t, e = x.shape
        # [T*B, E] @ [E, 4H] + bias: every timestep's projection in one
        # product, time-major so each step reads a contiguous [B, 4H].
        xp = torch.addmm(self.bias, x.transpose(0, 1).reshape(t * b, e),
                         self.kernel).view(t, b, 4 * u)
        h = xp.new_zeros(b, u)
        c = xp.new_zeros(b, u)
        ys = []
        for step in range(t):
            z = torch.addmm(xp[step], h, self.recurrent_kernel)
            s = torch.sigmoid(z)          # i | f | . | o
            g = torch.tanh(z[:, 2 * u:3 * u])
            c = s[:, u:2 * u] * c + s[:, :u] * g
            h = s[:, 3 * u:] * torch.tanh(c)
            if self.return_sequences:
                ys.append(h)
        return torch.stack(ys, 1) if self.return_sequences else h


class LSTM(FusedLSTM):
    """``keras.layers.LSTM(units)`` on torch's fused LSTM kernel (cuDNN on
    the card), over the same three Keras variables."""

    def forward(self, x):
        self._check(x)
        u = self.units
        dt = (torch.get_autocast_dtype(x.device.type)
              if torch.is_autocast_enabled(x.device.type) else x.dtype)
        # cuDNN reads each weight as a dense [4H, in] matrix.
        x, w_ih, w_hh, b_ih = (a.to(dt).contiguous() for a in (
            x, self.kernel.t(), self.recurrent_kernel.t(), self.bias))
        zero = x.new_zeros(1, x.shape[0], u)
        out, h, _ = torch._VF.lstm(
            x, (zero, zero), [w_ih, w_hh, b_ih, torch.zeros_like(b_ih)],
            True, 1, 0.0, self.training, False, True)
        return out if self.return_sequences else h[0]

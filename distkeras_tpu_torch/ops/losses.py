"""Losses of the Keras trainer family: ``f(y_true, y_pred) -> scalar``.

Counterpart of ``distkeras_tpu/ops/losses.py``, the same seven names and
formulas in torch:

- the crossentropies take logits and run ``log_softmax`` in the logits'
  own dtype (bf16 logits under ``mixed_bfloat16`` give a bf16 loss, as
  the reference's do), or clip probabilities to ``[1e-7, 1]`` with
  ``from_logits=False``;
- the elementwise losses match label rank to prediction rank with the
  reference's ``_align`` rule and its error;
- binary crossentropy on logits is the stable
  ``max(x, 0) - x z + log1p(exp(-|x|))``.

``y_true`` is a tensor on the predictions' device (labels of any dtype).
"""

from __future__ import annotations

from typing import Callable

import torch

Loss = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _categorical_crossentropy(y_true, y_pred, from_logits=True):
    logp = (torch.log_softmax(y_pred, dim=-1) if from_logits
            else torch.log(torch.clamp(y_pred, 1e-7, 1.0)))
    return -torch.mean(torch.sum(y_true * logp, dim=-1))


def _sparse_categorical_crossentropy(y_true, y_pred, from_logits=True):
    logp = (torch.log_softmax(y_pred, dim=-1) if from_logits
            else torch.log(torch.clamp(y_pred, 1e-7, 1.0)))
    idx = y_true.to(torch.int32).long()[..., None]
    return -torch.mean(torch.gather(logp, -1, idx)[..., 0])


def _align(y_true, y_pred):
    """Match label rank to prediction rank for elementwise losses.

    (B,) labels vs (B, 1) predictions would otherwise silently
    broadcast to (B, B) and compute garbage.
    """
    if y_true.dim() == y_pred.dim() - 1 and y_pred.shape[-1] == 1:
        return y_true[..., None]
    if y_true.shape != y_pred.shape:
        raise ValueError(
            f"label shape {tuple(y_true.shape)} incompatible with "
            f"prediction shape {tuple(y_pred.shape)}")
    return y_true


def _binary_crossentropy(y_true, y_pred, from_logits=True):
    z = _align(y_true, y_pred).to(y_pred.dtype)
    if from_logits:
        x = y_pred
        return torch.mean(torch.clamp(x, min=0) - x * z
                          + torch.log1p(torch.exp(-torch.abs(x))))
    p = torch.clamp(y_pred, 1e-7, 1 - 1e-7)
    return -torch.mean(z * torch.log(p) + (1 - z) * torch.log(1 - p))


def _mse(y_true, y_pred):
    y_true = _align(y_true, y_pred)
    return torch.mean(torch.square(y_pred - y_true.to(y_pred.dtype)))


def _mae(y_true, y_pred):
    y_true = _align(y_true, y_pred)
    return torch.mean(torch.abs(y_pred - y_true.to(y_pred.dtype)))


_LOSSES: dict[str, Loss] = {
    "categorical_crossentropy": _categorical_crossentropy,
    "sparse_categorical_crossentropy": _sparse_categorical_crossentropy,
    "binary_crossentropy": _binary_crossentropy,
    "mse": _mse,
    "mean_squared_error": _mse,
    "mae": _mae,
    "mean_absolute_error": _mae,
}


def resolve_loss(loss) -> Loss:
    """A loss name (the Keras / reference names above) or a callable
    ``f(y_true, y_pred) -> scalar``, which passes through.  The
    crossentropies expect logits: the zoo's models end in a linear
    layer."""
    if callable(loss):
        return loss
    try:
        return _LOSSES[loss]
    except KeyError:
        raise ValueError(
            f"Unknown loss {loss!r}; known: {sorted(_LOSSES)} "
            "or pass a callable f(y_true, y_pred) -> scalar.") from None

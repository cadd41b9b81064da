"""Optimizer resolution for the Keras trainer family.

Counterpart of ``distkeras_tpu/ops/optimizers.py::resolve_optimizer``:
the reference-era names resolve to a :class:`~distkeras_tpu_torch.
trainers.optim.Optimizer` with optax's formulas and defaults, at the
per-name default learning rate (the Keras default) unless one is given.
A learning rate may be a schedule of the update count (0 for the first
update), and a ready ``Optimizer`` passes through unchanged, as an optax
transform does in the reference (``EAMSGD`` passes its Nesterov sgd).
"""

from __future__ import annotations

from distkeras_tpu_torch.trainers.optim import Optimizer

# The Keras defaults the reference resolves each name at.
DEFAULT_LEARNING_RATES = {
    "sgd": 0.01,
    "adam": 0.001,
    "adamw": 0.001,
    "nadam": 0.001,
    "adagrad": 0.01,
    "adadelta": 1.0,
    "rmsprop": 0.001,
}


def resolve_optimizer(spec, learning_rate=None) -> Optimizer:
    """``spec``: a name of :data:`DEFAULT_LEARNING_RATES` or an
    :class:`Optimizer` (passed through).  ``learning_rate`` overrides
    the name's default; it may be a callable ``step -> lr``."""
    if isinstance(spec, Optimizer):
        return spec
    if not isinstance(spec, str):
        raise TypeError(
            f"optimizer spec must be a name or an Optimizer, got {type(spec)}")
    name = spec.lower()
    if name not in DEFAULT_LEARNING_RATES:
        raise ValueError(f"Unknown optimizer {spec!r}; known: "
                         f"{sorted(DEFAULT_LEARNING_RATES)}")
    lr = (learning_rate if learning_rate is not None
          else DEFAULT_LEARNING_RATES[name])
    if not callable(lr) and lr <= 0:
        raise ValueError(f"learning_rate must be positive, got {lr}")
    return Optimizer(name, lr)

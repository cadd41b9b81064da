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


# The names whose update rule is per-leaf elementwise: all of them, as in
# the reference (the ZeRO stages shard such an update exactly).
ZERO1_ELEMENTWISE = frozenset(DEFAULT_LEARNING_RATES)


def zero1_compatible(spec) -> bool | None:
    """Whether ``spec`` is known-safe under the ZeRO sharded update: a
    name of :data:`ZERO1_ELEMENTWISE` or an :class:`Optimizer` (every
    one of the port's is elementwise; its clip sums its norm over the
    group) is; an unknown name is not; anything else cannot be
    inspected (None: the trainers warn)."""
    if isinstance(spec, str):
        return spec.lower() in ZERO1_ELEMENTWISE
    if isinstance(spec, Optimizer):
        return True
    return None


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

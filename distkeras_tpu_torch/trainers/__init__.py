"""The reference's ``distkeras_tpu.trainers`` surface: the Keras trainer
family, the async fleet and the LM trainers.

Resolved on first use (PEP 562), so that importing the package loads
nothing its modules do not already load."""

import importlib

_HOME = {
    "Trainer": "base",
    "SingleTrainer": "base",
    "DistributedTrainer": "distributed",
    "ADAG": "distributed",
    "AsyncDP": "async_dp",
    "DynSGD": "distributed",
    "AEASGD": "elastic",
    "EAMSGD": "elastic",
    "DOWNPOUR": "elastic",
    "AveragingTrainer": "elastic",
    "EnsembleTrainer": "elastic",
    "LMTrainer": "lm",
    "LoRATrainer": "lm",
}

__all__ = list(_HOME)


def __getattr__(name):
    if name not in _HOME:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{_HOME[name]}")
    return getattr(module, name)


def __dir__():
    return sorted(set(globals()) | set(__all__))

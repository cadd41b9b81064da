"""The reference's ``distkeras_tpu.models`` surface: the Keras-model
adapter and its train state.

Resolved on first use (PEP 562), so that importing the package loads
nothing its modules do not already load."""

import importlib

_HOME = {
    "ModelAdapter": "adapter",
    "TrainState": "adapter",
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

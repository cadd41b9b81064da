"""The reference's ``distkeras_tpu.ops`` surface: loss and optimizer
resolution by name.

Resolved on first use (PEP 562), so that importing the package loads
nothing its modules do not already load."""

import importlib

_HOME = {
    "resolve_loss": "losses",
    "resolve_optimizer": "optimizers",
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

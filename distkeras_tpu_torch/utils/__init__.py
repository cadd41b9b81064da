"""The reference's ``distkeras_tpu.utils`` surface: serialization,
``to_dense_vector`` / ``uniform_weights``, ``StepTimer``, ``trace`` and
``annotate``.  Resolved on first use, so that the stdlib-only modules
here (``locks``, which the telemetry and the cluster layer import) do not
pull in torch."""

import importlib

_HOME = {
    "serialize_keras_model": "serialization",
    "deserialize_keras_model": "serialization",
    "to_dense_vector": "misc",
    "uniform_weights": "misc",
    "StepTimer": "profiling",
    "annotate": "profiling",
    "trace": "profiling",
}

__all__ = list(_HOME)


def __getattr__(name):
    if name not in _HOME:
        raise AttributeError(
            f"module 'distkeras_tpu_torch.utils' has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{_HOME[name]}")
    return getattr(module, name)


def __dir__():
    return sorted(set(globals()) | set(__all__))

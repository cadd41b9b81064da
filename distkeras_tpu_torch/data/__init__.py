"""The reference's ``distkeras_tpu.data`` surface: the dataset, the BPE
tokenizer and the column transformers.

Resolved on first use (PEP 562), so that importing the package loads
nothing its modules do not already load."""

import importlib

_HOME = {
    "Dataset": "dataset",
    "BPETokenizer": "tokenizer",
    "Transformer": "transformers",
    "OneHotTransformer": "transformers",
    "LabelIndexTransformer": "transformers",
    "MinMaxTransformer": "transformers",
    "ReshapeTransformer": "transformers",
    "DenseTransformer": "transformers",
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

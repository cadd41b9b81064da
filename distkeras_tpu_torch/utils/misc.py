"""Small helpers: the port's copy of ``distkeras_tpu/utils/misc.py``'s
``to_dense_vector``, ``uniform_weights`` (reference parity:
distkeras/utils.py) and ``nll_to_perplexity``.  The reference's JAX
device probes (``probe_devices`` / ``probe_device_count_subprocess``)
have no counterpart: the port's process sees its one device."""

from __future__ import annotations

import math

import numpy as np

from distkeras_tpu_torch.utils.serialization import get_weights, set_weights


def to_dense_vector(label, num_classes: int) -> np.ndarray:
    """Integer label -> one-hot dense vector (f32).  Vectorized: accepts
    a scalar or an array of labels."""
    labels = np.asarray(label, dtype=np.int64)
    return np.eye(num_classes, dtype=np.float32)[labels]


def uniform_weights(model, bounds=(-0.5, 0.5), seed: int | None = None):
    """Re-initialize every weight of ``model`` (a zoo module) uniformly in
    ``bounds``, drawn from ``np.random.default_rng(seed)`` in Keras'
    ``get_weights`` order and layout — the reference's draws for the same
    seed.  Returns the model."""
    rng = np.random.default_rng(seed)
    low, high = bounds
    set_weights(model, [rng.uniform(low, high, size=w.shape).astype(w.dtype)
                        for w in get_weights(model)])
    return model


def nll_to_perplexity(mean_nll: float) -> float:
    """exp(mean NLL) with the reference's overflow guard."""
    return math.exp(mean_nll) if mean_nll < 700 else float("inf")

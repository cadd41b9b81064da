"""Evaluators: ``evaluate(dataset) -> float`` over named columns.

Counterpart of ``distkeras_tpu/evaluators.py`` (reference parity:
distkeras/evaluators.py::AccuracyEvaluator), and its
``PerplexityEvaluator`` over the port's own ``lm_nll``.
"""

from __future__ import annotations

import numpy as np
import torch

from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.models import transformer as tfm
from distkeras_tpu_torch.trainers.lm import nll_to_perplexity


class Evaluator:
    def evaluate(self, dataset: Dataset) -> float:  # pragma: no cover
        raise NotImplementedError


class AccuracyEvaluator(Evaluator):
    """Fraction of rows where the prediction index equals the label.

    Accepts an index column (from LabelIndexTransformer) or a raw
    prediction-vector column (argmaxed here), and sparse or one-hot
    labels.
    """

    def __init__(self, prediction_col: str = "prediction_index",
                 label_col: str = "label"):
        self.prediction_col = prediction_col
        self.label_col = label_col

    def evaluate(self, dataset: Dataset) -> float:
        preds = dataset[self.prediction_col]
        if preds.ndim > 1:
            preds = np.argmax(preds, axis=-1)
        labels = dataset[self.label_col]
        if labels.ndim > 1:  # one-hot labels
            labels = np.argmax(labels, axis=-1)
        return float(np.mean(preds.astype(np.int64) == labels.astype(np.int64)))


class PerplexityEvaluator(Evaluator):
    """Held-out perplexity of a transformer LM over token rows
    ``[N, seq + 1]``: ``lm_nll`` over ``batch_size`` chunks (a remainder
    of up to ``batch_size - 1`` rows is dropped, as in the reference),
    ``exp(mean NLL)`` out.  Runs where ``params`` live."""

    def __init__(self, params, cfg, batch_size: int = 8,
                 tokens_col: str = "tokens"):
        self.params = params
        self.cfg = cfg
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.batch_size = batch_size
        self.tokens_col = tokens_col

    def evaluate(self, dataset) -> float:
        tokens = (dataset if isinstance(dataset, np.ndarray)
                  else dataset[self.tokens_col])
        if tokens.ndim != 2 or tokens.shape[1] < 2:
            raise ValueError(
                f"tokens must be [N, seq+1] with seq >= 1, got "
                f"{tokens.shape}")
        bs = self.batch_size
        n = len(tokens) - (len(tokens) % bs)
        if not n:
            raise ValueError(
                f"dataset has {len(tokens)} rows; one batch needs {bs}")
        device = self.params["tok_emb"].device
        total = 0.0
        with torch.no_grad():
            for i in range(0, n, bs):
                chunk = torch.as_tensor(np.asarray(tokens[i:i + bs], np.int32),
                                        device=device)
                total += float(tfm.lm_nll(self.params, chunk, self.cfg))
        return nll_to_perplexity(total / (n // bs))

"""Column transformers: the port's own numpy copy.

Counterpart of ``distkeras_tpu/data/transformers.py`` (reference parity:
distkeras/transformers.py): each transformer is ``transform(dataset) ->
dataset`` appending or replacing named columns with one vectorized numpy
expression, so a port pipeline gives the reference's columns exactly.
"""

from __future__ import annotations

import numpy as np

from distkeras_tpu_torch.data.dataset import Dataset


class Transformer:
    """Base: subclasses implement ``transform(dataset) -> dataset``."""

    def transform(self, dataset: Dataset) -> Dataset:  # pragma: no cover
        raise NotImplementedError

    def __call__(self, dataset: Dataset) -> Dataset:
        return self.transform(dataset)


class OneHotTransformer(Transformer):
    """Integer label column -> one-hot float vector column.

    Reference parity: distkeras/transformers.py::OneHotTransformer.
    """

    def __init__(self, num_classes: int, input_col: str = "label",
                 output_col: str = "label_onehot"):
        self.num_classes = num_classes
        self.input_col = input_col
        self.output_col = output_col

    def transform(self, dataset: Dataset) -> Dataset:
        labels = dataset[self.input_col].astype(np.int64)
        onehot = np.eye(self.num_classes, dtype=np.float32)[labels]
        return dataset.with_column(self.output_col, onehot)


class LabelIndexTransformer(Transformer):
    """Prediction-vector column -> argmax index column.

    Reference parity: distkeras/transformers.py::LabelIndexTransformer
    (used after ModelPredictor to turn raw outputs into class labels,
    SURVEY.md §3.5).
    """

    def __init__(self, input_col: str = "prediction",
                 output_col: str = "prediction_index"):
        self.input_col = input_col
        self.output_col = output_col

    def transform(self, dataset: Dataset) -> Dataset:
        preds = dataset[self.input_col]
        return dataset.with_column(self.output_col,
                                   np.argmax(preds, axis=-1).astype(np.int64))


class MinMaxTransformer(Transformer):
    """Scale a column to [new_min, new_max] given observed/known bounds.

    Reference parity: distkeras/transformers.py::MinMaxTransformer.
    Bounds may be supplied (the reference requires them) or computed
    from the data when omitted.
    """

    def __init__(self, input_col: str = "features",
                 output_col: str | None = None,
                 o_min: float | None = None, o_max: float | None = None,
                 n_min: float = 0.0, n_max: float = 1.0):
        self.input_col = input_col
        self.output_col = output_col or input_col
        self.o_min, self.o_max = o_min, o_max
        self.n_min, self.n_max = n_min, n_max

    def transform(self, dataset: Dataset) -> Dataset:
        x = dataset[self.input_col].astype(np.float32)
        o_min = self.o_min if self.o_min is not None else float(x.min())
        o_max = self.o_max if self.o_max is not None else float(x.max())
        scale = (self.n_max - self.n_min) / max(o_max - o_min, 1e-12)
        return dataset.with_column(self.output_col,
                                   (x - o_min) * scale + self.n_min)


class StandardScaleTransformer(Transformer):
    """Per-feature standardization: (x - mean) / std.

    The reference's canonical workflow standardizes features with Spark
    ML's StandardScaler before any dist-keras trainer sees them
    (SURVEY.md §3.5 pipeline); this is that stage, Dataset-native.
    Fit-once semantics: statistics are computed from the *first* dataset
    transformed (or passed explicitly) and reused for every later call,
    so train and test get the same scaling.
    """

    def __init__(self, input_col: str = "features",
                 output_col: str | None = None,
                 mean: np.ndarray | None = None,
                 std: np.ndarray | None = None):
        self.input_col = input_col
        self.output_col = output_col or input_col
        self.mean, self.std = mean, std

    def transform(self, dataset: Dataset) -> Dataset:
        x = dataset[self.input_col].astype(np.float32)
        if self.mean is None:
            self.mean = x.mean(axis=0)
        if self.std is None:
            self.std = x.std(axis=0)
        return dataset.with_column(
            self.output_col, (x - self.mean) / np.maximum(self.std, 1e-12))


class ReshapeTransformer(Transformer):
    """Reshape each row of a column (flat vector -> image tensor).

    Reference parity: distkeras/transformers.py::ReshapeTransformer
    (used to feed CNNs from flat Spark vectors).
    """

    def __init__(self, input_col: str, output_col: str, shape: tuple):
        self.input_col = input_col
        self.output_col = output_col
        self.shape = tuple(shape)

    def transform(self, dataset: Dataset) -> Dataset:
        x = dataset[self.input_col]
        return dataset.with_column(self.output_col,
                                   x.reshape((len(x),) + self.shape))


class DenseTransformer(Transformer):
    """Sparse (indices, values) columns -> dense vector column.

    Reference parity: distkeras/transformers.py::DenseTransformer
    (Spark sparse vectors -> dense).  Input is a pair of object-arrays of
    per-row index/value arrays (scalars accepted as length-1 rows), or an
    already-dense column (passthrough).

    Behavior note vs the per-row-loop implementation: negative sparse
    indices raise ``ValueError`` here instead of silently wrapping to the
    end of the row — wrapping was never meaningful for Spark sparse
    vectors, whose indices are non-negative by contract.
    """

    def __init__(self, input_col: str = "features",
                 output_col: str | None = None, size: int | None = None,
                 indices_col: str | None = None, values_col: str | None = None):
        self.input_col = input_col
        self.output_col = output_col or input_col
        self.size = size
        self.indices_col = indices_col
        self.values_col = values_col

    def transform(self, dataset: Dataset) -> Dataset:
        if self.indices_col and self.values_col:
            idx = dataset[self.indices_col]
            val = dataset[self.values_col]
            if self.size is None:
                raise ValueError("DenseTransformer needs size= for sparse input")
            out = np.zeros((len(dataset), self.size), dtype=np.float32)
            if len(dataset):
                # One flattened scatter instead of a per-row Python loop:
                # ragged per-row index/value arrays concatenate to flat
                # (row, col, val) triples and assign in a single fancy
                # index (duplicate (row, col) keeps last-wins semantics,
                # same as the row-at-a-time assignment).  atleast_1d
                # accepts scalar rows (a single index/value per row).
                idx = [np.atleast_1d(ii) for ii in idx]
                val = [np.atleast_1d(vv) for vv in val]
                lengths = np.fromiter((len(ii) for ii in idx),
                                      dtype=np.int64, count=len(dataset))
                vlengths = np.fromiter((len(vv) for vv in val),
                                       dtype=np.int64, count=len(dataset))
                # Per-row, not aggregate: equal totals with unequal rows
                # would silently shift values across rows.
                if not np.array_equal(lengths, vlengths):
                    bad = int(np.nonzero(lengths != vlengths)[0][0])
                    raise ValueError(
                        f"indices/values length mismatch at row {bad}: "
                        f"{lengths[bad]} indices vs {vlengths[bad]} values")
                if lengths.sum():
                    rows = np.repeat(np.arange(len(dataset)), lengths)
                    cols = np.concatenate(
                        [np.asarray(ii, np.int64) for ii in idx])
                    vals = np.concatenate(
                        [np.asarray(vv, np.float32) for vv in val])
                    if cols.size and (cols.min() < 0
                                      or cols.max() >= self.size):
                        raise ValueError(
                            f"sparse index out of range for size="
                            f"{self.size}: [{cols.min()}, {cols.max()}]")
                    out[rows, cols] = vals
            return dataset.with_column(self.output_col, out)
        # Already dense: ensure float32 ndarray.
        x = np.asarray(dataset[self.input_col], dtype=np.float32)
        return dataset.with_column(self.output_col, x)

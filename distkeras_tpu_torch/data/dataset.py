"""Column-oriented in-memory Dataset: the port's own copy.

Counterpart of ``distkeras_tpu/data/dataset.py`` (jax-free there too):
an immutable dict of equal-length named numpy columns, with the same
constructors, ``shuffle`` / ``split`` permutations
(``np.random.default_rng(seed).permutation``), strided ``shard`` and
``batches`` iteration, so rows come out in the reference's order bit for
bit.  Row gathers are numpy fancy indexing (the reference's native
threaded gather returns the same rows); ``batches(prefetch=N)`` prepares
batches N ahead on a background thread (``data.prefetch.Prefetcher``).
"""

from __future__ import annotations

from typing import Iterator, Mapping

import numpy as np


class Dataset:
    """Immutable dict of equal-length named numpy columns."""

    def __init__(self, columns: Mapping[str, np.ndarray]):
        if not columns:
            raise ValueError("Dataset needs at least one column")
        lengths = {k: len(v) for k, v in columns.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"Column length mismatch: {lengths}")
        self._cols = {k: np.asarray(v) for k, v in columns.items()}

    # ------------------------------------------------------------ basics

    def __len__(self) -> int:
        return len(next(iter(self._cols.values())))

    @property
    def columns(self) -> tuple[str, ...]:
        return tuple(self._cols)

    def __getitem__(self, name: str) -> np.ndarray:
        return self._cols[name]

    def with_column(self, name: str, values: np.ndarray) -> "Dataset":
        cols = dict(self._cols)
        cols[name] = np.asarray(values)
        return Dataset(cols)

    def drop(self, *names: str) -> "Dataset":
        return Dataset({k: v for k, v in self._cols.items() if k not in names})

    def select(self, *names: str) -> "Dataset":
        return Dataset({k: self._cols[k] for k in names})

    def take(self, n: int) -> "Dataset":
        return Dataset({k: v[:n] for k, v in self._cols.items()})

    # ------------------------------------------------------- constructors

    @staticmethod
    def from_arrays(features: np.ndarray, labels: np.ndarray | None = None,
                    features_col: str = "features", label_col: str = "label"
                    ) -> "Dataset":
        cols = {features_col: features}
        if labels is not None:
            cols[label_col] = labels
        return Dataset(cols)

    @staticmethod
    def from_csv(path: str, label_col: str | int | None = None,
                 features_col: str = "features", dtype=np.float32,
                 delimiter: str = ",", skip_header: int = 1) -> "Dataset":
        """Read a numeric CSV into one features matrix (+ optional label).

        Covers the reference's canonical tabular flow (workflow.ipynb
        reads the ATLAS Higgs CSV then assembles a feature vector).
        """
        if not skip_header:
            # Headerless numeric CSV: label_col may be an integer index.
            # ndmin=2 keeps one-column files as [n, 1], not a transposed
            # [1, n] (np.atleast_2d on a 1-D read would do the latter).
            data = np.loadtxt(path, delimiter=delimiter, dtype=dtype, ndmin=2)
            if label_col is None:
                return Dataset({features_col: data})
            if not isinstance(label_col, int):
                raise ValueError(
                    "headerless CSV (skip_header=0): label_col must be a "
                    f"column index, got {label_col!r}")
            labels = data[:, label_col]
            feats = np.delete(data, label_col, axis=1)
            return Dataset({features_col: feats, "label": labels})
        # skip_header semantics: the number of header lines; column names
        # are read from the *last* of them (genfromtxt's skip_header counts
        # lines skipped before the names line).
        # dtype=None infers per-column dtypes, so a non-numeric column
        # (string ids etc.) raises at the astype below instead of turning
        # into silent NaNs.
        raw = np.genfromtxt(
            path, delimiter=delimiter, names=True, dtype=None,
            skip_header=max(0, skip_header - 1), encoding="utf-8")
        names = list(raw.dtype.names)
        if label_col is not None and label_col not in names:
            raise ValueError(f"label column {label_col!r} not in {names}")
        feat_names = [n for n in names if n != label_col]
        feats = np.stack([raw[n].astype(dtype) for n in feat_names], axis=1)
        cols = {features_col: feats}
        if label_col is not None:
            cols[label_col] = raw[label_col]
        return Dataset(cols)

    # --------------------------------------------------------- reshaping

    def shuffle(self, seed: int | None = None) -> "Dataset":
        """Global random permutation (reference: distkeras/utils.py::shuffle,
        which sorted a Spark DataFrame by a random key).

        """
        perm = np.random.default_rng(seed).permutation(len(self))
        return Dataset({k: v[perm] for k, v in self._cols.items()})

    def split(self, frac: float, seed: int | None = None
              ) -> tuple["Dataset", "Dataset"]:
        """Random (train, held-out) split; ``frac`` is the first part.

        The reference delegates splitting to Spark's
        ``randomSplit`` (workflow.ipynb); here it is a permutation
        slice, deterministic under ``seed``.
        """
        if not 0.0 < frac < 1.0:
            raise ValueError(f"frac must be in (0, 1), got {frac}")
        n = len(self)
        cut = round(n * frac)  # int() truncation would undershoot e.g.
        if cut == 0 or cut == n:  # 100 * 0.29 == 28.999…
            raise ValueError(
                f"split frac={frac} of {n} rows leaves an empty part")
        perm = np.random.default_rng(seed).permutation(n)
        first, second = perm[:cut], perm[cut:]
        return (Dataset({k: v[first] for k, v in self._cols.items()}),
                Dataset({k: v[second] for k, v in self._cols.items()}))

    def shard(self, index: int, num_shards: int) -> "Dataset":
        """Strided host shard — each host keeps rows i, i+num_shards, ...

        The multi-host analogue of Spark assigning partitions to
        executors; strided (not contiguous) so class distribution stays
        balanced without a shuffle.
        """
        if not (0 <= index < num_shards):
            raise ValueError(f"shard index {index} out of range {num_shards}")
        return Dataset({k: v[index::num_shards] for k, v in self._cols.items()})

    def repeat(self, epochs: int) -> "Dataset":
        return Dataset({k: np.concatenate([v] * epochs)
                        for k, v in self._cols.items()})

    # --------------------------------------------------------- iteration

    def batches(self, batch_size: int, *, features_col: str = "features",
                label_col: str | None = "label", drop_remainder: bool = True,
                window: int | None = None, prefetch: int = 0
                ) -> Iterator[tuple[np.ndarray, np.ndarray] | np.ndarray]:
        """Yield (x, y) minibatches; with ``window``, yield [w, B, ...] stacks.

        ``window`` serves the accumulation trainers (ADAG/DynSGD): one
        yielded element carries ``window`` microbatches so a single
        accumulation step consumes them.
        ``drop_remainder=True`` keeps the step shapes fixed.
        ``prefetch=N`` stages batch preparation N elements ahead on a
        background thread (data.prefetch.Prefetcher).
        """
        if window and not drop_remainder:
            raise ValueError(
                "window requires drop_remainder=True: a partial tail "
                "cannot be reshaped to [window, batch, ...]")

        def gen():
            n = len(self)
            x = self._cols[features_col]
            y = self._cols[label_col] if label_col else None
            step = batch_size * (window or 1)
            end = n - (n % step) if drop_remainder else n
            for i in range(0, end, step):
                xb = x[i:i + step]
                yb = y[i:i + step] if y is not None else None
                if window:
                    xb = xb.reshape((window, batch_size) + xb.shape[1:])
                    if yb is not None:
                        yb = yb.reshape((window, batch_size) + yb.shape[1:])
                yield (xb, yb) if y is not None else xb

        if prefetch:
            from distkeras_tpu_torch.data.prefetch import Prefetcher

            return Prefetcher(gen(), depth=prefetch)
        return gen()

    def num_batches(self, batch_size: int, window: int | None = None) -> int:
        return len(self) // (batch_size * (window or 1))

"""Byte-level BPE tokenizer: the text -> tokens edge of the LM pipeline.

The port's own copy of ``distkeras_tpu/data/tokenizer.py``:
:class:`BPETokenizer` trains byte-level BPE merges on a corpus, encodes
text to int32 token arrays (the ``LMTrainer`` row contract, through
:meth:`BPETokenizer.encode_corpus`), and decodes samples from
``generate()`` back to text.  The same ``dkt-bpe-v1`` files load in
both packages.

Train / encode / decode run in C++ (``native/tokenizer.cc`` through the
port's loader, ``distkeras_tpu_torch.native``) when it builds, with the
reference's exact-equivalent pure-Python path otherwise; both implement
greedy rank-order BPE, so they give the same ids.  ``last_path`` records
which of the two ran last (``"native"`` or ``"python"``).

Byte-level means no out-of-vocabulary text exists: any bytes encode,
and decode is a lossless inverse.  Token ids: 0..255 are raw bytes,
256+i is merge i.
"""

from __future__ import annotations

import json

import numpy as np

from distkeras_tpu_torch import native


def _merge(toks: list[int], pair: tuple[int, int], new_id: int) -> list[int]:
    """Replace every non-overlapping occurrence of ``pair`` (left to
    right) with ``new_id`` — the BPE rewrite shared by python-path
    training and encoding."""
    out, i = [], 0
    while i < len(toks):
        if i + 1 < len(toks) and (toks[i], toks[i + 1]) == pair:
            out.append(new_id)
            i += 2
        else:
            out.append(toks[i])
            i += 1
    return out


class BPETokenizer:
    """Byte-level BPE with a learned merge table.

    >>> tok = BPETokenizer.train(corpus_text, vocab_size=1024)
    >>> ids = tok.encode("hello world")     # np.int32 [n]
    >>> tok.decode(ids) == "hello world"    # lossless
    """

    def __init__(self, merges: np.ndarray):
        merges = np.ascontiguousarray(merges, dtype=np.int32)
        if merges.ndim != 2 or (len(merges) and merges.shape[1] != 2):
            raise ValueError(f"merges must be [n, 2] int32, got {merges.shape}")
        for i, (l, r) in enumerate(merges):
            if not (0 <= l < 256 + i and 0 <= r < 256 + i):
                raise ValueError(
                    f"merge {i} references token ids ({l}, {r}) that do not "
                    f"exist yet (valid: 0..{256 + i - 1}) — corrupt table?")
        self.merges = merges
        self._rank = {(int(l), int(r)): i for i, (l, r) in enumerate(merges)}
        # "native" or "python": the path of the last train / encode /
        # decode that reached one (None before any).
        self.last_path: str | None = None

    # ------------------------------------------------------------ training

    @classmethod
    def train(cls, corpus: str | bytes, vocab_size: int = 512
              ) -> "BPETokenizer":
        """Learn ``vocab_size - 256`` merges from ``corpus``.

        Stops early (smaller vocab) when no adjacent pair repeats.
        """
        if vocab_size < 256:
            raise ValueError(
                f"vocab_size must be >= 256 (the byte alphabet), "
                f"got {vocab_size}")
        data = corpus.encode("utf-8") if isinstance(corpus, str) else corpus
        n_merges = vocab_size - 256
        if n_merges == 0 or len(data) < 2:
            return cls(np.empty((0, 2), np.int32))

        handle = native.bpe_lib()
        if handle is not None:
            buf = np.empty((n_merges, 2), np.int32)
            src = np.frombuffer(data, np.uint8)
            learned = handle.dkt_bpe_train(
                src.ctypes.data, len(src), n_merges, buf.ctypes.data)
            tok = cls(buf[:learned].copy())
        else:
            tok = cls(cls._train_py(data, n_merges))
        tok.last_path = "python" if handle is None else "native"
        return tok

    @staticmethod
    def _train_py(data: bytes, n_merges: int) -> np.ndarray:
        toks = list(data)
        merges = []
        for m in range(n_merges):
            counts: dict[tuple[int, int], int] = {}
            for pair in zip(toks, toks[1:]):
                counts[pair] = counts.get(pair, 0) + 1
            if not counts:
                break
            # max count, ties to the smallest pair — matches the C++
            # (std::map iterates sorted; strict > keeps the first max).
            best = min(counts, key=lambda p: (-counts[p], p))
            if counts[best] < 2:
                break
            merges.append(best)
            toks = _merge(toks, best, 256 + m)
        return np.asarray(merges, np.int32).reshape(-1, 2)

    # ------------------------------------------------------------ coding

    @property
    def vocab_size(self) -> int:
        return 256 + len(self.merges)

    def encode(self, text: str | bytes) -> np.ndarray:
        """Encode to int32 token ids (never fails: byte-level)."""
        data = text.encode("utf-8") if isinstance(text, str) else text
        if not data:
            return np.empty((0,), np.int32)

        handle = native.bpe_lib()
        self.last_path = "python" if handle is None else "native"
        if handle is not None:
            src = np.frombuffer(data, np.uint8)
            out = np.empty(len(src), np.int32)
            n = handle.dkt_bpe_encode(
                self.merges.ctypes.data, len(self.merges),
                src.ctypes.data, len(src), out.ctypes.data)
            return out[:n].copy()
        return self._encode_py(data)

    def _encode_py(self, data: bytes) -> np.ndarray:
        toks = list(data)
        rank = self._rank
        while True:
            # Lowest-rank pair present anywhere; merging can only create
            # pairs of *higher* rank (a merge id only appears in later
            # rules), so rank order is globally safe.
            best = None
            for pair in set(zip(toks, toks[1:])):
                r = rank.get(pair)
                if r is not None and (best is None or r < best[0]):
                    best = (r, pair)
            if best is None:
                break
            r, pair = best
            toks = _merge(toks, pair, 256 + r)
        return np.asarray(toks, np.int32)

    def decode(self, ids, errors: str = "replace") -> str:
        """Decode token ids back to text (lossless for encode output)."""
        return bytes(self.decode_bytes(ids)).decode("utf-8", errors=errors)

    def decode_bytes(self, ids) -> np.ndarray:
        ids = np.ascontiguousarray(ids, dtype=np.int32)
        if ids.ndim != 1:
            raise ValueError(f"ids must be 1-D, got shape {ids.shape}")
        if ids.size == 0:
            return np.empty((0,), np.uint8)
        if ids.min() < 0 or ids.max() >= self.vocab_size:
            raise ValueError(
                f"token id out of range for vocab_size={self.vocab_size}")

        handle = native.bpe_lib()
        self.last_path = "python" if handle is None else "native"
        if handle is not None:
            # Exact output size from the per-id expansion lengths.
            cap = int(np.take(self._expansion_lens(), ids).sum())
            out = np.empty(cap, np.uint8)
            n = handle.dkt_bpe_decode(
                self.merges.ctypes.data, len(self.merges),
                ids.ctypes.data, len(ids), out.ctypes.data, cap)
            if n < 0:  # pragma: no cover - guarded by the range check
                raise ValueError("native BPE decode failed")
            return out[:n].copy()
        table = self._expansion_table()
        return np.asarray(
            [b for i in ids for b in table[int(i)]], np.uint8)

    def _expansion_table(self) -> list[bytes]:
        table: list[bytes] = [bytes([b]) for b in range(256)]
        for l, r in self.merges:
            table.append(table[int(l)] + table[int(r)])
        return table

    def _expansion_lens(self) -> np.ndarray:
        lens = [1] * 256
        for l, r in self.merges:
            lens.append(lens[int(l)] + lens[int(r)])
        return np.asarray(lens, np.int64)

    # ------------------------------------------------------------ persist

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"format": "dkt-bpe-v1",
                       "merges": self.merges.tolist()}, f)

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        with open(path) as f:
            blob = json.load(f)
        if blob.get("format") != "dkt-bpe-v1":
            raise ValueError(f"not a dkt-bpe-v1 file: {path}")
        return cls(np.asarray(blob["merges"], np.int32).reshape(-1, 2))

    # ------------------------------------------------------------ batching

    def encode_corpus(self, text: str | bytes, seq_len: int) -> np.ndarray:
        """Encode and pack into LMTrainer rows ``[N, seq_len + 1]``.

        Consecutive windows with one-token overlap (each row carries
        inputs plus the shifted targets, the trainers/lm.py contract);
        the tail remainder is dropped.
        """
        ids = self.encode(text)
        n = (len(ids) - 1) // seq_len
        if n < 1:
            raise ValueError(
                f"corpus encodes to {len(ids)} tokens; one row needs "
                f"{seq_len + 1}")
        windows = np.lib.stride_tricks.sliding_window_view(ids, seq_len + 1)
        return np.ascontiguousarray(windows[::seq_len][:n])

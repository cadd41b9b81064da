"""Document packing for LM training rows (numpy only).

The port's own copy of ``distkeras_tpu/data/packing.py`` (whose package
imports JAX at import time): ``pack_documents`` lays variable-length
documents end to end into ``[N, seq_len + 1]`` rows with a parallel
``segment_ids`` array, so attention stays within a document (the flash
kernels' segment mask) and the loss skips cross-boundary and padding
targets (``lm_loss(..., segment_ids=)``, ``LMTrainer.train(segments=)``).
"""

from __future__ import annotations

import numpy as np


def pack_documents(docs, seq_len: int, pad_id: int = 0):
    """Pack token documents into LM rows.

    ``docs``: iterable of 1-D int token sequences (each one document).
    Returns ``(rows [N, seq_len+1] int32, segments [N, seq_len+1]
    int32)`` — the trainers/lm.py row contract (inputs + shifted
    targets) plus per-position document ids: 1, 2, ... within each row,
    0 for padding.  Feed both to ``lm_loss(..., segment_ids=segments)``
    (or ``LMTrainer.train(rows, segments=segments)``).

    Greedy streaming fill: documents are laid end-to-end; a document
    longer than the remaining row space CONTINUES into the next row
    under a fresh segment id (its continuation attends only its own
    row's slice — context resets at the row boundary, the standard
    packing trade).  Single-token tails are dropped (a segment needs
    >= 2 positions to yield one trainable target).  The final partial
    row is padded with ``pad_id`` / segment 0.
    """
    if seq_len < 1:
        raise ValueError(f"seq_len must be >= 1, got {seq_len}")
    width = seq_len + 1
    rows, segs = [], []
    cur_r = np.full((width,), pad_id, np.int64)
    cur_s = np.zeros((width,), np.int32)
    fill, next_seg = 0, 1

    def flush():
        nonlocal cur_r, cur_s, fill, next_seg
        if fill:
            rows.append(cur_r.copy())
            segs.append(cur_s.copy())
        cur_r = np.full((width,), pad_id, np.int64)
        cur_s = np.zeros((width,), np.int32)
        fill, next_seg = 0, 1

    for doc in docs:
        doc = np.asarray(doc).ravel()
        if doc.size < 2:
            continue  # no trainable target even alone
        start = 0
        while start < doc.size:
            if fill >= width - 1:
                flush()  # < 2 free slots: nothing trainable fits
            take = min(doc.size - start, width - fill)
            if doc.size - start - take == 1:
                take -= 1  # don't strand a 1-token (untrainable) tail
            if take < 2 and fill:
                # A 1-token chunk is untrainable waste (its target is
                # boundary-masked): start this document on a fresh row
                # instead.  Fresh rows always fit >= 2 (width >= 3;
                # the seq_len=1 edge accepts the degenerate chunk).
                flush()
                continue
            cur_r[fill:fill + take] = doc[start:start + take]
            cur_s[fill:fill + take] = next_seg
            fill += take
            next_seg += 1
            start += take
    flush()
    if not rows:
        raise ValueError(
            f"no document provided >= 2 tokens; nothing to pack into "
            f"rows of seq_len={seq_len}")
    return (np.stack(rows).astype(np.int32),
            np.stack(segs).astype(np.int32))


def packing_efficiency(segments) -> float:
    """Fraction of positions carrying real tokens (segment != 0)."""
    segments = np.asarray(segments)
    return float((segments != 0).mean())

"""Content-hash stem residency: the digest the paged engine publishes.

The port's own copy of ``distkeras_tpu/serving/residency.py``.  The paged
engine (:mod:`~distkeras_tpu_torch.serving.paged`) names a resident KV
block by the chain hash of the whole token prefix up to and including
that block.  A cache-aware router on another host compares these digests
with its own, so the bytes must be the reference's exactly: blake2b
(16-byte digest) over the previous digest and the block's tokens as
little-endian int32.  Pure numpy and hashlib, no torch.
"""

from __future__ import annotations

import hashlib

import numpy as np


def chain_hash(prev: bytes, tokens) -> bytes:
    """Chain hash of one full block of prompt tokens: a pure function
    of the whole token prefix up to and including this block, so equal
    digests imply equal (position, content) — the stem-sharing key."""
    h = hashlib.blake2b(prev, digest_size=16)
    h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
    return h.digest()


def stem_hashes(tokens, block: int) -> list[bytes]:
    """Chain hashes of every FULL ``block``-token block of ``tokens`` (a
    partial tail block has no stable identity and gets no digest).
    Engines prefill the warm prompt (every token but the last), so the
    residency a request can hit is ``stem_hashes(prompt[:-1], block)``."""
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    tokens = np.asarray(tokens, np.int32).reshape(-1)
    out: list[bytes] = []
    digest = b""
    for k in range(tokens.size // block):
        digest = chain_hash(digest, tokens[k * block:(k + 1) * block])
        out.append(digest)
    return out


def stem_hexes(tokens, block: int) -> list[str]:
    """:func:`stem_hashes` as hex strings (the JSON-safe spelling)."""
    return [h.hex() for h in stem_hashes(tokens, block)]


__all__ = ["chain_hash", "stem_hashes", "stem_hexes"]

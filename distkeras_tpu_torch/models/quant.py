"""Weight-read helpers of ``distkeras_tpu/models/quant.py``, full
precision only: plain tensors pass straight through.  ``QTensor`` int8
weights and the int8 KV cache come with a later slice (ROADMAP A9)."""

from __future__ import annotations

import torch


def deq(w):
    """Dequantize-if-needed: every weight read of the decode step goes
    through here; a plain tensor passes straight through."""
    return w


def unembed_logits(x, tok_emb, dtype):
    """Unembedding head ``x [..., d] @ tok_emb^T -> [..., V]``, with the
    table cast to ``dtype`` and both operands promoted as JAX does."""
    table = tok_emb.to(dtype)
    common = torch.promote_types(x.dtype, table.dtype)
    return torch.matmul(x.to(common), table.to(common).t())


def embed_rows(tok_emb, tokens, dtype):
    """Embedding lookup, cast to the compute dtype."""
    return tok_emb[tokens].to(dtype)

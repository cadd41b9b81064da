"""int8 weights and the int8 KV cache for the decode path.

Counterpart of ``distkeras_tpu/models/quant.py``.  ``quantize_params``
stores the decode-relevant matmul weights as int8 with per-output-channel
f32 scales (:class:`QTensor`); every weight read of the decode step goes
through :func:`deq` (and :func:`embed_rows` / :func:`unembed_logits` for
the tied embedding), so quantized and plain trees share one code path.
``quantize_kv`` quantizes K/V rows per token and kv-head for the int8
cache (``generate(kv_int8=True)``).

The arithmetic is the reference's op for op (absmax, a true division,
round half to even, clip), all exact in f32, so the same f32 weights give
the same ``q`` and ``s`` in both packages, bit for bit.  Divisions run
against device tensors: CUDA turns a division by a host scalar into a
product by its reciprocal, which is not exact.

``generate`` keeps a quantized tree on the sequential path (the batched
prefill forward wants the training weights), as the reference does.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class QTensor:
    """int8 values ``q`` and f32 per-output-channel scales ``s`` (at the
    rank of ``q``, size 1 on the contracted axes): ``q * s`` is the
    weight."""

    q: torch.Tensor  # int8
    s: torch.Tensor  # f32, broadcastable to q.shape

    @property
    def shape(self):
        return self.q.shape

    @property
    def device(self) -> torch.device:
        return self.q.device

    def dequant(self, dtype=torch.float32):
        return (self.q.float() * self.s).to(dtype)


def _div(x, d: float):
    """``x / d`` as a true division on every device."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _quantize(w, contract_axes: tuple[int, ...]) -> QTensor:
    """Symmetric absmax int8 over the contracted axes: each output
    channel rounds on its own scale."""
    w = w.detach().float()
    amax = w.abs().amax(dim=contract_axes, keepdim=True)
    s = torch.where(amax > 0, _div(amax, 127.0), 1.0)
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return QTensor(q=q, s=s)


# Weight name -> axes its decode-step matmul contracts over (the leading
# [L] stack axis is never contracted).
_CONTRACT = {
    "wq": (1,), "wk": (1,), "wv": (1,),   # [L, d, h, hd]: over d
    "wo": (1, 2),                          # [L, h, hd, d]: over h, hd
    "w1": (1,), "w2": (1,),                # [L, d, f] / [L, f, d]
}


def quantize_params(params):
    """Quantize the attention projections, the dense-FFN mats and
    ``tok_emb`` (per vocab row: the unembedding's output channel, and
    what a gathered embedding row needs) of a transformer params tree to
    int8, on the tree's device.  RMSNorm scales (and ``pos_emb``) stay as
    they are.  MoE configs raise, as in the reference (the decode MoE
    gathers per-token expert slabs)."""
    params = dict(params)
    layers = dict(params["layers"])
    if "moe" in layers:
        raise ValueError(
            "quantize_params supports dense-FFN configs only (decode-time "
            "MoE gathers per-token expert slabs)")
    for group in ("attn", "ffn"):
        layers[group] = {k: _quantize(v, _CONTRACT[k])
                         for k, v in layers[group].items()}
    params["layers"] = layers
    params["tok_emb"] = _quantize(params["tok_emb"], (1,))
    return params


def is_quantized(params) -> bool:
    return isinstance(params.get("tok_emb"), QTensor)


def deq(w, dtype=None):
    """Dequantize-if-needed: a :class:`QTensor` becomes dense f32 (or
    ``dtype``), so a bf16 activation times an int8 weight runs in f32 as
    JAX's promotion has it; a plain tensor passes through (cast only when
    ``dtype`` is given)."""
    if isinstance(w, QTensor):
        return w.dequant(dtype or torch.float32)
    return w if dtype is None else w.to(dtype)


def unembed_logits(x, tok_emb, dtype):
    """Unembedding head ``x [..., d] @ tok_emb^T -> [..., V]``.  An int8
    table is contracted as ``q`` cast to the activations' dtype (int8 is
    exact in bf16) and the f32 result scaled by each vocab row's scale;
    a plain table is cast to ``dtype``, both operands promoted as JAX
    does."""
    if isinstance(tok_emb, QTensor):
        out = torch.matmul(x, tok_emb.q.to(x.dtype).t())
        return out.float() * tok_emb.s[:, 0]
    table = tok_emb.to(dtype)
    common = torch.promote_types(x.dtype, table.dtype)
    return torch.matmul(x.to(common), table.to(common).t())


def embed_rows(tok_emb, tokens, dtype):
    """Embedding lookup; int8 rows are gathered, then dequantized."""
    if isinstance(tok_emb, QTensor):
        rows = tok_emb.q[tokens].float()
        return (rows * tok_emb.s[tokens]).to(dtype)
    return tok_emb[tokens].to(dtype)


def quantize_kv(x):
    """Per-token, per-kv-head symmetric int8 of K/V rows
    ``[..., kv_heads, head_dim]`` -> ``(int8, scale [..., kv_heads])``,
    scale = max(absmax, 1e-12) / 127 over head_dim."""
    xf = x.float()
    scale = _div(torch.clamp(xf.abs().amax(dim=-1), min=1e-12), 127.0)
    q = torch.round(xf / scale[..., None])
    return q.to(torch.int8), scale


__all__ = ["QTensor", "quantize_params", "quantize_kv", "deq",
           "embed_rows", "unembed_logits", "is_quantized"]

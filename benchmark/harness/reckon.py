"""The yardstick's arithmetic: the card's peaks, and the operations and
bytes of the work the cells do, counted from shapes alone.

Nothing here imports the program: a count that came from the code under
test could be bent by a change to it.

Peaks are NVIDIA's published figures for one H100 SXM (dense, no
sparsity) at its full 700 W power limit.  The f32 attention kernels run
their products on the tensor cores as three TF32 passes (3xTF32), so
their peak is the TF32 rate over three.
"""

from __future__ import annotations

PEAK_FLOPS = {
    "bfloat16": 989e12,
    "float16": 989e12,
    "tf32": 495e12,
    "float32_3xtf32": 495e12 / 3,
    "float32": 67e12,           # without the tensor cores
}
HBM_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def causal_pairs(lq: int, lk: int | None = None) -> int:
    """(query, key) pairs a causal mask keeps: query ``r`` sees keys
    ``0..r`` (aligned at the start, ``lk >= lq``)."""
    lk = lq if lk is None else lk
    return sum(min(r, lk - 1) + 1 for r in range(lq)) if lk < lq \
        else lq * (lq + 1) // 2


def attention_pairs(lq: int, lk: int, causal: bool) -> int:
    return causal_pairs(lq, lk) if causal else lq * lk


def attention_call(kind: str, b: int, lq: int, h: int, d: int,
                   causal: bool, dtype: str, lk: int | None = None):
    """``(flops, bytes)`` one attention call needs, from its shapes.

    ``kind``: ``"fwd"`` (S = QK^T and P V: 4 D FLOPs a live pair; q, k,
    v read and o written once, plus the f32 log-sum-exp row a training
    forward keeps), ``"dq"`` (S, dP = dO V^T, dQ = dS K: 6 D a pair;
    q, k, v, dO read, dQ written, lse and delta read) or ``"dkv"`` (S,
    dP, dV = P^T dO, dK = dS^T Q: 8 D a pair; q, k, v, dO read, dK, dV
    written, lse and delta read)."""
    lk = lq if lk is None else lk
    pairs = b * h * attention_pairs(lq, lk, causal)
    elt = DTYPE_BYTES[dtype]
    q_bytes = b * lq * h * d * elt
    kv_bytes = b * lk * h * d * elt
    rows = b * h * lq * 4
    if kind == "fwd":
        return 4 * d * pairs, 2 * q_bytes + 2 * kv_bytes + rows
    if kind == "dq":
        return 6 * d * pairs, 3 * q_bytes + 2 * kv_bytes + 2 * rows
    if kind == "dkv":
        return 8 * d * pairs, 2 * q_bytes + 4 * kv_bytes + 2 * rows
    raise ValueError(f"unknown attention call kind {kind!r}")


def attention_bound_s(kind: str, b: int, lq: int, h: int, d: int,
                      causal: bool, dtype: str, lk: int | None = None):
    """``(seconds, bound_by)``: the least time the card needs for the
    call, the larger of its FLOPs over the peak and its bytes over the
    HBM rate."""
    flops, nbytes = attention_call(kind, b, lq, h, d, causal, dtype, lk)
    peak = PEAK_FLOPS["float32_3xtf32" if dtype == "float32" else dtype]
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("flops" if t_ops >= t_bytes else "bytes")


def lm_matmul_params(cfg: dict) -> int:
    """Weights the LM's matrix products touch per token: each block's
    q, k, v, o and the two FFN matrices, and the tied unembedding (the
    embedding lookup is a gather, not a product)."""
    d, f, layers = cfg["d_model"], cfg["d_ff"], cfg["n_layers"]
    hd = d // cfg["n_heads"]
    kv = cfg.get("n_kv_heads") or cfg["n_heads"]
    attn = d * cfg["n_heads"] * hd * 2 + d * kv * hd * 2
    return layers * (attn + 2 * d * f) + cfg["vocab_size"] * d


def lm_train_flops(cfg: dict, batch: int, seq: int) -> int:
    """Model FLOPs of one training step over ``batch`` rows of ``seq``
    inputs: 6 N a token for the products (forward and backward), plus
    causal attention at 3 x its forward's 4 d FLOPs a live pair.
    Recomputation is not counted."""
    tokens = batch * seq
    attn = 3 * 4 * cfg["d_model"] * cfg["n_layers"] * batch \
        * causal_pairs(seq)
    return 6 * lm_matmul_params(cfg) * tokens + attn


def lm_forward_flops(cfg: dict, start: int, count: int) -> int:
    """Model FLOPs of a forward over ``count`` tokens at positions
    ``start .. start + count - 1`` of one sequence (prefill or decode):
    2 N a token plus 4 d FLOPs a layer for every key a query sees."""
    keys = sum(start + i + 1 for i in range(count))
    return (2 * lm_matmul_params(cfg) * count
            + 4 * cfg["d_model"] * cfg["n_layers"] * keys)

"""Attention in PyTorch: naive, blockwise (online softmax), and flash.

Counterpart of ``distkeras_tpu/ops/attention.py``; the tiers keep its
semantics so the tests hold them against each other and against the JAX
package:

- :func:`naive_attention` — materialized logits; the numerics oracle.
- :func:`blockwise_attention` — online softmax over KV chunks; the plain
  version of the flash kernel, and what :func:`flash_attention` runs on
  CPU tensors.
- :func:`flash_attention` — a ``torch.autograd.Function`` over the
  hand-written Hopper kernels on CUDA tensors: the forward
  ``csrc/flash_fwd.cu`` (with the per-row log-sum-exp when a gradient is
  needed) and the FA2 backward ``csrc/flash_bwd.cu`` (dQ, dK/dV); on CPU
  tensors the blockwise tier, differentiated by autograd.
- :func:`flash_fwd_plain`, :func:`flash_bwd_dq_plain`,
  :func:`flash_bwd_dkv_plain` — the kernels' plain versions (the tests
  and ``chip_smoke.py`` hold the kernels against them).

All take ``q: [B, Lq, H, D]``, ``k/v: [B, Lkv, H, D]`` and return
``[B, Lq, H, D]``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from distkeras_tpu_torch.ops import _build

# Finite stand-in for -inf: keeps exp()/max() NaN-free when a whole row
# or chunk is masked.
NEG_INF = -1e30

# KV chunk of the plain path when the caller gives none (the JAX
# package's fallback chunk, so CPU numerics follow the same order).
_PLAIN_BLOCK_K = 1024

# Launch counts of the CUDA kernels: each wrapper adds one where it
# launches its kernel, so a run can show that its path went through them.
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def _scale_for(q, scale):
    return (1.0 / math.sqrt(q.shape[-1])) if scale is None else scale


def _causal_mask(lq: int, lk: int, q_offset, kv_offset, window=None,
                 device=None):
    """[lq, lk] bool mask: True where q position >= k position (global);
    with ``window`` also requires q - k < window."""
    rows = torch.arange(lq, device=device)[:, None] + q_offset
    cols = torch.arange(lk, device=device)[None, :] + kv_offset
    mask = rows >= cols
    if window is not None:
        mask = mask & (rows - cols < window)
    return mask


def _check_window(window, causal) -> None:
    if window is None:
        return
    if not causal:
        raise ValueError(
            "window (sliding-window attention) requires causal=True — "
            "the window is defined over the causal past")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def naive_attention(q, k, v, causal: bool = False, scale: float | None = None,
                    q_offset: int = 0, kv_offset: int = 0,
                    window: int | None = None, segment_ids=None):
    """Materialized-logits attention; the test oracle.  ``segment_ids
    [B, L]`` restricts attention to within-segment pairs."""
    _check_window(window, causal)
    scale = _scale_for(q, scale)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        mask = _causal_mask(q.shape[1], k.shape[1], q_offset, kv_offset,
                            window, q.device)
        logits = torch.where(mask[None, None], logits, NEG_INF)
    if segment_ids is not None:
        seg = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        logits = torch.where(seg, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# --------------------------------------------------------------- online core


def attention_chunk(q, k, v, m, l, o, causal: bool, scale: float,
                    q_offset, kv_offset, window: int | None = None,
                    seg_q=None, seg_k=None):
    """One online-softmax update with a KV chunk.

    Running state per q row: ``m`` max logit ``[B,H,Lq]``, ``l``
    normalizer ``[B,H,Lq]``, ``o`` unnormalized output ``[B,H,Lq,D]``.
    """
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        mask = _causal_mask(q.shape[1], k.shape[1], q_offset, kv_offset,
                            window, q.device)
        logits = torch.where(mask[None, None], logits, NEG_INF)
    if seg_q is not None:
        seg = seg_q[:, None, :, None] == seg_k[:, None, None, :]
        logits = torch.where(seg, logits, NEG_INF)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    correction = torch.exp(m - m_new)
    p = torch.exp(logits - m_new[..., None])
    l_new = l * correction + p.sum(dim=-1)
    o_new = o * correction[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v)
    return m_new, l_new, o_new


def online_init(batch, heads, lq, dim, dtype=torch.float32, device=None):
    """Fresh (m, l, o) state for the online-softmax recurrence."""
    return (torch.full((batch, heads, lq), NEG_INF, dtype=dtype,
                       device=device),
            torch.zeros((batch, heads, lq), dtype=dtype, device=device),
            torch.zeros((batch, heads, lq, dim), dtype=dtype, device=device))


def online_finish(m, l, o):
    """Normalize accumulated output -> [B, Lq, H, D].  Fully masked rows
    return the mean of V, as the naive oracle does; the ``l == 0`` guard
    only protects against exp underflow."""
    out = o / torch.where(l == 0, 1.0, l)[..., None]
    return out.permute(0, 2, 1, 3)


def _online(q, k, v, causal, scale, block_k, q_offset, kv_offset, window,
            segment_ids):
    """(m, l, o) of the online softmax over KV chunks of ``block_k``
    (clamped to the largest divisor of Lkv not above it), in f32."""
    _check_window(window, causal)
    b, lq, h, d = q.shape
    lk = k.shape[1]
    block_k = min(block_k, lk)
    while lk % block_k:
        block_k -= 1
    if segment_ids is not None and (tuple(segment_ids.shape) != (b, lk)
                                    or lq != lk):
        raise ValueError(
            f"segment_ids must be [batch, seq] = ({b}, {lk}) with "
            f"lq == lkv, got {tuple(segment_ids.shape)} (lq={lq})")
    qf = q.float()
    m, l, o = online_init(b, h, lq, d, device=q.device)
    for start in range(0, lk, block_k):
        sl = slice(start, start + block_k)
        m, l, o = attention_chunk(
            qf, k[:, sl].float(), v[:, sl].float(), m, l, o, causal, scale,
            q_offset, kv_offset + start, window,
            seg_q=segment_ids,
            seg_k=None if segment_ids is None else segment_ids[:, sl])
    return m, l, o


def blockwise_attention(q, k, v, causal: bool = False,
                        scale: float | None = None, block_k: int = 512,
                        q_offset: int = 0, kv_offset: int = 0,
                        window: int | None = None, segment_ids=None):
    """Online-softmax attention over KV chunks of ``block_k`` (clamped to
    the largest divisor of Lkv not above it), computed in f32; the plain
    version of the flash kernel.  ``segment_ids [B, L]`` needs
    lq == lkv."""
    m, l, o = _online(q, k, v, causal, _scale_for(q, scale), block_k,
                      q_offset, kv_offset, window, segment_ids)
    return online_finish(m, l, o).to(q.dtype)


# ------------------------------------------------- plain FA2 (kernels' twins)


def flash_fwd_plain(q, k, v, causal: bool, scale: float,
                    window: int | None = None, segment_ids=None):
    """The training forward's plain version: ``(out, lse)`` with ``out``
    in q's dtype and ``lse = m + log l`` f32 ``[B, H, Lq]`` (the ``l ==
    0`` guard of the reference, so a fully masked row keeps ``m``)."""
    m, l, o = _online(q, k, v, causal, scale, _PLAIN_BLOCK_K, 0, 0, window,
                      segment_ids)
    lse = m + torch.log(torch.where(l == 0, 1.0, l))
    return online_finish(m, l, o).to(q.dtype), lse


def attention_delta(do, out):
    """``delta = rowsum(dO * O)`` in f32, ``[B, H, Lq]``: the softmax
    normalizer's gradient term, computed outside the kernels as the
    reference computes it outside its own."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _fa2_probs(q, k, lse, causal, scale, window, q0, k0, seg_q, seg_k):
    """Rebuilt probabilities ``p = exp(s - lse)`` ``[B, H, lq, lk]`` of a
    q chunk (rows from ``q0``) against a kv chunk (columns from ``k0``),
    masked as the forward masks (finite NEG_INF)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        mask = _causal_mask(q.shape[1], k.shape[1], q0, k0, window, q.device)
        s = torch.where(mask[None, None], s, NEG_INF)
    if seg_q is not None:
        s = torch.where(seg_q[:, None, :, None] == seg_k[:, None, None, :],
                        s, NEG_INF)
    return torch.exp(s - lse[..., None])


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool, scale: float,
                       window: int | None = None, segment_ids=None,
                       block: int = _PLAIN_BLOCK_K):
    """dQ of FA2 from the saved lse, over KV chunks of ``block``; the
    plain version of ``flash_bwd_dq_cuda``.  dQ in q's dtype."""
    _check_window(window, causal)
    qf, dof = q.float(), do.float()
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for start in range(0, k.shape[1], block):
        sl = slice(start, start + block)
        kc, vc = k[:, sl].float(), v[:, sl].float()
        p = _fa2_probs(qf, kc, lse, causal, scale, window, 0, start,
                       segment_ids,
                       None if segment_ids is None else segment_ids[:, sl])
        dp = torch.einsum("bqhd,bkhd->bhqk", dof, vc)
        ds = p * (dp - delta[..., None]) * scale
        dq += torch.einsum("bhqk,bkhd->bqhd", ds, kc)
    return dq.to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool, scale: float,
                        window: int | None = None, segment_ids=None,
                        block: int = _PLAIN_BLOCK_K):
    """(dK, dV) of FA2 from the saved lse, over q chunks of ``block``;
    the plain version of ``flash_bwd_dkv_cuda``.  In k's / v's dtype."""
    _check_window(window, causal)
    kf, vf = k.float(), v.float()
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for start in range(0, q.shape[1], block):
        sl = slice(start, start + block)
        qc, doc = q[:, sl].float(), do[:, sl].float()
        p = _fa2_probs(qc, kf, lse[:, :, sl], causal, scale, window, start,
                       0, None if segment_ids is None else segment_ids[:, sl],
                       segment_ids)
        dv += torch.einsum("bhqk,bqhd->bkhd", p, doc)
        dp = torch.einsum("bqhd,bkhd->bhqk", doc, vf)
        ds = p * (dp - delta[:, :, sl, None]) * scale
        dk += torch.einsum("bhqk,bqhd->bkhd", ds, qc)
    return dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------ CUDA kernels

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _check_kernel_inputs(q, k, v, *more) -> None:
    """What the Hopper kernels take; anything else raises (the CUDA path
    never falls back to the plain version).  ``more``: further
    ``[B, Lq, H, D]`` tensors (dO) checked like q."""
    for name, t in (("q", q), ("k", k), ("v", v),
                    *((f"arg{i}", t) for i, t in enumerate(more))):
        if not t.is_cuda:
            raise ValueError(f"flash kernel: {name} is not a CUDA tensor")
        if t.dim() != 4:
            raise ValueError(
                f"flash kernel: {name} must be [B, L, H, D], got "
                f"{tuple(t.shape)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("flash kernel: q, k, v must share dtype and "
                             "device")
        if t.stride(-1) != 1:
            raise ValueError(
                f"flash kernel: {name} needs unit stride on head_dim")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"flash kernel takes float32 or bfloat16, got {q.dtype}")
    b, lq, h, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(
            f"flash kernel takes head_dim in {_HEAD_DIMS}, got {d}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != q.shape[2:]:
        raise ValueError(
            f"flash kernel: k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
            f"match q {tuple(q.shape)} (repeat GQA heads before the call)")
    if any(t.shape != q.shape for t in more):
        raise ValueError("flash kernel: dO must have q's shape")
    if lq < 1 or k.shape[1] < 1 or b * h > 65535:
        raise ValueError(
            f"flash kernel: need Lq, Lkv >= 1 and B*H <= 65535, got "
            f"{tuple(q.shape)}, Lkv={k.shape[1]}")


def _kernel_segments(segment_ids, q, k):
    """int32 ``[B, L]`` contiguous segment ids on q's device (lq == lkv),
    or None."""
    if segment_ids is None:
        return None
    b, lq = q.shape[:2]
    if tuple(segment_ids.shape) != (b, lq) or k.shape[1] != lq:
        raise ValueError(
            f"flash kernel: segment_ids must be [batch, seq] = ({b}, {lq}) "
            f"with lq == lkv, got {tuple(segment_ids.shape)} "
            f"(lkv={k.shape[1]})")
    if segment_ids.device != q.device:
        raise ValueError("flash kernel: segment_ids must live on q's device")
    return segment_ids.to(torch.int32).contiguous()


def _check_rows(name, t, q):
    b, lq, h, _ = q.shape
    if (t.dtype != torch.float32 or tuple(t.shape) != (b, h, lq)
            or not t.is_contiguous() or t.device != q.device):
        raise ValueError(f"flash kernel: {name} must be contiguous f32 "
                         f"[B, H, Lq] = ({b}, {h}, {lq}) on q's device")


def _launch(source, name, q, k, ptrs, strided, scale, causal, window):
    """Call the C entry ``dkt_<name>`` of ``csrc/<source>.cu`` (built at
    first use) on the current stream with its calling convention: ``ptrs``
    (tensors or None), (dtype, B, H, Lq, Lk, D), the b / l / h strides of
    the ``strided`` tensors, scale, causal, window, stream.  Raises on a
    launch error; counts the launch in ``LAUNCHES[name]`` otherwise."""
    lib = _build.load(source)
    fn = getattr(lib, f"dkt_{name}")
    if fn.argtypes is None:
        fn.argtypes = ([_PTR] * len(ptrs) + [_I32] * 6
                       + [_I64] * (3 * len(strided))
                       + [ctypes.c_float, _I32, _I32, _PTR])
        fn.restype = ctypes.c_int
        lib.dkt_error_string.argtypes = [_I32]
        lib.dkt_error_string.restype = ctypes.c_char_p
    b, lq, h, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(None if t is None else t.data_ptr() for t in ptrs),
                 _DTYPE_CODES[q.dtype], b, h, lq, k.shape[1], d,
                 *(s for t in strided for s in t.stride()[:3]),
                 float(scale), int(causal), int(window or 0), stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.dkt_error_string(err).decode())
    LAUNCHES[name] += 1


def flash_fwd_cuda(q, k, v, causal: bool, scale: float,
                   window: int | None = None, segment_ids=None,
                   with_lse: bool = False):
    """Launch ``csrc/flash_fwd.cu`` on the current stream; returns
    ``(O, lse)``: O in q's dtype ``[B, Lq, H, D]``, and with
    ``with_lse`` the f32 ``[B, H, Lq]`` log-sum-exp (else None — the
    inference launch writes none)."""
    _check_kernel_inputs(q, k, v)
    if not scale > 0:
        raise ValueError(f"flash kernel: scale must be positive (the "
                         f"softmax keeps its max over raw logits), got {scale}")
    seg = _kernel_segments(segment_ids, q, k)
    b, lq, h, d = q.shape
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    _launch("flash_fwd", "flash_fwd", q, k, (q, k, v, out, lse, seg),
            (q, k, v, out), scale, causal, window)
    return out, lse


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal: bool, scale: float,
                      window: int | None = None, segment_ids=None):
    """Launch the dQ kernel of ``csrc/flash_bwd.cu``: dQ in q's dtype,
    ``[B, Lq, H, D]``, from the forward's lse and ``delta``
    (:func:`attention_delta`), both f32 ``[B, H, Lq]``."""
    _check_kernel_inputs(q, k, v, do)
    _check_rows("lse", lse, q)
    _check_rows("delta", delta, q)
    seg = _kernel_segments(segment_ids, q, k)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch("flash_bwd", "flash_bwd_dq", q, k,
            (q, k, v, do, lse, delta, seg, dq), (q, k, v, do, dq), scale,
            causal, window)
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal: bool, scale: float,
                       window: int | None = None, segment_ids=None):
    """Launch the dK/dV kernel of ``csrc/flash_bwd.cu``: ``(dK, dV)`` in
    k's / v's dtype, ``[B, Lkv, H, D]``."""
    _check_kernel_inputs(q, k, v, do)
    _check_rows("lse", lse, q)
    _check_rows("delta", delta, q)
    seg = _kernel_segments(segment_ids, q, k)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    _launch("flash_bwd", "flash_bwd_dkv", q, k,
            (q, k, v, do, lse, delta, seg, dk, dv), (q, k, v, do, dk, dv),
            scale, causal, window)
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """The kernels under autograd (counterpart of the reference's
    ``custom_vjp``): the forward saves O and lse, the backward runs the
    dQ and dK/dV kernels; ``segment_ids`` gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window, segment_ids):
        out, lse = flash_fwd_cuda(q, k, v, causal, scale, window,
                                  segment_ids, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids)
        ctx.args = (causal, scale, window)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, out, lse, seg = ctx.saved_tensors
        if g.stride(-1) != 1:
            g = g.contiguous()  # the kernels take strides, not this one
        delta = attention_delta(g, out)
        dq = flash_bwd_dq_cuda(q, k, v, g, lse, delta, *ctx.args, seg)
        dk, dv = flash_bwd_dkv_cuda(q, k, v, g, lse, delta, *ctx.args, seg)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal: bool = False, scale: float | None = None,
                    block_k: int | None = None, window: int | None = None,
                    segment_ids=None):
    """Fused attention: the Hopper kernels on CUDA tensors, the blockwise
    tier on CPU tensors; differentiable on both.

    On CUDA, a call that needs a gradient launches the forward with lse
    and, in the backward, the FA2 dQ and dK/dV kernels; a call under
    ``no_grad`` (or on inputs that need none) launches the inference
    forward only.  The kernels use their own tiles: ``block_k`` only sets
    the plain path's KV chunk.  ``window`` (with ``causal=True``) is
    sliding-window attention: each query attends its last ``window``
    positions.  ``segment_ids [B, L]`` (packed sequences) masks attention
    to within-segment pairs and is not differentiated.
    """
    _check_window(window, causal)
    s = _scale_for(q, scale)
    if q.is_cuda:
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            return _FlashAttention.apply(q, k, v, causal, s, window,
                                         segment_ids)
        return flash_fwd_cuda(q, k, v, causal, s, window, segment_ids)[0]
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return blockwise_attention(
        q, k, v, causal=causal, scale=s,
        block_k=block_k if block_k is not None else _PLAIN_BLOCK_K,
        window=window, segment_ids=segment_ids)

"""Attention in PyTorch: naive, blockwise (online softmax), and flash.

Counterpart of ``distkeras_tpu/ops/attention.py``; the tiers keep its
semantics so the tests hold them against each other and against the JAX
package:

- :func:`naive_attention` — materialized logits; the numerics oracle.
- :func:`blockwise_attention` — online softmax over KV chunks; the plain
  version of the flash kernel, and what :func:`flash_attention` runs on
  CPU tensors.
- :func:`flash_attention` — on CUDA tensors the hand-written Hopper
  kernel ``csrc/flash_fwd.cu`` (forward only, no ``segment_ids``); on CPU
  tensors the blockwise tier.

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
LAUNCHES = {"flash_fwd": 0}


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


def blockwise_attention(q, k, v, causal: bool = False,
                        scale: float | None = None, block_k: int = 512,
                        q_offset: int = 0, kv_offset: int = 0,
                        window: int | None = None, segment_ids=None):
    """Online-softmax attention over KV chunks of ``block_k`` (clamped to
    the largest divisor of Lkv not above it), computed in f32; the plain
    version of the flash kernel.  ``segment_ids [B, L]`` needs
    lq == lkv."""
    _check_window(window, causal)
    b, lq, h, d = q.shape
    lk = k.shape[1]
    block_k = min(block_k, lk)
    while lk % block_k:
        block_k -= 1
    scale = _scale_for(q, scale)
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
    return online_finish(m, l, o).to(q.dtype)


# ------------------------------------------------------------ CUDA kernel

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def _flash_lib():
    lib = _build.load("flash_fwd")
    fn = lib.dkt_flash_fwd
    if fn.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([ptr] * 4 + [i32] * 6 + [i64] * 12
                       + [ctypes.c_float, i32, i32, ptr])
        fn.restype = ctypes.c_int
        lib.dkt_error_string.argtypes = [i32]
        lib.dkt_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_inputs(q, k, v) -> None:
    """What the Hopper kernel takes; anything else raises (the CUDA path
    never falls back to the plain version)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
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
    if lq < 1 or k.shape[1] < 1 or b * h > 65535:
        raise ValueError(
            f"flash kernel: need Lq, Lkv >= 1 and B*H <= 65535, got "
            f"{tuple(q.shape)}, Lkv={k.shape[1]}")


def flash_fwd_cuda(q, k, v, causal: bool, scale: float,
                   window: int | None = None):
    """Launch ``csrc/flash_fwd.cu`` on the current stream; returns O in
    q's dtype, [B, Lq, H, D]."""
    _check_kernel_inputs(q, k, v)
    lib = _flash_lib()
    b, lq, h, d = q.shape
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dkt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], b, h, lq, k.shape[1], d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], float(scale), int(causal),
            int(window or 0), stream)
    if err:
        raise RuntimeError("flash_fwd kernel launch failed: "
                           + lib.dkt_error_string(err).decode())
    LAUNCHES["flash_fwd"] += 1
    return out


def flash_attention(q, k, v, causal: bool = False, scale: float | None = None,
                    block_k: int | None = None, window: int | None = None,
                    segment_ids=None):
    """Fused attention: the Hopper kernel on CUDA tensors, the blockwise
    tier on CPU tensors.

    The CUDA path is inference-only (its backward, and its
    ``segment_ids`` and lse variants, come with the training slice) and
    uses its own tiles: ``block_k`` only sets the plain path's KV chunk.  ``window`` (with ``causal=True``) is sliding-window
    attention: each query attends its last ``window`` positions.
    """
    _check_window(window, causal)
    s = _scale_for(q, scale)
    if q.is_cuda:
        if segment_ids is not None:
            raise NotImplementedError(
                "segment_ids on the CUDA flash path come with the training "
                "slice (ROADMAP queue B)")
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            raise NotImplementedError(
                "the CUDA flash kernel is forward-only; its backward "
                "(ROADMAP B2/B3) comes with the training slice — run "
                "under torch.no_grad()")
        return flash_fwd_cuda(q, k, v, causal, s, window)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return blockwise_attention(
        q, k, v, causal=causal, scale=s,
        block_k=block_k if block_k is not None else _PLAIN_BLOCK_K,
        window=window, segment_ids=segment_ids)

"""Decoder-only transformer LM in PyTorch: the dense inference trunk.

Counterpart of ``distkeras_tpu/models/transformer.py``: plain functions
over a params dict in the same L-stacked layout (``init_params``), so the
JAX package's weights carry across unchanged (utils.serialization).
Dtypes follow JAX's promotion: with f32 weights under a ``bfloat16``
config only the embeddings round to bf16 and the trunk runs in f32, as
in the reference.

Not in this slice: MoE FFNs (ROADMAP A9), training dropout, remat, the
pipelined trunk and the losses (ROADMAP A2-A4).  Configs that need them
raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F

from distkeras_tpu_torch.ops.attention import flash_attention
from distkeras_tpu_torch.utils.device import check_on_device, resolve_device


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Same fields, defaults and validation as the JAX package's config
    (so a ``save_lm`` artifact's config loads as is)."""
    vocab_size: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    max_len: int = 128
    num_experts: int = 0
    moe_top_k: int = 1
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    dtype: str = "float32"
    rope: bool = False
    rope_theta: float = 10000.0
    dropout: float = 0.0
    n_kv_heads: int | None = None
    remat: bool = False
    remat_policy: str | None = None
    ce_chunks: int = 0
    attention_window: int | None = None
    z_loss_coef: float = 0.0

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        kv = self.n_kv_heads if self.n_kv_heads is not None else self.n_heads
        if not 1 <= kv <= self.n_heads or self.n_heads % kv:
            raise ValueError(
                f"n_kv_heads={kv} must divide n_heads={self.n_heads}")
        return kv

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


_REMAT_POLICIES = (None, "dots", "dots_no_batch")


def _validate(cfg: TransformerConfig) -> None:
    """The JAX ``init_params`` checks, plus the configs this slice does
    not run."""
    if not 0.0 <= cfg.dropout < 1.0:
        raise ValueError(f"dropout must be in [0, 1), got {cfg.dropout}")
    if cfg.ce_chunks < 0:
        raise ValueError(f"ce_chunks must be >= 0, got {cfg.ce_chunks}")
    if cfg.z_loss_coef < 0:
        raise ValueError(
            f"z_loss_coef must be >= 0, got {cfg.z_loss_coef} (a negative "
            "coefficient would silently disable the regularizer)")
    if cfg.attention_window is not None and cfg.attention_window < 1:
        raise ValueError(
            f"attention_window must be >= 1, got {cfg.attention_window}")
    if cfg.num_experts and not 1 <= cfg.moe_top_k <= cfg.num_experts:
        raise ValueError(
            f"moe_top_k={cfg.moe_top_k} must be in [1, num_experts="
            f"{cfg.num_experts}]")
    if cfg.remat_policy not in _REMAT_POLICIES:
        raise ValueError(
            f"unknown remat_policy {cfg.remat_policy!r}; "
            f"known: {sorted(p for p in _REMAT_POLICIES if p)} or None")
    if cfg.remat_policy is not None and not cfg.remat:
        raise ValueError(
            "remat_policy is set but remat=False — the policy only "
            "selects what a rematerialized backward may save; enable "
            "remat=True (or drop the policy)")
    if cfg.rope and cfg.head_dim % 2:
        raise ValueError(
            f"rope needs an even head_dim, got {cfg.head_dim} "
            f"(d_model={cfg.d_model}, n_heads={cfg.n_heads})")
    _check_supported(cfg)


def _check_supported(cfg: TransformerConfig) -> None:
    if cfg.num_experts:
        raise NotImplementedError(
            "MoE configs (num_experts > 0) are not ported yet (ROADMAP A9)")
    if cfg.remat:
        raise NotImplementedError(
            "remat is a training feature; it comes with the training "
            "slice (ROADMAP A2/A4)")


def _layer(tree, i: int):
    """Layer ``i`` of the L-stacked per-layer params."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _dot(x, w, n: int = 1):
    """Contract the last ``n`` axes of ``x`` with the first ``n`` of
    ``w`` (the reference's einsums), both operands promoted as JAX
    promotes them (bf16 x f32 -> f32)."""
    common = torch.promote_types(x.dtype, w.dtype)
    inner = math.prod(w.shape[:n])
    out = torch.matmul(x.to(common).reshape(-1, inner),
                       w.to(common).reshape(inner, -1))
    return out.reshape(*x.shape[:x.dim() - n], *w.shape[n:])


def init_params(rng, cfg: TransformerConfig, device=None):
    """Parameter dict in the JAX layout (per-layer params stacked on a
    leading [n_layers] axis), f32, with the reference's shapes and
    scales.  ``rng`` is a CPU ``torch.Generator`` or an int seed; JAX's
    PRNG stream cannot be matched, so parity runs carry weights across
    with ``params_from_numpy`` instead."""
    device = resolve_device(device)
    _validate(cfg)
    gen = rng if isinstance(rng, torch.Generator) else \
        torch.Generator().manual_seed(int(rng))
    d, f, h, hd = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.head_dim
    kv, L = cfg.kv_heads, cfg.n_layers

    def dense(shape, fan_in):
        return torch.randn(shape, generator=gen) / math.sqrt(fan_in)

    params = {
        "tok_emb": dense((cfg.vocab_size, d), d),
        "ln_f_scale": torch.ones(d),
        "layers": {
            "ln1_scale": torch.ones(L, d),
            "ln2_scale": torch.ones(L, d),
            "attn": {
                "wq": dense((L, d, h, hd), d),
                "wk": dense((L, d, kv, hd), d),
                "wv": dense((L, d, kv, hd), d),
                "wo": dense((L, h, hd, d), d),
            },
            "ffn": {
                "w1": dense((L, d, f), d),
                "w2": dense((L, f, d), f),
            },
        },
    }
    if not cfg.rope:
        params["pos_emb"] = dense((cfg.max_len, d), 1.0) * 0.02

    def place(t):
        return {k: place(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.to(device)

    return place(params)


def _resolve_attention_fn(cfg: TransformerConfig, attention_fn):
    """The reference's window guard: a custom fn's ``handles_window``
    must equal ``cfg.attention_window`` (a one-sided band would diverge
    the forward from the KV-cached decode, which follows cfg)."""
    if attention_fn is None:
        return lambda q, k, v: flash_attention(q, k, v, True,
                                               window=cfg.attention_window)
    fn_window = getattr(attention_fn, "handles_window", None)
    if fn_window != cfg.attention_window:
        raise ValueError(
            f"attention window mismatch: cfg.attention_window="
            f"{cfg.attention_window} but the supplied attention_fn "
            f"implements window={fn_window} (fn.handles_window)")
    return attention_fn


def _check_len(s: int, cfg: TransformerConfig) -> None:
    if not cfg.rope and s > cfg.max_len:
        raise ValueError(
            f"sequence length {s} exceeds max_len={cfg.max_len}")


def _rms_norm(x, scale, eps=1e-6):
    """Square in f32, cast back to ``x.dtype``, then multiply by the
    scale with JAX promotion (f32 scale -> f32 result)."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope_angles(positions, head_dim: int, theta: float):
    """Rotation angles ``[..., head_dim/2]`` for integer positions."""
    half = head_dim // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=positions.device) / half)
    return positions.float()[..., None] * inv


def rope_rotate(x, ang):
    """Half-split rotary rotation of the last dim of ``x`` by ``ang``;
    f32 math, input dtype out."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    c, s = torch.cos(ang), torch.sin(ang)
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)


def _attention_block(lp, x, attention_fn, rope_ang=None, kv_groups=1,
                     return_kv=False):
    q = _dot(x, lp["wq"])
    k = _dot(x, lp["wk"])
    v = _dot(x, lp["wv"])
    if rope_ang is not None:
        q, k = rope_rotate(q, rope_ang), rope_rotate(k, rope_ang)
    kv = (k, v)  # post-rope, pre-GQA-expansion: the decode cache layout
    if kv_groups > 1:  # GQA: expand shared K/V heads for the kernel
        k = k.repeat_interleave(kv_groups, dim=2)
        v = v.repeat_interleave(kv_groups, dim=2)
    out = _dot(attention_fn(q, k, v), lp["wo"], n=2)
    return (out, kv) if return_kv else out


def _ffn(lp, h):
    """Dense FFN; ``jax.nn.gelu`` defaults to the tanh approximation."""
    return _dot(F.gelu(_dot(h, lp["w1"]), approximate="tanh"), lp["w2"])


def block_apply(layer_params, x, cfg: TransformerConfig,
                attention_fn: Callable, rope_ang=None, return_kv=False):
    """One pre-norm dense block.  Returns (x, aux_loss), or
    (x, aux_loss, (k, v)) with ``return_kv`` (post-rope, kv-heads-only —
    the decode-cache layout that ``generate.prefill`` consumes)."""
    h = _rms_norm(x, layer_params["ln1_scale"])
    a = _attention_block(layer_params["attn"], h, attention_fn, rope_ang,
                         kv_groups=cfg.n_heads // cfg.kv_heads,
                         return_kv=return_kv)
    kv = None
    if return_kv:
        a, kv = a
    x = x + a
    out = x + _ffn(layer_params["ffn"], _rms_norm(x, layer_params["ln2_scale"]))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return (out, aux, kv) if return_kv else (out, aux)


def _embed(params, tokens, cfg: TransformerConfig):
    """Token (+ learned position) embedding and the rope angles."""
    dtype = cfg.torch_dtype
    s = tokens.shape[1]
    x = params["tok_emb"][tokens].to(dtype)
    rope_ang = None
    if cfg.rope:
        pos = torch.arange(s, device=tokens.device)
        rope_ang = rope_angles(pos, cfg.head_dim,
                               cfg.rope_theta)[None, :, None, :]
    else:
        x = x + params["pos_emb"][:s][None].to(dtype)
    return x, rope_ang


def apply_hidden(params, tokens, cfg: TransformerConfig,
                 attention_fn: Callable | None = None, dropout_rng=None):
    """Trunk forward: tokens [B, S] -> final-norm hidden [B, S, D];
    returns (hidden, aux).  Packed sequences (``segment_ids``) come with
    the training slice."""
    _check_supported(cfg)
    if dropout_rng is not None:
        raise NotImplementedError(
            "training dropout comes with the training slice (ROADMAP A4); "
            "inference is deterministic")
    attention_fn = _resolve_attention_fn(cfg, attention_fn)
    _check_len(tokens.shape[1], cfg)
    x, rope_ang = _embed(params, tokens, cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, aux = block_apply(_layer(params["layers"], i), x, cfg,
                             attention_fn, rope_ang)
        aux_total = aux_total + aux
    return _rms_norm(x, params["ln_f_scale"]), aux_total


def _unembed(hidden, params, cfg: TransformerConfig):
    """Tied unembedding head: hidden [B, S, D] -> f32 logits [B, S, V]."""
    table = params["tok_emb"].to(cfg.torch_dtype)
    return _dot(hidden, table.t()).float()


def apply(params, tokens, cfg: TransformerConfig,
          attention_fn: Callable | None = None, dropout_rng=None,
          device=None):
    """Forward pass: tokens [B, S] int -> (f32 logits [B, S, V], aux).

    ``attention_fn(q, k, v) -> out`` defaults to causal flash attention
    (the Hopper kernel on the card).  Runs on ``device`` — the card
    unless ``device="cpu"`` — where the params must already live.
    """
    device = resolve_device(device)
    check_on_device(params, device)
    tokens = torch.as_tensor(tokens, device=device).long()
    with torch.no_grad():
        x, aux_total = apply_hidden(params, tokens, cfg, attention_fn,
                                    dropout_rng)
        return _unembed(x, params, cfg), aux_total

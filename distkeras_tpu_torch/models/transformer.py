"""Decoder-only transformer LM in PyTorch: the dense trunk, its losses
and the train step.

Counterpart of ``distkeras_tpu/models/transformer.py``: plain functions
over a params dict in the same L-stacked layout (``init_params``), so the
JAX package's weights carry across unchanged (utils.serialization).
Dtypes follow JAX's promotion: with f32 weights under a ``bfloat16``
config only the embeddings round to bf16 and the trunk runs in f32, as
in the reference.

Training: ``lm_loss`` / ``lm_nll`` (full or chunked vocab head, z-loss,
packed ``segment_ids``) are differentiated by autograd, through the
flash kernels' backward on the card; ``make_train_step`` applies an
``trainers.optim.Optimizer``.  Dropout draws its masks from an explicit
``torch.Generator`` (JAX's key stream cannot be matched).  ``remat``
recomputes each block in the backward (``torch.utils.checkpoint``), with
the reference's two selective policies.

Not ported yet: MoE FFNs (ROADMAP A9) and the pipelined trunk.  MoE
configs raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

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


_MM, _ADDMM, _BMM = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                    torch.ops.aten.bmm.default)
# remat_policy -> the ops whose outputs a rematerialized block saves (the
# reference's jax.checkpoint_policies): "dots" keeps every matmul output
# (checkpoint_dots), "dots_no_batch" only the products without batch dims
# (dots_with_no_batch_dims_saveable).  Everything else, the flash
# kernels' autograd.Function among it, is recomputed in the backward.
_REMAT_POLICIES = {
    None: None,
    "dots": [_MM, _ADDMM, _BMM],
    "dots_no_batch": [_MM, _ADDMM],
}


def _validate_remat_policy(cfg: TransformerConfig,
                           require_remat: bool = True) -> None:
    """An unknown name always raises; ``require_remat`` (init_params)
    also rejects a policy with ``remat=False``.  At apply time a leftover
    policy on a ``remat=False`` config (an inference copy of a training
    config) is inert, as in the reference."""
    if cfg.remat_policy is None:
        return
    if cfg.remat_policy not in _REMAT_POLICIES:
        raise ValueError(
            f"unknown remat_policy {cfg.remat_policy!r}; "
            f"known: {sorted(p for p in _REMAT_POLICIES if p)} or None")
    if require_remat and not cfg.remat:
        raise ValueError(
            "remat_policy is set but remat=False — the policy only "
            "selects what a rematerialized backward may save; enable "
            "remat=True (or drop the policy)")


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
    _validate_remat_policy(cfg)
    if cfg.rope and cfg.head_dim % 2:
        raise ValueError(
            f"rope needs an even head_dim, got {cfg.head_dim} "
            f"(d_model={cfg.d_model}, n_heads={cfg.n_heads})")
    _check_supported(cfg)


def _check_supported(cfg: TransformerConfig) -> None:
    if cfg.num_experts:
        raise NotImplementedError(
            "MoE configs (num_experts > 0) are not ported yet (ROADMAP A9)")


def _layers(tree, n: int):
    """The ``n`` per-layer param dicts of the L-stacked params, by one
    ``unbind`` per leaf: its backward stacks the per-layer gradients in
    one op, where indexing each layer would scatter each into a
    full-size zero tensor."""
    if isinstance(tree, dict):
        per_key = {k: _layers(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return tree.unbind(0)


def named_leaves(tree, prefix=""):
    """``[(path, tensor)]`` of a nested params dict, paths joined by
    ``/`` (the reference's key paths)."""
    out = []
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            out += named_leaves(value, path + "/")
        else:
            out.append((path, value))
    return out


def _leaves(tree):
    return [leaf for _, leaf in named_leaves(tree)]


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


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


def _resolve_attention_fn(cfg: TransformerConfig, attention_fn,
                          segment_ids=None):
    """The reference's guards: no fn builds the default windowed flash
    call (closing over ``segment_ids``); a custom fn with segments must
    take them itself (``fn.handles_segments`` and a ``segment_ids``
    kwarg), and its ``handles_window`` must equal ``cfg.attention_window``
    (a one-sided band would diverge the forward from the KV-cached
    decode, which follows cfg)."""
    if attention_fn is None:
        return lambda q, k, v: flash_attention(
            q, k, v, True, window=cfg.attention_window,
            segment_ids=segment_ids)
    if segment_ids is not None:
        if not getattr(attention_fn, "handles_segments", False):
            raise ValueError(
                "segment_ids with this custom attention_fn is not "
                "supported: the packed-document mask must be applied "
                "inside the attention implementation (set "
                "fn.handles_segments = True and accept a segment_ids "
                "kwarg) — or drop the custom fn / unpack the batch")
        base_fn = attention_fn
        attention_fn = lambda q, k, v: base_fn(q, k, v,
                                               segment_ids=segment_ids)
        attention_fn.handles_window = getattr(base_fn, "handles_window",
                                              None)
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


def _check_generator(gen) -> None:
    if gen is not None and not isinstance(gen, torch.Generator):
        raise TypeError(
            f"dropout_rng must be a torch.Generator (on the activations' "
            f"device), got {type(gen).__name__}")


def _dropout(x, rate: float, gen):
    """Inverted dropout with masks from ``gen`` (a ``torch.Generator``
    on x's device): keep with probability ``1 - rate``, scale by its
    inverse — the reference's formula; its bits come from JAX's key and
    cannot be matched."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, 0).to(x.dtype)


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
                attention_fn: Callable, rope_ang=None, drop_rng=None,
                return_kv=False):
    """One pre-norm dense block.  Returns (x, aux_loss), or
    (x, aux_loss, (k, v)) with ``return_kv`` (post-rope, kv-heads-only —
    the decode-cache layout that ``generate.prefill`` consumes).
    ``drop_rng`` (a ``torch.Generator``) enables residual dropout on the
    attention and FFN outputs."""
    h = _rms_norm(x, layer_params["ln1_scale"])
    a = _attention_block(layer_params["attn"], h, attention_fn, rope_ang,
                         kv_groups=cfg.n_heads // cfg.kv_heads,
                         return_kv=return_kv)
    kv = None
    if return_kv:
        a, kv = a
    if drop_rng is not None:
        a = _dropout(a, cfg.dropout, drop_rng)
    x = x + a
    y = _ffn(layer_params["ffn"], _rms_norm(x, layer_params["ln2_scale"]))
    if drop_rng is not None:
        y = _dropout(y, cfg.dropout, drop_rng)
    out = x + y
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return (out, aux, kv) if return_kv else (out, aux)


def _remat_block(cfg: TransformerConfig):
    """``block_apply`` wrapped per ``cfg.remat`` / ``cfg.remat_policy``:
    under autograd each block runs inside a non-reentrant
    ``torch.utils.checkpoint``, which keeps only the block's inputs (and,
    with a policy, the outputs of the policy's matmuls) and recomputes
    the rest in the backward.  Without grad it is ``block_apply``.

    Dropout: the checkpoint restores the default generators only, not
    the explicit one the masks come from.  So the forward draws from
    (and advances) the caller's generator, and the recompute redraws the
    same masks from a copy of the state it had before the block, which
    leaves the caller's stream where the forward left it.
    """
    _validate_remat_policy(cfg, require_remat=False)
    if not cfg.remat:
        return block_apply
    ops = _REMAT_POLICIES[cfg.remat_policy]
    kw = {} if ops is None else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, ops)}

    def block(lp, x, cfg, attention_fn, rope_ang=None, drop_rng=None):
        if not torch.is_grad_enabled():
            return block_apply(lp, x, cfg, attention_fn, rope_ang, drop_rng)
        state = None if drop_rng is None else drop_rng.get_state()
        calls = []

        def run(lp, x, rope_ang):
            gen = drop_rng
            if calls and gen is not None:  # the recompute
                gen = torch.Generator(drop_rng.device)
                gen.set_state(state)
            calls.append(True)
            return block_apply(lp, x, cfg, attention_fn, rope_ang, gen)

        return checkpoint(run, lp, x, rope_ang, use_reentrant=False, **kw)

    return block


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
                 attention_fn: Callable | None = None, dropout_rng=None,
                 segment_ids=None):
    """Trunk forward: tokens [B, S] -> final-norm hidden [B, S, D];
    returns (hidden, aux).

    ``dropout_rng`` (a ``torch.Generator`` on the tokens' device) with
    ``cfg.dropout > 0`` enables training dropout: the embedding, then
    each block's attention and FFN outputs, in that order, draw their
    masks from it.  ``segment_ids [B, S]`` (packed sequences,
    data/packing.py) masks attention to within-segment pairs.  With
    ``cfg.remat`` each block is recomputed in the backward
    (:func:`_remat_block`).
    """
    _check_supported(cfg)
    _check_generator(dropout_rng)
    attention_fn = _resolve_attention_fn(cfg, attention_fn, segment_ids)
    _check_len(tokens.shape[1], cfg)
    x, rope_ang = _embed(params, tokens, cfg)
    drop = dropout_rng if cfg.dropout > 0 else None
    if drop is not None:
        x = _dropout(x, cfg.dropout, drop)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    block = _remat_block(cfg)
    for lp in _layers(params["layers"], cfg.n_layers):
        x, aux = block(lp, x, cfg, attention_fn, rope_ang, drop)
        aux_total = aux_total + aux
    return _rms_norm(x, params["ln_f_scale"]), aux_total


def _unembed(hidden, params, cfg: TransformerConfig):
    """Tied unembedding head: hidden [B, S, D] -> f32 logits [B, S, V]."""
    table = params["tok_emb"].to(cfg.torch_dtype)
    return _dot(hidden, table.t()).float()


def apply(params, tokens, cfg: TransformerConfig,
          attention_fn: Callable | None = None, dropout_rng=None,
          device=None):
    """Forward pass: tokens [B, S] int -> (f32 logits [B, S, V], aux),
    without gradients (training goes through :func:`lm_loss`).

    ``attention_fn(q, k, v) -> out`` defaults to causal flash attention
    (the Hopper kernel on the card).  Runs on ``device`` — the card
    unless ``device="cpu"`` — where the params must already live.
    """
    device = resolve_device(device)
    check_on_device(params, device)
    tokens = _as_ids(tokens, device, torch.long)
    with torch.no_grad():
        x, aux_total = apply_hidden(params, tokens, cfg, attention_fn,
                                    dropout_rng)
        return _unembed(x, params, cfg), aux_total


def _as_ids(x, device, dtype):
    return torch.as_tensor(x, device=device).to(dtype)


# ------------------------------------------------------------------ losses


def chunked_softmax_xent(hidden, emb, targets, n_chunks: int):
    """Mean softmax cross-entropy without materializing full logits.
    Returns ``(mean_nll, mean_lse_sq)`` (the second is the z-loss
    statistic).

    ``hidden`` [B, S, D], ``emb`` [V, D], ``targets`` [B, S] int — target
    -1 marks an excluded position (packed-sequence boundaries / padding,
    and the internal chunk-pad rows); the mean divides by the valid count
    only.  Each chunk's [N/n_chunks, V] logits slice is reduced to its
    per-row ``logsumexp - target_logit`` and discarded; a
    ``torch.utils.checkpoint`` per chunk re-derives it in the backward,
    as ``jax.checkpoint`` on the reference's scan body does.
    """
    n_tok = targets.numel()
    d = hidden.shape[-1]
    h = hidden.reshape(n_tok, d)
    t = targets.reshape(n_tok).long()
    pad = (-n_tok) % n_chunks
    if pad:
        h = torch.cat([h, h.new_zeros((pad, d))])
        t = torch.cat([t, t.new_full((pad,), -1)])
    h = h.reshape(n_chunks, -1, d)
    t = t.reshape(n_chunks, -1)
    emb_c = emb.to(hidden.dtype)

    def body(hc, tc):
        logits = _dot(hc, emb_c.t()).float()
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, tc.clamp(min=0)[:, None])[:, 0]
        valid = tc >= 0
        return (torch.where(valid, lse - tgt, 0.0).sum(),
                torch.where(valid, lse.square(), 0.0).sum())

    total = z_total = torch.zeros((), dtype=torch.float32,
                                  device=hidden.device)
    for c in range(n_chunks):
        if torch.is_grad_enabled():
            nll, z = checkpoint(body, h[c], t[c], use_reentrant=False)
        else:
            nll, z = body(h[c], t[c])
        total, z_total = total + nll, z_total + z
    denom = (t >= 0).sum().clamp(min=1).float()
    return total / denom, z_total / denom


def _forward_nll(params, tokens, cfg: TransformerConfig,
                 attention_fn: Callable | None, apply_fn: Callable | None,
                 dropout_rng=None, hidden_fn: Callable | None = None,
                 segment_ids=None):
    """(mean next-token NLL, aux) — shared by train loss and eval.

    Three forward routes, as in the reference:

    - ``apply_fn(params, inputs) -> (logits, aux)``: caller-materialized
      logits; full log_softmax head.
    - ``hidden_fn(params, inputs) -> (hidden, aux)``: caller-supplied
      final-norm hidden states; the head honors ``cfg.ce_chunks``.
    - neither: the default :func:`apply_hidden` trunk; the head honors
      ``cfg.ce_chunks``.

    ``segment_ids [B, S+1]`` (aligned with ``tokens``): attention is
    segment-masked on the default trunk, and targets that cross a
    document boundary or sit in padding (segment 0) are excluded from
    the mean.  A custom fn with ``handles_segments = True`` is called as
    ``fn(params, inputs, seg)``.
    """
    if apply_fn is not None and hidden_fn is not None:
        raise ValueError("pass apply_fn or hidden_fn, not both")
    device = params["tok_emb"].device
    tokens = _as_ids(tokens, device, torch.long)
    targets = tokens[:, 1:]
    valid = seg_in = None
    if segment_ids is not None:
        segment_ids = _as_ids(segment_ids, device, torch.int32)
        if segment_ids.shape != tokens.shape:
            raise ValueError(
                f"segment_ids must align with tokens "
                f"{tuple(tokens.shape)}, got {tuple(segment_ids.shape)}")
        seg_in = segment_ids[:, :-1]
        # A target is trainable iff it continues its input's document.
        valid = (segment_ids[:, 1:] == seg_in) & (seg_in != 0)
        targets = torch.where(valid, targets, -1)
    zc = cfg.z_loss_coef

    def masked_mean(x):
        if valid is None:
            return x.mean()
        return torch.where(valid, x, 0.0).sum() / valid.sum().clamp(min=1)

    def full_head(logits, aux):
        # z-loss rides in aux (training-only; lm_nll drops aux).
        logp = F.log_softmax(logits, dim=-1)
        per_tok = -logp.gather(-1, targets.clamp(min=0)[..., None])[..., 0]
        nll = masked_mean(per_tok)
        if zc > 0:
            aux = aux + zc * masked_mean(torch.logsumexp(logits,
                                                         dim=-1).square())
        return nll, aux

    def call_custom(fn, *args):
        if seg_in is not None and getattr(fn, "handles_segments", False):
            return fn(*args, seg_in)
        return fn(*args)

    if apply_fn is not None:
        return full_head(*call_custom(apply_fn, params, tokens[:, :-1]))
    if hidden_fn is None:
        hidden_fn = lambda p, t: apply_hidden(p, t, cfg, attention_fn,
                                              dropout_rng, seg_in)
    hidden, aux = call_custom(hidden_fn, params, tokens[:, :-1])
    if cfg.ce_chunks > 1:
        nll, z_mean = chunked_softmax_xent(hidden, params["tok_emb"],
                                           targets, cfg.ce_chunks)
        if zc > 0:
            aux = aux + zc * z_mean
        return nll, aux
    return full_head(_unembed(hidden, params, cfg), aux)


def lm_loss(params, tokens, cfg: TransformerConfig,
            attention_fn: Callable | None = None,
            apply_fn: Callable | None = None, dropout_rng=None,
            hidden_fn: Callable | None = None, segment_ids=None):
    """Next-token cross-entropy (+ z-loss), mean over the trainable
    targets (all B*(S-1) positions, or the within-document subset when
    ``segment_ids`` marks packed sequences — see :func:`_forward_nll`).
    ``tokens [B, S+1]`` on the params' device (or host ints)."""
    if dropout_rng is not None and (apply_fn is not None
                                    or hidden_fn is not None):
        raise ValueError(
            "dropout_rng only threads through the default trunk; a "
            "custom apply_fn/hidden_fn must draw its own masks")
    nll, aux = _forward_nll(params, tokens, cfg, attention_fn, apply_fn,
                            dropout_rng, hidden_fn, segment_ids)
    return nll + aux


def lm_nll(params, tokens, cfg: TransformerConfig,
           attention_fn: Callable | None = None,
           apply_fn: Callable | None = None,
           hidden_fn: Callable | None = None, segment_ids=None):
    """Mean next-token NLL without the z-loss regularizer — the
    evaluation quantity (``exp`` of it is perplexity)."""
    return _forward_nll(params, tokens, cfg, attention_fn, apply_fn,
                        hidden_fn=hidden_fn, segment_ids=segment_ids)[0]


# -------------------------------------------------------------- train step


def global_norm(tensors):
    """``sqrt(sum of squares)`` over all entries of ``tensors`` (f32)."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t.float()) for t in tensors]))


def make_train_step(cfg: TransformerConfig, optimizer,
                    attention_fn: Callable | None = None,
                    apply_fn: Callable | None = None,
                    grad_accum: int = 1,
                    hidden_fn: Callable | None = None,
                    loss_fn: Callable | None = None,
                    probe: bool = False):
    """``step((params, opt_state), tokens, dropout_rng=None,
    segment_ids=None) -> ((params, opt_state), loss)``.

    ``optimizer`` is a ``trainers.optim.Optimizer`` and ``opt_state``
    its ``init(params)``, which makes the params' leaves require grad.
    The step updates the params in place (the same tensors come back):
    the port keeps one copy of the weights where the reference's pure
    step returns new arrays.  With ``grad_accum > 1``, ``tokens`` (and
    ``segment_ids``) are ``[grad_accum, B, S+1]``: the gradients of the
    microbatches are summed, then divided by ``grad_accum``, and one
    update applies their mean; the loss is the mean of the microbatch
    losses.  ``loss_fn`` (default :func:`lm_loss`) shares lm_loss's
    signature.  ``probe=True`` returns ``(carry, (loss, {"grad_norm":
    ...}))`` with the global norm of the (averaged) gradients.
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    fn = lm_loss if loss_fn is None else loss_fn

    def step(carry, tokens, dropout_rng=None, segment_ids=None):
        params, opt_state = carry
        if cfg.dropout > 0 and dropout_rng is None:
            raise ValueError(
                f"cfg.dropout={cfg.dropout} but the train step got no "
                "dropout_rng: pass step(carry, tokens, gen) with a "
                "torch.Generator, or training silently runs "
                "unregularized (LMTrainer threads one automatically)")
        rng = dropout_rng if cfg.dropout > 0 else None
        device = params["tok_emb"].device
        tokens = _as_ids(tokens, device, torch.long)
        if segment_ids is not None:
            segment_ids = _as_ids(segment_ids, device, torch.int32)
        leaves = _leaves(params)
        for p in leaves:
            p.grad = None
        if grad_accum == 1:
            loss = fn(params, tokens, cfg, attention_fn, apply_fn, rng,
                      hidden_fn, segment_ids)
            loss.backward()
            loss = loss.detach()
        else:
            loss = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(grad_accum):
                li = fn(params, tokens[i], cfg, attention_fn, apply_fn, rng,
                        hidden_fn,
                        None if segment_ids is None else segment_ids[i])
                li.backward()
                loss = loss + li.detach()
            for p in leaves:
                if p.grad is not None:
                    p.grad.div_(grad_accum)
            loss = loss / grad_accum
        norm = (global_norm([p.grad for p in leaves if p.grad is not None])
                if probe else None)
        optimizer.update(params, opt_state)
        if probe:
            return (params, opt_state), (loss, {"grad_norm": norm})
        return (params, opt_state), loss

    return step

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

MoE (``num_experts > 0``): training runs the reference's top-k capacity
dispatch (:func:`_moe_block`, computed by index instead of one-hot
einsums, with the load-balancing aux loss); ``moe_dense_routing=True``
and the KV-cached decode run the capacity-free :func:`_moe_dense_block`.

Sharded params (``parallel/layout.py``: a tree placed by a plan such as
:func:`tp_rules`) run through the same functions: :func:`apply_hidden`,
:func:`apply` and the losses take the tree's compute view, each block
runs its split attention heads and FFN columns between Megatron's f and
g over the model axis (the flash kernel on the local heads), and the
tied embedding is gathered whole for the lookup and the unembedding.

The seq, pipeline and expert axes: a ring ``attention_fn``
(``parallel.ring.make_ring_attention``) runs the trunk on this rank's
block of the sequence, its positions offset by ``fn.seq_shard``;
:func:`apply_pipelined` runs the stacked layers as GPipe stages
(``parallel.pipeline.make_pipeline``), optionally with the ring inside
each stage; and :func:`_moe_block` computes the reference's capacity,
slots and aux over the whole token group (the global batch, or one
microbatch under a pipeline), each rank running its own experts.
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

from distkeras_tpu_torch.models.quant import QTensor
from distkeras_tpu_torch.ops.attention import flash_attention
from distkeras_tpu_torch.parallel import collectives as C
from distkeras_tpu_torch.parallel.layout import Sharded, tp_of, views
from distkeras_tpu_torch.parallel.rules import P
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
    """The JAX ``init_params`` checks."""
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


def _layers(tree, n: int):
    """The ``n`` per-layer param dicts of the L-stacked params, by one
    ``unbind`` per leaf: its backward stacks the per-layer gradients in
    one op, where indexing each layer would scatter each into a
    full-size zero tensor."""
    leaf = tree
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    held = (leaf.q if isinstance(leaf, QTensor) else leaf).shape[0]
    if held != n:
        raise ValueError(
            f"the params hold {held} of n_layers={n} stacked layers (a "
            "pipeline stage's slice): a tree placed over a pipeline axis "
            "runs through apply_pipelined")
    return _layers_of(tree, n)


def _layers_of(tree, n: int):
    if isinstance(tree, dict):
        per_key = {k: _layers_of(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    if isinstance(tree, QTensor):
        return [QTensor(q, s) for q, s in zip(tree.q.unbind(0),
                                              tree.s.unbind(0))]
    return tree.unbind(0)


def named_leaves(tree, prefix=""):
    """``[(path, tensor)]`` of a nested params dict, paths joined by
    ``/`` (the reference's key paths); a tuple or list (a packed
    ``(adapters, base)`` state, a list of tensors) is keyed by index."""
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree))
    out = []
    for key, value in items:
        path = f"{prefix}{key}"
        if isinstance(value, (dict, tuple, list)):
            out += named_leaves(value, path + "/")
        else:
            out.append((path, value))
    return out


def _leaves(tree):
    return [leaf for _, leaf in named_leaves(tree)]


def _map_leaves(fn, tree):
    if isinstance(tree, Sharded):  # a placed tree keeps its layout
        return Sharded({k: _map_leaves(fn, v) for k, v in tree.items()},
                       tree.layout)
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def _promoted(*xs):
    """``xs`` cast to their common dtype, as JAX promotes einsum
    operands (bf16 x f32 -> f32)."""
    common = xs[0].dtype
    for x in xs[1:]:
        common = torch.promote_types(common, x.dtype)
    return [x.to(common) for x in xs]


def _einsum(eq, *xs):
    return torch.einsum(eq, *_promoted(*xs))


def _dot(x, w, n: int = 1):
    """Contract the last ``n`` axes of ``x`` with the first ``n`` of
    ``w`` (the reference's einsums), both operands promoted as JAX
    promotes them (bf16 x f32 -> f32)."""
    xc, wc = _promoted(x, w)
    inner = math.prod(w.shape[:n])
    out = torch.matmul(xc.reshape(-1, inner), wc.reshape(inner, -1))
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

    layers = {
        "ln1_scale": torch.ones(L, d),
        "ln2_scale": torch.ones(L, d),
        "attn": {
            "wq": dense((L, d, h, hd), d),
            "wk": dense((L, d, kv, hd), d),
            "wv": dense((L, d, kv, hd), d),
            "wo": dense((L, h, hd, d), d),
        },
    }
    if cfg.num_experts:
        e = cfg.num_experts
        layers["moe"] = {
            "wg": dense((L, d, e), d),
            "w1": dense((L, e, d, f), d),
            "w2": dense((L, e, f, d), f),
        }
    else:
        layers["ffn"] = {
            "w1": dense((L, d, f), d),
            "w2": dense((L, f, d), f),
        }
    params = {
        "tok_emb": dense((cfg.vocab_size, d), d),
        "ln_f_scale": torch.ones(d),
        "layers": layers,
    }
    if not cfg.rope:
        params["pos_emb"] = dense((cfg.max_len, d), 1.0) * 0.02

    def place(t):
        return {k: place(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.to(device)

    return place(params)


def tp_rules():
    """The Megatron layout over the ``model`` axis, keyed on the params'
    key paths (the [L] stack axis first for per-layer leaves): attention
    split on heads, the FFN column-parallel in and row-parallel out, the
    embeddings on d_model.  The reference's rules, spec for spec."""
    return [
        (r"attn/w[qkv]$", P(None, None, "model", None)),
        (r"attn/wo$", P(None, "model", None, None)),
        (r"ffn/w1$", P(None, None, "model")),
        (r"ffn/w2$", P(None, "model", None)),
        # MoE: experts over 'expert', their matmuls over 'model'.
        (r"moe/wg$", P()),
        (r"moe/w1$", P(None, "expert", None, "model")),
        (r"moe/w2$", P(None, "expert", "model", None)),
        (r"tok_emb$", P(None, "model")),
        (r"pos_emb$", P(None, "model")),
    ]


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


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _moe_gates(probs, cfg: TransformerConfig):
    """Top-k expert choice shared by every routing path: ``(gates [..., k],
    expert [..., k])``.  k = 1 keeps the raw top-1 probability (Switch);
    k > 1 renormalizes the top-k probabilities over the selected experts.
    Ties go to the lower expert index, as ``jax.lax.top_k`` breaks them
    (a stable descending sort; ``torch.topk`` promises no order)."""
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = order.values[..., :cfg.moe_top_k]
    expert = order.indices[..., :cfg.moe_top_k]
    if cfg.moe_top_k > 1:
        gates = gates / gates.sum(dim=-1, keepdim=True)
    return gates, expert


@dataclasses.dataclass(frozen=True)
class MoEScope:
    """Where an MoE block's tokens and experts live over the mesh.
    ``group``: ``(one-axis mesh, token dim)`` pairs, major first, whose
    ranks' tokens share one capacity count and one aux (the reference's
    global token set: the data axis splits the batch, dim 0, and the
    seq axis the sequence, dim 1); ``ep``: the expert axis's mesh when
    the experts split over it."""

    group: tuple = ()
    ep: object = None


def moe_scope(params, axes=("data", "seq")):
    """The :class:`MoEScope` of a compute view over ``axes`` (None for
    one process, or an unplaced tree)."""
    mesh = getattr(params, "mesh", None)
    if mesh is None:
        return None
    dims = {"data": 0, "seq": 1}
    group = tuple((mesh.sub(a), dims[a]) for a in axes
                  if int(mesh.shape[a]) > 1)
    ep = getattr(params, "ep", None)
    if not group and ep is None:
        return None
    return MoEScope(group, ep)


def _moe_block(lp, x, cfg: TransformerConfig, stats=None, scope=None,
               tp=None):
    """Top-k MoE with capacity dropping (Switch at k = 1, GShard at
    k = 2); returns ``(out, aux_loss)``.  A ``stats`` dict, when given,
    gains this call's ``dropped`` and ``assigned`` counts (device
    tensors) of top-k assignments over the whole token group.

    The reference's function, computed by index: its one-hot dispatch
    ``[k, N, E, C]`` would be 1.3 GB per layer at the d1024 bench row.
    Slots come from the same choice-major cumsum (first choices claim
    capacity before any second choice), so each kept assignment owns
    exactly one slot of ``[E, C]``: tokens gather into the slots, the
    experts run as two batched products, and each token sums its kept
    choices' gated outputs.  Dropped assignments contribute 0.  The
    dispatch is exact; the top-k combine differs from the einsum by
    summation order only.  f32 throughout, output in ``x.dtype``; the
    load-balancing aux loss (Switch eq. 4) is on first choices.

    Over a mesh (``scope``, :class:`MoEScope`) capacity, slots and aux
    are the token group's, as GSPMD keeps the reference's math global:
    each rank gathers the group's expert ids (the tokens in the
    reference's flatten order ``n = b S + s``), rebuilds the global slot
    order, and fills its own tokens' slots of the experts it runs; the
    sum over the group completes every slot exactly (one rank fills
    each).  Its experts' outputs are gathered over the expert axis and
    each rank combines its own tokens.  ``tp``: each expert's ``d_ff``
    split over the model axis (Megatron's f and g around the products).
    """
    b, s, d = x.shape
    n_loc = b * s
    e, k_sel = cfg.num_experts, cfg.moe_top_k
    group = scope.group if scope is not None else ()
    ep = scope.ep if scope is not None else None
    flat = x.reshape(n_loc, d).float()
    probs = torch.softmax(_dot(flat, lp["wg"]), dim=-1)      # [N, E]
    gates, expert = _moe_gates(probs, cfg)                    # [N, k]
    # Choice-major: assignment c * N + t is token t's choice c.
    e_mine = expert.t().reshape(k_sel * n_loc)
    if group:
        ids = expert.t().reshape(k_sel, b, s)
        starts = [0, 0]
        for m, dim in reversed(group):
            starts[dim] = m.rank * ids.shape[dim + 1]
            ids = C.gather_dim(ids, dim + 1, m)
        gb, gs = ids.shape[1:]
        n = gb * gs
        e_cm = ids.reshape(k_sel * n)
        rows = torch.arange(b, device=x.device) + starts[0]
        cols = torch.arange(s, device=x.device) + starts[1]
        mine = (rows[:, None] * gs + cols[None]).reshape(-1)
        pick = (torch.arange(k_sel, device=x.device)[:, None] * n
                + mine[None]).reshape(-1)
    else:
        n, e_cm = n_loc, e_mine
    cap = max(1, int(cfg.capacity_factor * k_sel * n / e))
    density = F.one_hot(e_cm[:n], e).float().mean(dim=0)
    if group:
        psum = probs.sum(dim=0)
        for m, _ in group:
            psum = C.sum_over_group(psum, m)
        p_mean = psum / n
    else:
        p_mean = probs.mean(dim=0)
    aux = (density * p_mean).sum() * e * cfg.aux_loss_coef
    # The running count scans the contiguous axis of [E, kN] (a scan over
    # the outer axis of [kN, E] is a slow kernel on the card).
    counts = F.one_hot(e_cm, e).t().contiguous().cumsum(dim=1)  # [E, kN]
    slot_all = counts.gather(0, e_cm[None])[0] - 1            # 0-based
    if stats is not None:
        stats["dropped"] = stats.get("dropped", 0) + (slot_all >= cap).sum()
        stats["assigned"] = stats.get("assigned", 0) + slot_all.numel()
    slot = slot_all[pick] if group else slot_all
    keep = slot < cap
    # Slot e * C + c of the flat [E * C] layout; dropped -> the dump slot.
    dest = torch.where(keep, e_mine * cap + slot, e * cap)
    # The experts this rank runs: a block of E / expert-axis-size.
    e_run = e // ep.size if ep is not None else e
    lo = ep.rank * e_run * cap if ep is not None else 0
    width = e_run * cap
    dl = dest - lo
    tok = torch.arange(n_loc, device=x.device).repeat(k_sel)
    src = torch.full((width + 1,), n_loc, dtype=torch.long, device=x.device)
    src[torch.where((dl >= 0) & (dl < width), dl, width)] = tok  # slot -> token
    # The experts' ranks dispatch alike: their input's gradient is the
    # sum of each one's experts' (Megatron's f over the expert axis).
    xd = C.copy_to_group(flat, ep) if ep is not None else flat
    padded = torch.cat([xd, xd.new_zeros((1, d))])           # row n: empty
    xe = padded.index_select(0, src[:width])
    for m, _ in group:  # one rank fills each slot: an exact sum
        xe = C.sum_over_group(xe, m)
    xe = xe.reshape(e_run, cap, d)
    w1, w2 = lp["w1"].to(flat.dtype), lp["w2"].to(flat.dtype)
    split = tp is not None and tp.ffn
    if split:
        xe = tp.enter(xe, True)
    ye = torch.bmm(_gelu(torch.bmm(xe, w1)), w2)
    if split:
        ye = tp.leave(ye, True)
    ye = ye.reshape(width, d)
    if ep is not None:
        ye = C.gather_on_use(ye, 0, ep, summed=False)         # [E * C, D]
    ye = torch.cat([ye, ye.new_zeros((1, d))])                # dump slot
    w = (gates.t().reshape(k_sel * n_loc) * keep)[:, None]
    out = (ye.index_select(0, dest) * w).reshape(k_sel, n_loc, d).sum(dim=0)
    return out.to(x.dtype).reshape(b, s, d), aux


def _all_experts(w, ep):
    """An expert-split weight whole (gathered over the expert axis, the
    gradient this rank's block)."""
    return w if ep is None else C.gather_on_use(w, 0, ep, summed=False)


def _moe_dense_block(lp, x, cfg: TransformerConfig, tp=None, ep=None):
    """Capacity-free top-k MoE over ``[B, S, D]``: every expert runs on
    every token and the router's picks are combined, unselected experts
    masked with ``where`` before the combine (a non-finite value there
    cannot reach the token).  Prefill, ``moe_dense_routing`` and the
    decode chunks run it; training keeps :func:`_moe_block`.  ``tp``:
    each expert's ``d_ff`` split over the model axis (the partial
    outputs summed by g); ``ep``: experts split over the expert axis,
    gathered whole here."""
    dtype = x.dtype
    probs = torch.softmax(_dot(x.float(), lp["wg"]), dim=-1)
    gates, expert = _moe_gates(probs, cfg)                    # [B, S, k]
    sel = (F.one_hot(expert, cfg.num_experts).float()
           * gates[..., None]).sum(dim=-2)                    # [B, S, E]
    split = tp is not None and tp.ffn
    xin = tp.enter(x, True) if split else x
    w1, w2 = _all_experts(lp["w1"], ep), _all_experts(lp["w2"], ep)
    h1 = _gelu(_einsum("bsd,edf->bsef", xin, w1.to(dtype)))
    y_all = _einsum("bsef,efd->bsed", h1, w2.to(dtype))
    y_all = torch.where(sel[..., None] > 0, y_all, 0.0)
    out = _einsum("bsed,bse->bsd", y_all, sel.to(y_all.dtype)).to(dtype)
    return tp.leave(out, True) if split else out


def block_apply(layer_params, x, cfg: TransformerConfig,
                attention_fn: Callable, rope_ang=None, drop_rng=None,
                return_kv=False, moe_dense_routing=False, tp=None,
                moe=None):
    """One pre-norm block.  Returns (x, aux_loss), or
    (x, aux_loss, (k, v)) with ``return_kv`` (post-rope, kv-heads-only —
    the decode-cache layout that ``generate.prefill`` consumes).
    ``drop_rng`` (a ``torch.Generator``) enables residual dropout on the
    attention and FFN outputs.  MoE configs run the capacity dispatch
    (:func:`_moe_block`, with its aux loss), or with
    ``moe_dense_routing`` the capacity-free :func:`_moe_dense_block`
    (aux 0).  ``tp`` (a ``parallel.layout.ModelAxis``): the attention
    and FFN run their local split between f and g over the model axis,
    and ``(k, v)`` are this rank's kv heads.  ``moe`` (an
    :class:`MoEScope`): the token group and expert axis of the MoE
    block."""
    h = _rms_norm(x, layer_params["ln1_scale"])
    a = _attention_block(layer_params["attn"],
                         tp.enter(h, tp.attn) if tp else h, attention_fn,
                         rope_ang, kv_groups=cfg.n_heads // cfg.kv_heads,
                         return_kv=return_kv)
    kv = None
    if return_kv:
        a, kv = a
    if tp:
        a = tp.leave(a, tp.attn)
    if drop_rng is not None:
        a = _dropout(a, cfg.dropout, drop_rng)
    x = x + a
    h = _rms_norm(x, layer_params["ln2_scale"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.num_experts and moe_dense_routing:
        y = _moe_dense_block(layer_params["moe"], h, cfg, tp=tp,
                             ep=moe.ep if moe is not None else None)
    elif cfg.num_experts:
        y, aux = _moe_block(layer_params["moe"], h, cfg, scope=moe, tp=tp)
    elif tp:
        y = tp.leave(_ffn(layer_params["ffn"], tp.enter(h, tp.ffn)),
                     tp.ffn)
    else:
        y = _ffn(layer_params["ffn"], h)
    if drop_rng is not None:
        y = _dropout(y, cfg.dropout, drop_rng)
    out = x + y
    return (out, aux, kv) if return_kv else (out, aux)


def _remat_block(cfg: TransformerConfig, moe_dense_routing: bool = False):
    """``block_apply`` wrapped per ``cfg.remat`` / ``cfg.remat_policy``:
    under autograd each block runs inside a non-reentrant
    ``torch.utils.checkpoint``, which keeps only the block's inputs (and,
    with a policy, the outputs of the policy's matmuls) and recomputes
    the rest in the backward.  Without grad it is ``block_apply``.
    ``moe_dense_routing`` is bound outside the checkpoint wrapper.

    Dropout: the checkpoint restores the default generators only, not
    the explicit one the masks come from.  So the forward draws from
    (and advances) the caller's generator, and the recompute redraws the
    same masks from a copy of the state it had before the block, which
    leaves the caller's stream where the forward left it.
    """
    _validate_remat_policy(cfg, require_remat=False)
    fn = (functools.partial(block_apply, moe_dense_routing=True)
          if moe_dense_routing else block_apply)
    if not cfg.remat:
        return fn
    ops = _REMAT_POLICIES[cfg.remat_policy]
    kw = {} if ops is None else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, ops)}

    def block(lp, x, cfg, attention_fn, rope_ang=None, drop_rng=None,
              tp=None, moe=None):
        if not torch.is_grad_enabled():
            return fn(lp, x, cfg, attention_fn, rope_ang, drop_rng, tp=tp,
                      moe=moe)
        state = None if drop_rng is None else drop_rng.get_state()
        calls = []

        def run(lp, x, rope_ang):
            gen = drop_rng
            if calls and gen is not None:  # the recompute
                gen = torch.Generator(drop_rng.device)
                gen.set_state(state)
            calls.append(True)
            return fn(lp, x, cfg, attention_fn, rope_ang, gen, tp=tp,
                      moe=moe)

        return checkpoint(run, lp, x, rope_ang, use_reentrant=False, **kw)

    return block


def _embed(params, tokens, cfg: TransformerConfig, start: int = 0):
    """Token (+ learned position) embedding and the rope angles;
    ``start`` is the global position of ``tokens``' first column (a
    sequence shard's offset)."""
    dtype = cfg.torch_dtype
    s = tokens.shape[1]
    x = params["tok_emb"][tokens].to(dtype)
    rope_ang = None
    if cfg.rope:
        pos = torch.arange(start, start + s, device=tokens.device)
        rope_ang = rope_angles(pos, cfg.head_dim,
                               cfg.rope_theta)[None, :, None, :]
    else:
        x = x + params["pos_emb"][start:start + s][None].to(dtype)
    return x, rope_ang


def _seq_start(attention_fn, s: int, cfg: TransformerConfig) -> int:
    """The global offset of a sequence shard of ``s`` columns (0 unless
    ``attention_fn`` is a ring over the seq axis), its global length
    checked against ``cfg.max_len``."""
    idx, count = getattr(attention_fn, "seq_shard", (0, 1))
    _check_len(s * count, cfg)
    return idx * s


def apply_hidden(params, tokens, cfg: TransformerConfig,
                 attention_fn: Callable | None = None, dropout_rng=None,
                 moe_dense_routing: bool = False, segment_ids=None):
    """Trunk forward: tokens [B, S] -> final-norm hidden [B, S, D];
    returns (hidden, aux).

    ``dropout_rng`` (a ``torch.Generator`` on the tokens' device) with
    ``cfg.dropout > 0`` enables training dropout: the embedding, then
    each block's attention and FFN outputs, in that order, draw their
    masks from it.  ``segment_ids [B, S]`` (packed sequences,
    data/packing.py) masks attention to within-segment pairs.  With
    ``cfg.remat`` each block is recomputed in the backward
    (:func:`_remat_block`).  ``moe_dense_routing=True`` scores MoE
    configs with the capacity-free routing of ``prefill`` and the decode
    (the inference semantics; aux comes back 0).  Sharded ``params``
    run through their compute view (``parallel.layout.views``); with a
    ring ``attention_fn`` (``parallel.ring``) ``tokens`` are this rank's
    block of the sequence, positioned at its global offset, and over a
    mesh this rank's rows, as the data axis splits the batch (MoE
    capacity and aux count the whole group's).
    """
    params = views(params)
    tp = tp_of(params)
    _check_generator(dropout_rng)
    start = _seq_start(attention_fn, tokens.shape[1], cfg)
    # The token group of MoE: the data ranks' rows, and the sequence
    # blocks when the ring splits the sequence.
    seq_split = getattr(attention_fn, "seq_shard", (0, 1))[1] > 1
    attention_fn = _resolve_attention_fn(cfg, attention_fn, segment_ids)
    layers = _layers(params["layers"], cfg.n_layers)
    x, rope_ang = _embed(params, tokens, cfg, start)
    drop = dropout_rng if cfg.dropout > 0 else None
    if drop is not None:
        x = _dropout(x, cfg.dropout, drop)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    block = _remat_block(cfg, moe_dense_routing)
    moe = (moe_scope(params, ("data", "seq") if seq_split else ("data",))
           if cfg.num_experts else None)
    for lp in layers:
        x, aux = block(lp, x, cfg, attention_fn, rope_ang, drop, tp=tp,
                       moe=moe)
        aux_total = aux_total + aux
    return _rms_norm(x, params["ln_f_scale"]), aux_total


def _head_table(params):
    """The tied table as the head uses it.  Over a pipeline axis every
    stage runs the head on the last stage's hidden states, so its
    gradient is kept on the last stage only and the sum over the stages
    counts it once (beside stage 0's lookup)."""
    pp = getattr(params, "pp", None)
    table = params["tok_emb"]
    return table if pp is None else C.count_once(table, pp, pp.size - 1)


def _unembed(hidden, params, cfg: TransformerConfig):
    """Tied unembedding head: hidden [B, S, D] -> f32 logits [B, S, V]."""
    table = _head_table(params).to(cfg.torch_dtype)
    return _dot(hidden, table.t()).float()


def apply(params, tokens, cfg: TransformerConfig,
          attention_fn: Callable | None = None, dropout_rng=None,
          moe_dense_routing: bool = False, device=None):
    """Forward pass: tokens [B, S] int -> (f32 logits [B, S, V], aux),
    without gradients (training goes through :func:`lm_loss`).
    ``moe_dense_routing``: see :func:`apply_hidden`.

    ``attention_fn(q, k, v) -> out`` defaults to causal flash attention
    (the Hopper kernel on the card).  Runs on ``device`` — the card
    unless ``device="cpu"`` — where the params must already live.
    """
    device = resolve_device(device)
    check_on_device(params, device)
    tokens = _as_ids(tokens, device, torch.long)
    with torch.no_grad():
        params = views(params)
        x, aux_total = apply_hidden(params, tokens, cfg, attention_fn,
                                    dropout_rng, moe_dense_routing)
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


def apply_pipelined(params, tokens, cfg: TransformerConfig, mesh,
                    microbatches: int, attention_fn: Callable | None = None,
                    axis_name: str = "pipeline", seq_axis: str | None = None,
                    return_hidden: bool = False, segment_ids=None):
    """Forward pass with the layer trunk pipelined over ``axis_name``;
    returns ``(logits, aux)`` (or the final-norm hidden states with
    ``return_hidden``, for the chunked loss head).

    The embedding and the head run outside the pipeline (they change
    shape); the residual trunk runs as ``n_stages`` contiguous stages of
    ``n_layers / n_stages`` layers under
    ``parallel.pipeline.make_pipeline``.  ``params``: a tree placed over
    the mesh (each rank holds its stage's layers, ``parallel/layout.py``)
    or the whole tree, whose stage slice each rank takes.  ``tokens``:
    this rank's rows (``[B, S]``; with ``seq_axis`` this rank's block of
    the sequence).  MoE aux flows through the pipeline averaged over
    microbatches; expert capacity applies per microbatch (over its rows
    on every data rank), as in the reference.

    ``seq_axis="seq"`` (PP x SP): each stage runs the ring attention
    body on its sequence block, positions global (offset by the block's
    index); MoE capacity then applies per sequence block, and the aux is
    averaged over the seq axis.  ``segment_ids`` (packed sequences) ride
    the pipeline as per-microbatch extras; only the default flash and
    ``seq_axis`` paths take them.  Every stage returns the last stage's
    result."""
    from distkeras_tpu_torch.parallel.pipeline import make_pipeline
    from distkeras_tpu_torch.parallel.ring import ring_attention

    segmented = segment_ids is not None
    if segmented and attention_fn is not None:
        raise ValueError(
            "segment_ids with a custom attention_fn is not supported "
            "under the pipeline — use the default flash path or "
            "seq_axis (see apply_hidden's guard)")
    x_spec = P()
    extras_spec = P() if segmented else None
    ring_seq = seq_axis is not None and int(mesh.shape[seq_axis]) > 1
    start = 0
    if ring_seq:
        if attention_fn is not None:
            raise ValueError(
                "pass either attention_fn or seq_axis, not both: under "
                "seq_axis the pipeline installs the ring attention body "
                "itself")
        attention_fn = functools.partial(
            ring_attention, axis_name=seq_axis, causal=True,
            window=cfg.attention_window, mesh=mesh)
        x_spec = P(None, seq_axis)
        if segmented:
            extras_spec = P(None, None, seq_axis)
        sq = mesh.sub(seq_axis)
        start = sq.rank * tokens.shape[1]
        _check_len(tokens.shape[1] * sq.size, cfg)
    else:
        _check_len(tokens.shape[1], cfg)
        if not segmented:
            attention_fn = _resolve_attention_fn(cfg, attention_fn)
    n_stages = int(mesh.shape[axis_name])
    if cfg.n_layers % n_stages:
        raise ValueError(
            f"n_layers={cfg.n_layers} not divisible into {n_stages} stages")
    per_stage = cfg.n_layers // n_stages
    params = views(params)
    tp = tp_of(params)
    pipe = mesh.sub(axis_name)
    device = params["tok_emb"].device
    tokens = _as_ids(tokens, device, torch.long)
    b, s = tokens.shape
    x, rope_ang = _embed(params, tokens, cfg, start)

    def stage_slice(a):
        # A whole tree's layers: this rank's stage (no communication).
        if a.shape[0] == cfg.n_layers and n_stages > 1:
            a = a[pipe.rank * per_stage:(pipe.rank + 1) * per_stage]
        return a.reshape(1, *a.shape)

    stage_params = _map_leaves(stage_slice, dict(params["layers"]))
    block = _remat_block(cfg)
    moe = moe_scope(params, ("data",)) if cfg.num_experts else None

    def stage_fn(lp, u, seg=None):
        if seg is None:
            att = attention_fn
        elif ring_seq:
            att = functools.partial(attention_fn, segment_ids=seg)
        else:
            att = _resolve_attention_fn(cfg, None, seg)
        aux_stage = torch.zeros((), dtype=torch.float32, device=u.device)
        for li in _layers(lp, per_stage):
            u, aux = block(li, u, cfg, att, rope_ang, tp=tp, moe=moe)
            aux_stage = aux_stage + aux
        return u, aux_stage

    pipe_fn = make_pipeline(stage_fn, mesh, microbatches, axis_name,
                            x_spec=x_spec, extras_spec=extras_spec)
    if segmented:
        segment_ids = _as_ids(segment_ids, device, torch.int32)
        if segment_ids.shape != tokens.shape:
            raise ValueError(
                f"segment_ids must align with tokens {tuple(tokens.shape)}, "
                f"got {tuple(segment_ids.shape)}")
        if b % microbatches:
            raise ValueError(f"batch {b} not divisible into "
                             f"{microbatches} microbatches")
        seg_mb = segment_ids.reshape(microbatches, b // microbatches, s)
        x, aux_total = pipe_fn(stage_params, x, seg_mb)
    else:
        x, aux_total = pipe_fn(stage_params, x)
    # The head runs on every stage from the last stage's result: its
    # weights' gradients count once over the stages (count_once).
    last = pipe.size - 1
    x = _rms_norm(x, C.count_once(params["ln_f_scale"], pipe, last))
    if return_hidden:
        return x, aux_total
    table = C.count_once(params["tok_emb"], pipe, last).to(cfg.torch_dtype)
    return _dot(x, table.t()).float(), aux_total


def _forward_nll(params, tokens, cfg: TransformerConfig,
                 attention_fn: Callable | None, apply_fn: Callable | None,
                 dropout_rng=None, hidden_fn: Callable | None = None,
                 moe_dense_routing: bool = False, segment_ids=None):
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
    params = views(params)
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
                                              dropout_rng, moe_dense_routing,
                                              seg_in)
    hidden, aux = call_custom(hidden_fn, params, tokens[:, :-1])
    if cfg.ce_chunks > 1:
        nll, z_mean = chunked_softmax_xent(hidden, _head_table(params),
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
                            dropout_rng, hidden_fn, segment_ids=segment_ids)
    return nll + aux


def lm_nll(params, tokens, cfg: TransformerConfig,
           attention_fn: Callable | None = None,
           apply_fn: Callable | None = None,
           hidden_fn: Callable | None = None,
           moe_dense_routing: bool = False, segment_ids=None):
    """Mean next-token NLL without the z-loss and MoE aux regularizers —
    the evaluation quantity (``exp`` of it is perplexity).
    ``moe_dense_routing=True`` evaluates an MoE config as the KV-cached
    decode routes it (default trunk only)."""
    return _forward_nll(params, tokens, cfg, attention_fn, apply_fn,
                        hidden_fn=hidden_fn,
                        moe_dense_routing=moe_dense_routing,
                        segment_ids=segment_ids)[0]


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
    signature; a custom one may differentiate another tree (the packed
    ``(adapters, base)`` of ``models.lora.make_lora_loss``), and only the
    leaves the optimizer holds are updated.  ``probe=True`` returns
    ``(carry, (loss, {"grad_norm": ...}))`` with the global norm of the
    (averaged) gradients.  A data-parallel ``optimizer``
    (``parallel/collectives.py``, ``parallel/exchange.py``) merges the
    local gradients over its group between the backward and the update.
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
        leaves = _leaves(params)
        device = leaves[0].device
        tokens = _as_ids(tokens, device, torch.long)
        if segment_ids is not None:
            segment_ids = _as_ids(segment_ids, device, torch.int32)
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
        # A data-parallel optimizer merges the gradients over the group
        # here (a no-op for one replica); the probe reads the result.
        optimizer.exchange(params, opt_state)
        norm = optimizer.grad_norm(params, opt_state) if probe else None
        optimizer.update(params, opt_state)
        if probe:
            return (params, opt_state), (loss, {"grad_norm": norm})
        return (params, opt_state), loss

    return step

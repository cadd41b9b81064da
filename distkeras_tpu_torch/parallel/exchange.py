"""Pluggable gradient exchange: Adasum, local SGD, error-feedback codecs.

Counterpart of ``distkeras_tpu/parallel/exchange.py``.  The default
exchange is the mean all-reduce (``collectives.DataParallel``, or the
ZeRO reduce-scatter); this module makes it a policy:

* **Adasum** (arXiv 2006.02924): the ranks' gradients combine pairwise
  with weights ``1 - <g_i, g_j> / (2 |g_i|^2)`` up a binary tree — the
  mean for parallel gradients, the sum for orthogonal ones.
* **Error-feedback codecs** (arXiv 1903.06701), per fusion bucket: the
  int8 codec quantizes each rank's contribution (plus the carried
  residual) row by row, moves the int8 rows through an all-to-all (rank
  k receives every peer's chunk k and sums it: a compressed
  reduce-scatter), re-quantizes the reduced chunk and all-gathers it;
  the residuals ``x - decode(encode(x))`` carry to the next step.
  Top-k keeps the ``topk_frac`` largest-magnitude entries of a bucket
  (the first k of a stable order, so ties pick the reference's
  indices).  ``zero1`` composes with int8 by compressing the
  reduce-scatter leg only.
* **Local SGD** (``sync_every=H``): H purely local steps per rank, then
  one merge of the parameter deltas (mean or Adasum, per bucket) and of
  the floating optimizer state (:func:`merge_local_params`,
  :func:`sync_local_tree`).

Each rank holds its own local gradient (the mean over its rows); the
buckets are :class:`~distkeras_tpu_torch.parallel.collectives.
Zero1Layout`'s, so a bucket, its chunks and its residuals have the
reference's geometry (``_residual_shapes`` gives the reference's global
shapes; a rank holds its slice, the leading axis dropped).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from distkeras_tpu_torch import obs
from distkeras_tpu_torch.parallel.collectives import (DEFAULT_BUCKET_MB,
                                                      DPOptimizer,
                                                      Zero1Layout,
                                                      ZeroOptimizer,
                                                      ZeroState, all_gather,
                                                      all_reduce, true_div)
from distkeras_tpu_torch.parallel.tree import (tree_flatten_with_names,
                                               tree_leaves, tree_unflatten)

_MERGE_RULES = ("mean", "adasum")
_CODECS = (None, "int8", "topk")
# Smallest positive normal f32: the zero-norm / zero-scale guard.
_EPS = float(np.finfo(np.float32).tiny)


@dataclasses.dataclass(frozen=True)
class ExchangeConfig:
    """One gradient-exchange policy (validated at construction).

    ``merge_rule``: "mean" or "adasum"; ``sync_every``: the local-SGD
    period; ``compress``: None, "int8", "topk" (``topk_frac`` of each
    bucket), or ordered ``(regex, codec)`` rules resolved per leaf (the
    buckets then group by codec).  ``bucket_mb`` sizes the buckets.
    """

    merge_rule: str = "mean"
    sync_every: int = 1
    compress: str | tuple | None = None
    topk_frac: float = 0.01
    bucket_mb: float = DEFAULT_BUCKET_MB

    def __post_init__(self):
        if self.merge_rule not in _MERGE_RULES:
            raise ValueError(
                f"merge_rule must be one of {_MERGE_RULES}, got "
                f"{self.merge_rule!r}")
        if isinstance(self.compress, (list, tuple)):
            rules = []
            for entry in self.compress:
                try:
                    pat, codec = entry
                except (TypeError, ValueError):
                    raise ValueError(
                        "compress rules must be (pattern, codec) "
                        f"pairs, got {entry!r}")
                if codec not in ("int8", "topk"):
                    raise ValueError(
                        f"compress rule {pat!r} names codec {codec!r}; "
                        "known codecs: 'int8', 'topk'")
                re.compile(pat)
                rules.append((str(pat), str(codec)))
            if not rules:
                raise ValueError(
                    "compress=[] is ambiguous: pass None for no codec "
                    "or at least one (pattern, codec) rule")
            object.__setattr__(self, "compress", tuple(rules))
        elif self.compress not in _CODECS:
            raise ValueError(
                f"compress must be one of {_CODECS} or a sequence of "
                f"(regex, codec) rules, got {self.compress!r}")
        if self.sync_every < 1:
            raise ValueError(
                f"sync_every must be >= 1, got {self.sync_every}")
        if not 0.0 < self.topk_frac <= 1.0:
            raise ValueError(
                f"topk_frac must be in (0, 1], got {self.topk_frac}")
        if self.compress is not None and self.merge_rule != "mean":
            raise ValueError(
                "compress composes with merge_rule='mean' only: the "
                "codecs implement a compressed sum, while adasum needs "
                "every replica's uncompressed contribution")
        if self.compress is not None and self.sync_every > 1:
            raise ValueError(
                "compress with sync_every > 1 is not supported: "
                "local-SGD exchanges parameters once per period, so "
                "there is no per-step gradient wire to compress")

    @property
    def is_default(self) -> bool:
        return (self.merge_rule == "mean" and self.sync_every == 1
                and self.compress is None)

    @property
    def needs_grad_exchange(self) -> bool:
        return not self.is_default and self.sync_every == 1

    @property
    def codec_rules(self) -> tuple | None:
        return self.compress if isinstance(self.compress, tuple) else None

    def label(self) -> str:
        parts = []
        if self.merge_rule != "mean":
            parts.append(self.merge_rule)
        if self.sync_every > 1:
            parts.append(f"localsgd{self.sync_every}")
        if self.codec_rules is not None:
            parts.append("rulesef")
        elif self.compress:
            parts.append(f"{self.compress}ef")
        return "_".join(parts) or "mean"


@dataclasses.dataclass
class ExchangeState:
    """The state of :class:`ExchangeOptimizer`: the inner optimizer's
    (over the params, or over this rank's shards under ``zero1``), the
    error-feedback residuals — ``e1`` per codec'd bucket ``[n, C_b]``
    (this rank's quantization error on its contribution), ``e2`` per
    int8 bucket outside zero1 ``[C_b]`` (the reduced chunk's) — and
    ``residual_norm``, their global L2 norm after the last step."""

    inner: Any
    e1: list
    e2: list
    residual_norm: Any
    layout: Zero1Layout
    shards: list | None = None
    mesh: Any = None
    probe_sq: Any = None

    @property
    def count(self) -> int:
        return self.inner.count

    @property
    def leaves(self) -> list:
        return self.inner.leaves

    @property
    def ema(self):
        if self.shards is None:
            return self.inner.ema
        return ZeroState(self.inner, self.layout, self.shards,
                         self.mesh).ema


# ------------------------------------------------------------- adasum


def adasum_combine(stack):
    """Reduce ``[m, D]`` stacked contributions to ``[D]`` by pairwise
    adaptive summation up a binary tree (an odd leftover rides up
    unmerged); the tree shape depends only on ``m``."""
    stack = stack.float()
    eps = torch.full((), _EPS, device=stack.device)
    while stack.shape[0] > 1:
        m = stack.shape[0]
        pairs = m // 2
        a, b = stack[0:2 * pairs:2], stack[1:2 * pairs:2]
        dot = (a * b).sum(-1, keepdim=True)
        na = (a * a).sum(-1, keepdim=True)
        nb = (b * b).sum(-1, keepdim=True)
        fa = torch.where(na > 0, 1.0 - dot / (2.0 * torch.maximum(na, eps)),
                         1.0)
        fb = torch.where(nb > 0, 1.0 - dot / (2.0 * torch.maximum(nb, eps)),
                         1.0)
        merged = fa * a + fb * b
        if m % 2:
            merged = torch.cat([merged, stack[-1:]], dim=0)
        stack = merged
    return stack[0]


# ------------------------------------------------------------- codecs


def int8_encode(x):
    """Symmetric per-row int8 quantization of ``x [..., C]`` over its
    last axis: ``(q int8, scale f32[..., 1])``, ``dequant = q * scale``;
    scale = amax / 127 (a true division), guarded so an all-zero row
    encodes to zeros.  The reference's ops in its order, exact in f32,
    so both packages give the same bits."""
    x = x.float()
    scale = true_div(x.abs().amax(dim=-1, keepdim=True), 127.0)
    scale = torch.maximum(scale, torch.full((), _EPS, device=x.device))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decode(q, scale):
    return q.float() * scale


# ------------------------------------------------------ bucket merges


def _merge_bucket_mean(bucket, mesh):
    return true_div(all_reduce(bucket.contiguous(), mesh), mesh.size)


def _merge_bucket_adasum(bucket, mesh):
    """Gather every rank's contribution, combine up the tree (the same
    math on every rank)."""
    stacked = all_gather(bucket.reshape(-1), mesh)           # [n, n*C]
    return adasum_combine(stacked).reshape(bucket.shape).to(bucket.dtype)


def _all_to_all(x, mesh):
    """Row ``j`` of the result is rank ``j``'s row ``rank`` of ``x``."""
    if mesh.group is None:
        return x.clone()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=mesh.group)
    return out


def _merge_bucket_int8(bucket, e1, e2, mesh, zero1):
    """Error-feedback int8 merge of this rank's ``[n, C]`` bucket (row k
    = rank k's chunk).  Returns ``(merged, e1', e2')``: the full mean
    bucket, or this rank's reduced ``[C]`` chunk under zero1."""
    n = mesh.size
    x = true_div(bucket.float(), n) + e1
    q, scale = int8_encode(x)                        # [n, C], [n, 1]
    e1_new = x - int8_decode(q, scale)
    qt = _all_to_all(q, mesh)                        # rows: peers' chunk
    st = _all_to_all(scale, mesh)
    chunk = int8_decode(qt, st).sum(0)               # [C]
    if zero1:
        return chunk, e1_new, e2
    y = chunk + e2
    q2, s2 = int8_encode(y[None])                    # [1, C], [1, 1]
    e2_new = y - int8_decode(q2, s2)[0]
    qg = all_gather(q2[0], mesh)                     # [n, C] int8
    sg = all_gather(s2[0], mesh)                     # [n, 1]
    return int8_decode(qg, sg).to(bucket.dtype), e1_new, e2_new


def _merge_bucket_topk(bucket, e1, mesh, k):
    """Error-feedback top-k: keep the k largest-magnitude entries of the
    residual-corrected contribution (the first k of a stable descending
    order), all-gather (values, indices), scatter-add."""
    shape = bucket.shape
    x = (true_div(bucket.float(), mesh.size) + e1).reshape(-1)
    idx = torch.sort(x.abs(), descending=True, stable=True).indices[:k]
    vals = x[idx]
    e_new = x.clone()
    e_new[idx] = 0.0
    e_new = e_new.reshape(shape)
    vg = all_gather(vals, mesh)
    ig = all_gather(idx, mesh)
    merged = torch.zeros_like(x).index_add_(0, ig.reshape(-1),
                                           vg.reshape(-1))
    return merged.reshape(shape).to(bucket.dtype), e_new


# ------------------------------------------------------------- layout


def resolve_codecs(rules: Sequence, tree, names=None):
    """Per-leaf codec tree from ordered ``(pattern, codec)`` rules
    (first match wins over the key paths, or over ``names``, a list of
    explicit leaf names in flatten order); an unmatched leaf raises."""
    from distkeras_tpu_torch.parallel.rules import (UnmatchedLeafError,
                                                    compile_rules,
                                                    first_match, match_rules)

    if names is None:
        return match_rules(list(rules), tree, what="codec")
    compiled = compile_rules(list(rules))
    named, spec = tree_flatten_with_names(tree)
    if len(names) != len(named):
        raise ValueError(f"names carries {len(names)} entries for "
                         f"{len(named)} leaves")
    out = []
    for name in names:
        matched, codec = first_match(compiled, str(name))
        if not matched:
            raise UnmatchedLeafError(str(name), "codec",
                                     [p.pattern for p, _ in compiled])
        out.append(codec)
    return tree_unflatten(spec, out)


def exchange_layout(tree, n: int, config: ExchangeConfig, names=None,
                    perms=None) -> Zero1Layout:
    """The fusion-bucket layout of one exchange policy: the ZeRO-1
    layout, grouped by resolved codec under codec rules."""
    if config.codec_rules is None:
        return Zero1Layout.for_tree(tree, n, config.bucket_mb, perms=perms)
    codecs = resolve_codecs(config.codec_rules, tree, names=names)
    return Zero1Layout.for_tree(tree, n, config.bucket_mb, groups=codecs,
                                perms=perms)


def _bucket_codecs(layout: Zero1Layout, config: ExchangeConfig) -> list:
    if config.codec_rules is not None:
        return list(layout.bucket_groups)
    return [config.compress] * len(layout.bucket_cols)


def _e2_slots(layout: Zero1Layout, config: ExchangeConfig,
              zero1: bool) -> dict:
    """bucket index -> slot in ``e2``: int8 buckets outside zero1."""
    if zero1:
        return {}
    codecs = _bucket_codecs(layout, config)
    return {i: k for k, i in enumerate(
        j for j, c in enumerate(codecs) if c == "int8")}


def _residual_shapes(layout: Zero1Layout, config: ExchangeConfig,
                     zero1: bool):
    """(e1 shapes, e2 shapes), global as the reference states them (a
    rank holds ``shape[1:]``)."""
    n = layout.n
    codecs = _bucket_codecs(layout, config)
    if not any(codecs):
        return [], []
    e1 = [(n, n, c) for c in layout.bucket_cols]
    e2 = [(n, layout.bucket_cols[i])
          for i in sorted(_e2_slots(layout, config, zero1))]
    return e1, e2


def topk_k(config: ExchangeConfig, bucket_cols: int, n: int) -> int:
    """Entries kept per bucket: ``topk_frac`` of the bucket, >= 1."""
    return max(1, int(round(config.topk_frac * bucket_cols * n)))


def wire_bytes(layout: Zero1Layout, config: ExchangeConfig,
               zero1: bool = False) -> tuple[int, int]:
    """``(baseline_bytes, wire_bytes)`` of one gradient exchange, ring
    model per device (all-reduce ``2(n-1)/n x payload``, one-shot
    collectives ``(n-1)/n``) — the reference's accounting."""
    n = layout.n
    ring = (n - 1) / n
    payloads = [c * n * d.itemsize
                for c, d in zip(layout.bucket_cols, layout.bucket_dtypes)]
    ar_legs = 1 if zero1 else 2
    f32_bytes = int(sum(ar_legs * ring * p for p in payloads))
    codecs = _bucket_codecs(layout, config)
    wire = 0.0
    for cols, payload, codec in zip(layout.bucket_cols, payloads, codecs):
        if codec == "int8":
            legs = 1 if zero1 else 2
            wire += legs * ring * (cols * n + 4 * n)
        elif codec == "topk":
            wire += ring * 8 * topk_k(config, cols, n) * n
        elif config.merge_rule == "adasum":
            wire += ring * n * payload
        else:
            wire += ar_legs * ring * payload
    return f32_bytes, int(wire)


def _record_geometry(layout: Zero1Layout, config: ExchangeConfig,
                     zero1: bool) -> None:
    if obs.active() is None:
        return
    f32_bytes, wire = wire_bytes(layout, config, zero1)
    obs.gauge("exchange.buckets", len(layout.bucket_cols))
    obs.gauge("exchange.f32_bytes", f32_bytes)
    obs.gauge("exchange.wire_bytes", wire)
    obs.gauge("exchange.compression_ratio", f32_bytes / max(wire, 1))
    obs.gauge("exchange.sync_every", config.sync_every)
    codecs = _bucket_codecs(layout, config)
    obs.event("exchange.geometry", merge_rule=config.merge_rule,
              codec=("rules" if config.codec_rules is not None
                     else config.compress or "none"), zero1=zero1,
              buckets=len(layout.bucket_cols),
              bucket_codecs=",".join(str(c) for c in codecs))


# --------------------------------------------------- the optimizer wrap


class ExchangeOptimizer(DPOptimizer):
    """``exchange`` merges this rank's local gradients by the configured
    policy per bucket; ``update`` runs the inner optimizer on the merged
    gradient (replicated), or under ``zero1`` on this rank's shards and
    all-gathers the new parameters.  ``names``: explicit leaf names for
    codec rules (the Keras trainers pass their variable paths);
    ``perms``: per-leaf permutations into the reference's layout."""

    def __init__(self, inner, mesh, config: ExchangeConfig,
                 zero1: bool = False, names=None, perms=None):
        super().__init__(inner, mesh)
        if zero1 and config.compress != "int8":
            raise ValueError(
                "zero1 composes with compress='int8' only (the chunked "
                "two-phase codec IS a compressed reduce-scatter; adasum, "
                "top-k and per-bucket codec rules merge whole buckets)")
        self.config = config
        self.zero1 = zero1
        self.names = names
        self.perms = perms
        self._zero = ZeroOptimizer(inner, mesh, config.bucket_mb, perms)

    def layout_for(self, params) -> Zero1Layout:
        return exchange_layout(params, self.mesh.size, self.config,
                               names=self.names, perms=self.perms)

    def init(self, params) -> ExchangeState:
        layout = self.layout_for(params)
        _record_geometry(layout, self.config, self.zero1)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        dev = leaves[0].device
        shards = None
        if self.zero1:
            with torch.no_grad():
                shards = [v[self.mesh.rank].clone()
                          for v in layout.shard_views(leaves)]
            inner = self.inner.init(layout.unflatten(shards))
        else:
            inner = self.inner.init(params)
        e1_s, e2_s = _residual_shapes(layout, self.config, self.zero1)
        return ExchangeState(
            inner=inner,
            e1=[torch.zeros(s[1:], device=dev) for s in e1_s],
            e2=[torch.zeros(s[1:], device=dev) for s in e2_s],
            residual_norm=torch.zeros((), device=dev), layout=layout,
            shards=shards, mesh=self.mesh)

    def exchange(self, params, state: ExchangeState) -> None:
        leaves = tree_leaves(params)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in leaves]
        state.probe_sq = torch.stack(
            [g.float().square().sum() for g in grads]).sum()
        layout, config, mesh = state.layout, self.config, self.mesh
        codecs = _bucket_codecs(layout, config)
        e2_slot = _e2_slots(layout, config, self.zero1)
        merged, e1_new, e2_new = [], [], []
        for i, b in enumerate(layout.pack(grads)):
            if codecs[i] == "int8":
                m, r1, r2 = _merge_bucket_int8(
                    b, state.e1[i],
                    state.e2[e2_slot[i]] if i in e2_slot else 0.0,
                    mesh, self.zero1)
                e1_new.append(r1)
                if i in e2_slot:
                    e2_new.append(r2)
            elif codecs[i] == "topk":
                k = topk_k(config, layout.bucket_cols[i], mesh.size)
                m, r1 = _merge_bucket_topk(b, state.e1[i], mesh, k)
                e1_new.append(r1)
            elif config.merge_rule == "adasum":
                m = _merge_bucket_adasum(b, mesh)
            else:
                m = _merge_bucket_mean(b, mesh)
            merged.append(m)
        if e1_new or e2_new:
            sq = torch.stack([e.square().sum() for e in e1_new + e2_new]
                             ).sum()
            state.residual_norm = torch.sqrt(all_reduce(sq, mesh))
        state.e1, state.e2 = e1_new, e2_new
        if self.zero1:
            ZeroOptimizer.set_shard_grads(self._zstate(state), merged)
        else:
            for p, g in zip(leaves, layout.unpack(merged)):
                p.grad = g

    def _zstate(self, state: ExchangeState) -> ZeroState:
        return ZeroState(state.inner, state.layout, state.shards, self.mesh)

    def grad_norm(self, params, state: ExchangeState):
        """The reference's probe under an exchange policy: the norm of
        the stacked local gradients, ``sqrt(sum_r |g_r|^2)``."""
        return torch.sqrt(all_reduce(state.probe_sq.clone(), self.mesh))

    def update(self, params, state: ExchangeState) -> None:
        if self.zero1:
            self._zero.update(params, self._zstate(state))
        else:
            self.inner.update(params, state.inner)


def exchange_optimizer(inner, mesh, config: ExchangeConfig,
                       zero1: bool = False, names=None,
                       perms=None) -> ExchangeOptimizer:
    return ExchangeOptimizer(inner, mesh, config, zero1=zero1, names=names,
                             perms=perms)


def residual_norm_of(opt_state):
    """The residual-norm scalar of an exchange state, or None."""
    if isinstance(opt_state, ExchangeState):
        return float(opt_state.residual_norm)
    return None


# --------------------------------------------------- local-SGD merging


def _mean_buckets(leaves, mesh, bucket_mb: float) -> list:
    """The group mean of ``leaves`` through the fusion buckets: one
    all-reduce per bucket, not per leaf."""
    layout = Zero1Layout.for_tree(list(leaves), mesh.size, bucket_mb)
    return layout.unpack([_merge_bucket_mean(b, mesh)
                          for b in layout.pack(list(leaves))])


def merge_local_params(start, local, config: ExchangeConfig, mesh) -> list:
    """The parameter merge at a local-SGD sync point: ``start`` (the
    leaves the period began from) plus the merged deltas ``local -
    start`` — their mean (local SGD / federated averaging) or their
    Adasum combination, per fusion bucket."""
    delta = [b - a for a, b in zip(start, local)]
    if config.merge_rule == "mean":
        merged = _mean_buckets(delta, mesh, config.bucket_mb)
    else:
        layout = Zero1Layout.for_tree(delta, mesh.size, config.bucket_mb)
        merged = layout.unpack([_merge_bucket_adasum(b, mesh)
                                for b in layout.pack(delta)])
    return [a + m for a, m in zip(start, merged)]


def sync_local_tree(tensors, config: ExchangeConfig, mesh) -> list:
    """The momentum-aware half of the sync: the group mean of every
    floating tensor of ``tensors`` (through the buckets); the rest pass
    through (step counts advance alike on every rank)."""
    tensors = list(tensors)
    fmask = [torch.is_tensor(t) and t.is_floating_point() for t in tensors]
    floats = [t for t, m in zip(tensors, fmask) if m]
    if not floats:
        return tensors
    merged = iter(_mean_buckets(floats, mesh, config.bucket_mb))
    return [next(merged) if m else t for t, m in zip(tensors, fmask)]


__all__ = ["ExchangeConfig", "ExchangeState", "ExchangeOptimizer",
           "exchange_optimizer", "exchange_layout", "resolve_codecs",
           "residual_norm_of", "adasum_combine", "int8_encode",
           "int8_decode", "merge_local_params", "sync_local_tree",
           "topk_k", "wire_bytes"]

"""Bucketed collectives over the process group + the ZeRO sharded update.

Counterpart of ``distkeras_tpu/parallel/collectives.py`` (the weight
update sharding of "Automatic Cross-Replica Sharding of Weight Update in
Data-Parallel Training", arXiv 2004.13336):

    reduce-scatter(grads)  ->  each rank updates only its 1/n shard
                           ->  all-gather(new shard)

with the training math of the replicated update (the update rule is
elementwise) and ~n x less optimizer state per device.

Gradient trees are flattened into ~``bucket_mb`` **fusion buckets**:
each leaf is padded to a multiple of ``n`` (the data axis) and viewed
as ``[n, cols]`` — row ``k`` is the chunk rank ``k`` owns — then
same-dtype leaves are concatenated along the columns.
:class:`Zero1Layout` computes that placement from shapes alone, leaf
for leaf as the reference does (JAX's leaf order: dict keys sorted), so
the two packages place every leaf at the same bucket, offset and width.
A leaf may carry a permutation into the reference's layout (the Keras
trainers' dense and conv kernels are stored transposed in torch), so a
chunk holds the same elements in both packages.

The collectives are explicit ``torch.distributed`` calls on this rank's
tensors: :func:`scatter` reduce-scatters a ``[n, C]`` local bucket into
this rank's summed ``[C]`` row, :func:`all_gather` gathers every rank's
``[C]`` row into ``[n, C]``, :func:`gather_bucket` is the ZeRO-3
gather-on-use (all-gather forward, reduce-scatter backward) and
:func:`adasum_reduce` the standalone Adasum merge.  A mesh with no
process group (one process) runs them as the local identities.

:class:`ZeroOptimizer` wraps the port's :class:`~distkeras_tpu_torch.
trainers.optim.Optimizer` (every name is per-leaf elementwise) into the
stage-1 update; stages 2 and 3 drive it from their own steps
(``models/adapter.py``, ``trainers/lm.py``).  Bucket geometry is
recorded under the reference's ``zero1.*`` obs names.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from distkeras_tpu_torch import obs
from distkeras_tpu_torch.parallel.tree import (tree_flatten,
                                               tree_flatten_with_names,
                                               tree_leaves, tree_unflatten)

# ~4 MB buckets, as the reference.
DEFAULT_BUCKET_MB = 4.0


def as_torch_dtype(d) -> torch.dtype:
    """A torch dtype from a torch or numpy dtype (or its name)."""
    if isinstance(d, torch.dtype):
        return d
    return torch.from_numpy(np.empty(0, dtype=np.dtype(d))).dtype


def true_div(x, d):
    """``x / d`` as a true division on every device (CUDA turns a
    division by a host scalar into a product by its reciprocal)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


@dataclasses.dataclass(frozen=True)
class _Slot:
    """Where one leaf lives inside the bucketed layout (``shape`` in the
    reference's layout; ``perm`` takes a port leaf there)."""

    shape: tuple
    dtype: Any
    size: int       # prod(shape)
    cols: int       # padded size // n
    bucket: int
    offset: int     # column offset inside the bucket
    perm: tuple | None = None


@dataclasses.dataclass(frozen=True)
class Zero1Layout:
    """Deterministic leaf -> bucket placement for one tree geometry,
    from shapes and dtypes only (tensors, or anything with ``shape`` /
    ``dtype``)."""

    n: int
    spec: Any
    slots: tuple
    bucket_cols: tuple
    bucket_dtypes: tuple
    bucket_groups: tuple = ()

    @classmethod
    def for_tree(cls, tree, n: int, bucket_mb: float = DEFAULT_BUCKET_MB,
                 groups=None, perms=None) -> "Zero1Layout":
        """``groups``: a same-structure tree of group keys (a bucket
        never straddles two); ``perms``: per leaf (flatten order) a
        permutation into the reference's layout, or None."""
        leaves, spec = tree_flatten(tree)
        if n < 1:
            raise ValueError(f"axis size must be >= 1, got {n}")
        if groups is None:
            group_of = [None] * len(leaves)
        else:
            group_of = _group_leaves(groups)
            if len(group_of) != len(leaves):
                raise ValueError(
                    f"groups carries {len(group_of)} entries for "
                    f"{len(leaves)} leaves")
        perms = list(perms) if perms is not None else [None] * len(leaves)
        by_key: dict[Any, list[int]] = {}
        for i, leaf in enumerate(leaves):
            by_key.setdefault((as_torch_dtype(leaf.dtype), group_of[i]),
                              []).append(i)
        slots: list = [None] * len(leaves)
        bucket_cols: list[int] = []
        bucket_dtypes: list = []
        bucket_groups: list = []
        for (dtype, group), idxs in by_key.items():
            budget = max(1, int(bucket_mb * 2 ** 20 / dtype.itemsize))
            cur_cols, cur_bucket = 0, -1
            for i in idxs:
                shape = tuple(leaves[i].shape)
                if perms[i] is not None:
                    shape = tuple(shape[d] for d in perms[i])
                size = int(math.prod(shape)) or 1
                cols = -(-size // n)
                if cur_bucket < 0 or cur_cols * n + cols * n > budget:
                    bucket_cols.append(0)
                    bucket_dtypes.append(dtype)
                    bucket_groups.append(group)
                    cur_bucket = len(bucket_cols) - 1
                    cur_cols = 0
                slots[i] = _Slot(shape=shape, dtype=dtype,
                                 size=int(math.prod(shape)), cols=cols,
                                 bucket=cur_bucket, offset=cur_cols,
                                 perm=(None if perms[i] is None
                                       else tuple(perms[i])))
                cur_cols += cols
                bucket_cols[cur_bucket] = cur_cols
        return cls(n=n, spec=spec, slots=tuple(slots),
                   bucket_cols=tuple(bucket_cols),
                   bucket_dtypes=tuple(bucket_dtypes),
                   bucket_groups=tuple(bucket_groups))

    # ------------------------------------------------------------ views

    @property
    def shard_shapes(self) -> frozenset:
        return frozenset((self.n, s.cols) for s in self.slots)

    def _leaves(self, tree) -> list:
        leaves = tree if isinstance(tree, list) and len(tree) == len(
            self.slots) else tree_leaves(tree)
        if len(leaves) != len(self.slots):
            raise ValueError(f"tree has {len(leaves)} leaves, the layout "
                             f"{len(self.slots)}")
        return leaves

    def leaf_view(self, slot: _Slot, x):
        """One leaf -> its ``[n, cols]`` chunk-major view (zero pad)."""
        if slot.perm is not None:
            x = x.permute(*slot.perm)
        flat = x.reshape(-1)
        pad = slot.cols * self.n - slot.size
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        return flat.reshape(self.n, slot.cols)

    def _from_flat(self, slot: _Slot, flat):
        x = flat[:slot.size].reshape(slot.shape)
        if slot.perm is not None:
            x = x.permute(*np.argsort(slot.perm).tolist())
        return x

    def shard_views(self, tree) -> list:
        """Leaves -> ``[n, cols]`` views, in leaf order."""
        return [self.leaf_view(s, x)
                for s, x in zip(self.slots, self._leaves(tree))]

    def unview(self, views) -> list:
        """Inverse of :meth:`shard_views` (pad dropped)."""
        return [self._from_flat(s, v.reshape(-1))
                for s, v in zip(self.slots, views)]

    # ---------------------------------------------------------- buckets

    def pack(self, tree) -> list:
        """Leaves -> list of ``[n, C_b]`` fusion buckets."""
        return self.pack_views(self.shard_views(tree))

    def pack_views(self, views) -> list:
        groups: list[list] = [[] for _ in self.bucket_cols]
        for slot, v in zip(self.slots, views):
            groups[slot.bucket].append(v)
        return [vs[0] if len(vs) == 1 else torch.cat(vs, dim=1)
                for vs in groups]

    def views_from_buckets(self, buckets: Sequence) -> list:
        return [buckets[s.bucket][:, s.offset:s.offset + s.cols]
                for s in self.slots]

    def zero_buckets(self, device) -> list:
        return [torch.zeros((self.n, c), dtype=d, device=device)
                for c, d in zip(self.bucket_cols, self.bucket_dtypes)]

    def unpack(self, buckets: Sequence) -> list:
        """Bucket list -> leaves in their own shapes (pad dropped)."""
        return [self._from_flat(
            s, buckets[s.bucket][:, s.offset:s.offset + s.cols].reshape(-1))
            for s in self.slots]

    # ------------------------------------------------ this rank's rows

    def rows_to_shards(self, rows: Sequence) -> list:
        """Per-bucket ``[C]`` rows (one rank's) -> per-leaf ``[cols]``
        shards (column slices, no copy)."""
        return [rows[s.bucket][s.offset:s.offset + s.cols]
                for s in self.slots]

    def pack_rows(self, shards: Sequence) -> list:
        """Per-leaf ``[cols]`` shards -> per-bucket ``[C]`` rows."""
        groups: list[list] = [[] for _ in self.bucket_cols]
        for slot, v in zip(self.slots, shards):
            groups[slot.bucket].append(v.reshape(-1))
        return [vs[0] if len(vs) == 1 else torch.cat(vs) for vs in groups]

    def unflatten(self, leaves):
        return tree_unflatten(self.spec, leaves)


def _group_leaves(groups) -> list:
    """Leaves of a group tree whose leaves may be None (a None key is a
    leaf here, unlike in a parameter tree)."""
    if isinstance(groups, dict):
        return [g for k in sorted(groups) for g in _group_leaves(groups[k])]
    if isinstance(groups, (list, tuple)):
        return [g for v in groups for g in _group_leaves(v)]
    return [groups]


def record_layout(layout: Zero1Layout) -> None:
    """Bucket geometry into the obs registry (once per layout)."""
    if obs.active() is None:
        return
    bucket_bytes = [c * layout.n * d.itemsize
                    for c, d in zip(layout.bucket_cols, layout.bucket_dtypes)]
    pad = sum((s.cols * layout.n - s.size) * s.dtype.itemsize
              for s in layout.slots)
    obs.gauge("zero1.buckets", len(bucket_bytes))
    obs.gauge("zero1.exchange_bytes", sum(bucket_bytes))
    obs.gauge("zero1.pad_bytes", pad)
    for b in bucket_bytes:
        obs.observe("zero1.bucket_bytes", b,
                    buckets=(2**18, 2**20, 2**22, 2**24, 2**26))


# ------------------------------------------------------------ collectives

_RS = getattr(dist, "reduce_scatter_single", None) or getattr(
    dist, "reduce_scatter_tensor", None)
_AG = getattr(dist, "all_gather_single", None) or getattr(
    dist, "all_gather_into_tensor", None)


def all_reduce(t, mesh, op=None):
    """In-place sum (or ``op``) of ``t`` over the group; identity for a
    single process."""
    if mesh.group is not None:
        dist.all_reduce(t, dist.ReduceOp.SUM if op is None else op,
                        group=mesh.group)
    return t


def scatter(bucket, mesh):
    """Reduce-scatter of this rank's ``[n, C]`` contribution: the sum
    over ranks of row ``rank``, ``[C]`` (row k is rank k's chunk)."""
    n = mesh.size
    if bucket.ndim != 2 or bucket.shape[0] != n:
        raise ValueError(f"scatter takes [n, C] with n == the data axis "
                         f"({n}); got {tuple(bucket.shape)}")
    if mesh.group is None:
        return bucket[0].clone()
    out = bucket.new_empty(bucket.shape[1])
    _RS(out, bucket.contiguous().reshape(-1), group=mesh.group)
    return out


def reduce_scatter(x, mesh):
    """Per-rank reduce-scatter: ``x [C]`` is this rank's addend (C a
    multiple of the data axis ``n``); returns this rank's ``C/n`` chunk
    of the sum over ranks (rank k: columns ``[k C/n, (k+1) C/n)``)."""
    n = mesh.size
    if x.ndim != 1 or x.shape[0] % n:
        raise ValueError(
            f"reduce_scatter takes [C] with C divisible by the data axis "
            f"size ({n}) (each rank receives a C/n chunk); got shape "
            f"{tuple(x.shape)} — pad the columns to a multiple of the "
            "axis size")
    return scatter(x.reshape(n, -1), mesh)


def all_gather(row, mesh):
    """Every rank's ``[C]`` row, stacked ``[n, C]`` in rank order."""
    if mesh.group is None:
        return row.reshape(1, -1).clone()
    out = row.new_empty((mesh.size, row.numel()))
    _AG(out.reshape(-1), row.contiguous().reshape(-1), group=mesh.group)
    return out


class _GatherBucket(torch.autograd.Function):
    @staticmethod
    def forward(ctx, row, mesh):
        ctx.mesh = mesh
        return all_gather(row, mesh)

    @staticmethod
    def backward(ctx, grad):
        return scatter(grad.contiguous(), ctx.mesh), None


def gather_bucket(row, mesh):
    """ZeRO-3 gather-on-use: forward all-gathers this rank's ``[C]``
    parameter row into the full ``[n, C]`` bucket; the backward
    reduce-scatters the bucket's gradient back to this rank's row (the
    sum over ranks), so the gradient of a gathered parameter only
    materializes as the owned shard."""
    return _GatherBucket.apply(row, mesh)


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return all_reduce(t.contiguous().clone(), mesh)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), ctx.mesh), None


def sum_over_group(t, mesh):
    """The sum of ``t`` over the group's ranks, differentiable: the
    backward all-reduces the gradient too, so every rank's ``t`` gets
    the terms of every rank's loss (a synchronized batch norm's
    statistics)."""
    return _SumOverGroup.apply(t, mesh)


def gather_dim(x, dim: int, mesh):
    """Every rank's ``x`` concatenated along ``dim`` in rank order (a
    ``[.., n * c, ..]`` tensor from each rank's ``[.., c, ..]``)."""
    if mesh.group is None:
        return x.clone()
    rows = all_gather(x.movedim(dim, 0).contiguous(), mesh)
    return rows.reshape(mesh.size * x.shape[dim], *x.movedim(dim, 0)
                        .shape[1:]).movedim(0, dim)


def scatter_dim(x, dim: int, mesh):
    """Reduce-scatter along ``dim``: the sum over ranks of this rank's
    block of ``x`` (``dim`` split into ``n`` blocks in rank order)."""
    if mesh.group is None:
        return x.clone()
    xm = x.movedim(dim, 0).contiguous()
    row = scatter(xm.reshape(mesh.size, -1), mesh)
    return row.reshape(xm.shape[0] // mesh.size, *xm.shape[1:]).movedim(
        0, dim)


def block_of(x, dim: int, mesh):
    """This rank's block of ``x`` along ``dim`` (no communication)."""
    c = x.shape[dim] // mesh.size
    return x.narrow(dim, mesh.rank * c, c)


class _GatherOnUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, summed):
        ctx.dim, ctx.mesh, ctx.summed = dim, mesh, summed
        return gather_dim(x, dim, mesh)

    @staticmethod
    def backward(ctx, grad):
        if ctx.summed:
            return scatter_dim(grad, ctx.dim, ctx.mesh), None, None, None
        return (block_of(grad, ctx.dim, ctx.mesh).contiguous(), None, None,
                None)


def gather_on_use(x, dim: int, mesh, summed: bool = True):
    """Gather-on-use of a leaf split along ``dim`` over ``mesh``'s axis:
    the forward all-gathers the whole leaf; the backward reduce-scatters
    its gradient to this rank's block (``summed``: ranks that compute on
    different rows, as the data axis does), or takes this rank's block
    of it (``summed=False``: ranks whose computation with the gathered
    leaf is replicated, as a model axis's outside its split layers)."""
    return _GatherOnUse.apply(x, dim, mesh, summed)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), ctx.mesh), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x.contiguous().clone(), mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x, mesh):
    """Megatron's f: the identity forward, an all-reduce of the gradient
    backward (the input of a block whose weights the group splits)."""
    return _CopyToGroup.apply(x, mesh)


def reduce_from_group(x, mesh):
    """Megatron's g: the all-reduce of the group's partial sums forward,
    the identity backward (the output of a split block)."""
    return _ReduceFromGroup.apply(x, mesh)


def exchange_rows(x, mesh):
    """Every rank's ``x``, stacked ``[n, *x.shape]`` in rank order (one
    all-gather over the group: the transport of :func:`ppermute`)."""
    return all_gather(x.contiguous().reshape(-1), mesh).reshape(
        mesh.size, *x.shape)


def _routed(x, mesh, pairs):
    """What this rank receives when every rank sends its ``x`` along
    ``pairs`` (``(src, dst)``): the source's ``x``, or zeros for a rank
    that receives from nobody.  Every rank calls it (a collective)."""
    rows = exchange_rows(x, mesh)
    src = [s for s, d in pairs if d == mesh.rank]
    return rows[src[0]].clone() if src else torch.zeros_like(x)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, perm):
        ctx.mesh, ctx.perm = mesh, perm
        return _routed(x, mesh, perm)

    @staticmethod
    def backward(ctx, grad):
        inverse = [(d, s) for s, d in ctx.perm]
        return _routed(grad, ctx.mesh, inverse), None, None


def ppermute(x, mesh, perm):
    """``jax.lax.ppermute`` over ``mesh``'s axis: rank ``d`` of every
    pair ``(s, d)`` of ``perm`` receives rank ``s``'s ``x``; a rank that
    receives from nobody gets zeros.  The backward sends the cotangent
    along the inverse permutation.  Its transport is one all-gather over
    the axis's group (gloo and NCCL both run it on CUDA tensors), so
    every rank of the group must call it, in the same order, forward
    and backward."""
    perm = tuple((int(s), int(d)) for s, d in perm)
    if len({d for _, d in perm}) != len(perm) or len(
            {s for s, _ in perm}) != len(perm):
        raise ValueError(f"ppermute needs a permutation, got {perm}")
    if mesh.group is None:
        return x if (0, 0) in perm else torch.zeros_like(x)
    return _PPermute.apply(x, mesh, perm)


class _FromRank(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, src):
        ctx.mesh, ctx.src = mesh, src
        mine = x if mesh.rank == src else torch.zeros_like(x)
        return all_reduce(mine.contiguous().clone(), mesh)

    @staticmethod
    def backward(ctx, grad):
        keep = ctx.mesh.rank == ctx.src
        return (grad if keep else torch.zeros_like(grad)), None, None


def from_rank(x, mesh, src: int):
    """Rank ``src``'s ``x`` on every rank of the group (the others'
    ``x`` only gives the shape).  The ranks then compute alike with it,
    so the backward hands ``src`` its own gradient (one copy of the
    replicated computation's) and the others zeros, with no
    communication."""
    if mesh.group is None:
        return x
    return _FromRank.apply(x, mesh, int(src))


class _CountOnce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, owner):
        ctx.keep = mesh.rank == owner
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.keep else torch.zeros_like(grad)), None, None


def count_once(x, mesh, owner: int):
    """Identity forward; the backward keeps the gradient on rank
    ``owner`` only.  For a leaf replicated over the group that every
    rank uses in the same replicated computation (a pipeline's head)
    while its other uses differ by rank: the sum of its gradients over
    the group then counts the replicated use once."""
    if mesh.group is None:
        return x
    return _CountOnce.apply(x, mesh, int(owner))


def adasum_reduce(x, mesh):
    """Adasum merge of every rank's ``[C]`` contribution (rule in
    ``parallel/exchange.py``): identical contributions give the value
    itself, orthogonal ones their sum."""
    from distkeras_tpu_torch.parallel.exchange import adasum_combine

    return adasum_combine(all_gather(x, mesh)).to(x.dtype)


def dist_norm(tensors, mesh):
    """Global L2 norm of ``tensors`` summed over the group (f32)."""
    ts = [t for t in tensors if t is not None]
    if not ts:
        return torch.zeros(())
    sq = torch.stack([t.float().square().sum() for t in ts]).sum()
    return torch.sqrt(all_reduce(sq, mesh))


# ------------------------------------------------------------ the wrapper


def zero_validate(mesh, spec, axis: str = "data", stage: int = 1) -> None:
    """The ZeRO enablement checks: a pure data mesh, and an optimizer
    whose update is per-leaf elementwise (every name of the port is;
    a custom object warns)."""
    knob = f"zero={stage}" if stage != 1 else "zero1=True"
    for ax, size in mesh.shape.items():
        if ax != axis and int(size) > 1:
            raise ValueError(
                f"{knob} composes with the {axis} axis only, but the "
                f"mesh has {ax}={int(size)}; the ZeRO stages shard the "
                "update of *replicated* parameters — use fsdp/TP plans "
                "when a rule-driven parameter layout is wanted instead")
    from distkeras_tpu_torch.ops.optimizers import zero1_compatible

    compat = zero1_compatible(spec)
    if compat is False:
        raise ValueError(
            f"optimizer {spec!r} is known-incompatible with the ZeRO "
            "sharded update (its update rule mixes elements within a "
            "leaf), so sharding changes the math; train it replicated")
    if compat is None:
        warnings.warn(
            f"{knob} with an optimizer that cannot be verified "
            "elementwise: the sharded update is math-identical only for "
            "per-leaf elementwise update rules", stacklevel=3)


class DPOptimizer:
    """Base of the data-parallel optimizer wrappers of an
    :class:`Optimizer` (``inner``): ``init(params)``, ``exchange(params,
    state)`` (after the backward: merge the local gradients over the
    group), ``grad_norm(params, state)`` (the probe's global gradient
    norm) and ``update(params, state)`` (in place) — the protocol the
    train steps drive."""

    def __init__(self, inner, mesh):
        self.inner = inner
        self.mesh = mesh


class DataParallel(DPOptimizer):
    """The plain exchange: the local gradients' mean over the group, one
    in-place all-reduce per ~``bucket_mb`` bucket, then the replicated
    update.  With a ``layout`` (``parallel/layout.py``: params placed
    over a mesh) the group is the data axis's, a leaf split over the
    data axis arrives summed by its gather's reduce-scatter and is only
    divided, the layout's
    :meth:`~distkeras_tpu_torch.parallel.layout.Layout.reduce_grads`
    finishes the exchange over the axes beyond ``data``, and the clip's
    and the probe's norms count each element of the placed tree once
    over the whole mesh."""

    def __init__(self, inner, mesh, bucket_mb: float = DEFAULT_BUCKET_MB,
                 layout=None):
        super().__init__(inner, mesh)
        self.bucket_mb = bucket_mb
        self.layout = layout

    def init(self, params):
        return self.inner.init(params)

    def _named_grads(self, params):
        return [(n, p.grad) for n, p in
                tree_flatten_with_names(params)[0] if p.grad is not None]

    def exchange(self, params, state) -> None:
        if self.layout is not None and self.layout.pp is not None:
            # A stage that does not use a leaf (the position table past
            # stage 0) still sends its zeros: every rank packs the same
            # buckets.
            for p in tree_leaves(params):
                if p.grad is None and p.requires_grad:
                    p.grad = torch.zeros_like(p)
        # Leaves without a gradient (a frozen base) are alike on every
        # rank and stay out of the exchange.
        named = [(n, p) for n, p in tree_flatten_with_names(params)[0]
                 if p.grad is not None]
        lay = self.layout
        if self.mesh.group is not None:
            self._data_mean(named)
        if lay is not None:
            lay.reduce_grads(named, self.bucket_mb)

    def _data_mean(self, named) -> None:
        lay = self.layout
        summed = [p for n, p in named if lay is not None
                  and lay.splits_data(n)]
        for p in summed:
            p.grad = true_div(p.grad, self.mesh.size)
        leaves = [p for n, p in named if lay is None
                  or not lay.splits_data(n)]
        if not leaves:
            return
        grads = [p.grad for p in leaves]
        layout = Zero1Layout.for_tree(grads, 1, self.bucket_mb)
        buckets = [true_div(all_reduce(b.contiguous(), self.mesh),
                            self.mesh.size) for b in layout.pack(grads)]
        for p, g in zip(leaves, layout.unpack(buckets)):
            p.grad = g

    def _norm_fn(self, params):
        if self.layout is None:
            return None
        names = {id(p.grad): n for n, p in
                 tree_flatten_with_names(params)[0] if p.grad is not None}
        return lambda grads: self.layout.norm(
            [(names[id(g)], g) for g in grads])

    def grad_norm(self, params, state):
        if self.layout is not None:
            return self.layout.norm(self._named_grads(params))
        return self.inner.grad_norm(params, state)

    def update(self, params, state) -> None:
        self.inner.update(params, state, norm_fn=self._norm_fn(params))


@dataclasses.dataclass
class ZeroState:
    """A sharded optimizer state: the inner state over this rank's
    shards (a tree shaped like the params, each leaf ``[cols]``)."""

    inner: Any
    layout: Zero1Layout
    shards: list
    mesh: Any = None

    @property
    def count(self) -> int:
        return self.inner.count

    @property
    def leaves(self) -> list:
        return self.shards

    @property
    def ema(self):
        """The EMA shadow in parameter layout (gathered), or None."""
        if self.inner.ema is None:
            return None
        return gather_tree(self.layout, tree_leaves(self.inner.ema),
                           self.mesh)


def gather_tree(layout: Zero1Layout, shards, mesh):
    """Per-leaf ``[cols]`` shards of every rank -> the full tree."""
    full = [all_gather(r, mesh) for r in layout.pack_rows(shards)]
    return layout.unflatten(layout.unpack(full))


class ZeroOptimizer(DPOptimizer):
    """ZeRO-1: the optimizer state lives over this rank's ``[cols]``
    chunk of every leaf; ``exchange`` reduce-scatters the gradient
    buckets (the mean), ``update`` steps the shards and all-gathers the
    new parameters.  ``perms``: per leaf a permutation into the
    reference's layout (Keras kernels)."""

    def __init__(self, inner, mesh, bucket_mb: float = DEFAULT_BUCKET_MB,
                 perms=None):
        super().__init__(inner, mesh)
        self.bucket_mb = bucket_mb
        self.perms = perms

    def layout_for(self, params) -> Zero1Layout:
        return Zero1Layout.for_tree(params, self.mesh.size, self.bucket_mb,
                                    perms=self.perms)

    def init(self, params) -> ZeroState:
        layout = self.layout_for(params)
        record_layout(layout)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        with torch.no_grad():
            shards = [v[self.mesh.rank].clone()
                      for v in layout.shard_views(leaves)]
        inner = self.inner.init(layout.unflatten(shards))
        return ZeroState(inner, layout, shards, self.mesh)

    def exchange(self, params, state: ZeroState) -> None:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in tree_leaves(params)]
        rows = [true_div(scatter(b, self.mesh), self.mesh.size)
                for b in state.layout.pack(grads)]
        self.set_shard_grads(state, rows)

    @staticmethod
    def set_shard_grads(state: ZeroState, rows) -> None:
        for s, g in zip(state.shards, state.layout.rows_to_shards(rows)):
            s.grad = g

    def grad_norm(self, params, state: ZeroState):
        return dist_norm([s.grad for s in state.shards], self.mesh)

    def step_shards(self, state: ZeroState) -> None:
        """The inner update on the shards (a clip reads the global
        norm over the group)."""
        self.inner.update(state.layout.unflatten(state.shards), state.inner,
                          norm_fn=lambda gs: dist_norm(gs, self.mesh))

    def update(self, params, state: ZeroState) -> None:
        self.step_shards(state)
        with torch.no_grad():
            full = [all_gather(r, self.mesh)
                    for r in state.layout.pack_rows(state.shards)]
            for p, v in zip(tree_leaves(params), state.layout.unpack(full)):
                p.copy_(v)
        for p in tree_leaves(params):
            p.grad = None


def zero1_validate(mesh, spec, axis: str = "data") -> None:
    """Stage-1 spelling of :func:`zero_validate` (the reference keeps it
    for the exchange layer's call sites)."""
    zero_validate(mesh, spec, axis=axis, stage=1)


def zero1_shard_shapes(params, n: int) -> frozenset:
    """The ``[n, cols]`` shapes ZeRO-1 optimizer-state leaves take for
    this parameter tree (the shard views of :class:`Zero1Layout`)."""
    return Zero1Layout.for_tree(params, n).shard_shapes


def zero1_optimizer(inner, mesh, bucket_mb: float = DEFAULT_BUCKET_MB,
                    perms=None) -> ZeroOptimizer:
    """ZeRO-1 wrap of an elementwise optimizer."""
    return ZeroOptimizer(inner, mesh, bucket_mb, perms)


def zero1_enable(inner, mesh, spec=None, bucket_mb: float | None = None,
                 stage: int = 1, perms=None) -> ZeroOptimizer:
    """Validate a trainer's ZeRO configuration and return the wrapped
    optimizer (the trainers' one enablement path)."""
    zero_validate(mesh, spec if spec is not None else inner, stage=stage)
    return ZeroOptimizer(inner, mesh,
                         DEFAULT_BUCKET_MB if bucket_mb is None else bucket_mb,
                         perms)


__all__ = ["Zero1Layout", "scatter", "reduce_scatter", "all_gather",
           "all_reduce", "gather_bucket", "adasum_reduce", "dist_norm",
           "zero_validate", "zero1_optimizer", "zero1_enable",
           "DPOptimizer", "DataParallel", "ZeroOptimizer", "ZeroState",
           "gather_tree", "true_div", "DEFAULT_BUCKET_MB", "gather_dim",
           "scatter_dim", "gather_on_use", "copy_to_group",
           "reduce_from_group", "ppermute", "from_rank", "count_once",
           "exchange_rows", "sum_over_group", "zero1_validate",
           "zero1_shard_shapes"]

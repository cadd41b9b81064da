"""Training state <-> checkpoint trees, for every trainer of the port.

A checkpoint holds the *full* training state as a tree of tensors and
Python values (``checkpoint.CheckpointManager`` writes it as numpy host
arrays): what a trainer of one process holds, whatever the sharding it
trained under.

- **Optimizer state** (:func:`opt_tree`): ``{"count", "slots", "ema"}``
  with ``slots`` the torch optimizer's per-leaf state (moments, step
  counters) keyed by the leaf's key path (``"layers/attn/wq"``, ``"0"``)
  and ``ema`` the EMA shadow by key path.  A ZeRO state's ``[cols]``
  shards are gathered into parameter-shaped moments (``gather_tree``),
  so a ZeRO checkpoint reads like a replicated one, and restore cuts
  each rank's shard back out of them by its layout.  An exchange state
  adds its error-feedback residuals ``e1`` / ``e2``, which are this
  rank's own and so are stacked over the ranks (``[n, ...]``), and its
  ``residual_norm``.  Under a placed tree (``parallel/layout.py``) each
  moment and the EMA are gathered whole by their leaf's spec, and
  restore cuts this rank's slices back out.
- **Per-rank state** (:func:`stack_tree` / :func:`unstack_tree`): a
  replica's state (the replica family) and a rank's dropout generator
  differ by rank; each tensor leaf is stacked ``[n, ...]`` over the
  group (``all_gather``) and each rank takes row ``rank`` back.

Gathering is a collective: every rank of a group builds the tree, rank
0 writes it.

**The local-shard tree** (``local=True``, the sharded backend's): the
same tree, gathering nothing.  Each leaf that would be gathered is this
rank's :class:`~distkeras_tpu_torch.checkpoint.Piece` of the global
leaf: a ZeRO state's ``[cols]`` shards with the layout's padding dropped
(:func:`zero_pieces`), a placed leaf's local slice by its spec
(:func:`placed_tree`), a per-rank leaf as this rank's row of the
``[n, ...]`` stack; replicated leaves stay tensors, which rank 0 writes.
Assembled from every rank's pieces it is the gathered tree, leaf for
leaf.  The loaders take either tree, and a lazily restored one
(:class:`~distkeras_tpu_torch.checkpoint.StoredLeaf` leaves): each rank
reads only the pieces it needs when the layout is the one saved, and
otherwise assembles the whole leaf and cuts its part out, as from a
gathered tree.
"""

from __future__ import annotations

import numpy as np
import torch

from distkeras_tpu_torch.checkpoint import Piece, StoredLeaf
from distkeras_tpu_torch.models.transformer import named_leaves
from distkeras_tpu_torch.parallel.collectives import (ZeroState, all_gather,
                                                      gather_tree)
from distkeras_tpu_torch.parallel.exchange import ExchangeState
from distkeras_tpu_torch.parallel.tree import (leaf_names,
                                               tree_flatten_with_names,
                                               tree_leaves, tree_unflatten)


def _comm_device(mesh, t):
    """Where ``t`` must live for a collective of ``mesh`` (NCCL takes
    device tensors only; a generator's state is a CPU tensor)."""
    if mesh.group is not None and mesh.backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return t.device


def gather_stack(t, mesh):
    """Every rank's ``t``, stacked ``[n, *t.shape]`` in rank order."""
    t = t.detach()
    if mesh.group is None:
        return t[None].clone()
    rows = all_gather(t.reshape(-1).to(_comm_device(mesh, t)), mesh)
    return rows.to(t.device).reshape(mesh.size, *t.shape)


def stack_tree(tree, mesh, local: bool = False):
    """Each tensor leaf stacked over the ranks (``local``: this rank's
    row of the stack); other values (counts, None) are alike on every
    rank and kept as they are."""
    if isinstance(tree, dict):
        return {k: stack_tree(v, mesh, local) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(stack_tree(v, mesh, local) for v in tree)
    if isinstance(tree, torch.Tensor):
        if local:
            return Piece.row(tree.detach(), mesh.rank, mesh.size)
        return gather_stack(tree, mesh)
    return tree


def row_of(stacked, rank: int):
    """Row ``rank`` of a stacked leaf (a lazily restored one reads that
    row alone)."""
    if isinstance(stacked, StoredLeaf):
        return stacked.row(rank)
    return stacked[rank]


def unstack_tree(tree, rank: int):
    """Inverse of :func:`stack_tree` for rank ``rank``."""
    if isinstance(tree, dict):
        return {k: unstack_tree(v, rank) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(unstack_tree(v, rank) for v in tree)
    if isinstance(tree, (torch.Tensor, StoredLeaf)):
        return row_of(tree, rank)
    return tree


def whole(v):
    """A restored leaf as one tensor (a lazily restored one assembled)."""
    return v.full() if isinstance(v, StoredLeaf) else v


# --------------------------------------------------- ZeRO and placed pieces


def _zero_range(slot, rank: int) -> tuple[int, int]:
    """The elements of the (permuted, flattened) leaf in this rank's
    ``[cols]`` shard, its padding left out."""
    a = rank * slot.cols
    return a, max(a, min(a + slot.cols, slot.size))


def zero_pieces(layout, shards, rank: int) -> list:
    """This rank's ``[cols]`` shard of each leaf of ``layout`` as a piece
    of the leaf (the padding dropped)."""
    out = []
    for slot, v in zip(layout.slots, shards):
        a, b = _zero_range(slot, rank)
        shape = slot.shape if slot.perm is None else tuple(
            slot.shape[d] for d in np.argsort(slot.perm))
        out.append(Piece(v.detach()[:b - a], shape, flat=(a, b),
                         perm=slot.perm))
    return out


def zero_cut(layout, slot, v, rank: int):
    """This rank's ``[cols]`` shard (zero padded) of the restored leaf
    ``v``."""
    if not isinstance(v, StoredLeaf):
        return layout.leaf_view(slot, v)[rank]
    a, b = _zero_range(slot, rank)
    x = v.read({"flat": [a, b]}, slot.perm)
    return torch.cat([x, x.new_zeros(slot.cols - (b - a))])


def _placed_where(layout, name: str) -> tuple:
    sharding, full = layout.shardings[name], layout.full_shapes[name]
    index = []
    for d, size in enumerate(full):
        i, count = sharding.chunk(d)
        k = size // count
        index.append((i * k, (i + 1) * k))
    return full, tuple(index)


def placed_piece(layout, name: str, v) -> Piece:
    """This rank's slice ``v`` of leaf ``name`` of a placed tree."""
    full, index = _placed_where(layout, name)
    return Piece(v.detach(), full, index=index)


def placed_tree(layout, tree):
    """Every leaf of this rank's slices ``tree`` as its piece."""
    named, spec = tree_flatten_with_names(tree)
    return tree_unflatten(spec, [placed_piece(layout, n, v)
                                 for n, v in named])


def local_leaf(layout, name: str, v):
    """This rank's slice of the restored leaf ``v`` under ``layout``."""
    if isinstance(v, StoredLeaf):
        _, index = _placed_where(layout, name)
        return v.read({"index": [list(ab) for ab in index]})
    return layout.local_leaf(name, v)


def local_tree(layout, tree):
    """This rank's slices of the restored full ``tree``."""
    named, spec = tree_flatten_with_names(tree)
    return tree_unflatten(spec, [local_leaf(layout, n, v)
                                 for n, v in named])


# ------------------------------------------------------- optimizer state


def _is_moment(v) -> bool:
    """A per-element slot (shaped like its leaf), not a step counter."""
    if isinstance(v, StoredLeaf):
        return len(v.shape) > 0
    return isinstance(v, torch.Tensor) and v.dim() > 0


def _slot_value(v, like):
    """A restored slot on its live leaf's device and dtype (the policy of
    ``torch.optim.Optimizer.load_state_dict``); counters stay as they
    were saved (Adam's ``step`` is a CPU float32 tensor)."""
    if _is_moment(v):
        return v.to(device=like.device, dtype=like.dtype).clone()
    return whole(v)


def _plain_tree(state, params, layout=None, local=False) -> dict:
    names = {id(t): n for n, t in named_leaves(params)}
    if layout is None:
        full = (lambda n, v: v)
    else:
        full = (lambda n, v: placed_piece(layout, n, v)) if local \
            else layout.gather_leaf
    slots = {}
    for p in state.leaves:
        st = state.torch_opt.state.get(p)
        if st:
            n = names[id(p)]
            slots[n] = {k: full(n, v) if _is_moment(v) else v
                        for k, v in st.items()}
    ema = None if state.ema is None else {
        n: full(n, v) for n, v in named_leaves(state.ema)}
    return {"count": state.count, "slots": slots, "ema": ema}


def _load_plain(state, params, tree, layout=None) -> None:
    names = {id(t): n for n, t in named_leaves(params)}
    if layout is None:
        cut = (lambda n, v: whole(v))
    else:
        cut = (lambda n, v: local_leaf(layout, n, v))
    state.count = tree["count"]
    opt = state.torch_opt
    for p in state.leaves:
        n = names[id(p)]
        st = tree["slots"].get(n)
        if st is not None:
            opt.state[p] = {k: _slot_value(cut(n, v) if _is_moment(v)
                                           else v, p)
                            for k, v in st.items()}
    if state.ema is not None:
        saved = tree["ema"]
        with torch.no_grad():
            for n, s in named_leaves(state.ema):
                s.copy_(cut(n, saved[n]))


def _zero_names(zs: ZeroState) -> list:
    return leaf_names(zs.layout.unflatten(list(range(len(zs.layout.slots)))))


def _zero_tree(zs: ZeroState, local: bool = False) -> dict:
    """The ZeRO inner state over the shards, gathered into parameter
    shape (a collective), or as this rank's pieces (``local``)."""
    layout, names = zs.layout, _zero_names(zs)
    if local:
        def full(vals):
            return zero_pieces(layout, vals, zs.mesh.rank)
    else:
        def full(vals):
            return tree_leaves(gather_tree(layout, vals, zs.mesh))
    per = [zs.inner.torch_opt.state.get(s, {}) for s in zs.shards]
    slots = [dict() for _ in per]
    for k in (per[0] if per else {}):
        if _is_moment(per[0][k]):
            for i, v in enumerate(full([st[k] for st in per])):
                slots[i][k] = v
        else:
            for i, st in enumerate(per):
                slots[i][k] = st[k]
    ema = None
    if zs.inner.ema is not None:
        ema = dict(zip(names, full(tree_leaves(zs.inner.ema))))
    return {"count": zs.inner.count,
            "slots": {n: s for n, s in zip(names, slots) if s},
            "ema": ema}


def _load_zero(zs: ZeroState, tree, full_params) -> None:
    layout, names, rank = zs.layout, _zero_names(zs), zs.mesh.rank
    with torch.no_grad():
        if full_params is not None:
            for slot, s, n in zip(layout.slots, zs.shards, names):
                s.copy_(zero_cut(layout, slot, full_params[n], rank))
        zs.inner.count = tree["count"]
        saved = [tree["slots"].get(n) for n in names]
        if all(st is not None for st in saved):
            opt = zs.inner.torch_opt
            for k, v0 in saved[0].items():
                if _is_moment(v0):
                    cut = [zero_cut(layout, slot, st[k], rank)
                           for slot, st in zip(layout.slots, saved)]
                else:
                    cut = [st[k] for st in saved]
                for s, v in zip(zs.shards, cut):
                    opt.state[s][k] = _slot_value(v, s)
        if zs.inner.ema is not None:
            for slot, s, n in zip(layout.slots, tree_leaves(zs.inner.ema),
                                  names):
                s.copy_(zero_cut(layout, slot, tree["ema"][n], rank))


def opt_tree(opt_state, params, mesh, layout=None,
             local: bool = False) -> dict | None:
    """The full tree of ``opt_state`` (an ``OptState`` over ``params``,
    a ``ZeroState``, or an ``ExchangeState``); None for no state.
    ``layout``: the placement of ``params`` (its moments gathered);
    ``local``: the local-shard tree (nothing gathered)."""
    if opt_state is None:
        return None
    if isinstance(opt_state, ExchangeState):
        if opt_state.shards is not None:
            inner = _zero_tree(ZeroState(opt_state.inner, opt_state.layout,
                                         opt_state.shards, mesh), local)
        else:
            inner = _plain_tree(opt_state.inner, params)
        return {"inner": inner,
                "e1": stack_tree(list(opt_state.e1), mesh, local),
                "e2": stack_tree(list(opt_state.e2), mesh, local),
                "residual_norm": opt_state.residual_norm.detach().clone()}
    if isinstance(opt_state, ZeroState):
        return _zero_tree(opt_state, local)
    return _plain_tree(opt_state, params, layout, local)


def load_opt_tree(opt_state, params, tree, mesh, full_params=None,
                  layout=None) -> None:
    """Load ``tree`` (from :func:`opt_tree`) into the fresh ``opt_state``
    in place.  ``full_params``: the restored parameters by key path, for
    a ZeRO state's parameter shards; ``layout``: the placement of
    ``params`` (each moment cut to this rank's slice)."""
    if opt_state is None:
        return
    if isinstance(opt_state, ExchangeState):
        if opt_state.shards is not None:
            _load_zero(ZeroState(opt_state.inner, opt_state.layout,
                                 opt_state.shards, mesh), tree["inner"],
                       full_params)
        else:
            _load_plain(opt_state.inner, params, tree["inner"])
        dev = opt_state.residual_norm.device
        opt_state.e1 = [row_of(e, mesh.rank).to(dev).clone()
                        for e in tree["e1"]]
        opt_state.e2 = [row_of(e, mesh.rank).to(dev).clone()
                        for e in tree["e2"]]
        opt_state.residual_norm = whole(tree["residual_norm"]).to(
            dev).clone()
        return
    if isinstance(opt_state, ZeroState):
        _load_zero(opt_state, tree, full_params)
        return
    _load_plain(opt_state, params, tree, layout)


def copy_leaves(dst, src) -> None:
    """Copy each leaf of tree ``src`` into the live leaf of ``dst`` at
    the same key path (device and dtype are ``dst``'s)."""
    saved = dict(named_leaves(src))
    with torch.no_grad():
        for name, d in named_leaves(dst):
            d.copy_(whole(saved[name]))


__all__ = ["opt_tree", "load_opt_tree", "stack_tree", "unstack_tree",
           "gather_stack", "copy_leaves", "row_of", "whole", "zero_pieces",
           "zero_cut", "placed_piece", "placed_tree", "local_leaf",
           "local_tree"]

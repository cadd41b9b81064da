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
  ``residual_norm``.
- **Per-rank state** (:func:`stack_tree` / :func:`unstack_tree`): a
  replica's state (the replica family) and a rank's dropout generator
  differ by rank; each tensor leaf is stacked ``[n, ...]`` over the
  group (``all_gather``) and each rank takes row ``rank`` back.

Gathering is a collective: every rank of a group builds the tree, rank
0 writes it.
"""

from __future__ import annotations

import torch

from distkeras_tpu_torch.models.transformer import named_leaves
from distkeras_tpu_torch.parallel.collectives import (ZeroState, all_gather,
                                                      gather_tree)
from distkeras_tpu_torch.parallel.exchange import ExchangeState
from distkeras_tpu_torch.parallel.tree import leaf_names, tree_leaves


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


def stack_tree(tree, mesh):
    """Each tensor leaf stacked over the ranks; other values (counts,
    None) are alike on every rank and kept as they are."""
    if isinstance(tree, dict):
        return {k: stack_tree(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(stack_tree(v, mesh) for v in tree)
    if isinstance(tree, torch.Tensor):
        return gather_stack(tree, mesh)
    return tree


def unstack_tree(tree, rank: int):
    """Inverse of :func:`stack_tree` for rank ``rank``."""
    if isinstance(tree, dict):
        return {k: unstack_tree(v, rank) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(unstack_tree(v, rank) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree[rank]
    return tree


# ------------------------------------------------------- optimizer state


def _is_moment(v) -> bool:
    """A per-element slot (shaped like its leaf), not a step counter."""
    return isinstance(v, torch.Tensor) and v.dim() > 0


def _slot_value(v, like):
    """A restored slot on its live leaf's device and dtype (the policy of
    ``torch.optim.Optimizer.load_state_dict``); counters stay as they
    were saved (Adam's ``step`` is a CPU float32 tensor)."""
    if _is_moment(v):
        return v.to(device=like.device, dtype=like.dtype).clone()
    return v


def _plain_tree(state, params) -> dict:
    names = {id(t): n for n, t in named_leaves(params)}
    slots = {}
    for p in state.leaves:
        st = state.torch_opt.state.get(p)
        if st:
            slots[names[id(p)]] = dict(st)
    ema = None if state.ema is None else dict(named_leaves(state.ema))
    return {"count": state.count, "slots": slots, "ema": ema}


def _load_plain(state, params, tree) -> None:
    names = {id(t): n for n, t in named_leaves(params)}
    state.count = tree["count"]
    opt = state.torch_opt
    for p in state.leaves:
        st = tree["slots"].get(names[id(p)])
        if st is not None:
            opt.state[p] = {k: _slot_value(v, p) for k, v in st.items()}
    if state.ema is not None:
        saved = tree["ema"]
        with torch.no_grad():
            for n, s in named_leaves(state.ema):
                s.copy_(saved[n])


def _zero_names(zs: ZeroState) -> list:
    return leaf_names(zs.layout.unflatten(list(range(len(zs.layout.slots)))))


def _zero_tree(zs: ZeroState) -> dict:
    """The ZeRO inner state over the shards, gathered into parameter
    shape (a collective)."""
    layout, names = zs.layout, _zero_names(zs)
    per = [zs.inner.torch_opt.state.get(s, {}) for s in zs.shards]
    slots = [dict() for _ in per]
    for k in (per[0] if per else {}):
        if _is_moment(per[0][k]):
            full = tree_leaves(gather_tree(layout, [st[k] for st in per],
                                           zs.mesh))
            for i, v in enumerate(full):
                slots[i][k] = v
        else:
            for i, st in enumerate(per):
                slots[i][k] = st[k]
    ema = None
    if zs.inner.ema is not None:
        ema = dict(zip(names, tree_leaves(gather_tree(
            layout, tree_leaves(zs.inner.ema), zs.mesh))))
    return {"count": zs.inner.count,
            "slots": {n: s for n, s in zip(names, slots) if s},
            "ema": ema}


def _rank_views(layout, full: list, rank: int) -> list:
    """This rank's ``[cols]`` shard of each full leaf."""
    return [v[rank] for v in layout.shard_views(full)]


def _load_zero(zs: ZeroState, tree, full_params) -> None:
    layout, names, rank = zs.layout, _zero_names(zs), zs.mesh.rank
    with torch.no_grad():
        if full_params is not None:
            full = [full_params[n] for n in names]
            for s, v in zip(zs.shards, _rank_views(layout, full, rank)):
                s.copy_(v)
        zs.inner.count = tree["count"]
        saved = [tree["slots"].get(n) for n in names]
        if all(st is not None for st in saved):
            opt = zs.inner.torch_opt
            for k, v0 in saved[0].items():
                if _is_moment(v0):
                    cut = _rank_views(layout, [st[k] for st in saved], rank)
                else:
                    cut = [st[k] for st in saved]
                for s, v in zip(zs.shards, cut):
                    opt.state[s][k] = _slot_value(v, s)
        if zs.inner.ema is not None:
            cut = _rank_views(layout, [tree["ema"][n] for n in names], rank)
            for s, v in zip(tree_leaves(zs.inner.ema), cut):
                s.copy_(v)


def opt_tree(opt_state, params, mesh) -> dict | None:
    """The full tree of ``opt_state`` (an ``OptState`` over ``params``,
    a ``ZeroState``, or an ``ExchangeState``); None for no state."""
    if opt_state is None:
        return None
    if isinstance(opt_state, ExchangeState):
        if opt_state.shards is not None:
            inner = _zero_tree(ZeroState(opt_state.inner, opt_state.layout,
                                         opt_state.shards, mesh))
        else:
            inner = _plain_tree(opt_state.inner, params)
        return {"inner": inner,
                "e1": [gather_stack(e, mesh) for e in opt_state.e1],
                "e2": [gather_stack(e, mesh) for e in opt_state.e2],
                "residual_norm": opt_state.residual_norm.detach().clone()}
    if isinstance(opt_state, ZeroState):
        return _zero_tree(opt_state)
    return _plain_tree(opt_state, params)


def load_opt_tree(opt_state, params, tree, mesh, full_params=None) -> None:
    """Load ``tree`` (from :func:`opt_tree`) into the fresh ``opt_state``
    in place.  ``full_params``: the restored parameters by key path, for
    a ZeRO state's parameter shards."""
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
        opt_state.e1 = [e[mesh.rank].to(dev).clone() for e in tree["e1"]]
        opt_state.e2 = [e[mesh.rank].to(dev).clone() for e in tree["e2"]]
        opt_state.residual_norm = tree["residual_norm"].to(dev).clone()
        return
    if isinstance(opt_state, ZeroState):
        _load_zero(opt_state, tree, full_params)
        return
    _load_plain(opt_state, params, tree)


def copy_leaves(dst, src) -> None:
    """Copy each leaf of tree ``src`` into the live leaf of ``dst`` at
    the same key path (device and dtype are ``dst``'s)."""
    saved = dict(named_leaves(src))
    with torch.no_grad():
        for name, d in named_leaves(dst):
            d.copy_(saved[name])


__all__ = ["opt_tree", "load_opt_tree", "stack_tree", "unstack_tree",
           "gather_stack", "copy_leaves"]

"""A parameter tree placed over the mesh, and how the trunk runs it.

The reference places each leaf by its ``PartitionSpec`` and lets GSPMD
insert the collectives.  The port runs one process per device, so a
:class:`Layout` makes them explicit:

- **Placement** (:meth:`Layout.shard`): each process holds the slice of
  every full leaf that ``NamedSharding(mesh, spec).local`` cuts, the
  slice the reference's ``jax.device_put`` puts on its device.  A tree
  of such slices is a :class:`Sharded` dict that carries its layout.
- **Native splits**: under the Megatron layout (``tp_rules``) the trunk
  consumes the model axis's split directly — each rank's attention runs
  its own heads (the flash kernel on ``[B, S, H/m, D]``), each FFN its
  own columns of ``d_ff`` — with one all-reduce pair a block
  (:class:`ModelAxis`: Megatron's f and g).  That holds when ``wq`` /
  ``wk`` / ``wv`` split heads (dim 2) and ``wo`` dim 1 over ``model``,
  and for the FFN when ``w1`` splits dim 2 and ``w2`` dim 1.
- **Gather on use** (:meth:`Layout.views`): every other split is
  all-gathered when the tree is used, with the gradient reduce-scattered
  back (``collectives.gather_on_use``): the embeddings under
  ``tp_rules``, every leaf's FSDP dimension, a user rule's split of any
  other dimension.  Over the data axis the gradient is summed (the
  ranks' rows differ); over the model axis, whose ranks compute alike
  outside their native blocks, it is this rank's block.

:func:`views` is the trunk's one entry: a :class:`Sharded` tree becomes
its compute view (a :class:`Views` dict with the ``tp`` handle), a view
or an unplaced tree passes through.  MoE under a mesh above 1 is
ROADMAP A7b.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from distkeras_tpu_torch.parallel import collectives as C
from distkeras_tpu_torch.parallel.mesh import Mesh
from distkeras_tpu_torch.parallel.rules import NamedSharding, P, _axes_of
from distkeras_tpu_torch.parallel.tree import (tree_flatten_with_names,
                                               tree_unflatten)

# The leaves the trunk consumes split, and the dimension it splits them
# on: attention by heads, the FFN by the columns of d_ff.
_NATIVE = {
    "attn": {"layers/attn/wq": 2, "layers/attn/wk": 2, "layers/attn/wv": 2,
             "layers/attn/wo": 1},
    "ffn": {"layers/ffn/w1": 2, "layers/ffn/w2": 1},
}


class Sharded(dict):
    """A params tree holding this process's slices, with their
    :class:`Layout` (``.layout``)."""

    def __init__(self, tree, layout: "Layout"):
        super().__init__(tree)
        self.layout = layout


class Views(dict):
    """The compute view of a :class:`Sharded` tree: native splits local,
    everything else whole; ``tp`` is the :class:`ModelAxis` (or None)."""

    tp = None


@dataclasses.dataclass(frozen=True, eq=False)
class ModelAxis:
    """The model axis as the trunk sees it: its one-axis ``mesh`` and
    which blocks run split (``attn``, ``ffn``)."""

    mesh: Mesh
    attn: bool
    ffn: bool

    def enter(self, x, on: bool):
        """f: the input of a split block (the gradient all-reduced)."""
        return C.copy_to_group(x, self.mesh) if on else x

    def leave(self, y, on: bool):
        """g: the all-reduce of a split block's partial output."""
        return C.reduce_from_group(y, self.mesh) if on else y


def _only_at(spec, dim: int, axis: str) -> bool:
    entries = tuple(spec)
    at = [d for d, e in enumerate(entries) if axis in _axes_of(e)]
    return at == [dim] and _axes_of(entries[dim]) == (axis,)


class Layout:
    """Every leaf's spec under ``plan`` over ``mesh``, from ``tree`` (the
    full leaves, or anything with their ``shape``)."""

    def __init__(self, plan, mesh: Mesh, tree):
        self.plan, self.mesh = plan, mesh
        named, self._spec = tree_flatten_with_names(tree)
        self.names = [n for n, _ in named]
        self.full_shapes = {n: tuple(x.shape) for n, x in named}
        self.specs = {n: plan.spec_for(n, shape=self.full_shapes[n],
                                       mesh=mesh) for n in self.names}
        self.shardings = {n: NamedSharding(mesh, s)
                          for n, s in self.specs.items()}
        if mesh.world_size > 1 and any(n.startswith("layers/moe/")
                                       for n in self.names):
            raise NotImplementedError(
                "MoE under a mesh above 1 is not ported yet (ROADMAP "
                "A7b, expert parallelism): its dispatch and aux loss "
                "are global-batch computations")
        native, on = {}, {}
        if int(mesh.shape["model"]) > 1:
            for block, dims in _NATIVE.items():
                on[block] = all(
                    n in self.specs and _only_at(self.specs[n], d, "model")
                    for n, d in dims.items())
                if on[block]:
                    native.update(dims)
        self.native = native
        self.tp = (ModelAxis(mesh.sub("model"), on.get("attn", False),
                             on.get("ffn", False)) if native else None)
        # Per leaf, the (dim, axis) gathers of its compute view: an
        # entry's axes minor first (JAX orders them major first).
        self.gathers = {}
        for n in self.names:
            ops = []
            for d, entry in enumerate(tuple(self.specs[n])):
                for ax in reversed(_axes_of(entry)):
                    if int(mesh.shape[ax]) == 1:
                        continue
                    if ax == "model" and native.get(n) == d:
                        continue
                    ops.append((d, ax))
            self.gathers[n] = ops

    # --------------------------------------------------------- placement

    def splits_data(self, name: str) -> bool:
        """Does ``name`` split over the data axis (so its gathered
        gradient arrives summed over the data ranks)?"""
        return int(self.mesh.shape["data"]) > 1 and any(
            "data" in _axes_of(e) for e in tuple(self.specs[name]))

    def replication(self, name: str) -> int:
        """How many processes hold each element of ``name``."""
        split = math.prod(int(self.mesh.shape[a])
                          for e in tuple(self.specs[name])
                          for a in _axes_of(e))
        return self.mesh.world_size // split

    def local_leaf(self, name: str, full):
        return self.shardings[name].local(full)

    def view_leaf(self, name: str, full):
        """The compute view's value of ``name`` from its full leaf: this
        rank's block along a native split, whole elsewhere."""
        d = self.native.get(name)
        if d is None:
            return full
        spec = [None] * (d + 1)
        spec[d] = "model"
        return NamedSharding(self.mesh, P(*spec)).local(full)

    def shard(self, tree):
        """This process's slices of the full ``tree`` (tensors: fresh
        contiguous copies); a dict comes back :class:`Sharded`."""
        named, spec = tree_flatten_with_names(tree)
        out = []
        for n, x in named:
            sl = self.local_leaf(n, x)
            out.append(sl.detach().contiguous().clone() if torch.is_tensor(sl)
                       else sl)
        out = tree_unflatten(spec, out)
        return Sharded(out, self) if isinstance(out, dict) else out

    def gather_leaf(self, name: str, x):
        """The full leaf from this process's slice (every split, native
        ones included; a collective over the split axes)."""
        x = x.detach()
        for d, entry in enumerate(tuple(self.specs[name])):
            for ax in reversed(_axes_of(entry)):
                x = C.gather_dim(x, d, self.mesh.sub(ax))
        return x

    def gather(self, tree) -> dict:
        """The full tree (plain dicts) from this process's slices."""
        named, spec = tree_flatten_with_names(tree)
        return tree_unflatten(spec, [self.gather_leaf(n, x)
                                     for n, x in named])

    def views(self, tree) -> Views:
        """The compute view: non-native splits gathered on use (the
        gradient reduce-scattered back), native splits local."""
        named, spec = tree_flatten_with_names(tree)
        out = []
        for n, x in named:
            for d, ax in self.gathers[n]:
                x = C.gather_on_use(x, d, self.mesh.sub(ax),
                                    summed=ax != "model")
            out.append(x)
        out = tree_unflatten(spec, out)
        if not isinstance(out, dict):
            return out
        v = Views(out)
        v.tp = self.tp
        return v

    def norm(self, named_grads):
        """The global L2 norm of a sharded gradient tree (``[(name,
        grad)]``): each element counted once over the whole grid."""
        terms = [g.float().square().sum() / self.replication(n)
                 for n, g in named_grads if g is not None]
        sq = torch.stack(terms).sum() if terms else torch.zeros(())
        return torch.sqrt(C.all_reduce(sq, self.mesh.whole()))


class SpecList:
    """A plan over a list of leaves, leaf ``i`` (named ``"i"``) placed by
    ``specs[i]``."""

    def __init__(self, specs):
        self.specs = list(specs)

    def spec_for(self, path: str, shape=None, mesh=None):
        return self.specs[int(path)]


def views(params):
    """The compute view of ``params``: a :class:`Sharded` tree's
    :meth:`Layout.views`, anything else as it is."""
    if isinstance(params, Sharded):
        return params.layout.views(params)
    return params


def tp_of(params) -> ModelAxis | None:
    """The model-axis handle of a compute view (None when unsplit)."""
    return getattr(params, "tp", None)


def place(params, plan, mesh) -> Sharded:
    """``params`` (full leaves) placed under ``plan`` over ``mesh``."""
    return Layout(plan, mesh, params).shard(params)


__all__ = ["Layout", "Sharded", "Views", "ModelAxis", "SpecList", "views",
           "tp_of", "place"]

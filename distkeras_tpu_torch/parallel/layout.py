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
  other dimension.  Over the data and seq axes the gradient is summed
  (the ranks' tokens differ); over the model and expert axes, whose
  ranks compute alike outside their native blocks, it is this rank's
  block.
- **Stages and experts**: under a pipeline axis every ``layers/`` leaf
  splits its stacked ``[L]`` dimension over ``pipeline`` (a rank holds
  its stage's layers, which ``apply_pipelined`` runs), and the MoE
  experts (``moe/w1`` / ``moe/w2`` dimension 1 over ``expert``, as
  ``tp_rules`` places them) stay local: each rank runs its own experts
  on the slots its token group fills (``models/transformer.py::
  _moe_block``), and each expert's ``d_ff`` splits over ``model`` like
  the FFN's.

:func:`views` is the trunk's one entry: a :class:`Sharded` tree becomes
its compute view (a :class:`Views` dict with the ``tp`` / ``ep`` / ``pp``
handles and the ``mesh``), a view or an unplaced tree passes through.
:meth:`Layout.reduce_grads` finishes a step's exchange over the axes
beyond ``data``: the gradients averaged over ``seq`` (its ranks hold
different tokens) and the leaves the pipeline does not split summed over
``pipeline`` (the embeddings' lookup on stage 0, the head on the last).
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
    "moe": {"layers/moe/w1": 3, "layers/moe/w2": 2},
}
# The MoE experts' dimension, local over the expert axis.
_EXPERT = {"layers/moe/w1": 1, "layers/moe/w2": 1}


class Sharded(dict):
    """A params tree holding this process's slices, with their
    :class:`Layout` (``.layout``)."""

    def __init__(self, tree, layout: "Layout"):
        super().__init__(tree)
        self.layout = layout


class Views(dict):
    """The compute view of a :class:`Sharded` tree: native splits local,
    everything else whole; ``tp`` is the :class:`ModelAxis` (or None),
    ``ep`` the expert axis's one-axis mesh when the experts split over
    it, ``pp`` the pipeline axis's when the layers do, ``mesh`` the
    whole mesh."""

    tp = None
    ep = None
    pp = None
    mesh = None


@dataclasses.dataclass(frozen=True, eq=False)
class ModelAxis:
    """The model axis as the trunk sees it: its one-axis ``mesh`` and
    which blocks run split (``attn``, and ``ffn`` for the dense FFN or
    the MoE experts' products)."""

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
    full leaves, or anything with their ``shape``).  ``stages=False``
    keeps the layers whole over a pipeline axis and ``experts=False``
    gathers split experts on use (the serving engines, which run every
    layer and every expert on each rank)."""

    def __init__(self, plan, mesh: Mesh, tree, stages: bool = True,
                 experts: bool = True):
        self.plan, self.mesh = plan, mesh
        self.stages = stages
        named, self._spec = tree_flatten_with_names(tree)
        self.names = [n for n, _ in named]
        self.full_shapes = {n: tuple(x.shape) for n, x in named}
        self.specs = {n: self._stage_split(n, plan.spec_for(
            n, shape=self.full_shapes[n], mesh=mesh)) for n in self.names}
        self.shardings = {n: NamedSharding(mesh, s)
                          for n, s in self.specs.items()}
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
                             on.get("ffn", False) or on.get("moe", False))
                   if native else None)
        self.local = {n: {0: "pipeline"} for n in self.names
                      if stages and int(mesh.shape["pipeline"]) > 1
                      and n.startswith("layers/")}
        self.ep = None
        if experts and int(mesh.shape["expert"]) > 1 and all(
                n in self.specs and _only_at(self.specs[n], d, "expert")
                for n, d in _EXPERT.items()):
            self.ep = mesh.sub("expert")
            for n, d in _EXPERT.items():
                self.local.setdefault(n, {})[d] = "expert"
        self.pp = (mesh.sub("pipeline") if any(
            "pipeline" in cut.values() for cut in self.local.values())
            else None)
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
                    if self.local.get(n, {}).get(d) == ax:
                        continue
                    ops.append((d, ax))
            self.gathers[n] = ops

    def _stage_split(self, name: str, spec):
        """``spec`` with the stacked layer dimension over the pipeline
        axis (a rank holds its stage's layers)."""
        if not self.stages or int(self.mesh.shape["pipeline"]) == 1 \
                or not name.startswith("layers/"):
            return spec
        entries = list(tuple(spec)) or [None]
        if any("pipeline" in _axes_of(e) for e in entries):
            return spec
        if entries[0] is not None:
            raise ValueError(
                f"{name}: the pipeline axis splits the stacked layer "
                f"dimension, which {spec} already places over "
                f"{entries[0]!r}")
        entries[0] = "pipeline"
        return P(*entries)

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
        cut = dict(self.local.get(name, {}))
        if name in self.native:
            cut[self.native[name]] = "model"
        if not cut:
            return full
        spec = [None] * (max(cut) + 1)
        for d, ax in cut.items():
            spec[d] = ax
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
                                    summed=ax in ("data", "seq"))
            out.append(x)
        out = tree_unflatten(spec, out)
        if not isinstance(out, dict):
            return out
        v = Views(out)
        v.tp, v.ep, v.pp, v.mesh = self.tp, self.ep, self.pp, self.mesh
        return v

    def splits(self, name: str, axis: str) -> bool:
        """Does ``name`` split over ``axis``?"""
        return any(axis in _axes_of(e) for e in tuple(self.specs[name]))

    def reduce_grads(self, named, bucket_mb: float = C.DEFAULT_BUCKET_MB):
        """The exchange over the axes beyond ``data`` (``named``: the
        ``[(name, param)]`` with gradients, already merged over the data
        axis): the mean over ``seq``, whose ranks' tokens differ, then
        the sum over ``pipeline`` of every leaf the stages do not split
        (each stage holds its own contribution to it).  The model and
        expert axes need none: their ranks compute alike outside their
        own blocks.  A :class:`SpecList` plan places a Keras model's
        variables, which the trainers replicate over every axis beyond
        ``data`` and ``model``: its ranks there compute alike and need
        none either."""
        if isinstance(self.plan, SpecList):
            return
        for ax, pick, div in (
                ("seq", lambda n: True, True),
                ("pipeline", lambda n: not self.splits(n, "pipeline"),
                 False)):
            sub = self.mesh.sub(ax)
            if sub.size == 1 or (ax == "pipeline" and self.pp is None):
                continue
            leaves = [p for n, p in named if pick(n)]
            if not leaves:
                continue
            grads = [p.grad for p in leaves]
            lay = C.Zero1Layout.for_tree(grads, 1, bucket_mb)
            buckets = [C.all_reduce(b.contiguous(), sub)
                       for b in lay.pack(grads)]
            if div:
                buckets = [C.true_div(b, sub.size) for b in buckets]
            for p, g in zip(leaves, lay.unpack(buckets)):
                p.grad = g

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


def views(params, whole_experts: bool = False):
    """The compute view of ``params``: a :class:`Sharded` tree's
    :meth:`Layout.views`, anything else as it is.  ``whole_experts``:
    experts split over the expert axis are gathered whole here, once, as
    the serving engines hold them (``Layout(experts=False)``), so the
    decode paths never gather them on use."""
    if not isinstance(params, Sharded):
        return params
    lay = params.layout
    if whole_experts and lay.ep is not None:
        shapes = tree_unflatten(lay._spec, [
            torch.empty(lay.full_shapes[n], device="meta")
            for n in lay.names])
        lay = Layout(lay.plan, lay.mesh, shapes, stages=lay.stages,
                     experts=False)
    return lay.views(params)


def tp_of(params) -> ModelAxis | None:
    """The model-axis handle of a compute view (None when unsplit)."""
    return getattr(params, "tp", None)


def place(params, plan, mesh) -> Sharded:
    """``params`` (full leaves) placed under ``plan`` over ``mesh``."""
    return Layout(plan, mesh, params).shard(params)


__all__ = ["Layout", "Sharded", "Views", "ModelAxis", "SpecList", "views",
           "tp_of", "place"]

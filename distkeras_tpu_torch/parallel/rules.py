"""Regex rules over flattened key paths: the framework-free matching.

The port's own copy of the matching half of
``distkeras_tpu/parallel/rules.py``: a rule is ``(pattern, value)``,
``pattern`` a regex searched in the leaf's key path (``"layers/attn/wq"``,
``"0"``), ``value`` a concrete value or a callable ``(name, leaf) ->
value | None`` (``None`` declines and falls through); first match wins,
and an unmatched leaf raises :class:`UnmatchedLeafError` naming it and
its nearest-miss patterns.  The gradient exchange's per-leaf codec
rules (``parallel/exchange.py``) resolve through it.

The sharding half: :class:`P` is the port's ``PartitionSpec`` (a tuple
of mesh-axis names, ``None`` or tuples of names, one entry per leading
dimension), :func:`match_partition_rules` the reference's scalar-guarded
matching, and :func:`tree_shardings` wraps specs into
:class:`NamedSharding`, whose :meth:`~NamedSharding.local` cuts the
slice of a full leaf that the reference's ``jax.device_put`` would place
on this process's device.  :func:`serving_kv_axis` derives the KV
cache's heads axis from a serving plan's attention rules (the
reference's checks and messages), and :func:`kv_slab_specs` /
:func:`kv_slab_shardings` place a cache, a paged slab or a prefix-pool
slab by it.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Sequence

from distkeras_tpu_torch.parallel.tree import (tree_flatten_with_names,
                                               tree_unflatten)


class UnmatchedLeafError(ValueError):
    """No rule matched a leaf (carries the leaf path); the message names
    the 3 nearest misses by match-prefix length."""

    def __init__(self, name: str, what: str, patterns: Sequence[str] = ()):
        self.leaf = name
        near = nearest_patterns(name, patterns)
        near_s = ("; nearest-miss patterns (by match-prefix length): "
                  + ", ".join(repr(p) for p in near)) if near else ""
        super().__init__(
            f"no {what} rule matched leaf {name!r}; rules are ordered "
            "(pattern, value) pairs matched first-match-wins against "
            "the flattened key path — add a rule for this leaf or a "
            f"catch-all ('.*', <default>) at the end{near_s}")


def _pattern_skeleton(pattern: str) -> str:
    """The literal spine of a regex: metacharacters stripped, escapes
    unwrapped."""
    s = re.sub(r"\\([\w/])", r"\1", pattern)
    return re.sub(r"[\^\$\.\*\+\?\(\)\[\]\{\}\|\\]", "", s)


def _miss_score(pattern: str, name: str) -> int:
    """Match-prefix length: the longest prefix of the pattern's literal
    skeleton that occurs in ``name``."""
    skel = _pattern_skeleton(pattern)
    for k in range(len(skel), 0, -1):
        if skel[:k] in name:
            return k
    return 0


def nearest_patterns(name: str, patterns: Sequence[str], n: int = 3):
    """The ``n`` patterns nearest to ``name`` by match-prefix length
    (ties keep rule order); patterns sharing nothing are omitted."""
    pats = [p if isinstance(p, str) else p.pattern for p in patterns]
    scored = sorted((-_miss_score(p, name), i)
                    for i, p in enumerate(pats))
    return [pats[i] for s, i in scored[:n] if s < 0]


_RAISE = object()


def leaf_name(path) -> str:
    """A key path (a sequence of dict keys / indices) rendered the way
    every rule is written against: ``"layers/0/attn/wq"``."""
    if isinstance(path, str):
        return path
    return "/".join(str(k) for k in path)


def _is_concrete(val) -> bool:
    return not (callable(val) and not isinstance(val, type))


def compile_rules(rules: Sequence[tuple[str, Any]]):
    """[(pattern, value)] -> [(compiled, value)], validating eagerly.
    An identical pattern after an earlier one with a concrete value can
    never fire, and raises."""
    claimed: dict[str, bool] = {}
    out = []
    for pat, val in rules:
        if claimed.get(pat):
            raise ValueError(
                f"duplicate pattern {pat!r}: an identical earlier rule "
                "with a concrete value already claims every match "
                "(first-match-wins), so this rule can never fire — "
                "remove one of the two (shard lint rule "
                "`duplicate-pattern`)")
        claimed[pat] = claimed.get(pat, False) or _is_concrete(val)
        out.append((re.compile(pat), val))
    return out


def first_match(compiled, name: str, leaf=None):
    """``(matched, value)`` of the first rule that matches ``name`` and
    accepts the leaf; ``(False, None)`` when none does."""
    for pat, val in compiled:
        if pat.search(name) is None:
            continue
        if callable(val) and not isinstance(val, type):
            out = val(name, leaf)
            if out is None:
                continue
            return True, out
        return True, val
    return False, None


def match_rules(rules: Sequence[tuple[str, Any]], tree, *,
                default: Any = _RAISE, what: str = "partition"):
    """Tree -> same-structure tree of rule values (unmatched leaves
    raise unless ``default`` is given)."""
    compiled = compile_rules(rules)
    named, spec = tree_flatten_with_names(tree)
    out = []
    for name, leaf in named:
        matched, val = first_match(compiled, name, leaf)
        if not matched:
            if default is _RAISE:
                raise UnmatchedLeafError(name, what,
                                         [p.pattern for p, _ in compiled])
            val = default
        out.append(val)
    return tree_unflatten(spec, out)


class P(tuple):
    """The port's ``PartitionSpec``: ``P("data", None)`` names, per
    leading dimension, the mesh axis (or tuple of axes, major first)
    that splits it; trailing dimensions are whole.  ``tuple(P(...))`` is
    ``tuple(jax.sharding.PartitionSpec(...))``."""

    _tree_leaf = True

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "PartitionSpec" + tuple.__repr__(self)

    def __getnewargs__(self):
        return tuple(self)


def _axes_of(entry) -> tuple:
    """Mesh axes one PartitionSpec entry names (an entry may be an
    axis name or a tuple of them)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else int(mesh.shape[axis])


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """``spec`` over ``mesh`` (a ``parallel.mesh.Mesh``): where each
    dimension of a leaf is split, and which slice this process holds."""

    mesh: Any
    spec: P

    def chunk(self, dim: int) -> tuple[int, int]:
        """``(index, count)`` of this process's block of dimension
        ``dim`` (axes of an entry major first, as JAX orders them)."""
        idx, count = 0, 1
        entries = tuple(self.spec)
        for ax in _axes_of(entries[dim] if dim < len(entries) else None):
            n = _axis_size(self.mesh, ax)
            c = 0 if self.mesh is None or self.mesh.coords is None \
                else int(self.mesh.coords[ax])
            idx, count = idx * n + c, count * n
        return idx, count

    def shard_shape(self, shape) -> tuple:
        out = []
        for d, size in enumerate(shape):
            _, count = self.chunk(d)
            if size % count:
                raise ValueError(
                    f"dimension {d} of shape {tuple(shape)} ({size}) does "
                    f"not split over {count} devices under {self.spec}")
            out.append(size // count)
        return tuple(out)

    def local(self, x):
        """This process's slice of the full leaf ``x`` (a tensor or a
        numpy array; a view where slicing gives one)."""
        sub = self.shard_shape(x.shape)
        idx = tuple(slice(self.chunk(d)[0] * n, (self.chunk(d)[0] + 1) * n)
                    for d, n in enumerate(sub))
        return x[idx]


def match_partition_rules(rules: Sequence[tuple[str, P]], tree, *,
                          default: Any = _RAISE):
    """Ordered ``(regex, P)`` rules over flattened key paths, first match
    wins, **scalar leaves always replicate**, unmatched non-scalar leaves
    raise naming the leaf (the reference's contract)."""
    def scalar_guard(name, leaf):
        shape = getattr(leaf, "shape", None)
        if shape is not None and len(shape) == 0:
            return P()
        return None

    return match_rules([(r".*", scalar_guard)] + list(rules), tree,
                       default=default)


def tree_shardings(mesh, rules: Sequence[tuple[str, Any]], tree, *,
                   default: Any = _RAISE, what: str = "sharding"):
    """Like :func:`match_rules`, with plain :class:`P` values wrapped into
    ``NamedSharding(mesh, spec)`` (shardings pass through): each one's
    ``local(leaf)`` is this process's slice."""
    def wrap(v):
        return NamedSharding(mesh, v) if isinstance(v, P) else v

    if default is not _RAISE:
        default = wrap(default)
    specs = match_rules(rules, tree, default=default, what=what)
    named, spec = tree_flatten_with_names(specs)
    return tree_unflatten(spec, [wrap(v) for _, v in named])


# ----------------------------------------------- the serving KV rules
#
# The KV cache's placement is derived from the param rules, never
# authored separately: the rule that splits the attention projections'
# heads over a mesh axis splits the cache's kv-heads dimension over it.

# Attention-projection paths of ``models/transformer.py::init_params``,
# with the index of the heads dimension in each [L, ...] stacked kernel.
_ATTN_HEAD_PATHS = (
    ("layers/attn/wq", 2, "n_heads"),
    ("layers/attn/wk", 2, "kv_heads"),
    ("layers/attn/wv", 2, "kv_heads"),
)


def serving_kv_axis(plan, mesh, cfg) -> str | None:
    """The mesh axis a serving plan splits attention heads over, and so
    the axis of the KV cache's kv-heads dimension; None when the plan
    leaves heads whole (pure-FSDP or replicated plans: the cache is
    replicated).  Checks head divisibility and names the offending
    rule."""
    axis, culprit = None, None
    for path, head_dim, attr in _ATTN_HEAD_PATHS:
        for pat, spec in plan.rules:
            if pat.search(path) is None:
                continue
            if callable(spec):
                raise ValueError(
                    f"serving plan rule ({pat.pattern!r}, <callable>) "
                    f"matches attention path {path!r}; the KV-cache "
                    "placement is derived from the attention rules, "
                    "which therefore must be concrete PartitionSpecs "
                    "— spell the attention rule out (callable rules "
                    "remain fine for every other path)")
            spec_t = tuple(spec)
            entries = (spec_t[head_dim]
                       if len(spec_t) > head_dim else None)
            for a in _axes_of(entries):
                n = int(mesh.shape[a])
                if n <= 1:
                    continue
                heads = int(getattr(cfg, attr))
                if heads % n:
                    raise ValueError(
                        f"serving plan rule ({pat.pattern!r}, "
                        f"{_spec_str(spec)}) shards the head dimension of "
                        f"{path!r} over mesh axis {a!r} (size {n}), "
                        f"but {attr}={heads} is not divisible by it — "
                        "shrink the axis or pick a head count the "
                        "mesh can split")
                if axis is not None and a != axis:
                    raise ValueError(
                        f"serving plan shards attention heads over "
                        f"two different mesh axes ({axis!r} via "
                        f"{culprit!r}, {a!r} via {pat.pattern!r}); "
                        "the KV cache has ONE heads dimension — use "
                        "one axis")
                axis, culprit = a, pat.pattern
            break  # first-match-wins, like every plan lookup
    return axis


def _spec_str(spec) -> str:
    """A spec as JAX prints a ``PartitionSpec`` (the reference's
    messages embed it)."""
    return "PartitionSpec(" + ", ".join(map(repr, tuple(spec))) + ")"


def kv_slab_specs(tree, axis: str | None):
    """Specs of a KV cache / paged block slab / prefix-pool slab: the
    kv-heads dimension (``ndim - 2`` of K/V, ``ndim - 1`` of the int8
    ``*scale`` leaves) over ``axis``, the rest whole; ``axis=None``
    replicates everything."""
    named, spec = tree_flatten_with_names(tree)
    out = []
    for name, a in named:
        if axis is None:
            out.append(P())
            continue
        ndim = len(a.shape)
        hd = ndim - 1 if name.endswith("scale") else ndim - 2
        entries = [None] * (hd + 1)
        entries[hd] = axis
        out.append(P(*entries))
    return tree_unflatten(spec, out)


def kv_slab_shardings(mesh, tree, axis: str | None):
    """:func:`kv_slab_specs` wrapped into :class:`NamedSharding`."""
    named, spec = tree_flatten_with_names(kv_slab_specs(tree, axis))
    return tree_unflatten(spec, [NamedSharding(mesh, s) for _, s in named])


__all__ = ["UnmatchedLeafError", "nearest_patterns", "leaf_name",
           "compile_rules", "first_match", "match_rules", "P",
           "NamedSharding", "match_partition_rules", "tree_shardings",
           "serving_kv_axis", "kv_slab_specs", "kv_slab_shardings"]

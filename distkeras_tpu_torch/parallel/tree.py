"""Flatten and rebuild parameter trees in JAX's leaf order.

The parallel layer lays leaves into fusion buckets in flatten order, so
the port flattens the way ``jax.tree_util`` does: dict keys sorted,
lists and tuples by index (a tuple class marked ``_tree_leaf``, the
port's ``PartitionSpec``, is a leaf), ``None`` an empty subtree.  The
leaf names are the reference's key paths (``"layers/attn/wq"``,
``"0"``), which the rule engine (``parallel/rules.py``) matches
against.
"""

from __future__ import annotations

_LEAF = object()


def tree_flatten_with_names(tree, prefix: str = ""):
    """``([(name, leaf)], spec)``: leaves in JAX's order and a spec that
    :func:`tree_unflatten` rebuilds the structure from."""
    if isinstance(tree, dict):
        out, spec = [], {}
        for k in sorted(tree):
            sub, spec[k] = tree_flatten_with_names(tree[k], f"{prefix}{k}/")
            out += sub
        return out, spec
    if isinstance(tree, (list, tuple)) and not getattr(tree, "_tree_leaf",
                                                       False):
        out, spec = [], []
        for i, v in enumerate(tree):
            sub, s = tree_flatten_with_names(v, f"{prefix}{i}/")
            out += sub
            spec.append(s)
        return out, (tuple(spec) if isinstance(tree, tuple) else spec)
    if tree is None:
        return [], None
    return [(prefix[:-1], tree)], _LEAF


def tree_flatten(tree):
    """``(leaves, spec)`` in JAX's leaf order."""
    named, spec = tree_flatten_with_names(tree)
    return [leaf for _, leaf in named], spec


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def leaf_names(tree) -> list[str]:
    return [name for name, _ in tree_flatten_with_names(tree)[0]]


def tree_unflatten(spec, leaves):
    """The structure of ``spec`` holding ``leaves`` (in flatten order)."""
    it = iter(leaves)

    def build(s):
        if s is _LEAF:
            return next(it)
        if isinstance(s, dict):
            return {k: build(v) for k, v in s.items()}
        if isinstance(s, (list, tuple)):
            return type(s)(build(v) for v in s)
        return None

    out = build(spec)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the tree spec holds")
    return out


def tree_map(fn, tree):
    leaves, spec = tree_flatten(tree)
    return tree_unflatten(spec, [fn(x) for x in leaves])

"""Regex rules over flattened key paths: the framework-free matching.

The port's own copy of the matching half of
``distkeras_tpu/parallel/rules.py``: a rule is ``(pattern, value)``,
``pattern`` a regex searched in the leaf's key path (``"layers/attn/wq"``,
``"0"``), ``value`` a concrete value or a callable ``(name, leaf) ->
value | None`` (``None`` declines and falls through); first match wins,
and an unmatched leaf raises :class:`UnmatchedLeafError` naming it and
its nearest-miss patterns.  The gradient exchange's per-leaf codec
rules (``parallel/exchange.py``) resolve through it.  The sharding
functions of the reference (``tree_shardings``, the KV-slab specs,
``serving_kv_axis``) wait for tensor parallelism (ROADMAP A7b).
"""

from __future__ import annotations

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


__all__ = ["UnmatchedLeafError", "nearest_patterns", "leaf_name",
           "compile_rules", "first_match", "match_rules"]

"""Shard lint: static partition-plan analysis + the placement census.

The port's counterpart of ``distkeras_tpu/analysis/shard_lint.py``.
The rules engine (``parallel/rules.py``) is the source of every
sharding, exchange-codec and serving-KV plan, so a dead or shadowed
rule, or a silently-replicated large tensor, is a finding here, in two
halves sharing the findings/suppression/baseline model:

**Plan lint** (:func:`lint_plan`) — pure-host analysis of an ordered
rule list against a target tree, no process group needed:

* ``invalid-regex`` (error) — a pattern that does not compile;
* ``duplicate-pattern`` (error) — an identical pattern repeated after
  an earlier occurrence with a *concrete* value (first-match-wins makes
  it unreachable; repeats after a *callable* occurrence are the legal
  decline-chain idiom) — the spelling ``rules.compile_rules`` rejects;
* ``dead-rule`` (error) — a pattern matching no leaf path in the tree;
* ``shadowed-rule`` (warn) — a rule whose every match is first claimed
  by earlier rules, so it can never fire;
* ``axis-divisibility`` (error) — a leaf dimension not divisible by the
  product of the mesh-axis sizes its winning spec entry names, from
  declared ``axis_sizes`` (no mesh);
* ``replicated-giant`` (warn) — a leaf no rule claims, above a byte
  threshold: under plan semantics it replicates on every rank.

**Placement census** (:func:`placement_census`) — per census target
(``analysis/targets.py``), every persistent tensor the step carries
(parameters, optimizer state, KV slabs), its placement (the port's
``Layout`` spec of each parameter leaf; ZeRO shards and the rest as
this rank holds them) and the bytes THIS rank holds, read off the live
tensors after one recorded step (torch allocates optimizer moments on
the first update).  Per-rank bytes are pinned per target in
``analysis/shard_budget.json`` (``shard-budget``, error).

The reference's resharding attribution reads XLA's HLO ``op_name``
scopes to find GSPMD-inserted collectives; the port inserts none —
every collective is an explicit call the step census records by kind
(:data:`NOT_PORTED_RULES`).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re

from distkeras_tpu_torch.analysis.findings import Finding

DEFAULT_GIANT_BYTES = 1 << 20

#: The reference's shard rules with no port counterpart.
NOT_PORTED_RULES = {
    "resharding-collective": "it reads XLA's compiled HLO op_name scopes "
                             "to find collectives GSPMD inserted; the "
                             "port has no compiler to insert one — every "
                             "collective is an explicit call, censused "
                             "by kind in the step census",
}

BUDGET_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "shard_budget.json")

_DTYPE_SHORT = {
    "float32": "f32", "float64": "f64", "float16": "f16",
    "bfloat16": "bf16", "int8": "s8", "int16": "s16", "int32": "s32",
    "int64": "s64", "uint8": "u8", "bool": "pred",
}


# ------------------------------------------------------------ plan lint


def _concrete(val) -> bool:
    # ONE concreteness predicate with the engine's build-time duplicate
    # rejection, so compile_rules and the duplicate-pattern lint agree.
    from distkeras_tpu_torch.parallel.rules import _is_concrete

    return _is_concrete(val)


def _spec_of(val):
    """The spec a rule value places, if it places one (a ``P`` or a
    ``NamedSharding``); None for codec strings etc."""
    from distkeras_tpu_torch.parallel.rules import P

    if isinstance(val, P):
        return val
    spec = getattr(val, "spec", None)
    if isinstance(spec, P):
        return spec
    return None


def _spec_str(spec) -> str:
    """THE spelling of a spec in findings and census rows (the
    reference's)."""
    return "P(" + ", ".join(repr(e) for e in tuple(spec)) + ")"


def _value_str(val) -> str:
    spec = _spec_of(val)
    if spec is not None:
        return _spec_str(spec)
    if not _concrete(val):
        return "<callable>"
    return repr(val)


def _itemsize(dtype) -> int:
    size = getattr(dtype, "itemsize", None)
    return int(size) if size else 4


def _leaf_bytes(leaf) -> int:
    shape = getattr(leaf, "shape", None)
    if shape is None:
        return 0
    return math.prod(shape) * _itemsize(leaf.dtype)


def _iter_rules(rules) -> list:
    """A ShardingPlan (compiled rules) or ``[(pattern, value)]`` ->
    ``[(pattern_str, value)]``."""
    items = getattr(rules, "rules", rules)
    return [(pat if isinstance(pat, str) else pat.pattern, val)
            for pat, val in items]


def lint_plan(rules, tree, *, name: str,
              axis_sizes: dict | None = None,
              giant_bytes: int = DEFAULT_GIANT_BYTES,
              ) -> list[Finding]:
    """Statically analyze one rule list against the tree it places.

    ``rules`` — a ShardingPlan, or ordered ``(pattern, value)`` pairs
    (specs, NamedShardings, codec names, or callable rules).  ``tree`` —
    the target tree (only each leaf's ``.shape`` / ``.dtype`` is read).
    ``name`` labels the findings.  ``axis_sizes`` — declared mesh-axis
    sizes for the divisibility check (axes not listed, and None, skip
    it).  Callable rules are evaluated per leaf; one that raises is
    treated as claiming the leaf.
    """
    from distkeras_tpu_torch.parallel.rules import _axes_of
    from distkeras_tpu_torch.parallel.tree import tree_flatten_with_names

    findings: list[Finding] = []

    def add(rule, sev, msg, hint=""):
        findings.append(Finding(rule=rule, severity=sev, path=name,
                                line=None, message=msg, hint=hint))

    norm: list[tuple] = []          # (pattern_str, compiled|None, value)
    claimed: dict[str, bool] = {}
    duplicates: set[int] = set()
    for i, (pat_s, val) in enumerate(_iter_rules(rules)):
        if claimed.get(pat_s):
            duplicates.add(i)
            add("duplicate-pattern", "error",
                f"rule {i} ({pat_s!r}, {_value_str(val)}) repeats a "
                "pattern an earlier rule with a concrete value already "
                "spells — first-match-wins makes it unreachable",
                "remove one of the duplicates (compile_rules rejects "
                "this shape at plan build)")
        claimed[pat_s] = claimed.get(pat_s, False) or _concrete(val)
        try:
            comp = re.compile(pat_s)
        except re.error as e:
            add("invalid-regex", "error",
                f"rule {i} pattern {pat_s!r} does not compile: {e}",
                "fix the regex — compile_rules raises the same error "
                "at plan construction")
            comp = None
        norm.append((pat_s, comp, val))

    leaves = tree_flatten_with_names(tree)[0]
    matched: list[list] = [[] for _ in norm]
    consulted: list[set] = [set() for _ in norm]
    winners: list[tuple] = []   # (leaf name, leaf, rule idx, spec|None)
    unmatched: list[tuple] = []
    for lname, leaf in leaves:
        won = False
        for i, (pat_s, comp, val) in enumerate(norm):
            if comp is None or comp.search(lname) is None:
                continue
            matched[i].append(lname)
            if won:
                continue
            consulted[i].add(lname)
            if _concrete(val):
                winners.append((lname, leaf, i, _spec_of(val)))
                won = True
            else:
                try:
                    out = val(lname, leaf)
                except Exception:  # noqa: BLE001 — see docstring
                    winners.append((lname, leaf, i, None))
                    won = True
                else:
                    if out is not None:
                        winners.append((lname, leaf, i, _spec_of(out)))
                        won = True
        if not won:
            unmatched.append((lname, leaf))

    for i, (pat_s, comp, val) in enumerate(norm):
        if comp is None or i in duplicates:
            # A duplicate is reported once, at the defect.
            continue
        if not matched[i]:
            add("dead-rule", "error",
                f"rule {i} ({pat_s!r}, {_value_str(val)}) matches no "
                "leaf in the target tree",
                "a typo'd pattern places nothing and its target leaf "
                "silently falls through — fix the pattern or drop the "
                "rule")
        elif not consulted[i]:
            mset = set(matched[i])
            covering = sorted({w_i for lname, _, w_i, _ in winners
                               if lname in mset})
            cov = ", ".join(f"rule {j} ({norm[j][0]!r})"
                            for j in covering[:3])
            ex = ", ".join(repr(l) for l in matched[i][:3])
            add("shadowed-rule", "warn",
                f"rule {i} ({pat_s!r}, {_value_str(val)}) is fully "
                f"shadowed: every leaf it matches ({ex}) is first "
                f"claimed by {cov}",
                "reorder the rules (first-match-wins) or delete the "
                "shadowed one")

    if axis_sizes:
        for lname, leaf, i, spec in winners:
            shape = getattr(leaf, "shape", None)
            if spec is None or shape is None:
                continue
            spec_t = tuple(spec)
            if len(spec_t) > len(shape):
                add("axis-divisibility", "error",
                    f"rule {i} ({norm[i][0]!r}, {_value_str(spec)}) "
                    f"names {len(spec_t)} dimensions but leaf "
                    f"{lname!r} has rank {len(shape)}",
                    "the spec would fail at placement; match the "
                    "leaf's rank")
                continue
            for d, entry in enumerate(spec_t):
                size = 1
                axes = [a for a in _axes_of(entry) if a in axis_sizes]
                for a in axes:
                    size *= int(axis_sizes[a])
                if size > 1 and shape[d] % size:
                    add("axis-divisibility", "error",
                        f"rule {i} ({norm[i][0]!r}, "
                        f"{_value_str(spec)}) shards dim {d} of leaf "
                        f"{lname!r} (shape {tuple(shape)}) over "
                        f"{'x'.join(axes)} (size {size}), which does "
                        f"not divide {shape[d]}",
                        "shrink the axis, pick a divisible dimension, "
                        "or leave the leaf replicated")

    # Plans with an fsdp_axis scatter unmatched leaves too, so
    # "unmatched" only means "replicated" when the augmentation would
    # decline the leaf — reuse the REAL augmentation to decide.
    fsdp_axis = getattr(rules, "fsdp_axis", None)

    def fsdp_shards(leaf) -> bool:
        from distkeras_tpu_torch.parallel.rules import P
        from distkeras_tpu_torch.parallel.sharding import _augment_fsdp

        if fsdp_axis is None:
            return False
        size = (axis_sizes or {}).get(fsdp_axis)
        if size is None:
            return True   # axis size undeclared: cannot prove replication
        shape = tuple(getattr(leaf, "shape", ()))
        return _augment_fsdp(P(), shape, int(size), fsdp_axis) != P()

    for lname, leaf in unmatched:
        nbytes = _leaf_bytes(leaf)
        if nbytes > giant_bytes and not fsdp_shards(leaf):
            add("replicated-giant", "warn",
                f"no rule claims leaf {lname!r} ({nbytes} bytes) — "
                "under plan semantics it replicates in full on every "
                "device",
                "add a rule (or an explicit ('.*', P()) catch-all if "
                "replication is intended — intent should be spelled, "
                "not defaulted)")
    return findings


# ------------------------------------------- the shipped-plan matrix

#: Shipped plans of the reference kept out of the port's suite.
NOT_PORTED_PLANS = {
    "zero1_plan/state_rules": "zero_state_rules places XLA sharding "
                              "trees of the ZeRO state; the port's "
                              "ZeroState holds each rank's shards and "
                              "Zero1Layout places them",
    "zero3_plan/state_rules": "as zero1_plan/state_rules",
}


def _lm_union() -> dict:
    """The union of a dense and an MoE parameter tree at the census
    shape (CPU tensors), so the MoE rules are live."""
    from distkeras_tpu_torch.analysis.targets import _lm_cfg
    from distkeras_tpu_torch.models import transformer as tfm

    cfg = _lm_cfg()
    moe = dataclasses.replace(cfg, num_experts=2)
    return {"dense": tfm.init_params(0, cfg, device="cpu"),
            "moe": tfm.init_params(0, moe, device="cpu")}


def plan_suite() -> list[tuple]:
    """``(name, rules, tree, axis_sizes)`` for every shipped plan
    constructor of the port against the trees it places: the serving
    plan, the Megatron rules, FSDP over the rules and the exchange
    codec rules, on the union of the dense and MoE trees at the
    census shape, with the reference's 4 x 2 analysis mesh."""
    from distkeras_tpu_torch.models import transformer as tfm
    from distkeras_tpu_torch.parallel.sharding import serving_plan

    lm_union = _lm_union()
    serving_axes = {"data": 4, "model": 2}
    return [
        ("serving_plan", serving_plan(), lm_union, serving_axes),
        ("tp_rules", tfm.tp_rules(), lm_union, serving_axes),
        ("fsdp_plan+tp_rules", serving_plan(fsdp_axis="data"),
         lm_union, serving_axes),
        # The per-bucket codec-rule spelling lmtrainer_rulesef trains
        # with.
        ("exchange_codec_rules",
         [("emb", "topk"), (".*", "int8")], lm_union["dense"], None),
    ]


def lint_repo_plans() -> list[Finding]:
    """The plan lint over every shipped plan constructor."""
    out: list[Finding] = []
    for name, rules, tree, axes in plan_suite():
        out += lint_plan(rules, tree, name=name, axis_sizes=axes)
    return out


# ------------------------------------------------- placement census


def _shape_str(t) -> str:
    dt = str(t.dtype).replace("torch.", "")
    short = _DTYPE_SHORT.get(dt, dt)
    return f"{short}[{','.join(str(d) for d in t.shape)}]"


def _walk(obj, prefix: str, out: list, seen: set) -> None:
    """``(name, tensor)`` of every tensor reachable from ``obj`` (dicts,
    sequences, dataclasses, a torch optimizer's per-parameter state),
    each tensor once."""
    import torch

    if isinstance(obj, torch.Tensor):
        # 0-d tensors (an optimizer's step counters) are bookkeeping.
        if obj.dim() and id(obj) not in seen:
            seen.add(id(obj))
            out.append((prefix.rstrip("/"), obj))
    elif isinstance(obj, torch.optim.Optimizer):
        for i, st in enumerate(obj.state.values()):
            _walk(st, f"{prefix}{i}/", out, seen)
    elif isinstance(obj, dict):
        for k in sorted(obj, key=str):
            _walk(obj[k], f"{prefix}{k}/", out, seen)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _walk(v, f"{prefix}{i}/", out, seen)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _walk(getattr(obj, f.name), f"{prefix}{f.name}/", out, seen)


def placement_census(spec) -> dict:
    """The placement table of one census target, read off the live
    tensors of ``spec.state`` (run the step first: optimizer moments
    exist only after an update).  Each tensor: ``[dtype[shape as this
    rank holds it], placement, bytes this rank holds]``; the placement
    of a parameter leaf is its layout spec where the hook gives one
    (``spec.placements``), else ``"rank"`` (whole, or the ZeRO shard,
    as held).  ``bytes_by_kind`` sums this rank's bytes per state kind
    (``params``, ``opt``, ``kv``)."""
    out: list = []
    seen: set = set()
    kinds: dict[str, int] = {}
    for kind in (spec.state or {}):
        start = len(out)
        _walk(spec.state[kind], f"{kind}/", out, seen)
        kinds[kind] = sum(t.numel() * t.element_size()
                          for _, t in out[start:])
    tensors = {}
    for name, t in out:
        leaf = name.split("/", 1)[1] if "/" in name else name
        place = spec.placements.get(leaf, "rank")
        tensors[name] = [_shape_str(t), place, t.numel() * t.element_size()]
    return {"tensors": tensors, "bytes_by_kind": kinds,
            "bytes_per_rank": sum(kinds.values())}


# ----------------------------------------------------------- budgets


def check_shard_budget(name: str, entry: dict, budgets: dict
                       ) -> list[Finding]:
    """Compare one target's placement census against the checked-in
    ``analysis/shard_budget.json``: any drift of a tensor's shape,
    placement or bytes, or of the totals, is an error; re-record a
    deliberate change with ``python -m distkeras_tpu_torch.analysis
    --update-budgets`` and review the diff."""
    want = budgets.get(name)
    if want is None:
        return [Finding(
            rule="shard-budget", severity="error", path=name, line=None,
            message="no placement budget recorded for this target",
            hint="run python -m distkeras_tpu_torch.analysis "
                 "--update-budgets")]
    if want == entry:
        return []
    got_t, want_t = entry.get("tensors", {}), want.get("tensors", {})
    changed = sorted(
        set(k for k in got_t if got_t[k] != want_t.get(k))
        | (set(want_t) - set(got_t)))
    detail = ", ".join(changed[:4]) + ("..." if len(changed) > 4 else "")
    return [Finding(
        rule="shard-budget", severity="error", path=name, line=None,
        message=(f"placements drifted from the budget: {len(changed)} "
                 f"tensor(s) changed ({detail}); per-rank bytes "
                 f"{want.get('bytes_by_kind')} -> "
                 f"{entry.get('bytes_by_kind')}"),
        hint="if the placement change is intentional, re-record with "
             "python -m distkeras_tpu_torch.analysis --update-budgets "
             "and review the analysis/shard_budget.json diff")]


def load_shard_budgets(path: str = BUDGET_PATH) -> dict:
    with open(path) as f:
        return json.load(f)["targets"]


def save_shard_budgets(path: str, budgets: dict, world: int = 8) -> None:
    doc = {
        "comment": "per-target placement census (every persistent tensor "
                   "one step carries: its shape and placement as rank 0 "
                   "holds it, and the bytes per rank by kind), recorded "
                   f"after one real step at world {world} in one process "
                   "on torch's fake process group; re-record with python "
                   "-m distkeras_tpu_torch.analysis --update-budgets and "
                   "review the diff",
        "world": world,
        "targets": budgets,
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")


__all__ = ["DEFAULT_GIANT_BYTES", "NOT_PORTED_RULES", "NOT_PORTED_PLANS",
           "lint_plan", "plan_suite", "lint_repo_plans",
           "placement_census", "check_shard_budget", "load_shard_budgets",
           "save_shard_budgets", "BUDGET_PATH"]

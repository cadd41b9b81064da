"""Placement plans: variable-path rules -> PartitionSpecs.

Counterpart of ``distkeras_tpu/parallel/sharding.py``.  A plan maps each
parameter to a :class:`~distkeras_tpu_torch.parallel.rules.P` by ordered
regex rules over its key path (unmatched leaves replicate), and
``fsdp_axis`` adds fully-sharded data parallelism on top
(:func:`_augment_fsdp`: the largest free dimension that divides goes on
that axis).  The specs are the reference's, leaf for leaf; in the port a
process holds the slice of each leaf its spec gives it
(``parallel/layout.py`` places a tree and runs it).

:func:`dp_plan` keeps everything whole, :class:`Zero1Plan` the optimizer
state as this rank's ``[cols]`` chunk of every leaf, :class:`Zero3Plan`
the parameters too, and :class:`ExchangePlan` a non-default gradient
exchange; the trainers read ``zero`` / ``zero1`` / ``exchange`` /
``bucket_mb`` off a plan, as the reference's do.  :func:`fsdp_plan`,
:func:`tp_plan` and :func:`serving_plan` (a :class:`ServingPlan`, whose
attention rules also place the KV cache) are the rule-driven plans.
"""

from __future__ import annotations

from typing import Sequence

from distkeras_tpu_torch.parallel.collectives import DEFAULT_BUCKET_MB
from distkeras_tpu_torch.parallel.rules import (NamedSharding, P,
                                                compile_rules, first_match)
from distkeras_tpu_torch.parallel.tree import (tree_flatten_with_names,
                                               tree_unflatten)


def _augment_fsdp(spec: P, shape, axis_size: int, axis: str) -> P:
    """Add ``axis`` to the largest still-unsharded dimension of ``shape``
    that divides evenly; small or indivisible leaves stay replicated."""
    if axis_size <= 1 or shape is None:
        return spec
    spec_t = tuple(spec) + (None,) * (len(shape) - len(spec))
    used = set()
    for s in spec_t:
        for a in (s if isinstance(s, tuple) else (s,)):
            if a is not None:
                used.add(a)
    if axis in used:
        return spec
    best, best_size = None, 0
    for i, (dim, s) in enumerate(zip(shape, spec_t)):
        if s is None and dim % axis_size == 0 and dim > best_size:
            best, best_size = i, dim
    if best is None:
        return spec
    new = list(spec_t)
    new[best] = axis
    while new and new[-1] is None:
        new.pop()
    return P(*new)


class ShardingPlan:
    """Ordered (regex, P) rules, first match wins; unmatched leaves
    replicate.  ``fsdp_axis`` shards each leaf's largest free dimension
    over that axis on top of the rules (a Megatron rule may claim one
    dimension and FSDP another)."""

    zero = 0
    zero1 = False
    bucket_mb = None

    def __init__(self, rules: Sequence = (), batch_spec=P("data"),
                 fsdp_axis: str | None = None):
        self.rules = compile_rules(rules)
        self.batch_spec = batch_spec
        self.fsdp_axis = fsdp_axis

    def spec_for(self, path: str, shape=None, mesh=None) -> P:
        matched, spec = first_match(self.rules, path)
        if not matched:
            spec = P()
        if self.fsdp_axis is not None and mesh is not None:
            spec = _augment_fsdp(spec, shape,
                                 int(mesh.shape[self.fsdp_axis]),
                                 self.fsdp_axis)
        return spec

    def param_shardings(self, mesh, paths: Sequence[str],
                        shapes: Sequence | None = None):
        """NamedShardings for a list of leaves ordered like ``paths``."""
        shapes = shapes if shapes is not None else [None] * len(paths)
        return [NamedSharding(mesh, self.spec_for(p, shape=s, mesh=mesh))
                for p, s in zip(paths, shapes)]

    def state_shardings(self, mesh, tv_paths: Sequence[str],
                        tv_shapes: Sequence):
        """Shardings of a training state: ``tv`` by the rules, each
        optimizer moment as its parameter (the update is elementwise),
        ``step`` replicated."""
        tv = self.param_shardings(mesh, tv_paths, tv_shapes)
        return {"tv": tv, "opt": list(tv),
                "step": NamedSharding(mesh, P())}

    def tree_shardings(self, mesh, tree):
        """NamedShardings for any tree, rules keyed on its key paths
        (``"layers/attn/wq"``)."""
        named, spec = tree_flatten_with_names(tree)
        return tree_unflatten(spec, [
            NamedSharding(mesh, self.spec_for(
                n, shape=tuple(x.shape) if hasattr(x, "shape") else None,
                mesh=mesh)) for n, x in named])


class Zero1Plan(ShardingPlan):
    """ZeRO-1: parameters whole, the optimizer state as this rank's
    shards (``collectives.ZeroOptimizer``)."""

    def __init__(self, bucket_mb: float | None = None):
        super().__init__()
        self.zero, self.zero1 = 1, True
        self.bucket_mb = DEFAULT_BUCKET_MB if bucket_mb is None else bucket_mb


class ExchangePlan(ShardingPlan):
    """A non-default gradient exchange (``parallel/exchange.py``): the
    optimizer state carries the residuals, and under zero1 x int8 is
    sharded as :class:`Zero1Plan`'s."""

    def __init__(self, config, zero1: bool = False):
        super().__init__()
        self.exchange = config
        self.zero1 = zero1
        self.zero = 1 if zero1 else 0
        self.bucket_mb = config.bucket_mb


class Zero3Plan(ShardingPlan):
    """ZeRO-3: parameters and optimizer state as this rank's chunk-major
    shards, gathered per fusion bucket on use (every leaf sharded,
    whatever its shape)."""

    def __init__(self, bucket_mb: float | None = None):
        super().__init__()
        self.zero = 3
        self.bucket_mb = DEFAULT_BUCKET_MB if bucket_mb is None else bucket_mb


class ServingPlan(ShardingPlan):
    """A :class:`ShardingPlan` for the serving path: the rules place the
    parameters, and the KV cache / paged slab / prefix-pool slab
    placement is derived from them (``rules.serving_kv_axis`` /
    ``kv_slab_specs``), so the plan and the cache cannot disagree.  Lane
    metadata (positions, tokens, page tables) replicates.  Built by
    :func:`serving_plan`; taken by ``ContinuousBatcher(plan=, mesh=)``
    and ``PagedBatcher(plan=, mesh=)``."""


def _override_rules(extra_rules, stock_rules) -> list:
    """User overrides ahead of stock rules, first-match-wins; an extra
    rule spelling a stock pattern verbatim replaces it."""
    seen = {pat for pat, _ in extra_rules}
    return list(extra_rules) + [(pat, val) for pat, val in stock_rules
                                if pat not in seen]


def serving_plan(extra_rules: Sequence = (),
                 fsdp_axis: str | None = None) -> ServingPlan:
    """The sharded serving plan: the transformer's Megatron rules over
    ``model`` (``models.transformer.tp_rules``), so attention and FFN
    split over it, the KV cache's kv-heads with them, and per-device
    parameter and KV bytes drop ~``model`` x.  ``extra_rules`` prepend;
    ``fsdp_axis`` also scatters still-whole parameters over that axis
    (gathered on use; the cache follows the attention rules only)."""
    from distkeras_tpu_torch.models.transformer import tp_rules

    return ServingPlan(rules=_override_rules(extra_rules, tp_rules()),
                       batch_spec=P(), fsdp_axis=fsdp_axis)


def dp_plan() -> ShardingPlan:
    """Pure data parallelism."""
    return ShardingPlan()


def zero1_plan(bucket_mb: float | None = None) -> Zero1Plan:
    """Data parallelism with the sharded weight update (ZeRO-1)."""
    return Zero1Plan(bucket_mb=bucket_mb)


def zero3_plan(bucket_mb: float | None = None) -> Zero3Plan:
    """Data parallelism with gather-on-use parameter shards (ZeRO-3)."""
    return Zero3Plan(bucket_mb=bucket_mb)


def fsdp_plan(extra_rules: Sequence = (), axis: str = "data"
              ) -> ShardingPlan:
    """Fully-sharded data parallelism: parameters and optimizer state
    split over ``axis`` by dimension, gathered on use, the gradient
    reduce-scattered."""
    return ShardingPlan(rules=extra_rules, batch_spec=P("data"),
                        fsdp_axis=axis)


def tp_plan(extra_rules: Sequence = ()) -> ShardingPlan:
    """Data + tensor parallelism for dense / conv / embedding stacks:
    the reference's rules over Keras variable paths (dense kernels split
    on their output columns, embeddings on the feature dimension, convs
    on output channels, over ``model``).  The transformer's Megatron
    layout is ``models.transformer.tp_rules``."""
    rules = _override_rules(extra_rules, [
        (r"(dense|mlp|fc)[^/]*/kernel$", P(None, "model")),
        (r"embedding[^/]*/embeddings$", P(None, "model")),
        (r"conv[^/]*/kernel$", P(None, None, None, "model")),
    ])
    return ShardingPlan(rules=rules, batch_spec=P("data"))


__all__ = ["ShardingPlan", "Zero1Plan", "ExchangePlan", "Zero3Plan",
           "ServingPlan", "dp_plan", "zero1_plan", "zero3_plan",
           "fsdp_plan", "tp_plan", "serving_plan"]

"""Placement plans of the data-parallel trainers.

Counterpart of ``distkeras_tpu/parallel/sharding.py``, data axis only.
In the reference a plan maps each parameter to a ``PartitionSpec`` and
XLA places state accordingly; in the port a process holds one replica,
so a plan says what that replica keeps whole and what it keeps as its
shard: :func:`dp_plan` everything whole (the batch split over ranks),
:class:`Zero1Plan` the optimizer state as this rank's ``[cols]`` chunk
of every leaf, :class:`Zero3Plan` the parameters too, and
:class:`ExchangePlan` a non-default gradient exchange (with its
error-feedback residuals).  The trainers read ``zero`` / ``zero1`` /
``exchange`` / ``bucket_mb`` off a plan, as the reference's do.

Rule-driven placements — :func:`fsdp_plan` (GSPMD dimension sharding),
:func:`tp_plan` (tensor parallelism), :func:`serving_plan` — are
ROADMAP A7b and raise.
"""

from __future__ import annotations

from typing import Sequence

from distkeras_tpu_torch.parallel.collectives import DEFAULT_BUCKET_MB

_A7B = ("is not ported yet (ROADMAP A7b: rule-driven parameter sharding "
        "and tensor parallelism); the port's plans are data-parallel")


class ShardingPlan:
    """Pure data parallelism: parameters and optimizer state whole on
    every rank, the batch split over the data axis.  ``rules`` (regex ->
    PartitionSpec) and ``fsdp_axis`` belong to tensor parallelism and
    raise."""

    zero = 0
    zero1 = False
    bucket_mb = None

    def __init__(self, rules: Sequence = (), batch_spec=("data",),
                 fsdp_axis: str | None = None):
        if rules:
            raise NotImplementedError(f"a ShardingPlan with rules {_A7B}")
        if fsdp_axis is not None:
            raise NotImplementedError(f"fsdp_axis= {_A7B}")
        self.rules = ()
        self.batch_spec = tuple(batch_spec)
        self.fsdp_axis = None


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


def dp_plan() -> ShardingPlan:
    """Pure data parallelism."""
    return ShardingPlan()


def zero1_plan(bucket_mb: float | None = None) -> Zero1Plan:
    """Data parallelism with the sharded weight update (ZeRO-1)."""
    return Zero1Plan(bucket_mb=bucket_mb)


def zero3_plan(bucket_mb: float | None = None) -> Zero3Plan:
    """Data parallelism with gather-on-use parameter shards (ZeRO-3)."""
    return Zero3Plan(bucket_mb=bucket_mb)


def fsdp_plan(extra_rules: Sequence = (), axis: str = "data"):
    raise NotImplementedError(f"fsdp_plan {_A7B}")


def tp_plan(extra_rules: Sequence = ()):
    raise NotImplementedError(f"tp_plan {_A7B}")


def serving_plan(extra_rules: Sequence = (), fsdp_axis: str | None = None):
    raise NotImplementedError(f"serving_plan {_A7B}")


__all__ = ["ShardingPlan", "Zero1Plan", "ExchangePlan", "Zero3Plan",
           "dp_plan", "zero1_plan", "zero3_plan", "fsdp_plan", "tp_plan",
           "serving_plan"]

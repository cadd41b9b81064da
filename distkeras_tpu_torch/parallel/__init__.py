"""Parallelism over ``torch.distributed``: the mesh of processes (data,
model, pipeline, seq and expert axes), the placement plans and layouts,
the bucketed collectives and ZeRO stages, ring attention, the GPipe
schedule, the gradient-exchange policies and the bounded-staleness async
tier (counterpart of ``distkeras_tpu/parallel``)."""

from distkeras_tpu_torch.parallel import collectives, rules
from distkeras_tpu_torch.parallel.async_tier import (AsyncConfig, AsyncPlane,
                                                     AsyncSchedule,
                                                     VirtualClock)
from distkeras_tpu_torch.parallel.collectives import (Zero1Layout,
                                                      all_gather,
                                                      gather_bucket,
                                                      reduce_scatter,
                                                      zero1_optimizer)
from distkeras_tpu_torch.parallel.mesh import (MeshSpec, initialize_multihost,
                                               local_device_count, make_mesh)
from distkeras_tpu_torch.parallel.rules import (match_partition_rules,
                                                match_rules)
from distkeras_tpu_torch.parallel.sharding import (ShardingPlan, Zero1Plan,
                                                   Zero3Plan, dp_plan,
                                                   fsdp_plan, tp_plan,
                                                   zero1_plan, zero3_plan)

__all__ = ["MeshSpec", "make_mesh", "local_device_count",
           "initialize_multihost", "ShardingPlan", "dp_plan", "fsdp_plan",
           "tp_plan", "zero1_plan", "zero3_plan", "Zero1Plan", "Zero3Plan",
           "collectives", "rules", "Zero1Layout", "reduce_scatter",
           "all_gather", "gather_bucket", "zero1_optimizer",
           "match_partition_rules", "match_rules",
           "AsyncConfig", "AsyncPlane", "AsyncSchedule", "VirtualClock"]

"""Continuous batching: lane-based serving engines over the decode step.

The port's counterpart of ``distkeras_tpu/serving``:

- :mod:`~distkeras_tpu_torch.serving.engine` — the shared host lane
  machinery (``_LaneEngine``) and the one-lane admission step;
- :mod:`~distkeras_tpu_torch.serving.lanes` — :class:`ContinuousBatcher`
  (greedy / sampled / per-request sampling, rolling lanes, shared and
  pooled prefixes, chunked prefill, elastic tiers);
- :mod:`~distkeras_tpu_torch.serving.admission` — deadlines, the bounded
  queue with :class:`QueueFull` backpressure, structured
  :class:`RequestResult`, drain-then-shutdown;
- :mod:`~distkeras_tpu_torch.serving.elastic` — elastic lane tiers;
- :mod:`~distkeras_tpu_torch.serving.paged` — :class:`PagedBatcher` and
  :class:`BlockAllocator`: block-granular paged KV with per-lane page
  tables, stem sharing, pinned stems and copy-on-write forks;
- :mod:`~distkeras_tpu_torch.serving.residency` — the chain hashes that
  name resident stems (the reference's bytes);
- :mod:`~distkeras_tpu_torch.serving.prefix` — :class:`PrefixPool` and
  :class:`PinnedStems`;
- :mod:`~distkeras_tpu_torch.serving.speculative` —
  :class:`SpeculativeBatcher`, draft-assisted lanes;
- :mod:`~distkeras_tpu_torch.serving.traffic` — :class:`TraceReplay`,
  the seeded deterministic load driver;
- :mod:`~distkeras_tpu_torch.serving.router` — the fleet:
  :class:`Router` (affinity / least-loaded / round-robin routing,
  health-gated membership, drain-and-reroute, the disaggregated
  prefill -> decode hop, streaming) over :class:`InProcessReplica` and
  :class:`HttpReplica` handles, and :class:`EngineEndpoint`, one engine
  served over HTTP;
- :mod:`~distkeras_tpu_torch.serving.disagg` — :class:`BlockShipment`
  and its wire codec (the reference's bytes);
- :mod:`~distkeras_tpu_torch.serving.autoscale` — :class:`Autoscaler`,
  :class:`AutoscalePolicy` and :class:`WarmPool`;
- :mod:`~distkeras_tpu_torch.serving.publish` and
  :mod:`~distkeras_tpu_torch.serving.canary` — versioned weight
  snapshots and the canary rollout over ``hot_swap=True`` engines.

Contract (every engine): every request's emitted tokens are exactly what
its solo ``generate`` / ``speculative_generate`` run emits.  Not ported
yet: ``plan=`` / ``mesh=`` (A7b).
"""

from distkeras_tpu_torch.serving.admission import (EngineClosed, QueueFull,
                                                   RequestResult)
from distkeras_tpu_torch.serving.autoscale import (Autoscaler,
                                                   AutoscalePolicy, WarmPool)
from distkeras_tpu_torch.serving.canary import CanaryController
from distkeras_tpu_torch.serving.disagg import (BlockShipment,
                                                decode_shipment,
                                                encode_shipment)
from distkeras_tpu_torch.serving.lanes import (KV_INT8_LANE_ADVISORY,
                                               ContinuousBatcher)
from distkeras_tpu_torch.serving.paged import BlockAllocator, PagedBatcher
from distkeras_tpu_torch.serving.prefix import PinnedStems, PrefixPool
from distkeras_tpu_torch.serving.residency import (chain_hash, stem_hashes,
                                                   stem_hexes)
from distkeras_tpu_torch.serving.publish import (SnapshotCorrupt,
                                                 SnapshotError,
                                                 SnapshotPublisher,
                                                 SnapshotReader,
                                                 StaleSnapshot)
from distkeras_tpu_torch.serving.router import (EngineEndpoint, HttpReplica,
                                                InProcessReplica,
                                                ReplicaUnreachable, Router,
                                                discover_replicas)
from distkeras_tpu_torch.serving.speculative import SpeculativeBatcher
from distkeras_tpu_torch.serving.traffic import (TRACE_SHAPES, TraceReplay,
                                                 TraceRequest)

__all__ = [
    "ContinuousBatcher",
    "SpeculativeBatcher",
    "PagedBatcher",
    "BlockAllocator",
    "PrefixPool",
    "PinnedStems",
    "Router",
    "InProcessReplica",
    "HttpReplica",
    "EngineEndpoint",
    "ReplicaUnreachable",
    "discover_replicas",
    "BlockShipment",
    "encode_shipment",
    "decode_shipment",
    "Autoscaler",
    "AutoscalePolicy",
    "WarmPool",
    "SnapshotPublisher",
    "SnapshotReader",
    "SnapshotError",
    "SnapshotCorrupt",
    "StaleSnapshot",
    "CanaryController",
    "TraceReplay",
    "TraceRequest",
    "TRACE_SHAPES",
    "RequestResult",
    "QueueFull",
    "EngineClosed",
    "KV_INT8_LANE_ADVISORY",
]

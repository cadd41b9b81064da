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
  the seeded deterministic load driver.

Contract (every engine): every request's emitted tokens are exactly what
its solo ``generate`` / ``speculative_generate`` run emits.  Not ported
yet: disaggregated serving (``BlockShipment``, the paged engine's
``export_blocks`` / ``import_blocks``), the router, autoscaling, weight
publishing, canaries and ``hot_swap`` (ROADMAP A10's fleet half), and
``plan=`` / ``mesh=`` (A7b).
"""

from distkeras_tpu_torch.serving.admission import (EngineClosed, QueueFull,
                                                   RequestResult)
from distkeras_tpu_torch.serving.lanes import ContinuousBatcher
from distkeras_tpu_torch.serving.paged import BlockAllocator, PagedBatcher
from distkeras_tpu_torch.serving.prefix import PinnedStems, PrefixPool
from distkeras_tpu_torch.serving.residency import (chain_hash, stem_hashes,
                                                   stem_hexes)
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
    "chain_hash",
    "stem_hashes",
    "stem_hexes",
    "TraceReplay",
    "TraceRequest",
    "TRACE_SHAPES",
    "RequestResult",
    "QueueFull",
    "EngineClosed",
]

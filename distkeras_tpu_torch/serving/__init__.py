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
- :mod:`~distkeras_tpu_torch.serving.prefix` — :class:`PrefixPool`;
- :mod:`~distkeras_tpu_torch.serving.speculative` —
  :class:`SpeculativeBatcher`, draft-assisted lanes;
- :mod:`~distkeras_tpu_torch.serving.traffic` — :class:`TraceReplay`,
  the seeded deterministic load driver.

Contract (both engines): every request's emitted tokens are exactly what
its solo ``generate`` / ``speculative_generate`` run emits.  Not ported
yet (ROADMAP A10): the paged engine, disaggregated serving, the router,
autoscaling, weight publishing and canaries.
"""

from distkeras_tpu_torch.serving.admission import (EngineClosed, QueueFull,
                                                   RequestResult)
from distkeras_tpu_torch.serving.lanes import ContinuousBatcher
from distkeras_tpu_torch.serving.prefix import PrefixPool
from distkeras_tpu_torch.serving.speculative import SpeculativeBatcher
from distkeras_tpu_torch.serving.traffic import (TRACE_SHAPES, TraceReplay,
                                                 TraceRequest)

__all__ = [
    "ContinuousBatcher",
    "SpeculativeBatcher",
    "PrefixPool",
    "TraceReplay",
    "TraceRequest",
    "TRACE_SHAPES",
    "RequestResult",
    "QueueFull",
    "EngineClosed",
]

"""Resilience for the port: deterministic fault injection (``chaos``)
and the serving engines' admission-control types.  The supervisor,
cluster and health layers of ``distkeras_tpu/resilience`` are not ported
yet (ROADMAP A8)."""

from distkeras_tpu_torch.resilience import chaos
from distkeras_tpu_torch.resilience.admission import (EngineClosed,
                                                      QueueFull,
                                                      RequestResult)
from distkeras_tpu_torch.resilience.chaos import (BeatDropped, FaultInjected,
                                                  FaultPlan, Preempted)

__all__ = ["chaos", "FaultPlan", "FaultInjected", "BeatDropped",
           "Preempted", "QueueFull", "EngineClosed", "RequestResult"]

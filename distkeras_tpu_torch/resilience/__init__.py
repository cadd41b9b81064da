"""Resilience for the port (counterpart of ``distkeras_tpu/resilience``):

- :mod:`~distkeras_tpu_torch.resilience.chaos` — deterministic, seedable
  fault injection over named probe sites (checkpoint saves, training
  rounds, serving steps, the speculative draft, cluster heartbeats, the
  async tier's pushes and merges).
- :mod:`~distkeras_tpu_torch.resilience.supervisor` — retry + backoff +
  verified auto-resume around any trainer's ``train``, with a SIGTERM
  preemption handler that forces a final synchronous checkpoint.
- :mod:`~distkeras_tpu_torch.resilience.health` — per-host heartbeats
  over a shared directory plus the read-side staleness monitor.
- :mod:`~distkeras_tpu_torch.resilience.cluster` — cluster epochs, the
  collective watchdog, per-host restart drivers, and cluster-consistent
  checkpoint selection (coordinated multi-process restart).
- :mod:`~distkeras_tpu_torch.resilience.admission` — request deadlines,
  bounded-queue backpressure, and structured results for the serving
  engines.
"""

from distkeras_tpu_torch.resilience import chaos, cluster, health
from distkeras_tpu_torch.resilience.admission import (EngineClosed,
                                                      QueueFull,
                                                      RequestResult)
from distkeras_tpu_torch.resilience.chaos import (BeatDropped, FaultInjected,
                                                  FaultPlan, Preempted)
from distkeras_tpu_torch.resilience.cluster import (ClusterMember,
                                                    ClusterSupervisor,
                                                    cluster_consistent_step)
from distkeras_tpu_torch.resilience.health import (HealthMonitor,
                                                   HeartbeatWriter)
from distkeras_tpu_torch.resilience.supervisor import Attempt, Supervisor

__all__ = [
    "chaos",
    "cluster",
    "health",
    "FaultPlan",
    "FaultInjected",
    "BeatDropped",
    "Preempted",
    "Supervisor",
    "Attempt",
    "RequestResult",
    "QueueFull",
    "EngineClosed",
    "ClusterMember",
    "ClusterSupervisor",
    "cluster_consistent_step",
    "HealthMonitor",
    "HeartbeatWriter",
]

"""Deterministic, seedable fault injection (chaos hooks).

The port's own copy of ``distkeras_tpu/resilience/chaos.py`` (the
serving engines probe ``serving.step``, ``serving.admit`` and
``serving.draft``).

The reference stack dies whole-job on any single failure and never
*exercises* that path — the parameter server is a single point of
failure and nothing in its test suite ever kills a worker (SURVEY.md
§5).  This module is the other half of a real failure story: the code
paths that production leans on (checkpoint saves, the training round
loop, the serving decode step, the speculative draft) each carry a
**probe site**, and a :class:`FaultPlan` decides — deterministically,
from a seed — which probes fire a fault.

Usage::

    from distkeras_tpu_torch.resilience import chaos

    plan = chaos.FaultPlan(seed=0)
    plan.fail("train.round", at=7)           # raise FaultInjected at round 7
    plan.preempt("train.round", at=5)        # raise Preempted (preemption)
    plan.fail("checkpoint.save")             # next save raises
    plan.delay("serving.step", seconds=0.01) # slow every decode window
    with plan:
        ...                                  # faults fire; plan.events records them

Sites are probed by the production code via :func:`probe`; when no plan
is active the probe is a module-level ``None`` check — effectively
free.  One plan is active at a time (nesting is a usage error: a chaos
schedule must be read off one plan, not two interleaved ones).

Probes are **host-side only**: a fault lands between device dispatches,
which is exactly where real preemptions and IO failures land.
"""

from __future__ import annotations

import dataclasses
import random
import signal as _signal
import time
from typing import Callable

from distkeras_tpu_torch import obs

# The known probe sites, checked at rule-registration time so a typo'd
# site fails loudly instead of silently never firing.
SITES = (
    "train.round",      # trainer family: start of every round's bookkeeping
    "checkpoint.save",  # CheckpointManager.save (both backends)
    "serving.step",     # ContinuousBatcher/SpeculativeBatcher.step
    "serving.admit",    # lane admission (submit/pump)
    "serving.draft",    # SpeculativeBatcher's draft half of the step
    "cluster.heartbeat",  # HeartbeatWriter: before every beat publishes
    "cluster.push",     # AsyncPlane.push: before a host's delta publishes
    "cluster.merge",    # AsyncPlane aggregation wave: before center applies
    "autoscale.join",   # Autoscaler scale-up: between warm-pool take
                        # and the join health gate (round 19)
    "publish.commit",   # SnapshotPublisher: between the bucket writes
                        # and the atomic manifest rename — a kill here
                        # leaves a torn snapshot no reader adopts
                        # (round 20)
    "canary.promote",   # CanaryController: between the canary gate
                        # passing and the fleet-wide swap (round 20)
)


class FaultInjected(RuntimeError):
    """Default error raised by an injected fault."""


class BeatDropped(RuntimeError):
    """Internal signal of a ``drop`` rule: the heartbeat writer catches
    it and skips publishing the beat — the partition fault kind (host
    alive, beats invisible to peers).  Never escapes the writer."""


class Preempted(RuntimeError):
    """A (simulated or real) preemption: stop now, resume from the
    latest checkpoint.  Raised by ``FaultPlan.preempt`` rules (the
    supervisor that resumes from it is ROADMAP A8)."""


@dataclasses.dataclass
class _Rule:
    site: str
    kind: str            # "fail" | "delay" | "signal" | "kill" | "drop"
    at: int | None = None          # fire when the probe's step/call == at
    times: int | None = 1          # firings remaining (None = unlimited)
    error: Callable[[str], BaseException] | None = None
    seconds: float = 0.0
    p: float = 1.0                 # firing probability (plan-seeded RNG)
    fired: int = 0


class FaultPlan:
    """A deterministic schedule of faults over the probe sites.

    ``seed`` drives the one RNG behind probabilistic rules (``p < 1``),
    so a chaos run is reproducible end to end.  ``events`` records every
    firing as ``(site, step, kind)`` for assertions.
    """

    def __init__(self, seed: int = 0):
        self._rng = random.Random(seed)
        self._rules: list[_Rule] = []
        self._calls: dict[str, int] = {}
        self.events: list[tuple[str, int, str]] = []

    # ------------------------------------------------------------ rules

    def _check_site(self, site: str) -> None:
        if site not in SITES:
            raise ValueError(
                f"unknown chaos site {site!r}; known sites: {SITES}")

    def fail(self, site: str, at: int | None = None, times: int | None = 1,
             error=None, p: float = 1.0) -> "FaultPlan":
        """Raise at ``site`` (``error``: exception class or factory
        taking the message; default :class:`FaultInjected`)."""
        self._check_site(site)
        self._rules.append(_Rule(site, "fail", at=at, times=times,
                                 error=error or FaultInjected, p=p))
        return self

    def preempt(self, site: str = "train.round", at: int | None = None,
                via_signal: bool = False) -> "FaultPlan":
        """Simulate a preemption at ``site``.

        ``via_signal=False`` raises :class:`Preempted` directly from the
        probe; ``via_signal=True`` delivers a real SIGTERM to this
        process instead — the full production path: the Supervisor's
        handler marks the preemption and the trainer's next round
        boundary forces a synchronous checkpoint and raises.
        """
        self._check_site(site)
        if via_signal:
            self._rules.append(_Rule(site, "signal", at=at, times=1))
        else:
            self._rules.append(_Rule(site, "fail", at=at, times=1,
                                     error=Preempted))
        return self

    def delay(self, site: str, seconds: float, at: int | None = None,
              times: int | None = None, p: float = 1.0) -> "FaultPlan":
        """Sleep ``seconds`` at ``site`` (default: every probe).  On
        ``cluster.heartbeat`` this is the **heartbeat-stall** fault
        kind: the writer thread wedges mid-beat and peers see the host
        go stale."""
        self._check_site(site)
        if seconds < 0:
            raise ValueError(f"seconds must be >= 0, got {seconds}")
        self._rules.append(_Rule(site, "delay", at=at, times=times,
                                 seconds=seconds, p=p))
        return self

    def kill(self, site: str, at: int | None = None,
             rc: int = 137) -> "FaultPlan":
        """**Host-kill** fault kind: ``os._exit(rc)`` at ``site`` — the
        process dies instantly with no cleanup, no atexit, no final
        checkpoint, exactly like SIGKILL/hardware loss.  The default rc
        mirrors a SIGKILLed process (128 + 9).  Only meaningful in
        multiprocess chaos runs (the cluster restart harness); a
        single-process test that kills itself takes pytest with it."""
        self._check_site(site)
        self._rules.append(_Rule(site, "kill", at=at, times=1,
                                 seconds=float(rc)))
        return self

    def drop(self, site: str = "cluster.heartbeat", at: int | None = None,
             times: int | None = 1, p: float = 1.0) -> "FaultPlan":
        """**Partition** fault kind: the probe site swallows the
        operation instead of performing it.  On ``cluster.heartbeat``
        the beat is silently not published — the host keeps running
        (and keeps training) while its peers watch it go stale, which
        is what a network partition looks like from the outside."""
        self._check_site(site)
        self._rules.append(_Rule(site, "drop", at=at, times=times, p=p))
        return self

    # ------------------------------------------------------------ firing

    def probe(self, site: str, step: int | None = None) -> None:
        """Evaluate this plan at one probe point.  ``step``: the
        caller's own counter (round number, step index); rules with
        ``at`` match against it, or against the per-site call index
        (1-based) when the caller has no counter."""
        self._calls[site] = self._calls.get(site, 0) + 1
        n = self._calls[site] if step is None else step
        for rule in self._rules:
            if rule.site != site:
                continue
            if rule.times is not None and rule.fired >= rule.times:
                continue
            if rule.at is not None and n != rule.at:
                continue
            if rule.p < 1.0 and self._rng.random() >= rule.p:
                continue
            rule.fired += 1
            self.events.append((site, n, rule.kind))
            # Injected faults ride the obs event trace (when a
            # telemetry session is active), so a chaos run's
            # fault/recovery timeline is machine-readable.
            obs.event("chaos.fault", site=site, step=n, kind=rule.kind)
            obs.count("chaos.faults", site=site, kind=rule.kind)
            if rule.kind == "delay":
                time.sleep(rule.seconds)
            elif rule.kind == "signal":
                _signal.raise_signal(_signal.SIGTERM)
            elif rule.kind == "kill":
                import os

                # Hard host loss: flush what telemetry we can (the
                # trace file is line-buffered) and die without cleanup.
                os._exit(int(rule.seconds))
            elif rule.kind == "drop":
                raise BeatDropped(f"chaos: dropped {site} (step {n})")
            else:
                raise rule.error(f"chaos: injected fault at {site} "
                                 f"(step {n})")

    # ------------------------------------------------------- activation

    def __enter__(self) -> "FaultPlan":
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("a FaultPlan is already active; chaos "
                               "plans do not nest")
        _ACTIVE = self
        return self

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        _ACTIVE = None


_ACTIVE: FaultPlan | None = None


def active_plan() -> FaultPlan | None:
    return _ACTIVE


def probe(site: str, step: int | None = None) -> None:
    """Production-side hook: no-op unless a :class:`FaultPlan` is
    active (one attribute load + ``is`` check on the hot path)."""
    if _ACTIVE is not None:
        _ACTIVE.probe(site, step)

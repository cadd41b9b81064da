"""SLO-driven autoscaling control plane over the fleet router.

The port's copy of ``distkeras_tpu/serving/autoscale.py``: the policy
layer that closes the loop over ``slo.breach`` callbacks, per-replica
queue/busy/residency state, membership epochs and lossless
drain-and-reroute.  It is deliberately
dumb: a :class:`Autoscaler` reads ONE consistent
:meth:`~distkeras_tpu_torch.serving.router.Router.fleet_snapshot` per
decision tick, applies a thresholds-plus-hysteresis policy
(:class:`AutoscalePolicy`), and actuates through the router's
existing membership surface.  Three load-bearing contracts:

- **Warm-pool joins build nothing.**  Scale-up never builds an engine:
  it admits a handle from a :class:`WarmPool` of replicas that were
  built and warmed BEFORE they were pooled (on the card: their caches
  and weights already allocated, so a join allocates no device memory).
  A candidate is health-gated before ``add_replica`` and verified
  live after it — a replica that died in the pool (or mid-join) is
  discarded without ever holding a route-table entry, and the next
  pool candidate is tried.
- **Scale-down is the existing lossless drain-and-reroute** under a
  bumped membership epoch (``Router.remove_replica``): unfinished
  accepted requests re-admit elsewhere idempotently by request id,
  so a retire costs latency, never a caller-visible loss.  The
  retired handle returns to the warm pool still warm (its device
  state survives), unless a ``release=`` hook takes ownership.
- **A replica that is the last holder of pinned prefix state is
  never retired.**  Pool entries and shipped disagg blocks are
  replica-local: draining the only replica advertising a
  ``prefix_id`` would drop pinned state callers still reference
  (pinned admissions to it would become structured errors).  The
  retire path skips such victims; when no safe victim exists the
  scale-down is *deferred* (``autoscale.retire_deferred``) until an
  unpin makes one — the refusal the regression test pins.

Determinism: the policy is a pure function of its tick inputs.
:meth:`Autoscaler.tick` is driven externally (a harness calls it once
per virtual-clock tick; a deployment can call it from any timer), hysteresis and cooldown count *ticks*, not wall seconds, and
every decision appends to an audit trail (``autoscale.decision``
events + :attr:`Autoscaler.decisions`) — two same-seed harness runs
over a :class:`~distkeras_tpu_torch.serving.traffic.TraceReplay` produce
identical decision timelines.  SLO breaches enter the loop through
:meth:`Autoscaler.on_breach` (a ``SloEngine.subscribe`` target): a
breach votes scale-up for ``policy.breach_ticks`` subsequent ticks.

Scaling is host bookkeeping: this module touches no device.
"""

from __future__ import annotations

import dataclasses

from distkeras_tpu_torch import obs
from distkeras_tpu_torch.resilience import chaos
from distkeras_tpu_torch.utils.locks import TracedLock


class WarmPool:
    """Warmed replica handles awaiting admission.

    A FIFO of router-attachable handles (``InProcessReplica`` /
    ``HttpReplica`` / anything with the replica surface) whose
    engines were built and warmed BEFORE pooling — the warm-pool
    contract that makes a scale-up join allocate nothing.  The pool does
    not health-check: the autoscaler gates health at admission time
    (a handle can die while pooled).  Thread-safe; retired replicas
    return here still warm.
    """

    def __init__(self, replicas=()):
        self._lock = TracedLock("serving.warm_pool")
        self._ready = list(replicas)

    def put(self, replica) -> None:
        with self._lock:
            self._ready.append(replica)

    def take(self):
        """Pop the oldest pooled handle, or None when empty."""
        with self._lock:
            return self._ready.pop(0) if self._ready else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._ready)

    def names(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(r.name for r in self._ready)


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """The policy knobs.

    Utilization is fleet-wide ``(lanes_busy + queue_depth) /
    lanes`` over serving (non-prefill, up, non-draining) replicas;
    router-level backlog (requests parked because every replica was
    saturated) always votes scale-up.  ``up_after``/``down_after``
    are consecutive-tick streak requirements (hysteresis — a single
    noisy tick moves nothing, and down_after > up_after biases the
    loop toward latency over cost); ``cooldown_ticks`` is the
    minimum tick gap between ANY two membership changes (flap
    damping); ``min_replicas``/``max_replicas`` is the envelope.
    ``breach_ticks`` is how long one SLO breach keeps voting
    scale-up after :meth:`Autoscaler.on_breach` records it."""

    min_replicas: int = 1
    max_replicas: int = 4
    up_threshold: float = 0.9
    down_threshold: float = 0.3
    up_after: int = 1
    down_after: int = 3
    cooldown_ticks: int = 2
    breach_ticks: int = 3

    def __post_init__(self):
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"({self.min_replicas}, {self.max_replicas})")
        if not 0.0 <= self.down_threshold < self.up_threshold:
            raise ValueError(
                "need 0 <= down_threshold < up_threshold, got "
                f"({self.down_threshold}, {self.up_threshold})")
        if self.up_after < 1 or self.down_after < 1:
            raise ValueError("up_after and down_after must be >= 1")
        if self.cooldown_ticks < 0 or self.breach_ticks < 0:
            raise ValueError(
                "cooldown_ticks and breach_ticks must be >= 0")


class Autoscaler:
    """The policy engine (module docstring has the full story).

    ``router``: the fleet :class:`~distkeras_tpu_torch.serving.router.
    Router` (actuator + snapshot source).  ``pool``: the
    :class:`WarmPool` scale-up admits from.  ``release``: optional
    hook called with a retired handle instead of pooling it (the
    owner takes shutdown responsibility).  Drive :meth:`tick` once
    per decision interval from one thread; :meth:`on_breach` may
    race it from the SLO ticker thread (it only records a vote).
    """

    def __init__(self, router, pool: WarmPool, *,
                 policy: AutoscalePolicy | None = None, release=None):
        self.router = router
        self.pool = pool
        self.policy = policy if policy is not None else AutoscalePolicy()
        self._release = release
        # Guards the cross-thread vote state only; never held across
        # router calls (no nesting with the serving.router lock).
        self._lock = TracedLock("serving.autoscale")
        self._breach_until = -1
        self._tick = -1
        self._hi_streak = 0
        self._lo_streak = 0
        self._last_change = None
        self.decisions: list[dict] = []

    # ----------------------------------------------------------- inputs

    def on_breach(self, rule, value) -> None:
        """``SloEngine.subscribe`` target: one breach votes scale-up
        for ``policy.breach_ticks`` subsequent ticks (edge-triggered
        breaches re-arm the vote; the engine fires this with its own
        lock released)."""
        del rule, value
        with self._lock:
            self._breach_until = self._tick + 1 + self.policy.breach_ticks

    @staticmethod
    def _serving(snap: dict) -> dict:
        """The snapshot's serving members: up, not draining, and not
        prefill-specialized (prefill replicas take no decode routes,
        so they are outside the decode-capacity envelope)."""
        return {n: r for n, r in snap["replicas"].items()
                if r["up"] and not r["draining"]
                and r["role"] != "prefill"}

    # --------------------------------------------------------- decision

    def tick(self) -> dict:
        """One decision pass.  Reads one consistent fleet snapshot,
        updates the hysteresis streaks, and actuates at most ONE
        membership change.  Returns the decision record (also
        appended to :attr:`decisions` and emitted as an
        ``autoscale.decision`` event for actions other than hold)."""
        with self._lock:
            self._tick += 1
            tick = self._tick
            breach = tick < self._breach_until
        p = self.policy
        snap = self.router.fleet_snapshot()
        serving = self._serving(snap)
        n = len(serving)
        lanes = sum(r["lanes"] for r in serving.values())
        busy = sum(r["lanes_busy"] + r["queue_depth"]
                   for r in serving.values())
        backlog = snap["pending"]
        util = (busy / lanes) if lanes else float(busy + backlog > 0)
        obs.gauge("autoscale.utilization", util)
        hot = util > p.up_threshold or backlog > 0 or breach
        cold = util < p.down_threshold and backlog == 0 and not breach
        self._hi_streak = self._hi_streak + 1 if hot else 0
        self._lo_streak = self._lo_streak + 1 if cold else 0
        cooling = (self._last_change is not None
                   and tick - self._last_change < p.cooldown_ticks)
        action, replica, reason = "hold", None, "steady"
        if cooling:
            reason = "cooldown"
        elif self._hi_streak >= p.up_after and n < p.max_replicas:
            action, replica, reason = self._scale_up(
                "breach" if breach else
                "backlog" if backlog > 0 else "utilization")
        elif self._lo_streak >= p.down_after and n > p.min_replicas:
            action, replica, reason = self._scale_down(snap, serving)
        if action in ("up", "down"):
            self._last_change = tick
            self._hi_streak = self._lo_streak = 0
        snap_after = self.router.fleet_snapshot()
        n_after = len(self._serving(snap_after))
        obs.gauge("autoscale.replicas", float(n_after))
        record = {"tick": tick, "action": action, "replica": replica,
                  "reason": reason, "replicas": n_after,
                  "epoch": snap_after["epoch"]}
        self.decisions.append(record)
        if action != "hold":
            obs.event("autoscale.decision", tick=tick, action=action,
                      replica=replica, reason=reason,
                      replicas=n_after, epoch=snap_after["epoch"])
        return record

    # --------------------------------------------------------- actuators

    def _scale_up(self, reason: str) -> tuple:
        """Admit the first live warm-pool candidate.  Health-gated
        before ``add_replica`` and verified up after it: a candidate
        that died in the pool or mid-join is discarded — never a
        route-table entry for a dead replica — and the next
        candidate is tried.  Empty (or fully dead) pool: the
        scale-up is recorded as exhausted and retried next time the
        streak rebuilds."""
        while True:
            cand = self.pool.take()
            if cand is None:
                obs.count("autoscale.pool_exhausted")
                return "exhausted", None, reason
            name = cand.name
            try:
                chaos.probe("autoscale.join")
                alive = bool(cand.healthy())
            except Exception:  # noqa: BLE001 — a dead probe is dead
                alive = False
            if alive:
                try:
                    self.router.add_replica(cand)
                except Exception:  # noqa: BLE001 — join raced death
                    alive = False
                else:
                    if name not in self.router.replicas_up():
                        # Died between the gate and the join: the
                        # membership entry is DOWN — drop it so a
                        # dead replica never lingers in the table.
                        self.router.remove_replica(name)
                        alive = False
            if alive:
                obs.count("autoscale.scale_ups")
                return "up", name, reason
            obs.count("autoscale.join_aborts")
            obs.event("autoscale.decision", tick=self._tick,
                      action="abort", replica=name,
                      reason="join-health-gate",
                      replicas=len(self.router.replicas_up()),
                      epoch=self.router.epoch)

    def _scale_down(self, snap: dict, serving: dict) -> tuple:
        """Retire the least-loaded serving replica that is SAFE to
        drop: one whose advertised pinned ``prefix_id``\\ s are all
        resident on some other serving replica (pool entries and
        disagg pins are replica-local, so in practice: no live
        pins).  No safe victim -> defer until an unpin."""
        others_ok = []
        for name in sorted(serving,
                           key=lambda n: (serving[n]["load"], n)):
            mine = set(serving[name]["prefix_ids"])
            elsewhere = set()
            for n2, r2 in serving.items():
                if n2 != name:
                    elsewhere |= set(r2["prefix_ids"])
            if mine <= elsewhere:
                others_ok.append(name)
        if not others_ok:
            obs.count("autoscale.retire_deferred")
            return "defer", None, "pinned-last-holder"
        victim = others_ok[0]
        handle = self.router.remove_replica(victim)
        if handle is not None:
            if self._release is not None:
                self._release(handle)
            else:
                self.pool.put(handle)
        obs.count("autoscale.scale_downs")
        del snap
        return "down", victim, "idle"


__all__ = ["Autoscaler", "AutoscalePolicy", "WarmPool"]

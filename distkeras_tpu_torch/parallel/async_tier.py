"""Bounded-staleness async parameter-serving plane.

Counterpart of ``distkeras_tpu/parallel/async_tier.py``: hosts train
locally and exchange PARAMETER DELTAS with a central plane
asynchronously, under a staleness bound ``tau`` (a host may start round
``r`` only while ``r - min(fleet rounds) <= tau``; past it a slow but
alive laggard parks the fast host under a hard-sync barrier, while a
laggard whose heartbeat froze is evicted by the watchdog after
``beat_window`` virtual seconds).  Deltas reduce up an explicit
``fanout``-ary aggregator tree (Adasum by default, or the sum), over an
int8 error-feedback wire (per-host residual carried to the next push).
Hosts join (bootstrapped from the center) and leave (their final delta
pushed first) mid-run.

Every decision reads one seeded :class:`VirtualClock`; round durations,
stalls, joins and leaves are pure functions of ``(seed, schedule)``, so
an interleaving replays bit for bit, and equals the reference's (the
same ``SeedSequence`` draws, the same event order).

Chaos probe sites (``resilience/chaos.py``): ``cluster.push`` fires
before a host's delta publishes (a fault there drops it cleanly) and
``cluster.merge`` before the root applies a wave (a fault leaves center
and pending buffer intact; the wave retries on the next push).

``coord_dir=`` roots the plane on the cluster substrate
(``resilience/cluster.py``, ``resilience/health.py``): every membership
transition requests the next :class:`EpochStore` epoch, and the
heartbeats are real ``health.write_beat`` files under
``<coord_dir>/beats`` stamped with the virtual clock, so an external
supervisor can observe the fleet's composition history.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from distkeras_tpu_torch import obs
from distkeras_tpu_torch.parallel.exchange import (adasum_combine,
                                                   int8_decode, int8_encode)
from distkeras_tpu_torch.parallel.tree import (tree_flatten, tree_leaves,
                                               tree_unflatten)

_MERGE_RULES = ("adasum", "sum")
_COMPRESS = (None, "int8")


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Knobs of the async tier (validated at construction): ``tau`` the
    staleness bound in rounds, ``beat_window`` the heartbeat-staleness
    window in virtual seconds."""

    tau: int = 4
    merge_rule: str = "adasum"
    compress: str | None = "int8"
    fanout: int = 2
    beat_window: float = 3.0

    def __post_init__(self):
        if self.tau < 1:
            raise ValueError(f"tau must be >= 1, got {self.tau}")
        if self.merge_rule not in _MERGE_RULES:
            raise ValueError(
                f"merge_rule must be one of {_MERGE_RULES}, "
                f"got {self.merge_rule!r}")
        if self.compress not in _COMPRESS:
            raise ValueError(
                f"compress must be one of {_COMPRESS}, "
                f"got {self.compress!r}")
        if self.fanout < 2:
            raise ValueError(f"fanout must be >= 2, got {self.fanout}")
        if self.beat_window <= 0:
            raise ValueError(
                f"beat_window must be > 0, got {self.beat_window}")


class VirtualClock:
    """Monotone virtual time: the one clock every schedule, heartbeat
    and staleness decision reads."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def advance_to(self, t: float) -> float:
        if t < self._now:
            raise ValueError(
                f"virtual time moved backwards: {t} < {self._now}")
        self._now = float(t)
        return self._now

    def __call__(self) -> float:
        return self._now


class AsyncSchedule:
    """Seeded per-host round timing and membership events:
    ``duration(host, rnd)`` is a pure function of ``(seed, host, rnd)``.
    ``stall(host, at_round, extra)`` (that round takes ``extra`` more
    virtual seconds and the host's heartbeat wedges), ``join(host,
    at_time)``, ``leave(host, after_round)``; each returns ``self``."""

    def __init__(self, seed: int = 0, base: float = 1.0,
                 jitter: float = 0.25):
        if base <= 0:
            raise ValueError(f"base must be > 0, got {base}")
        if not 0 <= jitter < 1:
            raise ValueError(f"jitter must be in [0, 1), got {jitter}")
        self.seed = int(seed)
        self.base = float(base)
        self.jitter = float(jitter)
        self._stalls: dict[tuple[int, int], float] = {}
        self._joins: list[tuple[float, int]] = []
        self._leaves: dict[int, int] = {}

    def duration(self, host: int, rnd: int) -> float:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, int(host), int(rnd)]))
        d = self.base * (1.0 + self.jitter * (2.0 * rng.random() - 1.0))
        return d + self._stalls.get((host, rnd), 0.0)

    def stall(self, host: int, at_round: int,
              extra: float) -> "AsyncSchedule":
        if extra < 0:
            raise ValueError(f"extra must be >= 0, got {extra}")
        self._stalls[(int(host), int(at_round))] = float(extra)
        return self

    def stalled(self, host: int, rnd: int) -> bool:
        return (int(host), int(rnd)) in self._stalls

    def join(self, host: int, at_time: float) -> "AsyncSchedule":
        self._joins.append((float(at_time), int(host)))
        self._joins.sort()
        return self

    def joins(self) -> list[tuple[float, int]]:
        return list(self._joins)

    def leave_after(self, host: int) -> int | None:
        return self._leaves.get(int(host))

    def leave(self, host: int, after_round: int) -> "AsyncSchedule":
        self._leaves[int(host)] = int(after_round)
        return self


# --------------------------------------------------------- merge kernels


def combine_group(deltas: list, merge_rule: str):
    """Merge one aggregator group's deltas (trees of tensors): per leaf,
    Adasum over the flattened vectors, or their sum."""
    if len(deltas) == 1:
        return deltas[0]
    flat = [tree_flatten(d) for d in deltas]
    spec = flat[0][1]
    out = []
    for leaves in zip(*(f[0] for f in flat)):
        x = torch.stack(leaves)
        if merge_rule == "adasum":
            out.append(adasum_combine(x.reshape(x.shape[0], -1)).reshape(
                x.shape[1:]))
        else:
            out.append(x.sum(0))
    return tree_unflatten(spec, out)


def tree_reduce(deltas: list, fanout: int, merge_rule: str):
    """Reduce ``m`` host deltas up the ``fanout``-ary aggregator tree
    (its shape depends only on ``m``)."""
    while len(deltas) > 1:
        deltas = [combine_group(deltas[i:i + fanout], merge_rule)
                  for i in range(0, len(deltas), fanout)]
    return deltas[0]


def _encode_ef(delta, residual):
    """Error-feedback int8 encode of a delta tree, one row per leaf:
    ``(q trees, scale trees, decoded tree, new residual)``."""
    dl, spec = tree_flatten(delta)
    q, s, dec, res = [], [], [], []
    for d, r in zip(dl, tree_leaves(residual)):
        x = d.float() + r
        qi, si = int8_encode(x.reshape(1, -1))
        di = int8_decode(qi, si).reshape(d.shape)
        q.append(qi), s.append(si), dec.append(di), res.append(x - di)
    return (tree_unflatten(spec, q), tree_unflatten(spec, s),
            tree_unflatten(spec, dec), tree_unflatten(spec, res))


def delta_of(tv_new, tv_pulled):
    """``tv_new - tv_pulled`` (new tensors)."""
    a, spec = tree_flatten(tv_new)
    return tree_unflatten(spec, [x.detach() - y for x, y in
                                 zip(a, tree_leaves(tv_pulled))])


def apply_delta(center, delta):
    a, spec = tree_flatten(center)
    return tree_unflatten(spec, [x + d for x, d in
                                 zip(a, tree_leaves(delta))])


def copy_tree(tree):
    """A real copy: the trainers update their state in place, so the
    center never aliases anything a step touches."""
    a, spec = tree_flatten(tree)
    return tree_unflatten(spec, [x.detach().clone() for x in a])


def wire_cost_bytes(q_tree, scale_tree) -> int:
    """One push's cross-host bytes: the int8 payload plus its f32
    per-row scales."""
    qb = sum(q.numel() for q in tree_leaves(q_tree))
    sb = sum(s.numel() * 4 for s in tree_leaves(scale_tree))
    return qb + sb


# ------------------------------------------------------------- the plane


@dataclasses.dataclass
class HostSlot:
    """Per-member bookkeeping: completed round, pulled center version,
    heartbeat freeze state, and the int8 EF residual."""

    round: int = 0
    version: int = 0
    joined_at: float = 0.0
    frozen_at: float | None = None
    residual: Any = None
    beats: int = 0


class AsyncPlane:
    """The parameter-serving plane: center params, elastic membership
    and the aggregation tree under one virtual clock.  ``push`` probes
    ``cluster.push`` before anything is enqueued; an aggregation wave
    probes ``cluster.merge`` before the center mutates — no torn merge
    is representable."""

    def __init__(self, center, config: AsyncConfig, clock: VirtualClock,
                 coord_dir: str | None = None):
        self.config = config
        self.clock = clock
        self.center = copy_tree(center)
        self.version = 0
        self.members: dict[int, HostSlot] = {}
        self.pending: list[tuple[int, Any]] = []
        self.pushes = 0
        self.merges = 0
        self.hard_syncs = 0
        self.evicted: list[int] = []
        self.dropped_deltas = 0
        self.wire_bytes = 0
        self.epoch = 0
        self._store = None
        self._hb_dir = None
        if coord_dir is not None:
            import os

            from distkeras_tpu_torch.resilience.cluster import EpochStore

            self._store = EpochStore(coord_dir)
            self._store.request(self.epoch)
            self._hb_dir = os.path.join(coord_dir, "beats")

    # ------------------------------------------------------- membership

    def _bump_epoch(self) -> None:
        """Every membership transition is a cluster-epoch generation
        (the marker-file contract of coordinated restarts)."""
        self.epoch += 1
        if self._store is not None:
            self._store.request(self.epoch)

    def join(self, host: int):
        """Register ``host`` at the fleet's max round; returns
        ``(params, version)`` copied from the center."""
        if host in self.members:
            raise ValueError(f"host {host} is already a member")
        rnd = max((m.round for m in self.members.values()), default=0)
        a, spec = tree_flatten(self.center)
        self.members[host] = HostSlot(
            round=rnd, version=self.version, joined_at=self.clock.now(),
            residual=tree_unflatten(spec, [torch.zeros_like(x, dtype=torch.float32)
                                           for x in a]))
        self._bump_epoch()
        self.beat(host)
        obs.event("async.join", host=host, round=rnd,
                  version=self.version, t=self.clock.now())
        obs.gauge("async.members", len(self.members))
        return copy_tree(self.center), self.version

    def leave(self, host: int, final_delta=None) -> None:
        """Graceful deregistration (a ``final_delta`` is pushed first)."""
        self._require_member(host)
        if final_delta is not None:
            self.push(host, final_delta)
        self._write_beat(host, done=True)
        del self.members[host]
        self._bump_epoch()
        obs.event("async.leave", host=host, t=self.clock.now())
        obs.gauge("async.members", len(self.members))

    def evict(self, host: int, reason: str) -> None:
        """Drop a member and every in-flight delta it owns."""
        self._require_member(host)
        before = len(self.pending)
        self.pending = [(h, d) for h, d in self.pending if h != host]
        self.dropped_deltas += before - len(self.pending)
        del self.members[host]
        self.evicted.append(host)
        self._bump_epoch()
        obs.event("async.evict", host=host, reason=reason,
                  dropped=before - len(self.pending), t=self.clock.now())
        obs.count("async.evictions", 1, reason=reason)
        obs.gauge("async.members", len(self.members))

    def _require_member(self, host: int) -> None:
        if host not in self.members:
            raise KeyError(f"host {host} is not a member "
                           f"(members: {sorted(self.members)})")

    # -------------------------------------------------------- heartbeats

    def _write_beat(self, host: int, done: bool = False) -> None:
        if self._hb_dir is not None:
            from distkeras_tpu_torch.resilience.health import write_beat

            write_beat(self._hb_dir, host, self.epoch,
                       self.members[host].beats, clock=self.clock,
                       done=done)

    def beat(self, host: int) -> None:
        """One virtual-time heartbeat (a frozen writer publishes
        nothing)."""
        m = self.members[host]
        if m.frozen_at is not None:
            return
        m.beats += 1
        self._write_beat(host)

    def freeze_beats(self, host: int) -> None:
        self._require_member(host)
        self.members[host].frozen_at = self.clock.now()

    def thaw_beats(self, host: int) -> None:
        if host in self.members:
            self.members[host].frozen_at = None
            self.beat(host)

    def stale(self, host: int) -> bool:
        """The writer froze more than ``beat_window`` virtual seconds
        ago (or the host is gone)."""
        m = self.members.get(host)
        if m is None:
            return True
        return (m.frozen_at is not None
                and self.clock.now() - m.frozen_at > self.config.beat_window)

    # ------------------------------------------------------ delta plane

    def pull(self, host: int):
        self._require_member(host)
        self.members[host].version = self.version
        return copy_tree(self.center), self.version

    def push(self, host: int, delta) -> None:
        """Publish one host's delta: probe, int8 EF encode (the wire
        leg), enqueue, and merge the wave at once."""
        from distkeras_tpu_torch.resilience import chaos

        self._require_member(host)
        chaos.probe("cluster.push", step=self.pushes + 1)
        self.pushes += 1
        m = self.members[host]
        if self.config.compress == "int8":
            q, scale, decoded, m.residual = _encode_ef(delta, m.residual)
            cost = wire_cost_bytes(q, scale)
        else:
            a, spec = tree_flatten(delta)
            decoded = tree_unflatten(spec, [x.float() for x in a])
            cost = sum(x.numel() * 4 for x in a)
        self.wire_bytes += cost
        obs.count("async.push", 1, host=host)
        obs.count("async.wire_bytes", cost, host=host)
        self.pending.append((host, decoded))
        self._merge_pending()

    def _merge_pending(self) -> None:
        from distkeras_tpu_torch.resilience import chaos

        if not self.pending:
            return
        try:
            chaos.probe("cluster.merge", step=self.merges + 1)
        except chaos.FaultInjected:
            obs.event("async.merge_fault", pending=len(self.pending),
                      t=self.clock.now())
            return
        merged = tree_reduce([d for _, d in self.pending],
                             self.config.fanout, self.config.merge_rule)
        self.center = apply_delta(self.center, merged)
        self.version += 1
        self.merges += 1
        self.pending = []
        obs.gauge("async.version", self.version)

    def flush(self) -> None:
        """Drain any wave a ``cluster.merge`` fault deferred."""
        self._merge_pending()

    def complete(self, host: int) -> int:
        """Mark one finished local round; returns the new round."""
        self._require_member(host)
        m = self.members[host]
        m.round += 1
        self.beat(host)
        obs.gauge("async.round", m.round, host=host)
        self._lag_gauges()
        return m.round

    # -------------------------------------------------------- staleness

    def min_round(self) -> int:
        return min((m.round for m in self.members.values()), default=0)

    def laggards(self, next_round: int) -> list[int]:
        return sorted(h for h, m in self.members.items()
                      if next_round - m.round > self.config.tau)

    def may_start(self, host: int,
                  next_round: int) -> tuple[bool, list[int]]:
        """The SSP gate (a blocked start is a hard-sync park, counted
        and evented)."""
        self._require_member(host)
        lag = [h for h in self.laggards(next_round) if h != host]
        if lag:
            self.hard_syncs += 1
            obs.event("async.hard_sync", host=host, round=next_round,
                      laggards=",".join(map(str, lag)),
                      t=self.clock.now())
            return False, lag
        return True, []

    def _lag_gauges(self) -> None:
        if not self.members:
            return
        lo = self.min_round()
        for h, m in self.members.items():
            obs.gauge("async.round_lag", m.round - lo, host=h)
        obs.gauge("async.staleness",
                  max(m.round for m in self.members.values()) - lo)


__all__ = ["AsyncConfig", "AsyncSchedule", "AsyncPlane", "VirtualClock",
           "HostSlot", "tree_reduce", "combine_group", "delta_of",
           "apply_delta", "copy_tree", "wire_cost_bytes"]

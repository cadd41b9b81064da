"""AsyncDP: bounded-staleness asynchronous data parallelism over hosts.

Counterpart of ``distkeras_tpu/trainers/async_dp.py`` (reference
parity: distkeras/trainers.py DOWNPOUR/AEASGD, async workers committing
deltas to a parameter server).  Each *host* is a world-1 ADAG
configuration — the same accumulation step — with its own parameters,
optimizer state and contiguous data shard, and hosts exchange parameter
deltas through the :class:`~distkeras_tpu_torch.parallel.async_tier.
AsyncPlane` under the staleness bound ``tau``, the aggregation tree and
the int8 error-feedback wire.

Hosts are simulated in one process under a seeded virtual-time clock:
round completions, stalls, barrier parks, watchdog evictions, joins and
leaves form a discrete-event loop that is a pure function of ``(seed,
schedule)`` — the reference's loop, event for event (the same
``(time, seq)`` heap keys).  Per host and round:

1. ``pull`` the center at version v;
2. one accumulation round on the host's next window;
3. ``push`` ``delta = tv_after - tv_pulled`` (the ``cluster.push`` chaos
   probe, int8-EF encoded) into the tree;
4. re-pull and start the next round unless the SSP gate blocks it.

A host killed mid-push (a ``fail`` rule on ``cluster.push``) publishes
nothing and leaves the membership.  ``coord_dir=`` roots the plane's
membership epochs and heartbeat files on the cluster substrate, and a
``checkpoint_dir`` receives the final center under step
``plane.version``.
"""

from __future__ import annotations

import heapq

import torch

from distkeras_tpu_torch import obs
from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.models.adapter import TrainState
from distkeras_tpu_torch.parallel.async_tier import (AsyncConfig, AsyncPlane,
                                                     AsyncSchedule,
                                                     VirtualClock, copy_tree,
                                                     delta_of)
from distkeras_tpu_torch.resilience import chaos
from distkeras_tpu_torch.trainers.distributed import ADAG


class AsyncDP(ADAG):
    """Bounded-staleness async DP: ``hosts`` simulated hosts, staleness
    bound ``tau``, ``async_merge`` ("adasum"/"sum") up a ``fanout``-ary
    tree, ``async_compress`` (None/"int8") on the wire, ``schedule`` an
    :class:`AsyncSchedule` (stalls, joins, leaves; default the plain
    seeded one), ``coord_dir`` the cluster directory of the plane's
    epochs and heartbeats.  The intra-host ADAG knobs compose except
    ``device_data``.  After ``train()``,
    ``async_report`` holds the audit trail: virtual makespan, per-host
    rounds, hard syncs, evictions, wire bytes and the center version."""

    _supports_device_data = False

    def __init__(self, keras_model, hosts: int = 2, tau: int = 4,
                 async_merge: str = "adasum",
                 async_compress: str | None = "int8",
                 fanout: int = 2, beat_window: float = 3.0,
                 schedule: AsyncSchedule | None = None,
                 async_seed: int = 0, coord_dir: str | None = None,
                 **kw):
        super().__init__(keras_model, **kw)
        if hosts < 1:
            raise ValueError(f"hosts must be >= 1, got {hosts}")
        if self.adapter.ntv_paths:
            raise ValueError(
                "AsyncDP needs a model without non-trainable training "
                "state (BatchNorm running stats, seeded Dropout): "
                "per-host local rounds would diverge it — train such "
                "models with the synchronous trainers")
        if self.num_workers != 1:
            raise ValueError(
                "AsyncDP simulates its hosts in one process, each a "
                f"world-1 ADAG; got num_workers={self.num_workers}")
        self.hosts = int(hosts)
        self.async_config = AsyncConfig(
            tau=tau, merge_rule=async_merge, compress=async_compress,
            fanout=fanout, beat_window=beat_window)
        self.schedule = schedule if schedule is not None \
            else AsyncSchedule(seed=async_seed)
        self.coord_dir = coord_dir
        self.async_report: dict | None = None

    def _host_windows(self, dataset: Dataset):
        """Contiguous per-host shards, pre-shaped into rounds: the
        epoch's window stream split into ``hosts`` equal runs."""
        w = self.communication_window
        H = self.exchange.sync_every
        feed_bs = self.batch_size * self.num_workers
        wins = []
        for xs, ys in dataset.batches(
                feed_bs, features_col=self.features_col,
                label_col=self.label_col, window=w * H):
            if H > 1:
                xs = xs.reshape((H, w) + xs.shape[1:])
                ys = ys.reshape((H, w) + ys.shape[1:])
            wins.append((xs, ys))
        per_host = len(wins) // self.hosts
        if per_host < 1:
            raise ValueError(
                f"dataset yields {len(wins)} round windows but the "
                f"fleet has {self.hosts} hosts; reduce hosts/batch_size/"
                "communication_window or provide more data")
        shards = [wins[h * per_host:(h + 1) * per_host]
                  for h in range(self.hosts)]
        return shards, feed_bs * w * H, per_host

    def _fit(self, dataset: Dataset):
        cfg = self.async_config
        sched = self.schedule
        state0 = self.adapter.init_state()
        step = self._accum_step_fn()
        shards, rows_per_round, per_host = self._host_windows(dataset)

        clock = VirtualClock()
        plane = AsyncPlane(state0.tv, cfg, clock, coord_dir=self.coord_dir)
        opt = self.adapter.optimizer

        # Per-host islands: each host's tv tensors are its own (the
        # optimizer state is bound to them and stays host-local, the
        # DOWNPOUR split); a pull copies the center into them.
        states: dict[int, TrainState] = {}
        pulled: dict[int, list] = {}
        cursor: dict[int, int] = {}
        quota: dict[int, int] = {}
        shard_of: dict[int, int] = {}
        parked: dict[int, list] = {}
        dead: set[int] = set()
        losses: list[float] = []
        rounds_done: dict[int, int] = {}

        # Discrete events: (time, seq, kind, host); seq breaks ties in
        # insertion order.
        events: list[tuple] = []
        seq = 0
        t_work = 0.0

        def push_event(t, kind, host):
            nonlocal seq
            heapq.heappush(events, (t, seq, kind, host))
            seq += 1

        def admit(host, shard_idx, n_rounds):
            tv, _ = plane.join(host)
            tv = [t.requires_grad_(True) for t in tv]
            states[host] = TrainState(
                tv=tv, ntv=copy_tree(state0.ntv), opt_state=opt.init(tv),
                step=state0.step)
            pulled[host] = copy_tree(tv)
            cursor[host] = 0
            quota[host] = n_rounds
            shard_of[host] = shard_idx
            rounds_done[host] = 0

        def start_round(host):
            rnd = plane.members[host].round + 1
            if sched.stalled(host, rnd):
                plane.freeze_beats(host)
            push_event(clock.now() + sched.duration(host, rnd),
                       "complete", host)

        def gate(host):
            rnd = plane.members[host].round
            left = sched.leave_after(host)
            if cursor[host] >= quota[host] or (left is not None
                                               and rnd >= left):
                plane.leave(host)
                states.pop(host), pulled.pop(host)
                return
            ok, lag = plane.may_start(host, rnd + 1)
            if ok:
                start_round(host)
            else:
                parked[host] = lag
                push_event(clock.now() + cfg.beat_window, "watchdog",
                           host)

        def unpark():
            for host in sorted(parked):
                rnd = plane.members[host].round
                if not [h for h in plane.laggards(rnd + 1) if h != host]:
                    parked.pop(host)
                    gate(host)

        for h in range(self.hosts):
            admit(h, h, self.num_epoch * per_host)
        for h in sorted(states):
            start_round(h)
        joins = list(sched.joins())

        while events:
            t, _, kind, host = heapq.heappop(events)
            clock.advance_to(t)
            while joins and joins[0][0] <= t:
                _, jh = joins.pop(0)
                if jh not in states and jh not in dead:
                    admit(jh, jh % self.hosts, per_host)
                    start_round(jh)
            if kind == "watchdog":
                if host not in parked:
                    continue
                for lag in list(parked[host]):
                    if lag in plane.members and plane.stale(lag):
                        plane.evict(lag, reason="heartbeat_stale")
                        dead.add(lag)
                        states.pop(lag, None), pulled.pop(lag, None)
                        parked.pop(lag, None)
                if host in parked and any(
                        plane.members[l].frozen_at is not None
                        for l in parked[host] if l in plane.members):
                    push_event(t + cfg.beat_window, "watchdog", host)
                unpark()
                continue
            if host not in states or host in dead:
                continue
            if host in parked:
                continue
            plane.thaw_beats(host)
            shard = shards[shard_of[host]]
            xs, ys = shard[cursor[host] % len(shard)]
            with self.step_timer.phase("h2d"):
                args = (torch.as_tensor(xs, device=self.device),
                        torch.as_tensor(ys, device=self.device))
            with self.step_timer.phase("step"):
                state, loss = step(states[host], *args)
            delta = delta_of(state.tv, pulled[host])
            try:
                plane.push(host, delta)
            except chaos.FaultInjected:
                plane.evict(host, reason="push_fault")
                dead.add(host)
                states.pop(host, None), pulled.pop(host, None)
                obs.count("async.push_faults", 1, host=host)
                unpark()
                continue
            cursor[host] += 1
            rounds_done[host] = plane.complete(host)
            t_work = t
            losses.append(float(loss))
            center, _ = plane.pull(host)
            with torch.no_grad():
                for p, c in zip(state.tv, center):
                    p.copy_(c)
            states[host] = state
            pulled[host] = copy_tree(center)
            gate(host)
            unpark()

        plane.flush()
        self._require_steps(losses, rows_per_round, len(dataset))
        self._record(losses)
        self.async_report = {
            "makespan": t_work,
            "rounds": dict(sorted(rounds_done.items())),
            "hard_syncs": plane.hard_syncs,
            "evicted": list(plane.evicted),
            "dropped_deltas": plane.dropped_deltas,
            "pushes": plane.pushes,
            "merges": plane.merges,
            "version": plane.version,
            "wire_bytes": plane.wire_bytes,
            "epoch": plane.epoch,
            "members_final": sorted(plane.members),
        }
        obs.gauge("async.makespan", t_work)
        final = TrainState(tv=plane.center, ntv=copy_tree(state0.ntv),
                           opt_state=None,
                           step=sum(rounds_done.values(), 0))
        self._checkpoint(lambda: self._state_tree(final), plane.version,
                         final=True)
        return final

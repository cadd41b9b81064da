"""Cluster health: per-host heartbeats over a shared directory.

The port's own copy of ``distkeras_tpu/resilience/health.py``.

The multi-host failure mode a per-process supervisor cannot cover:
synchronous data-parallel training blocks in a collective every step,
so when one host of the job dies the survivors do not crash — they
HANG, forever, inside the next all-reduce (the classic sync-SGD stall: one dead
participant freezes the whole step DAG, arXiv:1805.03812).  Nothing
host-local can notice that, because the hung host is perfectly healthy;
what died is a *peer*.  This module is the peer-visibility layer the
cluster supervisor (:mod:`distkeras_tpu_torch.resilience.cluster`)
builds its bounded-window detection on:

- :class:`HeartbeatWriter` — a daemon thread on every host that
  appends a fresh beat (atomic file replace) every ``interval``
  seconds.  The write goes through the ``cluster.heartbeat`` chaos
  probe, so fault plans can stall it (partition: the host is alive but
  its beats stop arriving) or kill the host outright.
- :class:`HealthMonitor` — reads every host's beat file and reports
  which peers are **stale** (no beat within ``window`` seconds).  Pure
  read-side; safe to poll from a watchdog thread while the main thread
  is wedged in a collective.

Deliberately file-based (any shared filesystem — NFS, GCS-fuse, or a
plain tmpdir in the multiprocess tests) and stdlib-only: the driver
process that supervises restarts never joins a process group or
touches a device (the chaos probe is imported lazily).  Clocks: beats
carry ``time.time()`` wall time; on a single machine (the test
harness) that is one clock, and on a real cluster NTP skew just widens
the effective window — choose ``window`` >> ``interval`` + worst-case
skew.
"""

from __future__ import annotations

import json
import os
import threading
import time


def _beat_path(directory: str, host: int) -> str:
    return os.path.join(directory, f"host{host}.hb")


def write_beat(directory: str, host: int, epoch: int, n: int,
               clock=time.time, done: bool = False) -> None:
    """Atomically publish one beat (tmp + ``os.replace`` — a reader
    never sees a torn beat).  ``done=True`` is the terminal beat: this
    host finished its work cleanly and will stop beating; monitors
    must not read the ensuing silence as a death."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".hb.{host}.{os.getpid()}.tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"host": host, "epoch": epoch, "n": n,
                   "t": clock(), "pid": os.getpid(), "done": done}, f)
    os.replace(tmp, _beat_path(directory, host))


def read_beat(directory: str, host: int) -> dict | None:
    """The host's latest beat, or None if it has never beaten (or the
    file is unreadable mid-replace on a non-atomic filesystem)."""
    try:
        with open(_beat_path(directory, host), encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def beat_age(directory: str, host: int,
             clock=time.time) -> tuple[float, bool] | None:
    """``(age_seconds, done)`` of the host's latest beat, or None when
    it never beat: the freshness primitive (fresh within the window,
    stale past it, ``done`` a clean completion that is always
    healthy)."""
    beat = read_beat(directory, host)
    if beat is None:
        return None
    return clock() - beat.get("t", 0.0), bool(beat.get("done"))


class HeartbeatWriter:
    """Daemon thread: publish a beat every ``interval`` seconds.

    Each beat passes the ``cluster.heartbeat`` chaos probe first, so a
    :class:`~distkeras_tpu_torch.resilience.chaos.FaultPlan` can ``delay``
    (stalled host), ``drop`` (partition: alive but invisible), or
    ``kill`` (hard host loss) the heartbeat stream deterministically.
    """

    def __init__(self, directory: str, host: int, epoch: int = 0,
                 interval: float = 0.5, clock=time.time):
        if interval <= 0:
            raise ValueError(f"interval must be > 0, got {interval}")
        self.directory = directory
        self.host = host
        self.epoch = epoch
        self.interval = interval
        self._clock = clock
        self._stop = threading.Event()
        self._thread = None
        self.beats = 0

    def beat_once(self) -> None:
        """One beat, chaos-probed (the writer thread's body; also
        callable directly from a round loop for progress-coupled
        beats)."""
        from distkeras_tpu_torch.resilience import chaos

        try:
            chaos.probe("cluster.heartbeat", step=self.beats + 1)
        except chaos.BeatDropped:
            return  # partition: stay alive, publish nothing
        self.beats += 1
        write_beat(self.directory, self.host, self.epoch, self.beats,
                   clock=self._clock)

    def start(self) -> "HeartbeatWriter":
        if self._thread is not None:
            raise RuntimeError("heartbeat writer already started")
        self.beat_once()  # first beat lands before start() returns

        def run():
            while not self._stop.wait(self.interval):
                self.beat_once()

        self._thread = threading.Thread(
            target=run, name=f"dkt-heartbeat-host{self.host}", daemon=True)
        self._thread.start()
        return self

    def mark_done(self) -> None:
        """Publish the terminal beat (``done=True``) and stop the
        thread: clean completion, not death.  The done beat passes the
        ``cluster.heartbeat`` chaos probe like every other beat — a
        partition that swallows a host's heartbeats must swallow its
        completion announcement too, or a partitioned host could fake
        clean completion to its peers."""
        from distkeras_tpu_torch.resilience import chaos

        self.stop()
        try:
            chaos.probe("cluster.heartbeat", step=self.beats + 1)
        except chaos.BeatDropped:
            return  # partitioned: the done beat never arrives either
        self.beats += 1
        write_beat(self.directory, self.host, self.epoch, self.beats,
                   clock=self._clock, done=True)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class HealthMonitor:
    """Read-side peer health over the shared beat directory.

    A peer is **stale** when its last beat is older than ``window``
    seconds (or it never beat at all once ``grace`` has elapsed since
    the monitor started — covers a host that died before its first
    beat).  ``stale_peers`` is what the collective watchdog polls; it
    never blocks and never touches a device.
    """

    def __init__(self, directory: str, host: int, num_hosts: int,
                 window: float = 3.0, grace: float | None = None,
                 clock=time.time):
        if num_hosts < 1:
            raise ValueError(f"num_hosts must be >= 1, got {num_hosts}")
        if window <= 0:
            raise ValueError(f"window must be > 0, got {window}")
        self.directory = directory
        self.host = host
        self.num_hosts = num_hosts
        self.window = window
        self.grace = window if grace is None else grace
        self._clock = clock
        self._born = clock()

    def peer_ids(self) -> list[int]:
        return [h for h in range(self.num_hosts) if h != self.host]

    def stale_peers(self, epoch: int | None = None) -> list[int]:
        """Hosts whose beats are missing or stale.  ``epoch``: ignore
        beats from older epochs (a relaunched host's stale pre-restart
        file must not count as liveness in the new generation)."""
        now = self._clock()
        stale = []
        for h in self.peer_ids():
            beat = read_beat(self.directory, h)
            if beat is not None and epoch is not None \
                    and beat.get("epoch", 0) < epoch:
                beat = None
            if beat is None:
                if now - self._born >= self.grace:
                    stale.append(h)
                continue
            if beat.get("done"):
                continue  # clean completion: silence is not death
            if now - beat.get("t", 0.0) > self.window:
                stale.append(h)
        return stale

    def alive(self, epoch: int | None = None) -> bool:
        return not self.stale_peers(epoch=epoch)


__all__ = ["HeartbeatWriter", "HealthMonitor", "write_beat",
           "read_beat", "beat_age"]

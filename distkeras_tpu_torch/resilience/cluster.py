"""Coordinated multi-host restart: cluster epochs, watchdogs, drivers.

The port's own copy of ``distkeras_tpu/resilience/cluster.py``.  The
:class:`~distkeras_tpu_torch.resilience.supervisor.Supervisor` makes
each *process* durable; this module makes the *job* durable.  The gap
it closes: synchronous data-parallel training steps through
collectives, so when one host dies the survivors neither crash nor
retry — they block forever inside the next all-reduce (SURVEY.md §5's
"the job dies", upgraded to "the job hangs").  A hung host cannot save
itself from the inside: the main thread is wedged in a collective.  Recovery
therefore has three cooperating layers, all coordinated through one
shared **cluster directory** (any shared filesystem; stdlib-only so
the driver never joins a process group):

- **Epoch store** (:class:`EpochStore`) — a monotone generation
  counter published as marker files.  Every ``torch.distributed``
  group the job ever forms is stamped with the epoch it belongs to; a
  restart is "everyone moves to epoch N+1", and the per-epoch
  coordinator port (``base_port + epoch``, the group's
  ``MASTER_PORT``) means a stale epoch's half-dead group can never be
  rejoined by accident.
- **Member** (:class:`ClusterMember`) — runs *inside* each training
  process: a heartbeat writer (health.py) plus the **collective
  watchdog** thread.  The watchdog polls peer heartbeats; when a peer
  goes stale (died, stalled, partitioned) or the epoch moves on, it
  requests the next epoch and aborts THIS process (``os._exit`` with
  :data:`EXIT_RESTART`) — the only reliable way out of a blocked
  collective, and exactly what a preemption looks like to the rest of
  the stack, so the per-host Supervisor/checkpoint machinery needs no
  new cases.
- **Driver** (:class:`ClusterSupervisor`) — runs *outside* (one per
  host, no process group): launches the training process for the current epoch,
  watches peers and the epoch store itself (covering the case where
  the training process died before its watchdog could act), kills and
  relaunches under the next epoch, and — on restart — trims every
  host's checkpoint store to the latest **cluster-consistent** step
  (:func:`cluster_consistent_step`: the highest step committed AND
  valid on every host) so all hosts resume from the same state and the
  resumed run replays the uninterrupted trajectory bit-for-bit.

The per-process fault matrix drives this layer end to end:
``FaultPlan.kill`` (host-kill), ``delay`` on ``cluster.heartbeat``
(stall) and ``drop`` (partition) — see tests/test_torch_cluster.py.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time

from distkeras_tpu_torch.resilience.health import (HealthMonitor,
                                                   HeartbeatWriter)

# The exit code a member uses to say "I aborted for a cluster restart,
# relaunch me under the next epoch" (EX_TEMPFAIL).  Any OTHER nonzero
# exit also triggers a restart — this one just names the reason.
EXIT_RESTART = 75


class ClusterGivenUp(RuntimeError):
    """The driver exhausted ``max_restarts`` coordinated restarts."""


# --------------------------------------------------------------- epochs


class EpochStore:
    """Monotone cluster generation counter over marker files.

    ``request(e)`` creates ``<dir>/epochs/<e>`` (atomic, idempotent —
    any number of hosts may request the same epoch concurrently);
    ``current()`` is the highest requested epoch, 0 before any
    request.  Epochs only ever move forward: there is no delete."""

    def __init__(self, directory: str):
        self.directory = os.path.join(directory, "epochs")

    def request(self, epoch: int) -> None:
        if epoch < 0:
            raise ValueError(f"epoch must be >= 0, got {epoch}")
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory, str(int(epoch)))
        with open(path, "a", encoding="utf-8"):
            pass

    def current(self) -> int:
        try:
            entries = os.listdir(self.directory)
        except OSError:
            return 0
        steps = [int(e) for e in entries if e.isdigit()]
        return max(steps, default=0)


# ----------------------------------- cluster-consistent checkpoint state


def step_is_valid(step_dir: str) -> bool:
    """Cheap integrity check for one committed checkpoint step.

    Pickle layout (``state.pkl``): the opcode stream must parse
    through to ``STOP`` — a host that died mid-
    ``CheckpointManager.save`` on a filesystem without atomic rename
    leaves a torn file that truncates mid-stream.  The scan
    (``pickletools.genops``) reads the file but never materializes the
    payload, so validating a multi-GB training state costs I/O, not
    allocation.  The port writes no orbax layout, so the reference's
    orbax tmp-suffix rule is not here; anything else non-empty is
    trusted (unknown layouts fail at restore time, loudly)."""
    if not os.path.isdir(step_dir):
        return False
    pkl = os.path.join(step_dir, "state.pkl")
    if os.path.exists(pkl):
        import pickletools

        try:
            with open(pkl, "rb") as f:
                last = None
                for op, _arg, _pos in pickletools.genops(f):
                    last = op.name
            return last == "STOP"
        except Exception:  # noqa: BLE001 — torn/corrupt == invalid
            return False
    return bool(os.listdir(step_dir))


def valid_steps(checkpoint_dir: str) -> list[int]:
    """The committed AND valid integer steps under one host's
    checkpoint directory (sorted)."""
    if not os.path.isdir(checkpoint_dir):
        return []
    return sorted(
        int(e) for e in os.listdir(checkpoint_dir)
        if e.isdigit() and step_is_valid(os.path.join(checkpoint_dir, e)))


def latest_valid_step(checkpoint_dir: str) -> int | None:
    """Newest committed step that passes :func:`step_is_valid`.

    Scans newest-first and stops at the first valid step, so the
    common case (intact latest) validates exactly one payload —
    :func:`valid_steps` would unpickle every retained checkpoint,
    which at multi-GB training state is real I/O.  Use this for
    resume-point selection; ``valid_steps`` only where the full set is
    needed (cluster consistency)."""
    if not os.path.isdir(checkpoint_dir):
        return None
    for s in sorted((int(e) for e in os.listdir(checkpoint_dir)
                     if e.isdigit()), reverse=True):
        if step_is_valid(os.path.join(checkpoint_dir, str(s))):
            return s
    return None


def cluster_consistent_step(checkpoint_dirs) -> int | None:
    """The highest checkpoint step present and valid on EVERY host.

    This is the cluster resume rule: a step that only some hosts
    committed (the fault landed mid-cadence), or that any host holds
    torn (died mid-save), must not be resumed from — the survivors
    would restore state the dead host never reached and the replicas
    would diverge on round one.  Duplicate paths (hosts sharing one
    store, as the port's rank-0 multi-process save does) collapse to
    one."""
    dirs = {os.path.realpath(d) for d in checkpoint_dirs}
    if not dirs:
        return None
    common = None
    for d in dirs:
        steps = set(valid_steps(d))
        common = steps if common is None else common & steps
    return max(common) if common else None


def trim_to_consistent(checkpoint_dirs) -> int | None:
    """Delete every step beyond (or torn at) the cluster-consistent
    step, on every host, so each host's own ``latest_step()``-driven
    auto-resume lands on the SAME state.  Returns the consistent step
    (None = nothing usable anywhere: resume from scratch)."""
    import shutil

    keep = cluster_consistent_step(checkpoint_dirs)
    for d in {os.path.realpath(p) for p in checkpoint_dirs}:
        if not os.path.isdir(d):
            continue
        for e in os.listdir(d):
            if not e.isdigit():
                continue
            step = int(e)
            path = os.path.join(d, e)
            if keep is None or step > keep or not step_is_valid(path):
                shutil.rmtree(path, ignore_errors=True)
    return keep


# --------------------------------------------------------------- member


class ClusterMember:
    """The in-process half: heartbeats out, collective watchdog in.

    Start this FIRST in a cluster job script — before
    :meth:`join_group` — so peers see liveness while the process group
    forms, and the watchdog can already abort a join that will never
    complete because a peer is gone:

    .. code-block:: python

        member = cluster.member_from_env()
        member.start()
        member.join_group()              # epoch-stamped coordinator
        try:
            Supervisor(trainer).run(ds)  # per-host retry still applies
            member.complete()
        finally:
            member.stop()

    The watchdog polls every ``poll`` seconds; a peer with no beat for
    ``window`` seconds (or a cluster epoch newer than ours) trips it:
    it requests the next epoch, emits a ``cluster.fault`` obs event,
    and calls ``abort`` — by default ``os._exit(EXIT_RESTART)``,
    because a survivor blocked inside a dead collective cannot be
    unwound politely (``abort=`` is injectable for tests).  Detection
    latency is bounded by ``window + poll``.
    """

    def __init__(self, coord_dir: str, host: int, num_hosts: int,
                 epoch: int = 0, *, base_port: int = 8476,
                 heartbeat_interval: float = 0.5, window: float = 3.0,
                 poll: float = 0.25, grace: float = 30.0,
                 abort=None, clock=time.time):
        self.coord_dir = coord_dir
        self.host = host
        self.num_hosts = num_hosts
        self.epoch = epoch
        self.base_port = base_port
        self.epochs = EpochStore(coord_dir)
        self.writer = HeartbeatWriter(
            os.path.join(coord_dir, "hb"), host, epoch=epoch,
            interval=heartbeat_interval, clock=clock)
        self.monitor = HealthMonitor(
            os.path.join(coord_dir, "hb"), host, num_hosts,
            window=window, grace=grace, clock=clock)
        self.poll = poll
        self._abort = abort if abort is not None else self._exit_abort
        self._stop = threading.Event()
        self._thread = None
        self.fault_reason: str | None = None

    @property
    def coordinator_address(self) -> str:
        """Epoch-stamped coordinator: a new generation forms on a new
        port, so survivors of epoch N can never half-join N+1."""
        return f"localhost:{self.base_port + self.epoch}"

    def join_group(self, device=None, backend: str | None = None,
                   timeout: float = 600.0):
        """Join the epoch's ``torch.distributed`` group through
        ``deploy.init_from_env`` (no-op, returning None, when
        single-host): rank ``host`` of ``num_hosts``, its store at
        :attr:`coordinator_address` (``MASTER_PORT = base_port +
        epoch``).  ``device`` / ``backend`` / ``timeout`` are
        ``init_from_env``'s (the card by default; ``device="cpu"`` for
        gloo; ``backend="gloo"`` for ranks sharing one card).  Returns
        this rank's device."""
        if self.num_hosts <= 1:
            return None
        from distkeras_tpu_torch import deploy

        addr, _, port = self.coordinator_address.rpartition(":")
        os.environ.pop("DKT_INIT_METHOD", None)  # the epoch's port rules
        os.environ.update({"MASTER_ADDR": addr, "MASTER_PORT": port,
                           "WORLD_SIZE": str(self.num_hosts),
                           "RANK": str(self.host)})
        return deploy.init_from_env(device=device, backend=backend,
                                    timeout=timeout)

    # ---------------------------------------------------------- threads

    def start(self) -> "ClusterMember":
        if self._thread is not None:
            raise RuntimeError("cluster member already started")
        self.writer.start()
        self._thread = threading.Thread(
            target=self._watch, name=f"dkt-watchdog-host{self.host}",
            daemon=True)
        self._thread.start()
        return self

    def _watch(self) -> None:
        while not self._stop.wait(self.poll):
            stale = self.monitor.stale_peers(epoch=self.epoch)
            if stale:
                self.trip(f"peer heartbeat(s) stale: hosts {stale}")
                return
            current = self.epochs.current()
            if current > self.epoch:
                self.trip(f"cluster moved to epoch {current} "
                          f"(we are epoch {self.epoch})")
                return

    def trip(self, reason: str) -> None:
        """The watchdog fired: request the next epoch, record the
        fault, abort this process (see class docstring)."""
        from distkeras_tpu_torch import obs

        self.fault_reason = reason
        self.epochs.request(self.epoch + 1)
        obs.event("cluster.fault", host=self.host, epoch=self.epoch,
                  reason=reason)
        obs.count("cluster.faults")
        self._abort(reason)

    def _exit_abort(self, reason: str) -> None:
        from distkeras_tpu_torch import obs

        try:
            # Best-effort flush: close the obs session so the trace
            # gets its final metrics record before the hard exit.
            obs.disable()
        except Exception:  # noqa: BLE001 — dying anyway
            pass
        print(f"[dkt-cluster host {self.host}] watchdog abort: {reason}",
              file=sys.stderr, flush=True)
        os._exit(EXIT_RESTART)

    def complete(self) -> None:
        """Training finished on this host: publish the terminal
        ``done`` beat (so stragglers never read our exit as a death)
        and stop the watchdog."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.writer.mark_done()

    def stop(self) -> None:
        self._stop.set()
        self.writer.stop()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def member_from_env() -> ClusterMember:
    """Build the :class:`ClusterMember` a :class:`ClusterSupervisor`
    driver described through the ``DKT_CLUSTER_*`` env vars."""
    env = os.environ
    return ClusterMember(
        coord_dir=env["DKT_CLUSTER_DIR"],
        host=int(env["DKT_CLUSTER_HOST"]),
        num_hosts=int(env["DKT_CLUSTER_NHOSTS"]),
        epoch=int(env.get("DKT_CLUSTER_EPOCH", "0")),
        base_port=int(env.get("DKT_CLUSTER_BASE_PORT", "8476")),
        heartbeat_interval=float(env.get("DKT_CLUSTER_INTERVAL", "0.5")),
        window=float(env.get("DKT_CLUSTER_WINDOW", "3.0")),
        grace=float(env.get("DKT_CLUSTER_GRACE", "30.0")),
    )


# --------------------------------------------------------------- driver


class ClusterSupervisor:
    """Per-host relauncher: the process-level half of coordinated
    restart.  Wraps the training process (which runs the per-host
    :class:`~distkeras_tpu_torch.resilience.supervisor.Supervisor`
    inside)
    the way that Supervisor wraps ``trainer.train``:

    - launch ``command`` for the current epoch with the
      ``DKT_CLUSTER_*`` env contract (:func:`member_from_env` reads
      it);
    - while it runs, watch peer heartbeats and the epoch store from
      the OUTSIDE — if a peer goes stale or the epoch advances, kill
      the child (this host may be wedged in a collective with a dead
      peer; its own watchdog usually fires first, this is the
      belt-and-braces layer) and move on;
    - on any child death, request the next epoch, wait at the epoch
      **barrier** (every host's driver must acknowledge the new epoch
      before anyone launches, so the new coordinator and its clients
      form one group), trim checkpoints to the cluster-consistent
      step (host 0 only, before releasing its barrier marker), and
      relaunch;
    - give up after ``max_restarts`` coordinated restarts
      (:class:`ClusterGivenUp`).

    **Flap dampening** (``healthy_uptime``): a link that partitions
    every few minutes would burn the whole restart budget in a day
    even though each epoch between flaps made real progress.  When an
    attempt runs at least ``healthy_uptime`` seconds before dying, the
    restart budget is REFUNDED (the counter resets to zero before the
    failure is charged): ``max_restarts`` then bounds *consecutive
    rapid* failures — the crash-loop it exists to stop — instead of
    lifetime flap count.  Attempts killed for exceeding
    ``attempt_timeout`` never refund (a hung child always outlives any
    uptime bar).  ``None`` disables the refund.

    Stdlib-only on purpose: drivers survive anything the training
    stack does, including torch refusing to import.
    """

    def __init__(self, coord_dir: str, host: int, num_hosts: int,
                 command, *, env: dict | None = None,
                 base_port: int = 8476, window: float = 3.0,
                 poll: float = 0.25, grace: float = 30.0,
                 heartbeat_interval: float = 0.5,
                 checkpoint_dirs=None, max_restarts: int = 4,
                 barrier_timeout: float = 120.0,
                 attempt_timeout: float | None = None,
                 healthy_uptime: float | None = None):
        self.coord_dir = coord_dir
        self.host = host
        self.num_hosts = num_hosts
        self.command = list(command)
        self.env = dict(env or {})
        self.base_port = base_port
        self.window = window
        self.poll = poll
        self.grace = grace
        self.heartbeat_interval = heartbeat_interval
        self.checkpoint_dirs = list(checkpoint_dirs or [])
        self.max_restarts = max_restarts
        self.barrier_timeout = barrier_timeout
        self.attempt_timeout = attempt_timeout
        if healthy_uptime is not None and healthy_uptime <= 0:
            raise ValueError(
                f"healthy_uptime must be positive (seconds) or None, "
                f"got {healthy_uptime}")
        self.healthy_uptime = healthy_uptime
        self.epochs = EpochStore(coord_dir)
        self.history: list[dict] = []   # one record per attempt

    # ------------------------------------------------------------ barrier

    def _barrier_dir(self, epoch: int) -> str:
        return os.path.join(self.coord_dir, "ready", str(epoch))

    def _enter_barrier(self, epoch: int) -> None:
        """Host 0 trims checkpoints BEFORE publishing its marker, so
        every other host's launch happens-after the trim."""
        if self.host == 0 and epoch > 0 and self.checkpoint_dirs:
            kept = trim_to_consistent(self.checkpoint_dirs)
            self.history.append({"epoch": epoch, "event": "trim",
                                 "consistent_step": kept})
        d = self._barrier_dir(epoch)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, str(self.host)), "a",
                  encoding="utf-8"):
            pass
        deadline = time.monotonic() + self.barrier_timeout
        while True:
            try:
                present = {int(e) for e in os.listdir(d) if e.isdigit()}
            except OSError:
                present = set()
            if present >= set(range(self.num_hosts)):
                return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"epoch {epoch} barrier: hosts "
                    f"{sorted(set(range(self.num_hosts)) - present)} "
                    f"never arrived within {self.barrier_timeout}s")
            time.sleep(self.poll)

    # -------------------------------------------------------------- run

    def _child_env(self, epoch: int) -> dict:
        env = {**os.environ, **self.env}
        env.update({
            "DKT_CLUSTER_DIR": self.coord_dir,
            "DKT_CLUSTER_HOST": str(self.host),
            "DKT_CLUSTER_NHOSTS": str(self.num_hosts),
            "DKT_CLUSTER_EPOCH": str(epoch),
            "DKT_CLUSTER_BASE_PORT": str(self.base_port),
            "DKT_CLUSTER_WINDOW": str(self.window),
            "DKT_CLUSTER_INTERVAL": str(self.heartbeat_interval),
            "DKT_CLUSTER_GRACE": str(self.grace),
        })
        return env

    def run(self) -> dict:
        """Drive attempts until one epoch's child exits 0 with the
        epoch still current.  Returns a summary dict (``epochs`` used,
        ``restarts``, per-attempt ``history``)."""
        restarts = 0
        while True:
            epoch = self.epochs.current()
            self._enter_barrier(epoch)
            monitor = HealthMonitor(
                os.path.join(self.coord_dir, "hb"), self.host,
                self.num_hosts, window=self.window, grace=self.grace)
            t0 = time.monotonic()
            child = subprocess.Popen(self.command,
                                     env=self._child_env(epoch))
            reason = None
            try:
                while child.poll() is None:
                    if self.attempt_timeout is not None and \
                            time.monotonic() - t0 > self.attempt_timeout:
                        reason = "attempt timeout"
                    elif self.epochs.current() > epoch:
                        reason = "epoch advanced"
                    else:
                        stale = monitor.stale_peers(epoch=epoch)
                        if stale:
                            reason = f"stale peers {stale}"
                            self.epochs.request(epoch + 1)
                    if reason is not None:
                        child.kill()
                        child.wait(timeout=30)
                        break
                    time.sleep(self.poll)
            finally:
                if child.poll() is None:
                    child.kill()
                    child.wait(timeout=30)
            rc = child.returncode
            duration = time.monotonic() - t0
            self.history.append({
                "epoch": epoch, "event": "attempt", "rc": rc,
                "reason": reason,
                "duration": duration})
            if rc == 0 and self.epochs.current() == epoch:
                return {"host": self.host, "epochs": epoch + 1,
                        "restarts": restarts, "history": self.history}
            if (self.healthy_uptime is not None and restarts
                    and duration >= self.healthy_uptime
                    and reason != "attempt timeout"):
                # Flap dampening: the attempt was healthy long enough
                # that this failure is a fresh fault, not the next
                # rung of a crash loop — refund the budget before
                # charging it.  A kill for exceeding attempt_timeout
                # is excluded: a deterministically hung child always
                # "survives" past healthy_uptime, and refunding it
                # would make ClusterGivenUp unreachable.
                self.history.append({"epoch": epoch, "event": "refund",
                                     "restarts_forgiven": restarts})
                restarts = 0
            self.epochs.request(epoch + 1)
            restarts += 1
            if restarts > self.max_restarts:
                raise ClusterGivenUp(
                    f"host {self.host}: {restarts} coordinated "
                    f"restarts exhausted (last rc={rc}, "
                    f"reason={reason})")


def run_cluster_local(command, num_hosts: int, coord_dir: str, *,
                      per_host_env=None, base_port: int = 8476,
                      checkpoint_dirs=None, **driver_kw) -> list[dict]:
    """Dev/test harness: run one :class:`ClusterSupervisor` per host
    in threads of THIS process (each drives its own training
    subprocesses).  ``per_host_env``: ``{host: {ENV: VAL}}`` extras —
    how chaos schedules are delivered to a single host.  Returns every
    driver's summary; any driver failure re-raises after all join."""
    per_host_env = per_host_env or {}
    results: list = [None] * num_hosts
    errors: list = [None] * num_hosts

    def drive(h):
        try:
            sup = ClusterSupervisor(
                coord_dir, h, num_hosts, command,
                env=per_host_env.get(h), base_port=base_port,
                checkpoint_dirs=checkpoint_dirs, **driver_kw)
            results[h] = sup.run()
        except BaseException as e:  # noqa: BLE001 — reported below
            errors[h] = e

    threads = [threading.Thread(target=drive, args=(h,),
                                name=f"dkt-driver-host{h}", daemon=True)
               for h in range(num_hosts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for h, e in enumerate(errors):
        if e is not None:
            raise RuntimeError(f"cluster driver for host {h} failed") from e
    return results


__all__ = ["EXIT_RESTART", "ClusterGivenUp", "EpochStore",
           "ClusterMember", "ClusterSupervisor", "member_from_env",
           "run_cluster_local", "step_is_valid", "valid_steps",
           "latest_valid_step", "cluster_consistent_step",
           "trim_to_consistent"]

"""The port's cluster resilience (``distkeras_tpu_torch/resilience/
health.py`` and ``cluster.py``) against the reference's contract
(tests/test_cluster.py), on the CPU.

Cheapest first: the health / epoch primitives with injected clocks (no
processes); the torn-checkpoint rule, held against the JAX package's
``step_is_valid`` / ``cluster_consistent_step`` on the same directories
(the port's pickle stores and the JAX pickle backend's, a truncated
``state.pkl`` among them), and the port's sharded layout torn a rank
file or a manifest short; a trainer's restore falling back past a torn
latest; the async tier's ``coord_dir`` files against the reference's;
the restart DRIVER with stdlib-only children; and the real thing: a
2-process gloo ADAG job whose host 1 is chaos-killed mid-training — the
drivers restart both hosts under epoch 1 (a new coordinator port), they
resume from the cluster-consistent checkpoint, and the weights equal an
uninterrupted 2-process run's bit for bit.
"""

import json
import os
import socket
import sys
import time

import numpy as np
import pytest
import torch

import distkeras_tpu_torch as dkt
from distkeras_tpu_torch.checkpoint import CheckpointManager
from distkeras_tpu_torch.resilience import cluster
from distkeras_tpu_torch.resilience.chaos import FaultPlan
from distkeras_tpu_torch.resilience.cluster import (ClusterMember, EpochStore,
                                                    cluster_consistent_step,
                                                    step_is_valid,
                                                    trim_to_consistent,
                                                    valid_steps)
from distkeras_tpu_torch.resilience.health import (HealthMonitor,
                                                   HeartbeatWriter,
                                                   beat_age, read_beat,
                                                   write_beat)
from tests.helpers import make_blobs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------- epochs


def test_epoch_store_is_monotone(tmp_path):
    store = EpochStore(str(tmp_path))
    assert store.current() == 0
    store.request(1)
    store.request(1)            # idempotent, concurrent-safe
    assert store.current() == 1
    store.request(3)
    store.request(2)            # late lower request cannot regress
    assert store.current() == 3
    with pytest.raises(ValueError):
        store.request(-1)


# ----------------------------------------------------------- heartbeats


def test_heartbeat_staleness_and_done(tmp_path):
    t = [100.0]
    clock = lambda: t[0]
    d = str(tmp_path / "hb")
    write_beat(d, 0, epoch=0, n=1, clock=clock)
    write_beat(d, 1, epoch=0, n=1, clock=clock)
    mon = HealthMonitor(d, host=0, num_hosts=3, window=2.0, grace=5.0,
                        clock=clock)
    assert mon.stale_peers() == []          # host 2 inside grace
    t[0] += 6.0
    # host 1's beat is now 6s old (> window) and host 2 never beat.
    assert mon.stale_peers() == [1, 2]
    assert beat_age(d, 1, clock=clock) == (6.0, False)
    assert beat_age(d, 2, clock=clock) is None
    write_beat(d, 1, epoch=0, n=2, clock=clock)
    assert mon.stale_peers() == [2]
    # done beat: clean completion is never read as death
    write_beat(d, 2, epoch=0, n=1, clock=clock, done=True)
    t[0] += 100.0
    assert mon.stale_peers() == [1]         # host 2 done; host 1 stale
    assert not mon.alive()


def test_heartbeat_epoch_filter(tmp_path):
    """A relaunched cluster must not count a dead host's pre-restart
    beats as liveness in the new generation."""
    t = [0.0]
    clock = lambda: t[0]
    d = str(tmp_path / "hb")
    write_beat(d, 1, epoch=0, n=9, clock=clock)
    mon = HealthMonitor(d, host=0, num_hosts=2, window=10.0, grace=1.0,
                        clock=clock)
    assert mon.stale_peers(epoch=0) == []   # fresh beat, right epoch
    t[0] += 2.0
    assert mon.stale_peers(epoch=1) == [1]  # old-epoch beat filtered


@pytest.mark.chaos
def test_chaos_partition_drops_beats(tmp_path):
    """The ``drop`` fault kind: the host keeps running but its beats
    never publish — a partition as peers see it (the done beat too)."""
    d = str(tmp_path / "hb")
    w = HeartbeatWriter(d, host=0, interval=0.05)
    with FaultPlan().drop("cluster.heartbeat", times=None):
        w.beat_once()
        w.mark_done()
    assert read_beat(d, 0) is None          # nothing ever published
    w.beat_once()                           # plan gone: beats flow
    assert read_beat(d, 0)["host"] == 0 and w.beats == 1


def test_watchdog_trips_on_stale_peer_and_requests_epoch(tmp_path):
    """The collective-watchdog core: a peer stops beating -> the member
    requests the next epoch and aborts (injected abort; the production
    default is os._exit(EXIT_RESTART))."""
    coord = str(tmp_path)
    write_beat(os.path.join(coord, "hb"), 1, epoch=0, n=1)
    tripped = []
    m = ClusterMember(coord, host=0, num_hosts=2, epoch=0,
                      heartbeat_interval=0.05, window=0.3, poll=0.05,
                      grace=5.0, abort=tripped.append)
    m.start()
    try:
        deadline = time.monotonic() + 5.0
        while not tripped and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        m.stop()
    assert tripped and "1" in tripped[0]
    assert m.epochs.current() == 1          # next epoch requested
    assert m.fault_reason is not None


def test_watchdog_trips_on_epoch_advance(tmp_path):
    coord = str(tmp_path)
    tripped = []
    m = ClusterMember(coord, host=0, num_hosts=1, epoch=0,
                      heartbeat_interval=0.05, window=5.0, poll=0.05,
                      abort=tripped.append)
    m.start()
    try:
        m.epochs.request(1)                 # another host moved on
        deadline = time.monotonic() + 5.0
        while not tripped and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        m.stop()
    assert tripped and "epoch 1" in tripped[0]


def test_member_from_env_round_trip(tmp_path, monkeypatch):
    monkeypatch.setenv("DKT_CLUSTER_DIR", str(tmp_path))
    monkeypatch.setenv("DKT_CLUSTER_HOST", "1")
    monkeypatch.setenv("DKT_CLUSTER_NHOSTS", "4")
    monkeypatch.setenv("DKT_CLUSTER_EPOCH", "3")
    monkeypatch.setenv("DKT_CLUSTER_BASE_PORT", "9100")
    m = cluster.member_from_env()
    assert (m.host, m.num_hosts, m.epoch) == (1, 4, 3)
    assert m.coordinator_address == "localhost:9103"  # epoch-stamped
    # A single host joins no group.
    assert ClusterMember(str(tmp_path), 0, 1).join_group() is None


# ------------------------------------- cluster-consistent checkpoints


def _port_store(d, steps):
    with CheckpointManager(str(d), max_to_keep=10, backend="pickle") as m:
        for s in steps:
            m.save({"v": torch.tensor(float(s)), "w": [torch.arange(s)]},
                   step=s, force=True)


def _jax_store(d, steps):
    from distkeras_tpu.checkpoint import CheckpointManager as JManager

    with JManager(str(d), backend="pickle", max_to_keep=10) as m:
        for s in steps:
            m.save({"v": np.float32(s)}, step=s, force=True)


def _tear_pickle(d, step):
    """Truncate the step's payload mid-byte: a host that died inside
    save() on a filesystem without atomic rename."""
    p = os.path.join(str(d), str(step), "state.pkl")
    data = open(p, "rb").read()
    with open(p, "wb") as f:
        f.write(data[:max(1, len(data) // 2)])


def test_torn_steps_agree_with_jax(tmp_path):
    """The port's integrity rule is the reference's on the same
    directories: stores written by either package, a truncated
    state.pkl, a step only one host committed, an empty step dir."""
    from distkeras_tpu.resilience import cluster as jcluster

    a, b, c = tmp_path / "h0", tmp_path / "h1", tmp_path / "h2"
    _port_store(a, [2, 4, 6])
    _port_store(b, [2, 4, 6])
    _jax_store(c, [2, 4, 6])
    dirs = [str(a), str(b), str(c)]

    def agree():
        for d in dirs:
            assert valid_steps(d) == jcluster.valid_steps(d)
            assert cluster.latest_valid_step(d) == \
                jcluster.latest_valid_step(d)
            for e in os.listdir(d):
                p = os.path.join(d, e)
                assert step_is_valid(p) == jcluster.step_is_valid(p)
        assert cluster_consistent_step(dirs) == \
            jcluster.cluster_consistent_step(dirs)

    agree()
    assert cluster_consistent_step(dirs) == 6
    _tear_pickle(b, 6)
    _tear_pickle(c, 4)
    os.makedirs(a / "8")                    # committed by name, empty
    agree()
    assert not step_is_valid(str(b / "6")) and not step_is_valid(str(a / "8"))
    assert valid_steps(str(b)) == [2, 4]
    # Highest step valid on EVERY host: host 1's torn 6 and host 2's
    # torn 4 leave 2.
    assert cluster_consistent_step(dirs) == 2
    assert cluster_consistent_step([str(a), str(a)]) == 6  # deduped
    kept = trim_to_consistent(dirs)
    assert kept == 2
    for d in dirs:
        assert sorted(int(e) for e in os.listdir(d) if e.isdigit()) == [2]
    # What is left restores (the port reads the JAX pickle too).
    assert float(CheckpointManager(str(c)).restore()["v"]) == 2.0


def test_cluster_consistent_step_skips_torn_sharded(tmp_path):
    """The reference's torn-orbax case on the port's sharded layout: a
    step dir whose rank file is missing, then one whose manifest is
    missing, is not valid and the cluster-consistent step falls back; so
    is a short rank file, a tmp entry left inside, and an uncommitted
    name."""
    a, b = tmp_path / "h0", tmp_path / "h1"
    for d in (a, b):
        with CheckpointManager(str(d), max_to_keep=10,
                               async_save=False) as m:
            for s in (1, 2, 3):
                m.save({"v": torch.arange(4.0), "n": s}, step=s, force=True)
    dirs = [str(a), str(b)]
    assert cluster_consistent_step(dirs) == 3
    os.remove(b / "3" / "rank0.bin")        # a rank's file never landed
    assert not step_is_valid(str(b / "3"))
    assert cluster_consistent_step(dirs) == 2
    os.remove(a / "2" / "manifest.json")    # the manifest never landed
    assert not step_is_valid(str(a / "2"))
    assert valid_steps(str(a)) == [1, 3]
    assert cluster_consistent_step(dirs) == 1
    assert cluster_consistent_step([str(a), str(a)]) == 3  # deduped
    with open(a / "3" / "rank0.bin", "ab") as f:          # a short or
        f.write(b"x")                                      # long file
    assert not step_is_valid(str(a / "3"))
    (b / "1" / "rank0.bin.part").write_bytes(b"")        # a tmp entry
    assert not step_is_valid(str(b / "1"))
    os.replace(a / "1", a / ".tmp.1")                     # uncommitted
    assert not step_is_valid(str(a / ".tmp.1"))
    assert cluster_consistent_step(dirs) is None
    assert trim_to_consistent(dirs) is None
    assert valid_steps(str(a)) == valid_steps(str(b)) == []


def test_trainer_restore_skips_torn_latest(tmp_path):
    """A torn latest checkpoint does not crash resume: the trainer warns,
    falls back to the latest VALID step, replays from there, and still
    lands on the uninterrupted run's weights."""
    x, y = make_blobs(n=128)
    ds = dkt.Dataset.from_arrays(x, y)
    common = dict(loss="sparse_categorical_crossentropy",
                  worker_optimizer="sgd", learning_rate=0.05,
                  batch_size=16, num_epoch=2, device="cpu")
    mlp = lambda: dkt.zoo.MLP(16, (32,), 4, seed=0)
    ref = dkt.SingleTrainer(mlp(), **common).train(ds)
    ckdir = str(tmp_path / "c")
    dkt.SingleTrainer(mlp(), checkpoint_dir=ckdir, checkpoint_every=1,
                      max_checkpoints=100, checkpoint_backend="pickle",
                      **common).train(ds)
    steps = sorted(int(e) for e in os.listdir(ckdir) if e.isdigit())
    _tear_pickle(tmp_path / "c", steps[-1])
    _tear_pickle(tmp_path / "c", steps[-2])
    resumed = dkt.SingleTrainer(mlp(), checkpoint_dir=ckdir,
                                checkpoint_every=1, resume=True,
                                max_checkpoints=100,
                                checkpoint_backend="pickle", **common)
    with pytest.warns(UserWarning, match="torn/partial"):
        out = resumed.train(ds)
    assert len(resumed.history) == 2        # replays the torn rounds
    for a, b in zip(out.parameters(), ref.parameters()):
        assert torch.equal(a, b)


# ------------------------------------------------- the async tier's files


def test_asyncdp_coord_dir_matches_jax(tmp_path):
    """AsyncDP(coord_dir=) writes the reference's cluster files: the same
    epoch markers and, per host, the same last beat (epoch, count,
    virtual time, done); the final center lands under step
    ``plane.version`` of the checkpoint_dir."""
    import distkeras_tpu as dk
    from distkeras_tpu.parallel import async_tier as jat
    from distkeras_tpu.resilience import cluster as jcluster
    from distkeras_tpu.resilience import health as jhealth
    from tests.helpers import make_mlp

    x, y = make_blobs(n=256)
    jm = make_mlp(seed=0)
    init = [np.asarray(v.value) for v in jm.trainable_variables]
    kw = dict(hosts=3, tau=2, beat_window=1.5,
              loss="sparse_categorical_crossentropy", worker_optimizer="sgd",
              learning_rate=0.05, batch_size=4, num_epoch=1,
              communication_window=2)

    def sched(cls):
        return cls(seed=3).stall(1, 2, 50.0).join(4, 2.0)

    jt = dk.AsyncDP(jm, schedule=sched(jat.AsyncSchedule), num_workers=1,
                    coord_dir=str(tmp_path / "j"), **kw)
    jt.train(dk.Dataset.from_arrays(x, y))
    tm = dkt.zoo.MLP(16, (32,), 4)
    dkt.module_from_keras_numpy(tm, init)
    tt = dkt.AsyncDP(tm, schedule=sched(dkt.AsyncSchedule),
                     coord_dir=str(tmp_path / "t"),
                     checkpoint_dir=str(tmp_path / "ck"), device="cpu", **kw)
    out = tt.train(dkt.Dataset.from_arrays(x, y))
    assert tt.async_report["epoch"] == jt.async_report["epoch"] > 0
    assert EpochStore(str(tmp_path / "t")).current() == \
        jcluster.EpochStore(str(tmp_path / "j")).current() == \
        tt.async_report["epoch"]
    for h in range(5):
        ours = read_beat(str(tmp_path / "t" / "beats"), h)
        ref = jhealth.read_beat(str(tmp_path / "j" / "beats"), h)
        assert (ours is None) == (ref is None)
        if ours is not None:
            for k in ("host", "epoch", "n", "t", "done"):
                assert ours[k] == ref[k], (h, k)
    saved = CheckpointManager(str(tmp_path / "ck"))
    assert saved.all_steps() == [tt.async_report["version"]]
    tv = saved.restore()["tv"]
    for a, b in zip(tv, out.parameters()):
        assert torch.equal(a, b.detach())


# ------------------------------------------- driver protocol (no torch)

# A stdlib-only cluster child: imports health/cluster through stub
# parent packages (no torch: ~0.1 s startup), beats, "works", and at
# epoch 0 host 1 hard-dies mid-work.  Proves the driver protocol —
# detection, epoch bump, barrier, relaunch — in seconds.
DRIVER_CHILD = """
import importlib, os, sys, time, types
for name, path in (("distkeras_tpu_torch", {pkg!r}),
                   ("distkeras_tpu_torch.resilience", {res!r})):
    mod = types.ModuleType(name)
    mod.__path__ = [path]
    sys.modules[name] = mod
cluster = importlib.import_module("distkeras_tpu_torch.resilience.cluster")

member = cluster.member_from_env()
member.start()
if member.epoch == 0 and member.host == 1:
    time.sleep(0.6)
    os._exit(137)                     # hard host loss, no cleanup
time.sleep(2.5)                       # "training"
member.complete()
assert "torch" not in sys.modules
print("host", member.host, "epoch", member.epoch, "done", flush=True)
"""


@pytest.mark.multiprocess
def test_driver_coordinated_restart_protocol(tmp_path):
    """Two drivers, stdlib children: host 1 dies at epoch 0 -> host 0's
    child watchdog aborts (EXIT_RESTART), both drivers meet at the
    epoch-1 barrier and relaunch, epoch 1 completes on both hosts."""
    pkg = os.path.join(REPO, "distkeras_tpu_torch")
    res = os.path.join(pkg, "resilience")
    child = DRIVER_CHILD.format(pkg=pkg, res=res)
    summaries = cluster.run_cluster_local(
        [sys.executable, "-c", child], num_hosts=2,
        coord_dir=str(tmp_path / "coord"), base_port=0,
        window=0.6, poll=0.1, heartbeat_interval=0.15, grace=20.0,
        max_restarts=2, barrier_timeout=30.0, attempt_timeout=60.0)
    for s in summaries:
        assert s["epochs"] == 2, s        # exactly one restart
        assert s["restarts"] == 1, s
    rcs = [a["rc"] for a in summaries[1]["history"]
           if a["event"] == "attempt"]
    assert rcs[0] == 137 and rcs[-1] == 0
    rcs0 = [a["rc"] for a in summaries[0]["history"]
            if a["event"] == "attempt"]
    assert rcs0[-1] == 0 and rcs0[0] != 0


# A stdlib-only flapping child: increments a counter file, dies with
# EXIT_RESTART for the first three runs (after `uptime` seconds of
# "healthy training"), completes on the fourth.
FLAP_CHILD = """
import os, sys, time
path, uptime = sys.argv[1], float(sys.argv[2])
n = int(open(path).read()) if os.path.exists(path) else 0
open(path, "w").write(str(n + 1))
if n < 3:
    time.sleep(uptime)
    os._exit(75)
"""


def _flap_driver(tmp_path, uptime, **kw):
    counter = str(tmp_path / "count")
    return cluster.ClusterSupervisor(
        str(tmp_path / "coord"), 0, 1,
        [sys.executable, "-c", FLAP_CHILD, counter, str(uptime)],
        poll=0.05, barrier_timeout=10.0, **kw)


@pytest.mark.multiprocess
def test_flap_dampening_refunds_restart_budget(tmp_path):
    """Three healthy-then-dead attempts against max_restarts=1: with
    ``healthy_uptime`` below each flap's uptime every healthy attempt
    refunds the budget and the job completes."""
    sup = _flap_driver(tmp_path, uptime=0.5, max_restarts=1,
                       healthy_uptime=0.2)
    summary = sup.run()
    attempts = [a for a in sup.history if a["event"] == "attempt"]
    refunds = [a for a in sup.history if a["event"] == "refund"]
    assert [a["rc"] for a in attempts] == [75, 75, 75, 0]
    assert len(refunds) == 2            # flaps 2 and 3 were forgiven
    assert summary["restarts"] == 1     # never exceeded the budget
    assert summary["epochs"] == 4


@pytest.mark.multiprocess
@pytest.mark.parametrize("uptime,healthy", [(0.5, None), (0.0, 30.0)],
                         ids=["no_refund", "rapid_crash_loop"])
def test_crash_ladder_exhausts_restart_budget(tmp_path, uptime, healthy):
    """Without the refund three flaps burn max_restarts=1; with it, a
    genuine crash loop (uptime below ``healthy_uptime``) still does."""
    sup = _flap_driver(tmp_path, uptime=uptime, max_restarts=1,
                       healthy_uptime=healthy)
    with pytest.raises(cluster.ClusterGivenUp):
        sup.run()
    assert not [a for a in sup.history if a["event"] == "refund"]


@pytest.mark.multiprocess
def test_hung_child_timeout_kills_never_refund(tmp_path):
    """Attempt-timeout kills never refund the budget (a hung child always
    outlives ``healthy_uptime``)."""
    sup = cluster.ClusterSupervisor(
        str(tmp_path / "coord"), 0, 1,
        [sys.executable, "-c", "import time; time.sleep(60)"],
        poll=0.05, barrier_timeout=10.0, max_restarts=1,
        attempt_timeout=0.3, healthy_uptime=0.1)
    with pytest.raises(cluster.ClusterGivenUp):
        sup.run()
    attempts = [a for a in sup.history if a["event"] == "attempt"]
    assert all(a["reason"] == "attempt timeout" for a in attempts)
    assert len(attempts) == 2
    assert not [a for a in sup.history if a["event"] == "refund"]


# ------------------------------------------------ the real thing (torch)


def _free_port(span: int = 4) -> int:
    """A base port whose next ``span`` ports are free, below the
    kernel's ephemeral range (32768 and up): the cluster binds ``base +
    epoch`` at each restart, and an ephemeral port taken between the
    pick and that bind (a gloo pair, another test's connection) would
    fail the restart's rendezvous."""
    import random

    rng = random.Random(os.getpid() ^ time.monotonic_ns())
    for _ in range(200):
        base = rng.randrange(20000, 32000 - span)
        try:
            for port in range(base, base + span):
                with socket.socket() as s:
                    s.bind(("localhost", port))
        except OSError:
            continue
        return base
    raise RuntimeError("no free port range below 32000")


def _cluster_job(tmp, kill):
    """Run tests/torch_cluster_job.py on two hosts under
    ``run_cluster_local``; returns (summaries, host 0's final.npz)."""
    tmp.mkdir()
    x, y = make_blobs(n=128)
    w = dkt.keras_numpy_from_module(dkt.zoo.MLP(16, (32,), 4, seed=0))[0]
    np.savez(tmp / "data.npz", x=x, y=y, n_w=np.asarray(len(w)),
             **{f"w{i}": a for i, a in enumerate(w)})
    spec = tmp / "spec.json"
    spec.write_text(json.dumps({"data": str(tmp / "data.npz"),
                                "out": str(tmp), "ckpt": str(tmp / "ckpt"),
                                "kill": kill}))
    summaries = cluster.run_cluster_local(
        [sys.executable, os.path.join(REPO, "tests", "torch_cluster_job.py"),
         str(spec)], num_hosts=2, coord_dir=str(tmp / "coord"),
        base_port=_free_port(), checkpoint_dirs=[str(tmp / "ckpt")],
        per_host_env={h: {"OMP_NUM_THREADS": "1"} for h in range(2)},
        window=3.0, poll=0.1, heartbeat_interval=0.2, grace=60.0,
        max_restarts=2, barrier_timeout=60.0, attempt_timeout=90.0)
    return summaries, dict(np.load(tmp / "final.npz"))


@pytest.mark.multihost
@pytest.mark.multiprocess
def test_two_process_kill_one_host_coordinated_restart(tmp_path):
    """Two gloo hosts train ADAG(num_workers=2); chaos hard-kills host 1
    at round 5 of epoch 0.  Both drivers restart under epoch 1 (host 0
    trims to the cluster-consistent step), the hosts join the epoch-1
    group on its own port, resume, and finish: the weights and the
    resumed rounds' losses equal an uninterrupted 2-host run's bit for
    bit."""
    straight_s, straight = _cluster_job(tmp_path / "straight", None)
    assert all(s["epochs"] == 1 and s["restarts"] == 0 for s in straight_s)
    assert len(straight["history"]) == 12
    summaries, got = _cluster_job(tmp_path / "killed", 5)
    for s in summaries:
        assert s["epochs"] == 2 and s["restarts"] == 1, s
    assert [a["rc"] for a in summaries[1]["history"]
            if a["event"] == "attempt"][0] == 137
    start = int(got["resumed_from"])
    assert 4 <= start <= 5                  # durable through round 4 or 5
    np.testing.assert_array_equal(got["history"],
                                  straight["history"][start:])
    for i in range(int(np.load(tmp_path / "straight" / "data.npz")["n_w"])):
        np.testing.assert_array_equal(got[f"w{i}"], straight[f"w{i}"])

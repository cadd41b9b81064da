"""The port's bounded-staleness async tier against the JAX package's.

``AsyncDP`` simulates its hosts in one process under a seeded virtual
clock, so the whole run is a pure function of ``(seed, schedule)``: the
same schedule — heterogeneous durations, a host wedged for 50 virtual
seconds (evicted by the watchdog), a host joining mid-run, and a
``fail`` rule on ``cluster.push`` (a host killed mid-push) — must give
the reference's event log (every ``async.*`` trace event, in order,
with its fields and virtual times) and audit report exactly, and the
center's weights and the loss history within 1e-5 (float32 steps,
summation order).  The plane's pieces (schedule draws, the int8 EF
encoding, the aggregation tree) are held against the reference's
directly: durations and int8 codes exactly, merges at 1e-6.
"""

import re

import numpy as np
import pytest
import torch

import distkeras_tpu as dk
import distkeras_tpu_torch as dkt
from distkeras_tpu import obs as jobs
from distkeras_tpu.parallel import async_tier as jat
from distkeras_tpu.resilience import chaos as jchaos
from distkeras_tpu_torch import obs as tobs
from distkeras_tpu_torch.parallel import async_tier as tat
from distkeras_tpu_torch.resilience import chaos as tchaos
from tests.conftest import make_blobs, make_mlp

TOL = dict(rtol=1e-5, atol=1e-5)
KW = dict(loss="sparse_categorical_crossentropy", worker_optimizer="sgd",
          learning_rate=0.05, batch_size=2, num_epoch=2,
          communication_window=2, seed=11)


def schedule(mod, stall=True):
    s = mod.AsyncSchedule(seed=3)
    if stall:
        s = s.stall(1, 2, 50.0).join(5, at_time=2.0)
    return s


def events(path, read):
    """The trace's ``async.*`` events: name and fields (the fields carry
    the virtual time; the record's own ``t`` is the wall clock)."""
    return [(r["name"], r["fields"]) for r in read(path)
            if r.get("kind") == "event" and r["name"].startswith("async.")]


def run_both(tmp_path, hosts=3, stall=True, fault=None, **kw):
    x, y = make_blobs(n=256)
    out = {}
    for name, pkg, obs, chaos, tier in (("jax", dk, jobs, jchaos, jat),
                                        ("torch", dkt, tobs, tchaos, tat)):
        model = make_mlp()
        extra = {"num_workers": 1}
        if name == "torch":
            weights = [np.asarray(v.value) for v in model.trainable_variables]
            model = dkt.module_from_keras_numpy(dkt.zoo.MLP(16, (32,), 4),
                                                weights)
            extra = {"device": "cpu"}
        t = pkg.AsyncDP(model, hosts=hosts, tau=2, beat_window=1.5,
                        schedule=schedule(tier, stall), **KW, **kw, **extra)
        path = str(tmp_path / f"{name}.jsonl")
        plan = chaos.FaultPlan(seed=0)
        if fault:
            plan.fail("cluster.push", at=fault)
        with obs.session(path), plan:
            trained = t.train(pkg.Dataset.from_arrays(x, y))
        w = ([np.asarray(v.value) for v in trained.trainable_variables]
             if name == "jax" else dkt.keras_numpy_from_module(trained)[0])
        out[name] = (t, w, events(path, obs.read_trace), plan.events)
    return out


@pytest.mark.parametrize("case", ["stall_join", "push_fault",
                                  "sum_plain_wire"])
def test_asyncdp_event_log_matches_jax(tmp_path, case):
    kw = dict(fault=5, stall=False) if case == "push_fault" else {}
    if case == "sum_plain_wire":
        kw = dict(stall=False, hosts=2, async_merge="sum",
                  async_compress=None)
    out = run_both(tmp_path, **kw)
    (jt, jw, jev, jplan), (tt, tw, tev, tplan) = out["jax"], out["torch"]
    assert tt.async_report == jt.async_report
    assert tev == jev and len(tev) > 0
    assert tplan == jplan
    if case == "push_fault":
        assert tplan == [("cluster.push", 5, "fail")]
        assert len(tt.async_report["evicted"]) == 1
    if case == "stall_join":
        r = tt.async_report
        assert r["evicted"] == [1] and 5 in r["rounds"]
        assert r["hard_syncs"] >= 1
    np.testing.assert_allclose(tt.history, jt.history, **TOL)
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a, b, **TOL)


def test_schedule_and_config_match_jax():
    js, ts = schedule(jat), schedule(tat)
    for h in range(6):
        for r in range(1, 8):
            assert ts.duration(h, r) == js.duration(h, r)
            assert ts.stalled(h, r) == js.stalled(h, r)
    assert ts.joins() == js.joins()
    for kw in (dict(tau=0), dict(merge_rule="mean"), dict(compress="fp8"),
               dict(fanout=1), dict(beat_window=0.0)):
        with pytest.raises(ValueError) as want:
            jat.AsyncConfig(**kw)
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            tat.AsyncConfig(**kw)
    clock = tat.VirtualClock(1.0)
    assert clock.advance_to(2.5) == clock() == 2.5
    with pytest.raises(ValueError, match="backwards"):
        clock.advance_to(1.0)


def test_plane_pieces_match_jax():
    rng = np.random.default_rng(0)
    deltas = [[rng.normal(size=(3, 4)).astype(np.float32),
               rng.normal(size=(5,)).astype(np.float32)] for _ in range(5)]
    for rule in ("adasum", "sum"):
        for fanout in (2, 3):
            want = jat.tree_reduce([list(d) for d in deltas], fanout, rule)
            got = tat.tree_reduce([[torch.from_numpy(a) for a in d]
                                   for d in deltas], fanout, rule)
            for a, b in zip(got, want):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-6)
    res = [np.zeros((3, 4), np.float32), np.full((5,), 1e-3, np.float32)]
    jq, js, jdec, jres = jat._encode_ef(deltas[0], res)
    tq, ts, tdec, tres = tat._encode_ef(
        [torch.from_numpy(a) for a in deltas[0]],
        [torch.from_numpy(a) for a in res])
    for a, b in zip(tq + ts + tdec, list(jq) + list(js) + list(jdec)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # The residual ``x - q * s``: XLA contracts it into a fused
    # multiply-add, torch rounds the product first (1 ulp).
    for a, b in zip(tres, jres):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2e-7)
    assert tat.wire_cost_bytes(tq, ts) == jat.wire_cost_bytes(jq, js)


def test_plane_contracts(tmp_path):
    clock = tat.VirtualClock()
    cfg = tat.AsyncConfig(tau=2, compress=None, beat_window=3.0)
    plane = tat.AsyncPlane([torch.zeros(4)], cfg, clock)
    tv, v = plane.join(0)
    plane.join(1)
    with pytest.raises(ValueError, match="already a member"):
        plane.join(0)
    with tchaos.FaultPlan(seed=0).fail("cluster.merge", at=1):
        plane.push(0, [torch.ones(4)])
    assert plane.version == 0 and len(plane.pending) == 1   # not torn
    plane.flush()
    assert plane.version == 1 and torch.equal(plane.center[0],
                                              torch.ones(4))
    for _ in range(3):
        plane.complete(0)
    ok, lag = plane.may_start(0, 4)
    assert not ok and lag == [1] and plane.hard_syncs == 1
    plane.freeze_beats(1)
    clock.advance_to(4.0)
    assert plane.stale(1)
    plane.evict(1, reason="heartbeat_stale")
    assert plane.evicted == [1] and plane.may_start(0, 4) == (True, [])
    with pytest.raises(KeyError):
        plane.pull(1)
    # coord_dir: membership transitions are cluster epochs and the beats
    # real heartbeat files on the virtual clock (the reference's files).
    from distkeras_tpu_torch.resilience import cluster, health

    coord = str(tmp_path / "coord")
    plane = tat.AsyncPlane([torch.zeros(1)], cfg, clock, coord_dir=coord)
    store = cluster.EpochStore(coord)
    assert store.current() == 0
    plane.join(0)
    plane.join(1)
    assert store.current() == plane.epoch == 2
    beat = health.read_beat(str(tmp_path / "coord" / "beats"), 1)
    assert beat["epoch"] == 2 and beat["t"] == clock.now() \
        and not beat["done"]
    plane.leave(1)
    assert store.current() == 3
    assert health.read_beat(str(tmp_path / "coord" / "beats"), 1)["done"]


def test_asyncdp_construction_rejects(tmp_path):
    mlp = lambda: dkt.zoo.MLP(16, (32,), 4)
    with pytest.raises(ValueError, match="hosts"):
        dkt.AsyncDP(mlp(), hosts=0, device="cpu")
    with pytest.raises(ValueError, match="device_data"):
        dkt.AsyncDP(mlp(), device_data=True, device="cpu")
    with pytest.raises(ValueError, match="merge_rule"):
        dkt.AsyncDP(mlp(), async_merge="median", device="cpu")
    # coord_dir is ported (the cluster substrate; tests/test_torch_cluster.py
    # runs it end to end).
    assert dkt.AsyncDP(mlp(), coord_dir=str(tmp_path), device="cpu"
                       ).coord_dir == str(tmp_path)

"""The port's fleet router against the JAX package's (CPU, f32).

Mirrors ``tests/test_router.py``.  The routing half runs each scenario
over scripted fake replicas (no model work) through BOTH packages'
``Router`` and holds the port to the reference's decisions, results and
epochs.  The engine half routes over the port's ``PagedBatcher``
replicas: every request's tokens equal (no tolerance) the JAX package's
lone engine and the port's own ``generate`` for the same prompt; one
case also runs the JAX router over JAX engines beside it.
"""

import json
import time
import urllib.request

import numpy as np
import pytest

from distkeras_tpu_torch import obs
from distkeras_tpu_torch.obs.report import request_waterfall
from distkeras_tpu_torch.obs.trace import read_trace
from distkeras_tpu_torch.serving import (EngineEndpoint, HttpReplica,
                                         InProcessReplica, Router)
from tests.torch_fleet import (BLOCK, PORT, REF, FakeReplica, HealthProbed,
                               both, jpaged, model, paged, prompt_of, run)


@pytest.fixture(scope="module")
def m():
    return model()


def fakes(ns, *specs):
    return [FakeReplica(ns, name, **kw) for name, kw in specs]


# ------------------------------------------------------------- routing


def test_affinity_hit_routes_to_resident_replica():
    def scenario(ns):
        rng = np.random.default_rng(0)
        prompt = prompt_of(rng)
        r0, r1 = fakes(ns, ("r0", {}), ("r1", dict(
            resident=ns.stem_hexes(prompt[:-1], 8))))
        router = ns.Router([r0, r1])
        with ns.obs.session() as sess:
            router.enqueue(prompt, 4)
            hits = sess.registry.counter("router.affinity_hits").value()
        assert len(r1.enqueued) == 1 and not r0.enqueued
        router.enqueue(prompt_of(rng), 4)      # a miss: least-loaded
        assert len(r0.enqueued) == 1
        return hits, r0.enqueued, r1.enqueued

    assert both(scenario)[0] == 1


def test_affinity_prefers_longest_resident_prefix():
    def scenario(ns):
        prompt = prompt_of(np.random.default_rng(1), 33)
        stems = ns.stem_hexes(prompt[:-1], 8)
        r0, r1 = fakes(ns, ("r0", dict(resident=stems[:1])),
                       ("r1", dict(resident=stems)))
        ns.Router([r0, r1]).enqueue(prompt, 4)
        assert len(r1.enqueued) == 1 and not r0.enqueued
        return r0.enqueued, r1.enqueued

    both(scenario)


def test_least_loaded_fallback_spreads_by_load():
    def scenario(ns):
        rng = np.random.default_rng(2)
        r0, r1 = fakes(ns, ("r0", {}), ("r1", {}))
        router = ns.Router([r0, r1])
        rids = [router.enqueue(prompt_of(rng), 4) for _ in range(4)]
        assert len(r0.enqueued) == 2 and len(r1.enqueued) == 2
        for r in (r0, r1):
            r.complete_all()
        assert set(router.pump()) == set(rids)
        assert all(router.take(x).ok for x in rids)
        return rids, r0.enqueued, r1.enqueued

    both(scenario)


def test_round_robin_policy_alternates():
    def scenario(ns):
        rng = np.random.default_rng(3)
        r0, r1 = fakes(ns, ("r0", dict(lanes=8)), ("r1", dict(lanes=8)))
        router = ns.Router([r0, r1], policy="round_robin")
        for _ in range(4):
            router.enqueue(prompt_of(rng), 4)
        assert len(r0.enqueued) == 2 and len(r1.enqueued) == 2
        return r0.enqueued, r1.enqueued

    both(scenario)


def test_queuefull_spills_to_next_candidate_then_caller():
    def scenario(ns):
        rng = np.random.default_rng(4)
        r0, r1 = fakes(ns, ("r0", dict(lanes=1, max_queue=0)),
                       ("r1", dict(lanes=1, max_queue=0)))
        router = ns.Router([r0, r1])
        router.enqueue(prompt_of(rng), 4)
        router.enqueue(prompt_of(rng), 4)      # spills to the other
        assert len(r0.enqueued) == 1 and len(r1.enqueued) == 1
        with pytest.raises(ns.QueueFull):
            router.enqueue(prompt_of(rng), 4)
        assert router.queued == 0
        res = router.shutdown(max_steps=0)
        assert len(res) == 2
        return sorted((k, v.status) for k, v in res.items())

    both(scenario)


def test_prefix_id_routes_to_advertising_replica():
    def scenario(ns):
        rng = np.random.default_rng(5)
        r0, r1 = fakes(ns, ("r0", {}), ("r1", dict(prefix_ids=[5])))
        router = ns.Router([r0, r1])
        router.enqueue(prompt_of(rng), 4, prefix_id=5)
        assert len(r1.enqueued) == 1 and not r0.enqueued
        with pytest.raises(ValueError, match="not resident"):
            router.enqueue(prompt_of(rng), 4, prefix_id=9)
        return r1.enqueued

    both(scenario)


# ---------------------------------------------------------- membership


def test_membership_via_heartbeat_staleness(tmp_path):
    def scenario(ns, hb):
        rng = np.random.default_rng(6)
        t = [0.0]
        clock = lambda: t[0]  # noqa: E731

        def health_of(host):
            def probe():
                aged = ns.beat_age(hb, host, clock=clock)
                return aged is not None and (aged[1] or aged[0] <= 2.0)
            return probe

        ns.write_beat(hb, 0, 0, 1, clock=clock)
        ns.write_beat(hb, 1, 0, 1, clock=clock)
        r0, r1 = fakes(ns, ("r0", dict(lanes=8)), ("r1", dict(lanes=8)))
        router = ns.Router([HealthProbed(r0, health_of(0)),
                            HealthProbed(r1, health_of(1))],
                           clock=clock, health_interval=0.5)
        rids = [router.enqueue(prompt_of(rng), 4) for _ in range(4)]
        assert len(r0.enqueued) == 2 and len(r1.enqueued) == 2
        epochs = [router.epoch]
        t[0] = 3.0
        ns.write_beat(hb, 0, 0, 2, clock=clock)
        router.pump()
        assert router.replicas_up() == ["r0"]
        epochs.append(router.epoch)
        assert len(r0.enqueued) == 4
        r0.complete_all()
        router.pump()
        assert sorted(router.results()) == sorted(rids)
        t[0] = 3.6
        ns.write_beat(hb, 0, 0, 3, clock=clock)
        ns.write_beat(hb, 1, 0, 2, clock=clock)
        router.pump()
        assert router.replicas_up() == ["r0", "r1"]
        epochs.append(router.epoch)
        assert epochs == sorted(set(epochs))
        return epochs, r0.enqueued

    port = scenario(PORT, str(tmp_path / "port"))
    assert port == scenario(REF, str(tmp_path / "ref"))


# ---------------------------------------------------- drain-and-reroute


def test_dead_replica_reroutes_accepted_requests():
    def scenario(ns):
        rng = np.random.default_rng(7)
        r0, r1 = fakes(ns, ("r0", dict(lanes=8)), ("r1", dict(lanes=8)))
        router = ns.Router([r0, r1], health_interval=0.0)
        rids = [router.enqueue(prompt_of(rng), 4) for _ in range(4)]
        r0.is_healthy = False
        with ns.obs.session() as sess:
            router.pump()
            reroutes = sess.registry.counter("router.reroutes").value()
        assert router.replicas_up() == ["r1"]
        assert len(r1.enqueued) == 4
        r1.complete_all()
        router.pump()
        results = router.results()
        assert sorted(results) == sorted(rids)
        assert all(results[x].ok for x in rids)
        return reroutes, r1.enqueued

    assert both(scenario)[0] == 2


def test_result_before_death_wins_over_reroute():
    def scenario(ns):
        r0, r1 = fakes(ns, ("r0", dict(lanes=8)), ("r1", dict(lanes=8)))
        router = ns.Router([r0, r1], health_interval=0.0)
        rid = router.enqueue(prompt_of(np.random.default_rng(8)), 4)
        r0.complete_all()
        r0.is_healthy = False                   # dies with the result
        router.pump()
        res = router.take(rid)
        assert res.ok and res.request_id == rid
        assert not r1.enqueued
        return res.request_id, res.tokens.tolist()

    both(scenario)


def test_reroute_parks_when_fleet_saturated_then_recovers():
    def scenario(ns):
        rng = np.random.default_rng(9)
        r0, r1 = fakes(ns, ("r0", dict(lanes=1, max_queue=0)),
                       ("r1", dict(lanes=1, max_queue=0)))
        router = ns.Router([r0, r1], health_interval=0.0)
        a = router.enqueue(prompt_of(rng), 4)
        b = router.enqueue(prompt_of(rng), 4)
        r0.is_healthy = False
        router.pump()
        queued = [router.queued]
        r1.complete_all()
        router.pump()
        queued.append(router.queued)
        r1.complete_all()
        router.pump()
        results = router.results()
        assert queued == [1, 0]
        assert sorted(results) == sorted([a, b])
        assert all(r.ok for r in results.values())
        return queued, r1.enqueued

    both(scenario)


def test_drain_replica_moves_unfinished_requests():
    def scenario(ns):
        rng = np.random.default_rng(10)
        r0, r1 = fakes(ns, ("r0", dict(lanes=8)), ("r1", dict(lanes=8)))
        router = ns.Router([r0, r1], health_interval=1e9)
        rids = [router.enqueue(prompt_of(rng), 4) for _ in range(4)]
        router.drain_replica("r0")
        assert "r0" not in router.replicas_up()
        assert len(r1.enqueued) == 4
        r1.complete_all()
        router.pump()
        assert sorted(router.results()) == sorted(rids)
        # remove_replica hands the detached handle back.
        assert router.remove_replica("r0") is r0
        return r1.enqueued, router.epoch

    both(scenario)


def test_prefix_request_dies_with_its_replica_as_structured_error():
    def scenario(ns):
        rng = np.random.default_rng(11)
        r0, r1 = fakes(ns, ("r0", dict(prefix_ids=[5])), ("r1", {}))
        router = ns.Router([r0, r1], health_interval=0.0)
        rid = router.enqueue(prompt_of(rng), 4, prefix_id=5)
        assert r0.enqueued
        other = router.enqueue(prompt_of(rng), 4)
        r0.is_healthy = False
        router.pump()
        res = router.take(rid)
        assert res.status == "error" and "prefix_id" in res.error
        r1.complete_all()
        router.pump()
        assert router.take(other).ok
        return res.status, res.error

    both(scenario)


def test_step_thread_failure_flips_healthy():
    class BoomEngine:
        _next_id = 0
        closed = False
        queued = 1

        def running(self):
            return [0]

        def step(self):
            raise RuntimeError("boom")

    for ns in (PORT, REF):
        rep = ns.InProcessReplica("boomer", BoomEngine())
        rep.start()
        deadline = time.monotonic() + 10.0
        while rep.healthy() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not rep.healthy()
        rep.stop()


# ----------------------------------------------------------- lifecycle


def test_engineclosed_wins_enqueue_race():
    def scenario(ns):
        router = ns.Router([FakeReplica(ns, "r0")])
        router.begin_shutdown()
        with pytest.raises(ns.EngineClosed):
            router.enqueue(prompt_of(np.random.default_rng(12)), 4)
        return router.shutdown(max_steps=0)

    assert both(scenario) == {}


def test_shutdown_cancels_stragglers():
    def scenario(ns):
        r0 = FakeReplica(ns, "r0", lanes=8)
        router = ns.Router([r0])
        rid = router.enqueue(prompt_of(np.random.default_rng(13)), 4)
        res = router.shutdown(max_steps=2)
        assert res[rid].status == "cancelled"
        return r0.steps, res[rid].status

    both(scenario)


def test_replica_scoped_slo_breach_demotes_automatically():
    def scenario(ns):
        t = [0.0]
        r0, r1 = fakes(ns, ("r0", {}), ("r1", {}))
        router = ns.Router([r0, r1], clock=lambda: t[0])
        rules = router.slo_rules(ns.SloRule(
            "serving.request_s", percentile=0.5, threshold=1.0,
            window_s=10.0))
        assert [r.replica for r in rules] == ["r0", "r1"]
        events = []
        reg = ns.MetricsRegistry()
        eng = ns.SloEngine(reg, rules, clock=lambda: t[0],
                           emit=lambda name, **f: events.append((name, f)))
        eng.subscribe(router.breach_demoter())
        h = reg.histogram("serving.request_s")
        for _ in range(5):
            h.observe(5.0)
        eng.tick()
        breaches = sorted(f["replica"] for n, f in events
                          if n == "slo.breach")
        assert breaches == ["r0", "r1"]
        assert all(mm.degraded_until > t[0]
                   for mm in router._members.values())
        n_breach = reg.counter("slo.breaches").value(
            metric="serving.request_s", q="p50", replica="r0")
        assert n_breach == 1
        r2 = FakeReplica(ns, "r2")
        router.add_replica(r2)
        router.enqueue(prompt_of(np.random.default_rng(14)), 4)
        assert len(r2.enqueued) == 1 and not r0.enqueued \
            and not r1.enqueued
        return breaches, n_breach

    both(scenario)


def test_expired_on_arrival_never_routes():
    def scenario(ns):
        t = [10.0]
        r0 = FakeReplica(ns, "r0")
        router = ns.Router([r0], clock=lambda: t[0])
        rid = router.enqueue(prompt_of(np.random.default_rng(15)), 4,
                             ttl=0.0)
        assert router.take(rid).timed_out
        assert not r0.enqueued
        return rid

    both(scenario)


# ------------------------------------------- integration: real engines


def test_two_engine_affinity_and_parity(m, rng):
    """Affinity co-locates a shared stem (3 of 4 admissions hit), and
    the routed tokens equal the JAX package's lone engine, the port's
    ``generate`` and the JAX router over JAX engines."""
    stem = rng.integers(0, 64, (8,)).astype(np.int32)
    tails = rng.integers(0, 64, (4, 4)).astype(np.int32)
    prompts = [np.concatenate([stem, t]) for t in tails]
    out = {}
    for ns, make in ((PORT, paged), (REF, jpaged)):
        engines = [make(m) for _ in range(2)]
        router = ns.Router([ns.InProcessReplica(f"r{i}", e)
                            for i, e in enumerate(engines)])
        rids = [router.enqueue(p, 5) for p in prompts]
        out[ns is PORT] = [np.asarray(r.tokens) for r in run(router, rids)]
        assert sum(e.stem_hit_blocks for e in engines) >= 3
    for got, want, p in zip(out[True], out[False], prompts):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, m["jsolo"](p, 5))
        np.testing.assert_array_equal(got, m["tsolo"](p, 5))


def test_drain_midstream_keeps_parity_and_waterfall(m, rng, tmp_path):
    trace = str(tmp_path / "router.jsonl")
    engines = [paged(m) for _ in range(2)]
    router = Router([InProcessReplica(f"r{i}", e)
                     for i, e in enumerate(engines)])
    prompt = rng.integers(0, 64, (6,)).astype(np.int32)
    with obs.session(trace_path=trace):
        rid = router.enqueue(prompt, 10)
        router.step()                   # partial decode on hop 0
        src = router._requests[rid].replica
        router.drain_replica(src)       # forces the re-route hop
        res = router.drain(rid)
        assert res.ok
    np.testing.assert_array_equal(res.tokens, m["jsolo"](prompt, 10))
    wf = request_waterfall(read_trace(trace), rid)
    assert wf["found"] and wf["status"] == "ok"
    assert wf["reroutes"] == 1
    names = [s["name"] for s in wf["stages"]]
    assert "router.route" in names and "router.reroute" in names
    assert "serving.emit" in names and "serving.finish" in names
    replicas = {s.get("replica") for s in wf["stages"]
                if s["name"] == "serving.emit"}
    assert replicas and None not in replicas
    assert wf["tokens"] == 10


def test_residency_digest_and_endpoint(m, rng):
    eng = paged(m)
    jeng = jpaged(m)
    stem = rng.integers(0, 64, (8,)).astype(np.int32)
    pid = eng.pin_prefix(stem)
    jpid = jeng.pin_prefix(stem)
    doc = eng.residency()
    jdoc = jeng.residency()
    assert doc["block"] == BLOCK and doc["lanes"] == 2
    assert pid in doc["prefix_ids"] and pid == jpid
    assert doc["stem_hashes"] == jdoc["stem_hashes"]
    assert len(doc["stem_hashes"]) == 1
    assert doc["param_version"] == jdoc["param_version"] == 0
    with obs.session(serve_port=0, residency=eng.residency) as sess:
        url = sess.server.url + "/residency"
        got = json.loads(urllib.request.urlopen(url, timeout=5).read())
        assert got["stem_hashes"] == doc["stem_hashes"]
        assert got["block"] == BLOCK
    eng.unpin_prefix(pid)


def test_http_endpoint_serves_router(m, rng):
    eng = paged(m)
    ep = EngineEndpoint(eng, host_id=3)
    ep.start(step=True)
    try:
        assert eng._next_id >= 4 * 1_000_000
        replica = HttpReplica("h3", ep.addr)
        router = Router([replica], health_interval=0.0)
        prompt = rng.integers(0, 64, (6,)).astype(np.int32)
        rid = router.enqueue(prompt, 5)
        deadline = time.monotonic() + 60.0
        while router.poll(rid) is None:
            router.pump()
            assert time.monotonic() < deadline
            time.sleep(0.05)
        res = router.take(rid)
        assert res.ok and res.prompt_len == 6
        assert len(res.generated) == 5
        np.testing.assert_array_equal(res.tokens, m["jsolo"](prompt, 5))
        assert res.request_id == rid and rid < 1_000_000
        doc = json.loads(urllib.request.urlopen(
            f"http://{ep.addr}/residency", timeout=5).read())
        assert doc["block"] == BLOCK
        assert replica.healthy()
    finally:
        ep.stop()
    assert not replica.healthy()
    router.pump()
    assert router.replicas_up() == []

"""The port's autoscaling control plane against the JAX package's.

Mirrors ``tests/test_autoscale.py``: every scenario runs over scripted
fake replicas through BOTH packages' ``Router`` / ``Autoscaler`` /
``WarmPool``, and the port's decision timeline (``asc.decisions``:
tick, action, replica, reason, fleet size, epoch), its fleet snapshots
and its membership must equal the reference's exactly, on top of the
reference tests' own assertions.
"""

import numpy as np
import pytest

from tests.torch_fleet import PORT, REF, both


class Fake:
    """The reference tests' replica: bounded queue, ``step()`` completes
    at most ``lanes`` requests per call (queues build under load),
    controllable health, and a residency doc with pinned ``prefix_ids``
    for the retire guard."""

    remote = False

    def __init__(self, ns, name, lanes=2, max_queue=64, role=None,
                 prefix_ids=(), fail_residency=False):
        self.ns = ns
        self.name = name
        self.lanes = lanes
        self.max_queue = max_queue
        self.role = role
        self.prefix_ids = set(prefix_ids)
        self.fail_residency = fail_residency
        self.alive = True
        self._next = 0
        self._q = {}
        self._done = {}

    def set_rid_base(self, base):
        self._next = max(self._next, base)

    def enqueue(self, prompt, max_new, **kw):
        if len(self._q) >= self.max_queue:
            raise self.ns.QueueFull("full")
        rid = self._next
        self._next += 1
        self._q[rid] = (np.asarray(prompt, np.int32), int(max_new))
        return rid

    def step(self):
        for rid in list(self._q)[:self.lanes]:
            p, n = self._q.pop(rid)
            self._done[rid] = self.ns.RequestResult(
                rid, np.concatenate([p, np.ones(n, np.int32)]), "ok",
                p.size)

    def poll(self, rid):
        return self._done.get(rid)

    def partial(self, rid):
        return self._done.get(rid)

    def healthy(self):
        return self.alive

    def residency(self):
        if self.fail_residency or not self.alive:
            raise RuntimeError("replica is gone")
        return {"queue_depth": len(self._q), "lanes_busy": 0,
                "lanes": self.lanes, "block": None, "stem_hashes": [],
                "prefix_ids": sorted(self.prefix_ids)}

    def load(self):
        return (len(self._q), 0, self.lanes)


def fleet(ns, *replicas, clock=None):
    return ns.Router(list(replicas),
                     clock=clock if clock is not None else (lambda: 0.0))


def scaler(ns, router, pool, **kw):
    defaults = dict(min_replicas=1, max_replicas=4, up_threshold=0.9,
                    down_threshold=0.3, up_after=1, down_after=2,
                    cooldown_ticks=0, breach_ticks=2)
    defaults.update(kw)
    return ns.serving.Autoscaler(
        router, pool, policy=ns.serving.AutoscalePolicy(**defaults))


def plain(snap):
    """A fleet snapshot with its frozensets as sorted lists (comparable
    across packages)."""
    reps = {n: {k: (sorted(v) if isinstance(v, frozenset) else v)
                for k, v in r.items()}
            for n, r in snap["replicas"].items()}
    return dict(snap, replicas=reps)


# ------------------------------------------------------ fleet_snapshot


def test_fleet_snapshot_one_consistent_read():
    def scenario(ns):
        t = [0.0]
        router = fleet(ns, Fake(ns, "r0"), Fake(ns, "r1", lanes=4),
                       clock=lambda: t[0])
        router.enqueue([1, 2, 3], 2)
        snap = router.fleet_snapshot()
        assert set(snap) == {"epoch", "pending", "closed", "replicas"}
        assert snap["epoch"] == router.epoch and snap["pending"] == 0
        one = snap["replicas"]["r0"]
        for key in ("up", "draining", "degraded", "inflight", "role",
                    "queue_depth", "lanes_busy", "lanes", "load",
                    "prefix_ids", "stems", "block", "param_version"):
            assert key in one
        assert sum(r["queue_depth"]
                   for r in snap["replicas"].values()) == 1
        assert snap["replicas"]["r1"]["lanes"] == 4
        return plain(snap)

    both(scenario)


def test_fleet_snapshot_degraded_and_draining_flags():
    def scenario(ns):
        t = [0.0]
        router = fleet(ns, Fake(ns, "r0"), Fake(ns, "r1"),
                       clock=lambda: t[0])
        router.mark_degraded("r0", cooldown=5.0)
        snaps = [plain(router.fleet_snapshot())]
        assert snaps[0]["replicas"]["r0"]["degraded"]
        assert not snaps[0]["replicas"]["r1"]["degraded"]
        t[0] = 6.0
        snaps.append(plain(router.fleet_snapshot()))
        assert not snaps[1]["replicas"]["r0"]["degraded"]
        router.drain_replica("r1")
        snaps.append(plain(router.fleet_snapshot()))
        assert snaps[2]["replicas"]["r1"]["draining"]
        assert snaps[2]["epoch"] == router.epoch
        return snaps

    both(scenario)


def test_fleet_snapshot_feeds_routing_consistently():
    def scenario(ns):
        router = fleet(ns, Fake(ns, "r0"), Fake(ns, "r1"))
        router.mark_degraded("r0", cooldown=100.0)
        for _ in range(3):
            router.enqueue([1, 2, 3], 1)
        snap = router.fleet_snapshot()
        assert snap["replicas"]["r1"]["queue_depth"] == 3
        assert snap["replicas"]["r0"]["queue_depth"] == 0
        return plain(snap)

    both(scenario)


def test_remove_replica_returns_handle():
    def scenario(ns):
        r0, r1 = Fake(ns, "r0"), Fake(ns, "r1")
        router = fleet(ns, r0, r1)
        assert router.remove_replica("r1") is r1
        assert router.replicas_up() == ["r0"]
        return router.epoch

    both(scenario)


# ------------------------------------------------------------ scale-up


def test_scale_up_on_saturation_admits_warm_replica():
    def scenario(ns):
        router = fleet(ns, Fake(ns, "r0", lanes=1))
        pool = ns.serving.WarmPool([Fake(ns, "w0")])
        asc = scaler(ns, router, pool)
        for _ in range(4):
            router.enqueue([1, 2], 1)
        with ns.obs.session() as sess:
            rec = asc.tick()
            ups = sess.registry.counter("autoscale.scale_ups").value()
        assert rec["action"] == "up" and rec["replica"] == "w0"
        assert "w0" in router.replicas_up() and len(pool) == 0
        assert rec["epoch"] == router.epoch
        return rec, ups

    assert both(scenario)[1] == 1


def test_join_health_gate_skips_dead_pool_replica():
    def scenario(ns):
        router = fleet(ns, Fake(ns, "r0", lanes=1))
        dead = Fake(ns, "w0")
        dead.alive = False
        pool = ns.serving.WarmPool([dead, Fake(ns, "w1")])
        asc = scaler(ns, router, pool)
        for _ in range(4):
            router.enqueue([1, 2], 1)
        rec = asc.tick()
        assert rec["action"] == "up" and rec["replica"] == "w1"
        assert "w0" not in router.fleet_snapshot()["replicas"]
        return asc.decisions

    both(scenario)


def test_join_aborts_when_death_races_the_gate():
    def scenario(ns):
        router = fleet(ns, Fake(ns, "r0", lanes=1))
        racy = Fake(ns, "w0", fail_residency=True)

        def health_flip():
            racy.alive = False
            return True

        racy.healthy = health_flip
        pool = ns.serving.WarmPool([racy, Fake(ns, "w1")])
        asc = scaler(ns, router, pool)
        for _ in range(4):
            router.enqueue([1, 2], 1)
        rec = asc.tick()
        assert rec["action"] == "up" and rec["replica"] == "w1"
        assert "w0" not in router.fleet_snapshot()["replicas"]
        return asc.decisions

    both(scenario)


def test_pool_exhausted_recorded_not_fatal():
    def scenario(ns):
        router = fleet(ns, Fake(ns, "r0", lanes=1))
        asc = scaler(ns, router, ns.serving.WarmPool())
        for _ in range(4):
            router.enqueue([1, 2], 1)
        rec = asc.tick()
        assert rec["action"] == "exhausted"
        assert router.replicas_up() == ["r0"]
        return rec

    both(scenario)


def test_max_envelope_respected():
    def scenario(ns):
        router = fleet(ns, Fake(ns, "r0", lanes=1))
        pool = ns.serving.WarmPool([Fake(ns, "w0"), Fake(ns, "w1")])
        asc = scaler(ns, router, pool, max_replicas=2)
        for _ in range(8):
            router.enqueue([1, 2], 1)
        for _ in range(3):
            asc.tick()
        assert len(router.replicas_up()) == 2 and len(pool) == 1
        return asc.decisions

    both(scenario)


# ---------------------------------------------------------- scale-down


def test_scale_down_is_lossless_and_pools_the_handle():
    def scenario(ns):
        router = fleet(ns, Fake(ns, "r0"), Fake(ns, "r1"))
        pool = ns.serving.WarmPool()
        asc = scaler(ns, router, pool, down_after=1)
        rids = [router.enqueue([1, 2, 3], 2) for _ in range(2)]
        epoch0 = router.epoch
        asc.tick()
        for _ in range(4):
            router.step()
        rec = asc.tick()
        assert rec["action"] == "down"
        assert len(router.replicas_up()) == 1 and router.epoch > epoch0
        assert pool.names() == (rec["replica"],)
        statuses = [router.drain(rid).status for rid in rids]
        assert statuses == ["ok", "ok"]
        return asc.decisions, statuses

    both(scenario)


def test_min_envelope_respected():
    def scenario(ns):
        router = fleet(ns, Fake(ns, "r0"))
        asc = scaler(ns, router, ns.serving.WarmPool(), down_after=1)
        for _ in range(5):
            rec = asc.tick()
        assert rec["action"] == "hold"
        assert router.replicas_up() == ["r0"]
        return asc.decisions

    both(scenario)


def test_retire_refused_for_last_pinned_holder():
    def scenario(ns):
        router = fleet(ns, Fake(ns, "r0", prefix_ids={7}), Fake(ns, "r1"))
        router.refresh_residency()
        asc = scaler(ns, router, ns.serving.WarmPool(), down_after=1)
        rec = asc.tick()
        assert rec["action"] == "down" and rec["replica"] == "r1"
        a, b = Fake(ns, "a", prefix_ids={1}), Fake(ns, "b", prefix_ids={2})
        router2 = fleet(ns, a, b)
        router2.refresh_residency()
        asc2 = scaler(ns, router2, ns.serving.WarmPool(), down_after=1)
        rec2 = asc2.tick()
        assert rec2["action"] == "defer"
        assert rec2["reason"] == "pinned-last-holder"
        assert len(router2.replicas_up()) == 2
        b.prefix_ids.clear()
        router2.refresh_residency()
        rec3 = asc2.tick()
        assert rec3["action"] == "down" and rec3["replica"] == "b"
        return asc.decisions, asc2.decisions

    both(scenario)


def test_retire_allowed_when_pin_resident_elsewhere():
    def scenario(ns):
        router = fleet(ns, Fake(ns, "a", prefix_ids={5}),
                       Fake(ns, "b", prefix_ids={5}))
        router.refresh_residency()
        asc = scaler(ns, router, ns.serving.WarmPool(), down_after=1)
        assert asc.tick()["action"] == "down"
        return asc.decisions

    both(scenario)


# --------------------------------------------------------- hysteresis


def test_hysteresis_damps_flapping_load():
    def scenario(ns):
        router = fleet(ns, Fake(ns, "r0", lanes=1))
        pool = ns.serving.WarmPool([Fake(ns, "w0"), Fake(ns, "w1")])
        asc = scaler(ns, router, pool, down_after=3, cooldown_ticks=2)
        changes = 0
        for i in range(12):
            if i % 2 == 0:
                for _ in range(4):
                    router.enqueue([1, 2], 1)
            for _ in range(6):
                router.step()
            changes += asc.tick()["action"] in ("up", "down")
        assert changes <= 2
        return asc.decisions

    both(scenario)


def test_cooldown_blocks_back_to_back_changes():
    def scenario(ns):
        router = fleet(ns, Fake(ns, "r0", lanes=1))
        pool = ns.serving.WarmPool([Fake(ns, f"w{i}") for i in range(3)])
        asc = scaler(ns, router, pool, cooldown_ticks=3)
        for _ in range(12):
            router.enqueue([1, 2], 1)
        assert asc.tick()["action"] == "up"
        held = [asc.tick() for _ in range(2)]
        assert all(r["action"] == "hold" and r["reason"] == "cooldown"
                   for r in held)
        assert len(router.replicas_up()) == 2
        return asc.decisions

    both(scenario)


# ---------------------------------------------------------- SLO wiring


def test_slo_breach_votes_scale_up():
    def scenario(ns):
        router = fleet(ns, Fake(ns, "r0"))
        asc = scaler(ns, router, ns.serving.WarmPool([Fake(ns, "w0")]),
                     breach_ticks=2)
        t = [0.0]
        reg = ns.MetricsRegistry()
        eng = ns.SloEngine(reg, rules=(ns.SloRule(
            "serving.ttft_s", percentile=0.5, threshold=0.01,
            window_s=5.0),), clock=lambda: t[0])
        eng.subscribe(asc.on_breach)
        h = reg.histogram("serving.ttft_s", "ttft")
        eng.tick()
        for _ in range(8):
            h.observe(0.5)
        t[0] = 1.0
        eng.tick()
        rec = asc.tick()
        assert rec["action"] == "up" and rec["reason"] == "breach"
        return asc.decisions

    both(scenario)


def test_breach_vote_expires():
    def scenario(ns):
        router = fleet(ns, Fake(ns, "r0"))
        asc = scaler(ns, router, ns.serving.WarmPool([Fake(ns, "w0")]),
                     breach_ticks=1, max_replicas=1)
        asc.on_breach(None, 1.0)
        assert asc.tick()["action"] == "hold"
        for _ in range(4):
            rec = asc.tick()
        assert rec["action"] == "hold"
        return asc.decisions

    both(scenario)


# ------------------------------------------------- determinism harness


def replay_run(ns, seed):
    """A miniature bench harness: a fixed trace, a fake fleet and a
    scaler, all stepped synchronously."""
    trace = ns.serving.TraceReplay("spike", seed=seed, base_rate=1.0,
                                   spike_at=4, spike_len=6,
                                   spike_rate=10.0)
    router = fleet(ns, Fake(ns, "r0", lanes=2))
    warm = [Fake(ns, f"w{i}", lanes=2) for i in range(3)]
    asc = scaler(ns, router, ns.serving.WarmPool(warm), down_after=2,
                 cooldown_ticks=1)
    for t in range(24):
        for req in trace.requests_at(t):
            try:
                router.enqueue(trace.prompt(req, stem_len=4, tail_len=2,
                                            vocab=16), req.max_new)
            except ns.QueueFull:
                pass
        for _ in range(2):
            router.step()
        asc.tick()
    return [(d["tick"], d["action"], d["replica"], d["reason"],
             d["replicas"], d["epoch"]) for d in asc.decisions]


def test_decision_timeline_deterministic_same_seed():
    a = both(replay_run, 11)
    assert a == replay_run(PORT, 11)
    assert any(action == "up" for _, action, *_ in a)


@pytest.mark.parametrize("seed", [1, 2])
def test_decision_timeline_equals_reference_per_seed(seed):
    both(replay_run, seed)


# ---------------------------------------------------------- validation


def test_policy_validation():
    for ns in (PORT, REF):
        pol = ns.serving.AutoscalePolicy
        for kw in (dict(min_replicas=0),
                   dict(min_replicas=3, max_replicas=2),
                   dict(up_threshold=0.2, down_threshold=0.5),
                   dict(up_after=0), dict(cooldown_ticks=-1)):
            with pytest.raises(ValueError):
                pol(**kw)


def test_warm_pool_fifo():
    def scenario(ns):
        a, b = Fake(ns, "a"), Fake(ns, "b")
        pool = ns.serving.WarmPool([a])
        pool.put(b)
        assert len(pool) == 2 and pool.names() == ("a", "b")
        assert pool.take() is a and pool.take() is b
        assert pool.take() is None
        return pool.names()

    both(scenario)

"""The port's train -> serve weight push against the JAX package's.

Mirrors ``tests/test_weight_push.py``: a reader never adopts a torn,
corrupt or stale snapshot, and decodes exactly what the reference's
reader decodes from the same files (int8 coding included);
``swap_params`` replaces the served weights between steps, monotone in
version, validated leaf for leaf with the reference's error types, in
place (no leaf changes address), and each version's tokens equal the
JAX package's lone engine on those weights; the canary controller
promotes, rolls back (NaN drift, a chaos fault at the promote probe)
and quarantines exactly as the reference's does; the autoscaler's
timeline is blind to ``param_version``; and an ``LMTrainer`` publishing
every round feeds a polling fleet to its final weights.
"""

import json
import os
import threading
import warnings

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu import serving as jserving
from distkeras_tpu.models import transformer as jtfm
from distkeras_tpu_torch.models import generate as tgen
from distkeras_tpu_torch.models import transformer as ttfm
from distkeras_tpu_torch.parallel.tree import tree_leaves, tree_map
from distkeras_tpu_torch.resilience import chaos
from distkeras_tpu_torch.serving import (AutoscalePolicy, Autoscaler,
                                         CanaryController, ContinuousBatcher,
                                         InProcessReplica, PrefixPool, Router,
                                         SnapshotCorrupt, SnapshotPublisher,
                                         SnapshotReader, StaleSnapshot,
                                         WarmPool)
from distkeras_tpu_torch.utils import locks
from distkeras_tpu_torch.utils.serialization import params_from_numpy
from tests.torch_fleet import CFG_KW

CFG = ttfm.TransformerConfig(**CFG_KW)
JCFG = jtfm.TransformerConfig(**CFG_KW)


@pytest.fixture(scope="module")
def w():
    """Two weight versions in both packages, and the JAX package's lone
    engine per version as the token oracle."""
    jp = [jax.tree.map(np.asarray, jtfm.init_params(jax.random.key(k),
                                                    JCFG))
          for k in (0, 1)]
    engines, memo = {}, {}

    def jsolo(v, prompt, n):
        key = (v, tuple(int(t) for t in prompt), n)
        if key not in memo:
            if v not in engines:
                engines[v] = jserving.ContinuousBatcher(
                    jp[v], JCFG, lanes=1, prompt_buckets=(8,))
            eng = engines[v]
            lane = eng.submit(np.asarray(prompt, np.int32), n)
            while lane in eng.running():
                eng.step()
            memo[key] = np.asarray(eng.drain(lane))
        return memo[key]

    return dict(jp=jp, jsolo=jsolo,
                tp=[params_from_numpy(p, "cpu") for p in jp])


def fresh(w, v):
    """A fresh port tree of version ``v`` (a push the caller owns)."""
    return params_from_numpy(w["jp"][v], "cpu")


def template():
    return ttfm.init_params(0, CFG, device="cpu")


def engine(w, v=0, **kw):
    """A hot-swap engine on the module's SHARED tree of version ``v``,
    as the reference's tests build theirs: the engine swaps its own
    copy, so every engine here starts from ``w["tp"][v]`` and none may
    write it (``test_publish_roundtrip_raw_and_int8`` reads it)."""
    return ContinuousBatcher(w["tp"][v], CFG, lanes=2, hot_swap=True,
                             device="cpu", **kw)


def serve(eng, prompt, n=6):
    lane = eng.submit(prompt, n)
    while lane in eng.running():
        eng.step()
    return np.asarray(eng.drain(lane))


def leaves_equal(a, b):
    return all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


# ------------------------------------------------------------- publish


def test_publish_roundtrip_raw_and_int8(tmp_path, w):
    """The port's publish loads back through both packages' readers,
    and the int8 decode is the reference codec's, leaf for leaf."""
    for coding in (None, "int8"):
        root = str(tmp_path / (coding or "raw"))
        SnapshotPublisher(root, coding=coding).publish(w["tp"][1], 3)
        reader = SnapshotReader(root)
        assert reader.latest_version() == 3
        version, got = reader.poll(template())
        assert version == 3
        ref = jserving.SnapshotReader(root).load(3, w["jp"][1])
        for a, b, r in zip(tree_leaves(got), tree_leaves(w["tp"][1]),
                           jax.tree.leaves(ref)):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a.numpy(), np.asarray(r))
            if coding is None:
                assert torch.equal(a, b)
            else:
                assert float((a - b).abs().max()) < 0.1


def test_reader_declines_torn_manifest(tmp_path, w):
    root = str(tmp_path)
    SnapshotPublisher(root).publish(w["tp"][0], 1)
    os.makedirs(os.path.join(root, "v00000002"))
    with open(os.path.join(root, "v00000002", "bucket_0000.npz"),
              "wb") as f:
        f.write(b"partial")
    reader = SnapshotReader(root)
    assert reader.latest_version() == 1
    with pytest.raises(SnapshotCorrupt):
        reader.load(2, template())
    with pytest.raises(jserving.SnapshotCorrupt):
        jserving.SnapshotReader(root).load(2, w["jp"][0])
    assert reader.poll(template())[0] == 1


def test_reader_declines_checksum_mismatch(tmp_path, w):
    root = str(tmp_path)
    SnapshotPublisher(root).publish(w["tp"][0], 1)
    with open(os.path.join(root, "v00000001", "MANIFEST.json")) as f:
        body = json.load(f)
    bucket = os.path.join(root, "v00000001", body["buckets"][0]["file"])
    data = np.load(bucket)["raw"].copy()
    data[0] ^= 0xFF
    np.savez(bucket[:-4], raw=data)
    with pytest.raises(SnapshotCorrupt, match="checksum"):
        SnapshotReader(root).load(1, template())
    with pytest.raises(jserving.SnapshotCorrupt):
        jserving.SnapshotReader(root).load(1, w["jp"][0])


def test_reader_declines_stale_version(tmp_path, w):
    root = str(tmp_path)
    pub = SnapshotPublisher(root)
    pub.publish(w["tp"][0], 1)
    pub.publish(w["tp"][0], 2)
    reader = SnapshotReader(root)
    reader.adopt(2)
    with pytest.raises(StaleSnapshot):
        reader.load(1, template())
    with pytest.raises(StaleSnapshot):
        reader.load(2, template())
    assert reader.poll(template()) is None


# ------------------------------------------------------------ hot swap


def test_hot_swap_per_version_parity(w, rng):
    """Each version's tokens equal the JAX lone engine's on those
    weights — across swap and rollback — and the swap moves no leaf."""
    eng = engine(w)
    ptrs = [t.data_ptr() for t in tree_leaves(eng.params)]
    prompt = rng.integers(0, 64, (5,)).astype(np.int32)
    np.testing.assert_array_equal(serve(eng, prompt),
                                  w["jsolo"](0, prompt, 6))
    assert eng.param_version == 0
    eng.swap_params(fresh(w, 1), 1)
    assert eng.param_version == 1
    np.testing.assert_array_equal(serve(eng, prompt),
                                  w["jsolo"](1, prompt, 6))
    # Numpy trees swap too (the reference's pushes are numpy).
    eng.swap_params(w["jp"][0], 0, allow_downgrade=True)
    np.testing.assert_array_equal(serve(eng, prompt),
                                  w["jsolo"](0, prompt, 6))
    assert [t.data_ptr() for t in tree_leaves(eng.params)] == ptrs
    assert eng.residency()["param_version"] == 0


def test_swap_validation(w):
    eng = engine(w)
    jeng = jserving.ContinuousBatcher(w["jp"][0], JCFG, lanes=2,
                                      hot_swap=True)
    for e, tree in ((eng, lambda v: fresh(w, v)),
                    (jeng, lambda v: w["jp"][v])):
        e.swap_params(tree(1), 2)
        with pytest.raises(ValueError, match="monotone|<="):
            e.swap_params(tree(0), 2)
        with pytest.raises(ValueError, match="monotone|<="):
            e.swap_params(tree(0), 1)
        bad = {k: v for k, v in tree(0).items() if k != "tok_emb"}
        with pytest.raises(ValueError):
            e.swap_params(bad, 3)
    # A refused swap (a wrong leaf past the first) leaves the weights
    # bit for bit: every leaf is validated before the first copy.
    before = tree_map(lambda t: t.clone(), eng.params)
    wrong = fresh(w, 0)
    last = sorted(k for k, v in wrong.items() if torch.is_tensor(v))[-1]
    wrong[last] = wrong[last].double()
    with pytest.raises(ValueError, match="leaf"):
        eng.swap_params(wrong, 9)
    assert leaves_equal(eng.params, before) and eng.param_version == 2
    plain = ContinuousBatcher(fresh(w, 0), CFG, lanes=2, device="cpu")
    with pytest.raises(ValueError, match="hot_swap"):
        plain.swap_params(fresh(w, 1), 1)


def test_hot_swap_rejects_baked_prefix_state(w):
    with pytest.raises(ValueError, match="hot_swap"):
        ContinuousBatcher(fresh(w, 0), CFG, lanes=2, hot_swap=True,
                          prefix_pool=PrefixPool(CFG, slots=1,
                                                 device="cpu"),
                          device="cpu")
    with pytest.raises(ValueError, match="hot_swap"):
        jserving.ContinuousBatcher(w["jp"][0], JCFG, lanes=2,
                                   hot_swap=True,
                                   prefix_pool=jserving.PrefixPool(
                                       JCFG, slots=1))


def test_concurrent_publish_while_swap_atomic(tmp_path, w, rng):
    """A publisher thread and a swap-and-serve loop race: every wave's
    tokens match exactly one version, never a mix."""
    root = str(tmp_path)
    pub = SnapshotPublisher(root)
    reader = SnapshotReader(root)
    eng = engine(w)
    prompt = rng.integers(0, 64, (5,)).astype(np.int32)
    refs = {0: w["jsolo"](0, prompt, 6), 1: w["jsolo"](1, prompt, 6)}
    trees = {1: fresh(w, 1), 2: fresh(w, 0)}
    base_viol = locks.violation_count()
    errs = []
    adopted_v1 = threading.Event()

    def publish_loop():
        try:
            pub.publish(trees[1], 1)
            adopted_v1.wait(timeout=30)
            pub.publish(trees[2], 2)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errs.append(e)

    t = threading.Thread(target=publish_loop)
    t.start()
    seen = []
    try:
        for _ in range(50):
            nxt = reader.poll(template())
            if nxt is not None:
                version, tree = nxt
                eng.swap_params(tree, version)
                reader.adopt(version)
                if version >= 1:
                    adopted_v1.set()
            out = serve(eng, prompt)
            matched = [v for v, ref in refs.items()
                       if np.array_equal(out, ref)]
            assert matched, "serve wave matched NO whole version"
            seen.append(matched[0])
            if eng.param_version == 2:
                break
    finally:
        adopted_v1.set()
        t.join(timeout=60)
    assert not t.is_alive(), "the publisher thread hung"
    assert not errs, errs
    assert eng.param_version == 2
    assert {0, 1} <= set(seen), seen
    assert locks.violation_count() == base_viol


def test_inflight_request_continues_on_the_new_weights(w, rng):
    """The mixed-cache contract: a request in flight across a swap
    keeps its pre-swap tokens (the old version's) and ends ok."""
    eng = engine(w)
    prompt = rng.integers(0, 64, (5,)).astype(np.int32)
    rid = eng.enqueue(prompt, 8)
    for _ in range(3):
        eng.step()
    head = list(eng.partial(rid).tokens)
    eng.swap_params(fresh(w, 1), 1)
    while eng.poll(rid) is None:
        eng.step()
    res = eng.take(rid)
    assert res.ok and list(res.tokens[:len(head)]) == head
    np.testing.assert_array_equal(head,
                                  w["jsolo"](0, prompt, 8)[:len(head)])


# -------------------------------------------------------------- canary


def fleet(w, n=2):
    engines = [engine(w) for _ in range(n)]
    return engines, Router([InProcessReplica(f"r{i}", e)
                            for i, e in enumerate(engines)])


def test_canary_push_leaves_a_shared_tree_fleet_alone(w, rng):
    """The reference's ``fleet(params)``: both engines built on ONE
    tree.  A canary push changes the canary only: inside the canary
    window the other replica still serves version 0 and the fleet
    snapshot says so, and no push ever writes the caller's tree."""
    shared = w["tp"][0]
    before = tree_map(lambda t: t.clone(), shared)
    engines = [ContinuousBatcher(shared, CFG, lanes=2, hot_swap=True,
                                 device="cpu") for _ in range(2)]
    router = Router([InProcessReplica(f"r{i}", e)
                     for i, e in enumerate(engines)])
    prompt = rng.integers(0, 64, (5,)).astype(np.int32)
    during = {}

    class Watched(CanaryController):
        def _drift(self, new_tree, old_tree):
            # Runs after the canary swap, before the fleet follows.
            during["versions"] = {
                n: r["param_version"]
                for n, r in router.fleet_snapshot()["replicas"].items()}
            during["tokens"] = [serve(e, prompt) for e in engines]
            return super()._drift(new_tree, old_tree)

    rec = Watched(router, None, CFG, template()).rollout(1, fresh(w, 1))
    assert rec["action"] == "promote" and rec["canaries"] == ["r0"]
    assert during["versions"] == {"r0": 1, "r1": 0}
    np.testing.assert_array_equal(during["tokens"][0],
                                  w["jsolo"](1, prompt, 6))
    np.testing.assert_array_equal(during["tokens"][1],
                                  w["jsolo"](0, prompt, 6))
    assert all(e.param_version == 1 for e in engines)
    for e in engines:
        np.testing.assert_array_equal(serve(e, prompt),
                                      w["jsolo"](1, prompt, 6))
    assert leaves_equal(shared, before)


def wave(router, n=3, max_new=5):
    rids = [router.enqueue([1 + i, 2, 3], max_new) for i in range(n)]
    return [tuple(int(t) for t in router.drain(r).tokens) for r in rids]


def test_canary_lifecycle(w):
    """Promote -> NaN rollback -> chaos fault at the promote probe, with
    per-replica ``param_version`` in the fleet snapshot: the same
    records as the reference's controller over its own fleet."""
    def lifecycle(mk_engine, router_cls, rep_cls, ctl_cls, cfg, tmpl, v1,
                  nan, plan_cls, fault):
        engines = [mk_engine() for _ in range(2)]
        router = router_cls([rep_cls(f"r{i}", e)
                             for i, e in enumerate(engines)])
        ctl = ctl_cls(router, None, cfg, tmpl)
        epoch0 = router.fleet_snapshot()["epoch"]
        recs = [ctl.rollout(1, v1())]
        snap = router.fleet_snapshot()
        assert all(r["param_version"] == 1
                   for r in snap["replicas"].values())
        assert snap["epoch"] > epoch0
        served = wave(router)
        recs.append(ctl.rollout(2, nan()))
        assert all(e.param_version == 1 for e in engines)
        assert wave(router) == served
        plan = plan_cls().fail("canary.promote", at=3)
        with plan:
            with pytest.raises(fault):
                ctl.rollout(3, v1())
        assert ("canary.promote", 3, "fail") in plan.events
        assert all(e.param_version == 1 for e in engines)
        assert wave(router) == served
        return [{k: v for k, v in r.items()} for r in recs], served

    from distkeras_tpu.resilience import chaos as jchaos

    base_viol = locks.violation_count()
    got = lifecycle(
        lambda: engine(w), Router, InProcessReplica, CanaryController, CFG,
        template(), lambda: fresh(w, 1),
        lambda: tree_map(lambda t: torch.full_like(t, float("nan")),
                         fresh(w, 1)),
        chaos.FaultPlan, chaos.FaultInjected)
    want = lifecycle(
        lambda: jserving.ContinuousBatcher(w["jp"][0], JCFG, lanes=2,
                                           hot_swap=True),
        jserving.Router, jserving.InProcessReplica,
        jserving.CanaryController, JCFG, w["jp"][0], lambda: w["jp"][1],
        lambda: jax.tree.map(lambda a: np.full_like(a, np.nan),
                             w["jp"][1]),
        jchaos.FaultPlan, jchaos.FaultInjected)
    assert [r["action"] for r in got[0]] == ["promote", "rollback"]
    assert got[0][1]["drift"] == float("inf")
    for g, r in zip(got[0], want[0]):
        assert {k: v for k, v in g.items() if k != "drift"} == \
            {k: v for k, v in r.items() if k != "drift"}
    np.testing.assert_allclose(got[0][0]["drift"], want[0][0]["drift"],
                               rtol=1e-4)
    assert got[1] == want[1]                  # the same promoted tokens
    assert locks.violation_count() == base_viol


def test_canary_poll_quarantines_rejected_version(tmp_path, w):
    root = str(tmp_path)
    pub = SnapshotPublisher(root)
    engines, router = fleet(w)
    ctl = CanaryController(router, SnapshotReader(root), CFG, template())
    pub.publish(fresh(w, 1), 1)
    assert ctl.poll()["action"] == "promote"
    pub.publish(tree_map(lambda t: torch.full_like(t, float("nan")),
                         fresh(w, 1)), 2)
    assert ctl.poll()["action"] == "rollback"
    assert all(e.param_version == 1 for e in engines)
    assert ctl.poll() is None
    # A corrupted bucket aborts and the fleet stays on its version.
    pub.publish(fresh(w, 0), 3)
    with open(os.path.join(root, "v00000003", "MANIFEST.json")) as f:
        body = json.load(f)
    bucket = os.path.join(root, "v00000003", body["buckets"][0]["file"])
    data = np.load(bucket)["raw"].copy()
    data[0] ^= 0xFF
    np.savez(bucket[:-4], raw=data)
    rec = ctl.poll()
    assert rec["action"] == "abort" and "checksum" in rec["error"]
    assert all(e.param_version == 1 for e in engines)


def test_autoscaler_ignores_param_version(w):
    def run(swap):
        engines, router = fleet(w)
        asc = Autoscaler(router, WarmPool([InProcessReplica("w0",
                                                            engine(w))]),
                         policy=AutoscalePolicy(
                             min_replicas=1, max_replicas=3, up_after=1,
                             down_after=10, cooldown_ticks=0))
        timeline = []
        for tick in range(4):
            if swap and tick == 2:
                for e in engines:
                    e.swap_params(fresh(w, 1), 1)
            timeline.append((tick, asc.tick()["action"]))
        return timeline

    assert run(swap=False) == run(swap=True)


# ------------------------------------------------------ trainer hook


def test_trainer_publishes_and_fleet_adopts(tmp_path, w):
    """The closed loop: an LMTrainer publishes every round while a
    hot-swap fleet polls; versions advance mid-session and the final
    served weights are the final trained weights."""
    import distkeras_tpu_torch as dkt

    root = str(tmp_path)
    toks = np.random.default_rng(0).integers(0, 64, (32, 17)).astype(
        np.int32)
    t = dkt.LMTrainer(CFG, learning_rate=1e-2, batch_size=16, num_epoch=2,
                      device="cpu")
    assert t.attach_publisher(SnapshotPublisher(root), every=1) is t
    engines, router = fleet(w)
    ctl = CanaryController(router, SnapshotReader(root), CFG, template())
    versions = []
    done = threading.Event()

    def poll_loop():
        while not done.is_set():
            rec = ctl.poll()
            if rec is not None and rec["action"] == "promote":
                versions.append(rec["version"])
            done.wait(0.01)

    poller = threading.Thread(target=poll_loop)
    poller.start()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            trained = t.train(dkt.Dataset({"tokens": toks}))
    finally:
        done.set()
        poller.join(timeout=60)
    assert not poller.is_alive(), "the canary poller hung"
    rec = ctl.poll()
    if rec is not None and rec["action"] == "promote":
        versions.append(rec["version"])
    rounds = len(t.history)
    assert versions and versions[-1] == rounds, (versions, rounds)
    assert all(e.param_version == rounds for e in engines)
    prompt = np.asarray([1, 2, 3], np.int32)
    res = router.drain(router.enqueue(prompt, 5))
    solo = tgen.generate(trained, prompt[None], CFG, 5,
                         device="cpu")[0].numpy()
    np.testing.assert_array_equal(np.asarray(res.tokens), solo)


def test_keras_trainer_publishes_its_weights(tmp_path):
    """Every trainer publishes through the same round hook, with and
    without a checkpoint directory: a Keras-family trainer publishes its
    parameter leaves (``tv`` / ``ntv``) every round and on the final one,
    and the last snapshot holds the trained weights."""
    import distkeras_tpu_torch as dkt

    rng = np.random.default_rng(3)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.int64)
    for ckpt in (None, str(tmp_path / "ckpt")):
        root = str(tmp_path / f"snap_{ckpt is None}")
        model = dkt.zoo.higgs_mlp(input_dim=8, hidden=(16,), seed=0)
        t = dkt.SingleTrainer(model, loss="sparse_categorical_crossentropy",
                              worker_optimizer="sgd", learning_rate=0.1,
                              batch_size=16, num_epoch=1, device="cpu",
                              checkpoint_dir=ckpt,
                              checkpoint_every=2 if ckpt else 0)
        t.attach_publisher(SnapshotPublisher(root), every=3)
        trained = t.train(dkt.Dataset.from_arrays(x, y))
        reader = SnapshotReader(root)
        assert reader.latest_version() == 4           # rounds 3 and 4
        assert sorted(os.listdir(root)) == ["LATEST", "v00000003",
                                            "v00000004"]
        tmpl = {"tv": [p.detach() for p in trained.parameters()],
                "ntv": [b for b in trained.buffers()]}
        version, got = reader.poll(tmpl)
        assert version == 4
        for a, b in zip(got["tv"], trained.parameters()):
            assert torch.equal(a, b.detach())
    # The replica family publishes its center variable, as the
    # reference's eval view reads it.
    root = str(tmp_path / "replica")
    model = dkt.zoo.higgs_mlp(input_dim=8, hidden=(16,), seed=0)
    t = dkt.AEASGD(model, loss="sparse_categorical_crossentropy",
                   learning_rate=0.1, batch_size=16, num_epoch=1,
                   communication_window=2, device="cpu")
    t.attach_publisher(SnapshotPublisher(root), every=1)
    trained = t.train(dkt.Dataset.from_arrays(x, y))
    tmpl = {"tv": [p.detach() for p in trained.parameters()],
            "ntv": [b for b in trained.buffers()]}
    version, got = SnapshotReader(root).poll(tmpl)
    assert version == len(os.listdir(root)) - 1 >= 1
    for a, b in zip(got["tv"], trained.parameters()):
        assert torch.equal(a, b.detach())
    with pytest.raises(ValueError, match="every"):
        t.attach_publisher(SnapshotPublisher(root), every=0)

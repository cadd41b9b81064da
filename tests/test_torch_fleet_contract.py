"""Cross-package contracts of the port's fleet (CPU).

- (i) block shipments: ``encode_shipment`` writes the reference's bytes
  for equal int8 and f32 contents, and each package decodes the other's;
- (ii) the wire: the port's ``HttpReplica`` drives the reference's
  ``EngineEndpoint`` and the reference's ``HttpReplica`` drives the
  port's (enqueue / poll / stream / residency / healthz and a shipment
  over ``POST /blocks``), tokens equal at f32;
- (iii) the schema: the routes and statuses the port's servers and
  clients speak, and the names, kinds and label keys its fleet modules
  emit, equal ``scripts/obs_schema.json`` (read only) — statically, by
  the reference's own census, and in a live router + disagg + autoscale
  + canary + publish + SLO run;
- (iv) snapshots: one package's publish loads in the other, raw and
  int8, with equal leaves and manifest checksums;
- the public surface: ``serving.__all__`` and ``obs.__all__`` equal the
  reference's, and ``kv_int8`` below 16 lanes warns and emits
  ``serving.advisory`` as the reference does.
"""

import json
import os
import struct
import time
import warnings

import jax
import numpy as np
import pytest
import torch

import distkeras_tpu.obs as j_obs
import distkeras_tpu.serving as j_serving
import distkeras_tpu_torch.obs as t_obs
import distkeras_tpu_torch.serving as t_serving
from distkeras_tpu.analysis import contract_lint as lint
from distkeras_tpu.serving import disagg as j_disagg
from distkeras_tpu_torch.parallel.tree import tree_leaves, tree_map
from distkeras_tpu_torch.serving import disagg as t_disagg
from distkeras_tpu_torch.serving.disagg import leaf_dtype_names
from tests.torch_fleet import (BLOCK, CFG_KW, FakeReplica, PORT, count,
                               jpaged, model, paged, run)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEMA = os.path.join(REPO, "scripts", "obs_schema.json")
PORT_PKG = os.path.join(REPO, "distkeras_tpu_torch")
FLEET_PREFIXES = ("router.", "serving.disagg.", "autoscale.", "canary.",
                  "publish.", "slo.", "serving.param_swap")


@pytest.fixture(scope="module")
def m():
    return model()


def schema():
    with open(SCHEMA, encoding="utf-8") as f:
        return json.load(f)


def fleet_names(names):
    return {n for n in names if n.startswith(FLEET_PREFIXES)}


# ------------------------------------------------ (i) block shipments


def blocks(seed=7, n=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        out.append((
            rng.integers(-127, 128, (2, 1, BLOCK, 2, 16)).astype(np.int8),
            rng.normal(size=(2, 1, BLOCK, 2)).astype(np.float32),
            rng.normal(size=(2, 1, BLOCK, 2, 16)).astype(np.float32)))
    return tuple(out), tuple(bytes([k]) * 16 for k in range(n))


@pytest.mark.parametrize("seed", [7, 8])
def test_shipment_bytes_equal_across_packages(seed):
    blk, hashes = blocks(seed)
    tb = t_disagg.encode_shipment(t_disagg.BlockShipment(
        block=BLOCK, hashes=hashes, blocks=blk))
    jb = j_disagg.encode_shipment(j_disagg.BlockShipment(
        block=BLOCK, hashes=hashes, blocks=blk))
    assert tb == jb
    for back in (t_disagg.decode_shipment(jb), j_disagg.decode_shipment(tb)):
        assert back.hashes == hashes and back.block == BLOCK
        for got, want in zip(back.blocks, blk):
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


def header(data: bytes) -> dict:
    (hlen,) = struct.unpack_from("<I", data)
    return json.loads(data[4:4 + hlen])


def test_engine_shipments_decode_in_the_other_package(m, rng):
    """A real slab's int8 (``kv_int8=True``) export crosses both ways
    and re-encodes to the same bytes."""
    prompt = rng.integers(0, 64, (17,)).astype(np.int32)
    tship = paged(m, kv_int8=True).export_blocks(prompt)
    jship = jpaged(m, kv_int8=True).export_blocks(prompt)
    assert leaf_dtype_names(tship) == ("int8", "float32", "int8", "float32")
    tb = t_disagg.encode_shipment(tship)
    jb = j_disagg.encode_shipment(jship)
    assert header(tb) == header(jb)          # the payloads: f32 rounding
    assert j_disagg.encode_shipment(j_disagg.decode_shipment(tb)) == tb
    assert t_disagg.encode_shipment(t_disagg.decode_shipment(jb)) == jb


# ------------------------------------------------------------ (ii) wire


def drive(http_cls, endpoint_cls, eng, prompt, block_src, n=5):
    """Drive one engine endpoint through one package's HttpReplica:
    the admission surface, then a shipment over /blocks."""
    ep = endpoint_cls(eng, host_id=2).start(step=True)
    try:
        rep = http_cls("h2", ep.addr)
        assert rep.healthy()
        doc = rep.residency()
        assert doc["block"] == BLOCK and doc["lanes"] == 2
        assert rep.load()[2] == 2
        rid = rep.enqueue(prompt, n)
        deadline = time.monotonic() + 60.0
        while (res := rep.poll(rid)) is None:
            part = rep.partial(rid)           # the live transcript
            assert part is not None and part.status in (
                "queued", "decoding", "ok")
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert res.ok
        # GET /stream serves terminal results too; unknown ids are None.
        np.testing.assert_array_equal(rep.partial(rid).tokens, res.tokens)
        assert rep.partial(987654321) is None
        fresh = np.arange(BLOCK, dtype=np.int32) + 50    # a cold stem
        imported = rep.import_blocks(block_src.export_blocks(fresh))
        assert imported["blocks"] == 1 and imported["hits"] == 0
        rep.unpin(int(imported["prefix_id"]))
        return np.asarray(res.tokens)
    finally:
        ep.stop()


def test_port_replica_drives_reference_endpoint(m, rng):
    prompt = rng.integers(0, 64, (9,)).astype(np.int32)
    toks = drive(t_serving.HttpReplica, j_serving.EngineEndpoint,
                 jpaged(m), prompt, jpaged(m))
    np.testing.assert_array_equal(toks, m["jsolo"](prompt, 5))


def test_reference_replica_drives_port_endpoint(m, rng):
    prompt = rng.integers(0, 64, (9,)).astype(np.int32)
    toks = drive(j_serving.HttpReplica, t_serving.EngineEndpoint,
                 paged(m), prompt, paged(m))
    np.testing.assert_array_equal(toks, m["jsolo"](prompt, 5))


def test_mixed_fleet_routes_across_packages(m, rng):
    """One port router over a port endpoint and a reference endpoint,
    the disaggregated hop crossing packages: port prefill, reference
    decode."""
    pre = t_serving.EngineEndpoint(paged(m), host_id=0,
                                   role="prefill").start(step=True)
    dec = j_serving.EngineEndpoint(jpaged(m), host_id=1,
                                   role="decode").start(step=True)
    try:
        router = t_serving.Router(
            [t_serving.HttpReplica("pre", pre.addr, role="prefill"),
             t_serving.HttpReplica("dec", dec.addr, role="decode")],
            health_interval=0.0)
        router.refresh_residency()
        prompt = rng.integers(0, 64, (17,)).astype(np.int32)
        with t_obs.session() as sess:
            rid = router.enqueue(prompt, 5)
            assert count(sess, "router.disagg_requests") == 1
        deadline = time.monotonic() + 60.0
        while router.poll(rid) is None:
            router.pump()
            assert time.monotonic() < deadline
            time.sleep(0.05)
        np.testing.assert_array_equal(router.take(rid).tokens,
                                      m["jsolo"](prompt, 5))
    finally:
        pre.stop()
        dec.stop()


# ----------------------------------------------------------- (iii) schema


def test_wire_census_equals_the_schema():
    """The reference's own static census over the port's server and
    client modules rebuilds the schema's ``wire`` section exactly."""
    files = {"serving/router.py": "engine", "obs/live.py": "telemetry"}
    servers, clients = {}, {}
    for rel, family in files.items():
        with open(os.path.join(PORT_PKG, rel), encoding="utf-8") as f:
            src = f.read()
        servers.setdefault(family, {}).update(lint.server_routes(src, rel))
        fam = clients.setdefault(family, {})
        for c in lint.client_calls(src, rel):
            ent = fam.setdefault(c["route"], {"params": set(),
                                              "expects": set(),
                                              "sites": []})
            ent["params"] |= c["params"]
            ent["expects"] |= c["expects"]
    assert lint._wire_doc(servers, clients) == schema()["wire"]


def test_emission_census_equals_the_schema():
    """Every fleet metric and event the port's modules emit, with its
    kind and label keys, is the schema's, and none is missing."""
    sites = []
    for root, _dirs, names in os.walk(PORT_PKG):
        for name in names:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path, encoding="utf-8") as f:
                    sites += lint.census_emits(f.read(), path)
    census, collisions = lint.merge_census(sites)
    assert not collisions
    pinned = schema()["metrics"]
    got = {n: {"kind": e["kind"], "labels": sorted(e["labels"])}
           for n, e in census.items() if n in fleet_names(census)}
    want = {n: pinned[n] for n in fleet_names(pinned)}
    assert got == want


def test_live_fleet_run_emits_the_schema(m, rng, tmp_path):
    """A router + disagg + autoscale + canary + publish + SLO run: every
    fleet name it records is in the schema, with its kind and label
    keys among the schema's."""
    pinned = schema()["metrics"]
    trace = str(tmp_path / "fleet.jsonl")
    rule = t_obs.SloRule("serving.request_s", percentile=0.5,
                         threshold=1e-9, window_s=60.0)
    with t_obs.session(trace_path=trace, slo_rules=[rule],
                       slo_tick_s=3600.0) as sess:
        pre, dec = paged(m), paged(m)
        router = t_serving.Router([
            t_serving.InProcessReplica("pre", pre, role="prefill"),
            t_serving.InProcessReplica("dec", dec, role="decode")])
        router.refresh_residency()
        prompts = [rng.integers(0, 64, (17,)).astype(np.int32)
                   for _ in range(2)]
        run(router, [router.enqueue(p, 4) for p in prompts])
        sess.slo.tick()
        asc = t_serving.Autoscaler(
            router, t_serving.WarmPool([FakeReplica(PORT, "w0")]),
            policy=t_serving.AutoscalePolicy(up_after=1, cooldown_ticks=0,
                                             breach_ticks=1))
        asc.on_breach(rule, 1.0)
        asc.tick()
        hs = t_serving.ContinuousBatcher(
            tree_map(torch.clone, m["p"]), m["cfg"], lanes=2,
            hot_swap=True, device="cpu")
        canary_router = t_serving.Router([t_serving.InProcessReplica(
            "c0", hs)])
        root = str(tmp_path / "snap")
        t_serving.SnapshotPublisher(root).publish(m["p"], 1)
        ctl = t_serving.CanaryController(
            canary_router, t_serving.SnapshotReader(root), m["cfg"],
            m["p"])
        assert ctl.poll()["action"] == "promote"
        snap = sess.registry.snapshot()
    records = [r for r in j_obs.read_trace(trace) if r["kind"] == "event"]
    seen = {}
    for name, doc in snap.items():
        labels = set().union(*(set(dict(s["labels"])) for s in
                               doc["series"])) if doc["series"] else set()
        seen[name] = (doc["kind"], labels)
    for r in records:
        kind, labels = seen.get(r["name"], ("event", set()))
        seen[r["name"]] = ("event", labels | set(r["fields"]) | {"t"})
    fleet = fleet_names(seen)
    for must in ("router.disagg_requests", "serving.disagg.blocks_in",
                 "autoscale.scale_ups", "canary.promotions",
                 "publish.snapshots", "slo.breaches",
                 "serving.param_swaps", "serving.param_swap"):
        assert must in fleet, must
    for name in fleet:
        kind, labels = seen[name]
        assert name in pinned, name
        assert kind == pinned[name]["kind"], name
        assert labels - {"t"} <= set(pinned[name]["labels"]) | {"t"}, name


# --------------------------------------------------------- (iv) snapshots


@pytest.mark.parametrize("coding", [None, "int8"])
def test_snapshots_interchange(m, tmp_path, coding):
    jp = m["jp"]
    t_root, j_root = str(tmp_path / "t"), str(tmp_path / "j")
    t_serving.SnapshotPublisher(t_root, coding=coding).publish(m["p"], 4)
    j_serving.SnapshotPublisher(j_root, coding=coding).publish(jp, 4)
    for sub in ("LATEST", "v00000004/MANIFEST.json"):
        with open(os.path.join(t_root, sub)) as a, \
                open(os.path.join(j_root, sub)) as b:
            assert json.load(a) == json.load(b)
    tmpl = tree_map(torch.zeros_like, m["p"])
    from_j = t_serving.SnapshotReader(j_root).load(4, tmpl)
    from_t = j_serving.SnapshotReader(t_root).load(4, jp)
    own = t_serving.SnapshotReader(t_root).load(4, tmpl)
    for a, b, c in zip(tree_leaves(from_j), jax.tree.leaves(from_t),
                       tree_leaves(own)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert torch.equal(a, c)


def test_bf16_snapshot_written_as_raw_words(m, tmp_path):
    """A bf16 tree publishes its raw 16-bit words under the name
    ``"bfloat16"``; the reference reads them as its own bfloat16 and the
    port reads them back bit for bit."""
    bf = tree_map(lambda t: t.to(torch.bfloat16), m["p"])
    root = str(tmp_path)
    t_serving.SnapshotPublisher(root).publish(bf, 1)
    with open(os.path.join(root, "v00000001", "MANIFEST.json")) as f:
        assert {b["dtype"] for b in json.load(f)["buckets"]} == \
            {"bfloat16"}
    back = t_serving.SnapshotReader(root).load(1, bf)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(back), tree_leaves(bf)))
    jtmpl = jax.tree.map(lambda a: a.astype(jax.numpy.bfloat16), m["jp"])
    ref = j_serving.SnapshotReader(root).load(1, jtmpl)
    for a, r in zip(tree_leaves(bf), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(
            a.view(torch.int16).numpy(),
            np.asarray(r).view(np.int16))


# ------------------------------------------------------ the public surface


def test_serving_and_obs_all_equal_the_reference():
    assert t_serving.__all__ == j_serving.__all__
    assert t_obs.__all__ == j_obs.__all__
    for mod, names in ((t_serving, t_serving.__all__),
                       (t_obs, t_obs.__all__)):
        for name in names:
            assert hasattr(mod, name), name
    assert t_serving.KV_INT8_LANE_ADVISORY == \
        j_serving.KV_INT8_LANE_ADVISORY == 16


@pytest.mark.parametrize("lanes, warns", [(2, True), (16, False)])
def test_kv_int8_small_lanes_advisory(m, tmp_path, lanes, warns):
    def build(obs_mod, make):
        path = str(tmp_path / f"{obs_mod.__name__}.jsonl")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with obs_mod.session(trace_path=path):
                make()
        events = [r for r in obs_mod.read_trace(path)
                  if r.get("name") == "serving.advisory"]
        return ([w for w in caught
                 if issubclass(w.category, RuntimeWarning)
                 and "kv_int8" in str(w.message)], events)

    tw, tev = build(t_obs, lambda: t_serving.ContinuousBatcher(
        m["p"], m["cfg"], lanes=lanes, kv_int8=True, device="cpu"))
    jw, jev = build(j_obs, lambda: j_serving.ContinuousBatcher(
        m["jp"], m["jcfg"], lanes=lanes, kv_int8=True))
    assert bool(tw) == bool(jw) == warns
    assert len(tev) == len(jev) == int(warns)
    if warns:
        for t, j in zip(tev, jev):
            assert t["fields"]["kind"] == j["fields"]["kind"] == \
                "kv_int8_small_lanes"
            assert t["fields"]["lanes"] == j["fields"]["lanes"] == lanes
        # The port states the card's finding, no TPU figure.
        assert "-15%" not in str(tw[0].message)
        assert "H100" in str(tw[0].message)
    # A paged kv_int8 engine at few lanes warns too (the same check).
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t_serving.PagedBatcher(m["p"], m["cfg"], lanes=lanes, block=BLOCK,
                               kv_int8="prefill", device="cpu")
    assert any("kv_int8" in str(w.message) for w in caught) == warns
    assert CFG_KW["max_len"] % BLOCK == 0

"""The port's disaggregated prefill -> decode against the JAX package
(CPU, f32).

Mirrors ``tests/test_disagg.py``.  Codec half: the port's wire format
round-trips bit-exactly (int8 and bf16 leaves included), refuses
anything torn, and writes the reference's bytes.  Engine half: the
port's ``export_blocks`` / ``import_blocks`` adopt by page-table splice
with the reference's allocator refcounts, and a shipment built by
either package adopts into the other's slab.  Fleet half: a role-split
port ``Router`` serves tokens equal (no tolerance) to the JAX package's
lone engine (greedy, chunked) and to the port's own solo engine
(seeded: JAX's PRNG cannot be matched; ``kv_int8``: the same-config
solo engine, as the reference holds it), skips transfers for warm
stems, falls back on hop failure, streams across the hop, and renders
the hop in the request waterfall.
"""

import time
import warnings

import numpy as np
import pytest
import torch

from distkeras_tpu.serving import disagg as j_disagg
from distkeras_tpu_torch import obs
from distkeras_tpu_torch.obs.report import request_waterfall
from distkeras_tpu_torch.obs.trace import read_trace
from distkeras_tpu_torch.serving import (EngineEndpoint, HttpReplica,
                                         InProcessReplica, PagedBatcher,
                                         Router, discover_replicas)
from distkeras_tpu_torch.serving.disagg import (BlockShipment,
                                                decode_shipment,
                                                encode_shipment,
                                                leaf_dtype_names)
from tests.torch_fleet import BLOCK, count, jpaged, model, run
from tests.torch_fleet import paged as _paged


@pytest.fixture(scope="module")
def m():
    return model()


def paged(m, **kw):
    kw.setdefault("n_blocks", 16)
    return _paged(m, **kw)


def cold(rng, blocks=2, tail=1):
    return rng.integers(0, 64, (blocks * BLOCK + tail,)).astype(np.int32)


def toy_shipment(cls=BlockShipment, n=2):
    rng = np.random.default_rng(7)
    blocks, hashes = [], []
    for k in range(n):
        blocks.append((
            rng.normal(size=(2, 1, BLOCK, 2, 4)).astype(np.float32),
            rng.integers(-127, 128, (2, 1, BLOCK, 2, 4)).astype(np.int8),
            rng.normal(size=(2, 1, BLOCK, 2, 1)).astype(np.float32)))
        hashes.append(bytes([k]) * 16)
    return cls(block=BLOCK, hashes=tuple(hashes), blocks=tuple(blocks))


# ----------------------------------------------------------- the codec


def test_codec_roundtrip_bit_exact_including_int8():
    ship = toy_shipment()
    data = encode_shipment(ship)
    assert data == j_disagg.encode_shipment(toy_shipment(
        j_disagg.BlockShipment))
    back = decode_shipment(data)
    assert back.block == ship.block and back.hashes == ship.hashes
    assert back.span == 2 * BLOCK and len(back) == 2
    assert back.nbytes == ship.nbytes
    for got, want in zip(back.blocks, ship.blocks):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_codec_rejects_malformed():
    ship = toy_shipment()
    data = encode_shipment(ship)
    with pytest.raises(ValueError, match="truncated"):
        decode_shipment(data[:3])
    with pytest.raises(ValueError, match="truncated"):
        decode_shipment(data[:40])
    with pytest.raises(ValueError, match="magic"):
        decode_shipment(data.replace(b"dkt-blocks", b"dkt-bogus!"))
    with pytest.raises(ValueError, match="payload"):
        decode_shipment(data[:-8])
    with pytest.raises(ValueError, match="empty"):
        encode_shipment(BlockShipment(block=BLOCK, hashes=(), blocks=()))
    with pytest.raises(ValueError, match="digests"):
        BlockShipment(block=BLOCK, hashes=(b"x",), blocks=())
    ragged = BlockShipment(block=BLOCK, hashes=ship.hashes,
                           blocks=(ship.blocks[0], ship.blocks[1][:2]))
    with pytest.raises(ValueError, match="ragged"):
        encode_shipment(ragged)


def test_bf16_blocks_ride_as_raw_words(m, rng):
    """A bf16 slab ships its raw 16-bit words named ``"bfloat16"`` (the
    reference's header and bytes), decodes without ml_dtypes, and
    splices back bit for bit; the reference decodes the same bytes into
    its own bfloat16 arrays."""
    import dataclasses

    cfg = dataclasses.replace(m["cfg"], dtype="bfloat16")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        src = PagedBatcher(m["p"], cfg, lanes=2, block=BLOCK,
                           prompt_buckets=(8,), device="cpu")
        dst = PagedBatcher(m["p"], cfg, lanes=2, block=BLOCK,
                           prompt_buckets=(8,), device="cpu")
    ship = src.export_blocks(cold(rng, tail=0))
    assert leaf_dtype_names(ship) == ("bfloat16", "bfloat16")
    data = encode_shipment(ship)
    assert b'"dtype": "bfloat16"' in data
    ref = j_disagg.decode_shipment(data)
    assert ref.blocks[0][0].dtype.name == "bfloat16"
    assert j_disagg.encode_shipment(ref) == data
    out = dst.import_blocks(decode_shipment(data))
    assert out["blocks"] == 2
    bids = list(dst.pinned.blocks_of(out["prefix_id"]))
    sids = [src.allocator.share_by_hash(h) for h in ship.hashes]
    for name in src.cache:
        assert torch.equal(dst.cache[name][:, bids],
                           src.cache[name][:, sids])


# ------------------------------------------------- export/import/adopt


def test_export_import_refcounts_and_admission_hit(m, rng):
    src, dst = paged(m), paged(m)
    prompt = cold(rng, blocks=2, tail=1)
    with obs.session() as sess:
        ship = src.export_blocks(prompt)
        assert count(sess, "serving.disagg.blocks_out") == 2
        assert count(sess, "serving.disagg.bytes_out") == ship.nbytes
    assert len(ship) == 2 and ship.block == BLOCK
    assert ship.span == 16 and ship.nbytes > 0
    # The reference's export of the same prompt: the same digests and
    # leaves, to f32 rounding (two packages, two GEMM orders).
    jship = jpaged(m, n_blocks=16).export_blocks(prompt)
    assert ship.hashes == jship.hashes
    for got, want in zip(ship.blocks, jship.blocks):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    back = decode_shipment(encode_shipment(ship))
    for got, want in zip(back.blocks, ship.blocks):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    base_used = dst.allocator.stats()["used"]
    with obs.session() as sess:
        imported = dst.import_blocks(ship)
        again = dst.import_blocks(ship)
        assert count(sess, "serving.disagg.blocks_in") == 4
        assert count(sess, "serving.disagg.adopt_hits") == 2
        assert count(sess, "serving.disagg.bytes_in") == 2 * ship.nbytes
    assert imported["blocks"] == 2 and imported["hits"] == 0
    assert again["hits"] == 2
    assert dst.allocator.stats()["used"] == base_used + 2
    assert set(ship.hexes()) <= set(dst.residency()["stem_hashes"])

    rid = dst.enqueue(prompt, 5)
    while dst.poll(rid) is None:
        dst.step()
    res = dst.take(rid)
    assert dst.stem_hit_blocks >= 2
    np.testing.assert_array_equal(res.tokens, m["jsolo"](prompt, 5))
    dst.unpin_prefix(imported["prefix_id"])
    dst.unpin_prefix(again["prefix_id"])
    assert dst.allocator.stats()["used"] == base_used


def test_import_backpressure_rolls_back_every_reference(m, rng):
    src = paged(m)
    small = paged(m, n_blocks=9)                 # capacity 8
    for _ in range(2):                           # pin 6 of 8 blocks
        small.pin_prefix(rng.integers(0, 64, (24,)).astype(np.int32))
    used = small.allocator.stats()["used"]
    assert used == 6
    ship = src.export_blocks(cold(rng, blocks=3, tail=0))
    with obs.session() as sess:
        assert small.import_blocks(ship) is None     # 3 > 2 free
        assert count(sess, "serving.disagg.import_declines") == 1
    assert small.allocator.stats()["used"] == used   # nothing leaked
    with pytest.raises(ValueError, match="paged at"):
        small.import_blocks(BlockShipment(block=4, hashes=ship.hashes,
                                          blocks=ship.blocks))
    with pytest.raises(ValueError, match="empty"):
        small.import_blocks(BlockShipment(block=BLOCK, hashes=(),
                                          blocks=()))
    # A cold block whose leaves do not fit the slab (the declined
    # import's blocks stay hash-resident, so use a fresh stem).
    fresh = src.export_blocks(cold(rng, blocks=1, tail=0))
    with pytest.raises(ValueError, match="leaves"):
        small.import_blocks(BlockShipment(
            block=BLOCK, hashes=fresh.hashes,
            blocks=(fresh.blocks[0][:1],)))
    wide = tuple(np.concatenate([a, a], axis=-1) for a in fresh.blocks[0])
    with pytest.raises(ValueError, match="does not match"):
        small.import_blocks(BlockShipment(block=BLOCK, hashes=fresh.hashes,
                                          blocks=(wide,)))
    assert small.allocator.stats()["used"] == used


def test_shipments_cross_packages(m, rng):
    """A reference shipment adopts into a port slab and a port shipment
    into a reference slab, and each side then serves the JAX lone
    engine's tokens from the adopted run."""
    prompt = cold(rng, blocks=2, tail=1)
    jsrc, jdst = jpaged(m, n_blocks=16), jpaged(m, n_blocks=16)
    tsrc, tdst = paged(m), paged(m)
    j2t = tdst.import_blocks(decode_shipment(j_disagg.encode_shipment(
        jsrc.export_blocks(prompt))))
    t2j = jdst.import_blocks(j_disagg.decode_shipment(encode_shipment(
        tsrc.export_blocks(prompt))))
    assert j2t["blocks"] == t2j["blocks"] == 2
    for eng in (tdst, jdst):
        rid = eng.enqueue(prompt, 5)
        while eng.poll(rid) is None:
            eng.step()
        assert eng.stem_hit_blocks >= 2
        np.testing.assert_array_equal(eng.take(rid).tokens,
                                      m["jsolo"](prompt, 5))


# --------------------------------------------------- the 2-stage fleet


class _NoDecode(InProcessReplica):
    def enqueue(self, *a, **kw):
        raise AssertionError("decode request admitted on the prefill "
                             "replica")


def fleet(m, prefill_cls=InProcessReplica, **kw):
    pre, dec = paged(m, **kw), paged(m, **kw)
    router = Router([prefill_cls("pre", pre, role="prefill"),
                     InProcessReplica("dec", dec, role="decode")])
    router.refresh_residency()
    return router, pre, dec


def test_disagg_parity_greedy_and_role_exclusivity(m, rng):
    router, _pre, dec = fleet(m, prefill_cls=_NoDecode)
    prompts = [cold(rng, blocks=2, tail=t) for t in (1, 2, 3)]
    with obs.session() as sess:
        rids = [router.enqueue(p, 5) for p in prompts]
        results = run(router, rids)
        assert count(sess, "router.disagg_requests") == 3
        assert count(sess, "router.disagg_fallbacks") == 0
    for res, p in zip(results, prompts):
        np.testing.assert_array_equal(res.tokens, m["jsolo"](p, 5))
    assert dec.stem_hit_blocks >= 6
    router.pump()
    assert dec.residency()["prefix_ids"] == []
    assert dec.allocator.stats()["used"] == 0


def test_disagg_parity_seeded_sampling(m, rng):
    kw = dict(temperature=0.7, top_k=16)
    router, _pre, _dec = fleet(m, **kw)
    prompts = [cold(rng, blocks=2, tail=t) for t in (1, 2)]
    seeds = [11, 12]
    rids = [router.enqueue(p, 5, seed=s) for p, s in zip(prompts, seeds)]
    for res, p, s in zip(run(router, rids), prompts, seeds):
        np.testing.assert_array_equal(res.tokens,
                                      m["tsolo"](p, 5, seed=s, **kw))


def test_disagg_parity_chunked_prefill(m, rng):
    router, _pre, _dec = fleet(m, prefill_chunk=8)
    prompt = cold(rng, blocks=2, tail=2)
    with obs.session() as sess:
        (res,) = run(router, [router.enqueue(prompt, 5)])
        assert count(sess, "router.disagg_requests") == 1
    np.testing.assert_array_equal(res.tokens, m["jsolo"](prompt, 5))


@pytest.mark.parametrize("kv_int8", [True, "prefill"])
def test_disagg_parity_kv_int8(m, rng, kv_int8):
    """int8 blocks ride the wire as they are: a disaggregated request
    equals the same-config solo engine that pins the stem first (the
    prefill replica's export runs ``pin_prefix``)."""
    prompt = cold(rng, blocks=2, tail=1)
    solo = paged(m, kv_int8=kv_int8)
    pid = solo.pin_prefix(prompt[:-1])
    rid = solo.enqueue(prompt, 5)
    while solo.poll(rid) is None:
        solo.step()
    ref = solo.take(rid).tokens
    solo.unpin_prefix(pid)
    router, _pre, _dec = fleet(m, kv_int8=kv_int8)
    with obs.session() as sess:
        (res,) = run(router, [router.enqueue(prompt, 5)])
        assert count(sess, "router.disagg_requests") == 1
    np.testing.assert_array_equal(res.tokens, ref)
    if kv_int8 is True:     # decode-built int8: the JAX engine's tokens
        np.testing.assert_array_equal(res.tokens,
                                      m["jsolo"](prompt, 5, kv_int8=True))


def test_warm_stems_skip_the_transfer(m, rng):
    router, _pre, _dec = fleet(m)
    head = cold(rng, blocks=2, tail=0)
    with obs.session() as sess:
        run(router, [router.enqueue(np.concatenate([head, head[:1]]), 5)])
        assert count(sess, "router.disagg_requests") == 1
        p2 = np.concatenate([head, head[1:2]])
        (r2,) = run(router, [router.enqueue(p2, 5)])
        assert count(sess, "router.disagg_requests") == 1
        assert count(sess, "router.disagg_warm_skips") >= 1
    np.testing.assert_array_equal(r2.tokens, m["jsolo"](p2, 5))


def test_prefill_failure_falls_back_never_errors(m, rng, monkeypatch):
    router, pre, _dec = fleet(m)

    def boom(tokens):
        raise RuntimeError("prefill replica died mid-build")

    monkeypatch.setattr(pre, "export_blocks", boom)
    prompt = cold(rng, blocks=2, tail=1)
    with obs.session() as sess:
        (res,) = run(router, [router.enqueue(prompt, 5)])
        assert count(sess, "router.disagg_fallbacks") == 1
        assert count(sess, "router.disagg_requests") == 0
    assert res.ok
    np.testing.assert_array_equal(res.tokens, m["jsolo"](prompt, 5))


# ------------------------------------------------------------ streaming


def test_stream_first_token_before_terminal(m, rng):
    router = Router([InProcessReplica("r0", paged(m))])
    prompt = rng.integers(0, 64, (6,)).astype(np.int32)
    rid = router.enqueue(prompt, 8)
    gen = router.stream(rid)
    first = next(gen)
    assert router.poll(rid) is None
    tokens = [first] + list(gen)
    res = router.take(rid)
    assert res.ok and tokens == list(res.generated)
    np.testing.assert_array_equal(res.tokens, m["jsolo"](prompt, 8))


def test_stream_across_the_disagg_hop(m, rng):
    router, _pre, _dec = fleet(m)
    prompt = cold(rng, blocks=2, tail=1)
    with obs.session() as sess:
        rid = router.enqueue(prompt, 6)
        assert count(sess, "router.disagg_requests") == 1
        tokens = list(router.stream(rid))
    assert tokens == list(m["jsolo"](prompt, 6)[prompt.size:])
    assert router.take(rid).ok


def test_waterfall_renders_the_block_transfer_hop(m, rng, tmp_path):
    trace = str(tmp_path / "disagg.jsonl")
    router, _pre, _dec = fleet(m)
    prompt = cold(rng, blocks=2, tail=1)
    with obs.session(trace_path=trace):
        rid = router.enqueue(prompt, 5)
        assert router.drain(rid).ok
    wf = request_waterfall(read_trace(trace), rid)
    assert wf["found"] and wf["status"] == "ok"
    names = [s["name"] for s in wf["stages"]]
    assert "router.prefill" in names
    assert "router.block_transfer" in names
    assert "serving.finish" in names
    hop = next(s for s in wf["stages"]
               if s["name"] == "router.block_transfer")
    assert hop["src"] == "pre" and hop["dst"] == "dec"
    assert hop["blocks"] == 2 and hop["bytes"] > 0


# ------------------------------------------------------- the endpoints


def test_endpoint_disagg_routes_and_discovery(m, rng, tmp_path):
    pre_eng, dec_eng = paged(m), paged(m)
    pre_ep = EngineEndpoint(pre_eng, host_id=0, role="prefill",
                            coord_dir=str(tmp_path))
    dec_ep = EngineEndpoint(dec_eng, host_id=1, role="decode",
                            coord_dir=str(tmp_path))
    pre_ep.start(step=True)
    dec_ep.start(step=True)
    try:
        found = {r.name: r for r in discover_replicas(str(tmp_path))}
        assert found["host0"].role == "prefill"
        assert found["host1"].role == "decode"
        pre = HttpReplica("pre", pre_ep.addr, role="prefill")
        dec = HttpReplica("dec", dec_ep.addr, role="decode")
        prompt = cold(rng, blocks=2, tail=1)
        ship = pre.prefill_blocks(prompt)
        assert len(ship) == 2 and ship.block == BLOCK
        imported = dec.import_blocks(ship)
        assert imported["blocks"] == 2 and imported["hits"] == 0
        dec.unpin(int(imported["prefix_id"]))
        assert dec.partial(123456789) is None
        router = Router([pre, dec], health_interval=0.0)
        router.refresh_residency()
        rid = router.enqueue(prompt, 5)
        deadline = time.monotonic() + 60.0
        while router.poll(rid) is None:
            router.pump()
            assert time.monotonic() < deadline
            time.sleep(0.05)
        res = router.take(rid)
        assert res.ok and len(res.generated) == 5
        np.testing.assert_array_equal(res.tokens, m["jsolo"](prompt, 5))
        assert dec_eng.stem_hit_blocks >= 2
    finally:
        pre_ep.stop()
        dec_ep.stop()
    assert discover_replicas(str(tmp_path)) == []

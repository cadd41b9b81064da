"""The port's serving fast path against the JAX package: chunked
prefill, the PrefixPool, elastic tiers and admission control (enqueue /
poll, QueueFull, deadlines, shutdown), the obs trace of admission, the
TraceReplay load driver, and a per-request-sampling schedule run through
the JAX engine and the port's.

Greedy tokens must equal the JAX package's at f32 (token equality);
sampled lanes equal the port's own solo ``generate(seed=...)``.
"""

import jax
import numpy as np
import pytest

from distkeras_tpu.models import generate as jgen
from distkeras_tpu.models import transformer as jtfm
from distkeras_tpu.serving import ContinuousBatcher as JaxBatcher
from distkeras_tpu.serving.traffic import TraceReplay as JaxTraceReplay
from distkeras_tpu_torch import obs
from distkeras_tpu_torch.models import generate as tgen
from distkeras_tpu_torch.models import transformer as ttfm
from distkeras_tpu_torch.obs.trace import read_trace
from distkeras_tpu_torch.serving import (ContinuousBatcher, PrefixPool,
                                         QueueFull, EngineClosed,
                                         TraceReplay)
from distkeras_tpu_torch.utils.serialization import params_from_numpy

KW = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
          max_len=64, rope=True)


@pytest.fixture(scope="module")
def m():
    jcfg = jtfm.TransformerConfig(**KW)
    jp = jax.tree.map(np.asarray, jtfm.init_params(jax.random.key(0), jcfg))
    tcfg = ttfm.TransformerConfig(**KW)
    tp = params_from_numpy(jp, "cpu")
    memo = {}

    def jsolo(prompt, n, prefix=None):
        """JAX solo greedy generate (past a JAX-prefilled ``prefix``),
        memoized per module."""
        key = (tuple(int(t) for t in prompt), n,
               None if prefix is None else tuple(int(t) for t in prefix))
        if key not in memo:
            kw = {}
            if prefix is not None:
                cache, _ = jgen.prefill(jp, np.asarray(prefix, np.int32)[None],
                                        jcfg, last_logits=False)
                kw["prompt_cache"] = (cache, len(prefix))
            memo[key] = np.asarray(jgen.generate(
                jp, np.asarray(prompt, np.int32)[None], jcfg, n, **kw))[0]
        return memo[key]

    return dict(jcfg=jcfg, jp=jp, cfg=tcfg, p=tp, jsolo=jsolo)


def engine(m, **kw):
    return ContinuousBatcher(m["p"], m["cfg"], device="cpu", **kw)


def segment(m, prefix):
    cache, _ = tgen.prefill(m["p"], np.asarray(prefix)[None], m["cfg"],
                            last_logits=False, device="cpu")
    return cache


def tsolo(m, prompt, n, **kw):
    return tgen.generate(m["p"], np.asarray(prompt)[None], m["cfg"], n,
                         device="cpu", **kw)[0].numpy()


def run_to_done(eng, lane):
    while lane in eng.running():
        eng.step()
    return eng.drain(lane)


# ------------------------------------------------------ chunked prefill


def test_chunked_prefill_parity_and_interleave(m, rng):
    """A prompt longer than prefill_chunk admits one chunk per step; the
    other lane emits one token on EVERY step of it; both match JAX, and
    the chunked lane's tokens equal monolithic admission's."""
    eng = engine(m, lanes=2, prefill_chunk=8, prompt_buckets=(8, 16))
    ps = rng.integers(0, 64, (4,))
    pl = rng.integers(0, 64, (30,))           # warm 29: 3 chunks + tail
    ls = eng.submit(ps, 24)
    for _ in range(2):
        eng.step()
    ll = eng.submit(pl, 8)
    assert ll in eng.running() and len(eng._lane_state[ll].chunks) == 3
    with pytest.raises(ValueError, match="still decoding"):
        eng.drain(ll)
    short = []
    while ll in eng.running():
        short.append(len(eng.step().get(ls, [])))
    assert short and all(n == 1 for n in short)
    out_l = eng.drain(ll)
    np.testing.assert_array_equal(out_l, m["jsolo"](pl, 8))
    np.testing.assert_array_equal(run_to_done(eng, ls), m["jsolo"](ps, 24))
    mono = engine(m, lanes=1, prompt_buckets=(8, 16))
    np.testing.assert_array_equal(run_to_done(mono, mono.submit(pl, 8)),
                                  out_l)


@pytest.mark.parametrize("chunk", [8, 16])
def test_chunked_prefill_sampled_and_tail_overlap(m, rng, chunk):
    """Chunked admission writes exactly the monolithic K/V: sampled
    requests replay their solo streams through awkward tails (warm %
    chunk != 0 takes the backed-up overlap tail)."""
    eng = engine(m, lanes=1, prefill_chunk=chunk, temperature=0.8, top_k=8,
                 prompt_buckets=(8,))
    for plen in (chunk + 2, 3 * chunk - 1):
        p = rng.integers(0, 64, (plen,))
        np.testing.assert_array_equal(
            run_to_done(eng, eng.submit(p, 6, seed=plen)),
            tsolo(m, p, 6, temperature=0.8, top_k=8, seed=plen))


def test_chunked_prefill_validation(m):
    with pytest.raises(ValueError, match="prefill_chunk"):
        engine(m, lanes=1, prefill_chunk=0)
    with pytest.raises(ValueError, match="prefill_chunk"):
        engine(m, lanes=1, prefill_chunk=100)


def test_chunked_lane_evicted_mid_admission(m, rng):
    """A deadline expiring while a lane still admits evicts it: a
    structured timeout, the chunk queue drained, and the lane reusable
    with exact parity."""
    t = {"now": 0.0}
    eng = engine(m, lanes=1, prefill_chunk=8, prompt_buckets=(8,),
                 clock=lambda: t["now"])
    eng.submit(rng.integers(0, 64, (30,)), 8, ttl=5.0)
    rid = eng.last_request_id
    assert eng._admitting
    t["now"] = 10.0
    eng.step()
    res = eng.take(rid)
    assert res.timed_out and not eng._admitting
    p2 = rng.integers(0, 64, (5,))
    np.testing.assert_array_equal(run_to_done(eng, eng.submit(p2, 6)),
                                  m["jsolo"](p2, 6))


# ---------------------------------------------------------- PrefixPool


def test_prefix_pool_refcount_lru_and_errors(m, rng):
    pool = PrefixPool(m["cfg"], slots=2, device="cpu")
    segs = {name: segment(m, rng.integers(0, 64, (n,)))
            for name, n in (("a", 4), ("b", 6), ("c", 5))}
    ida = pool.put(segs["a"], 4)
    idb = pool.put(segs["b"], 6)
    assert len(pool) == 2 and pool.length_of(ida) == 4
    pool.acquire(ida)
    pool.release(ida)
    idc = pool.put(segs["c"], 5)     # b is least recent and unpinned
    assert idb not in pool and ida in pool and idc in pool
    with pytest.raises(KeyError, match="prefix_id"):
        pool.length_of(idb)
    pool.acquire(ida)
    pool.acquire(idc)
    with pytest.raises(RuntimeError, match="referenced"):
        pool.put(segs["b"], 6)
    pool.release(ida)
    pool.put(segs["b"], 6)
    assert ida not in pool and idc in pool
    with pytest.raises(ValueError, match="spec"):
        pool.put({k: v[:1] for k, v in segs["a"].items()}, 4)
    with pytest.raises(ValueError, match="length"):
        pool.put(segs["a"], 0)
    q8 = PrefixPool(m["cfg"], slots=1, kv_int8=True, device="cpu")
    with pytest.raises(ValueError, match="spec"):
        q8.put(segs["a"], 4)
    with pytest.raises(ValueError, match="full-precision"):
        PrefixPool(m["cfg"], slots=1, kv_int8=True, draft_cfg=m["cfg"],
                   device="cpu")


def test_prefix_pool_parity_with_prompt_cache_and_zero_prefix_work(
        m, rng, tmp_path):
    """Two pooled prefixes on one engine: each request equals JAX's
    generate(tail, prompt_cache=(segment, P)) and the port's own; the
    admission span shows only the tail was prefilled (bucket 8, where
    prefix + tail would need the 64 bucket); a plain request still
    matches; a stale or pool-less prefix_id fails loudly."""
    pool = PrefixPool(m["cfg"], slots=2, device="cpu")
    pref_a = rng.integers(0, 64, (20,))
    pref_b = rng.integers(0, 64, (6,))
    ca, cb = segment(m, pref_a), segment(m, pref_b)
    ida, idb = pool.put(ca, 20), pool.put(cb, 6)
    eng = engine(m, lanes=2, prefix_pool=pool, prompt_buckets=(8,))
    tail = rng.integers(0, 64, (4,))
    path = str(tmp_path / "admit.jsonl")
    with obs.session(trace_path=path):
        la = eng.submit(tail, 6, prefix_id=ida)
        lb = eng.submit(tail, 6, prefix_id=idb)
        assert pool.refs_of(ida) == pool.refs_of(idb) == 1
        oa, ob = run_to_done(eng, la), run_to_done(eng, lb)
    np.testing.assert_array_equal(oa, m["jsolo"](tail, 6, prefix=pref_a))
    np.testing.assert_array_equal(ob, m["jsolo"](tail, 6, prefix=pref_b))
    np.testing.assert_array_equal(oa, tsolo(m, tail, 6,
                                            prompt_cache=(ca, 20)))
    assert pool.refs_of(ida) == 0
    admits = [r for r in read_trace(path)
              if r.get("name") == "serving.admit"]
    assert len(admits) == 2
    assert all(r["fields"]["bucket"] == 8 for r in admits)
    np.testing.assert_array_equal(run_to_done(eng, eng.submit(tail, 6)),
                                  m["jsolo"](tail, 6))
    with pytest.raises(ValueError, match="needs"):
        engine(m, lanes=1).submit(tail, 4, prefix_id=ida)


def test_prefix_pin_taken_first_and_released_on_decline(m, rng):
    pool = PrefixPool(m["cfg"], slots=1, device="cpu")
    cache = segment(m, rng.integers(0, 64, (6,)))
    pid = pool.put(cache, 6)
    eng = engine(m, lanes=1, prefix_pool=pool, prompt_buckets=(8,))
    tail = rng.integers(0, 64, (4,))
    with pytest.raises(ValueError, match="exceeds"):
        eng.submit(tail, 100, prefix_id=pid)
    assert pool.refs_of(pid) == 0
    lane = eng.submit(tail, 5, prefix_id=pid)
    assert pool.refs_of(pid) == 1
    assert eng.submit(tail, 5, prefix_id=pid) is None
    assert pool.refs_of(pid) == 1
    with pytest.raises(RuntimeError, match="referenced"):
        pool.put(cache, 6)
    run_to_done(eng, lane)
    assert pool.refs_of(pid) == 0
    pool.put(cache, 6)


def test_prefix_pool_chunked_one_token_and_sampled(m, rng):
    """The pool composes with chunked prefill (a long tail past a pooled
    prefix), the 1-token reseed path and sampled lanes."""
    pool = PrefixPool(m["cfg"], slots=1, device="cpu")
    pref = rng.integers(0, 64, (6,))
    cache = segment(m, pref)
    pid = pool.put(cache, 6)
    eng = engine(m, lanes=1, prefix_pool=pool, prefill_chunk=8,
                 prompt_buckets=(8,), temperature=0.8,
                 per_request_sampling=True)
    for tail_len in (25, 1):
        tail = rng.integers(0, 64, (tail_len,))
        np.testing.assert_array_equal(
            run_to_done(eng, eng.submit(tail, 6, temperature=0.0,
                                        prefix_id=pid)),
            m["jsolo"](tail, 6, prefix=pref))
    tail = rng.integers(0, 64, (3,))
    np.testing.assert_array_equal(
        run_to_done(eng, eng.submit(tail, 5, seed=17, prefix_id=pid)),
        tsolo(m, tail, 5, prompt_cache=(cache, 6), temperature=0.8,
              seed=17))


def test_prefix_pool_validation(m):
    draft_cfg = ttfm.TransformerConfig(**dict(KW, d_model=16, n_layers=1,
                                              d_ff=32))
    with pytest.raises(ValueError, match="plain PrefixPool"):
        engine(m, prefix_pool=PrefixPool(m["cfg"], slots=1,
                                         draft_cfg=draft_cfg, device="cpu"))
    with pytest.raises(ValueError, match="different config"):
        engine(m, prefix_pool=PrefixPool(draft_cfg, slots=1, device="cpu"))
    with pytest.raises(ValueError, match="full-cache"):
        PrefixPool(ttfm.TransformerConfig(**dict(KW, max_len=12,
                                                 attention_window=5)),
                   slots=1, device="cpu")


# ------------------------------------------ elastic tiers and admission


def test_elastic_tiers_scale_up_under_backpressure_and_back_down(m, rng):
    """Sustained overload steps the tier up (scale_up_after=1: no
    QueueFull, the overflow is absorbed by the resize), every request
    completes with JAX parity through the compaction, and an idle engine
    steps back down; tier moves are counted by obs."""
    prompts = [rng.integers(0, 64, (p,)) for p in (3, 5, 4, 6, 3)]
    with obs.session() as sess:
        eng = engine(m, lane_tiers=(1, 2, 4), max_queue=1, scale_up_after=1,
                     scale_down_after=2, prompt_buckets=(8,))
        assert eng.lanes == 1
        rids = [eng.enqueue(p, 6) for p in prompts]
        assert eng.lanes == 4
        assert tuple(eng.cache["k"].shape[1:2]) == (4,)
        while any(eng.poll(r) is None for r in rids):
            eng.step()
        for _ in range(6):
            eng.step()
        assert eng.lanes == 1 and eng.cache["k"].shape[1] == 1
        snap = sess.registry.snapshot()
    for rid, p in zip(rids, prompts):
        res = eng.take(rid)
        assert res.ok
        np.testing.assert_array_equal(res.tokens, m["jsolo"](p, 6))
    resizes = {tuple(s["labels"].items()): s["value"]
               for s in snap["serving.resizes"]["series"]}
    assert resizes[(("direction", "up"),)] == 2
    assert resizes[(("direction", "down"),)] == 2


def test_elastic_resize_mid_decode_and_contracts(m, rng):
    """A scale-up while a request decodes moves its lane by the device
    gather and keeps its tokens; elastic engines reject bare submit and
    undeclared step windows; the top tier raises QueueFull."""
    eng = engine(m, lane_tiers=(1, 2), max_queue=1, scale_up_after=1,
                 prompt_buckets=(8,), step_windows=(1, 4))
    p = rng.integers(0, 64, (3,))
    with pytest.raises(ValueError, match="enqueue"):
        eng.submit(p, 4)
    first = eng.enqueue(p, 20)
    eng.step(4)                               # decoding in lane 0
    with pytest.raises(ValueError, match="step_windows"):
        eng.step(3)
    more = [eng.enqueue(p, 4), eng.enqueue(p, 4)]   # overflow: 1 -> 2
    assert eng.lanes == 2
    with pytest.raises(QueueFull):
        eng.enqueue(p, 4)
    while any(eng.poll(r) is None for r in [first] + more):
        eng.step()
    np.testing.assert_array_equal(eng.take(first).tokens,
                                  m["jsolo"](p, 20))
    assert all(eng.take(r).ok for r in more)
    with pytest.raises(ValueError, match=">= 2 distinct tiers"):
        engine(m, lane_tiers=(4,), max_queue=1)
    with pytest.raises(ValueError, match="max_queue"):
        engine(m, lane_tiers=(1, 2))
    with pytest.raises(ValueError, match="include 1"):
        engine(m, lane_tiers=(1, 2), max_queue=1, step_windows=(4,))


def test_queue_deadlines_and_shutdown(m, rng):
    """The bounded queue raises QueueFull past max_queue; an expired
    request never takes a lane (structured timeout); a queued request
    admits FIFO when a lane frees; shutdown drains, then cancels what a
    max_steps bound cuts, and later admission raises EngineClosed."""
    t = {"now": 0.0}
    eng = engine(m, lanes=1, max_queue=1, prompt_buckets=(8,),
                 clock=lambda: t["now"])
    p = rng.integers(0, 64, (4,))
    late = eng.enqueue(p, 4, deadline=-1.0)
    assert eng.poll(late).timed_out and eng.free_lanes() == [0]
    a = eng.enqueue(p, 6)
    b = eng.enqueue(p, 3, ttl=100.0)
    with pytest.raises(QueueFull):
        eng.enqueue(p, 3)
    assert eng.queued == 1
    while eng.poll(a) is None:
        eng.step()
    res = eng.shutdown()
    assert res[a].ok and res[b].ok
    np.testing.assert_array_equal(res[b].tokens, m["jsolo"](p, 3))
    with pytest.raises(EngineClosed):
        eng.enqueue(p, 3)
    eng2 = engine(m, lanes=1, max_queue=2, prompt_buckets=(8,))
    rids = [eng2.enqueue(p, 10), eng2.enqueue(p, 10)]
    out = eng2.shutdown(max_steps=2)
    assert out[rids[0]].status == "cancelled"
    assert out[rids[1]].status == "cancelled"
    assert len(out[rids[0]].tokens) == len(p) + 2
    # A mid-decode deadline evicts with the partial transcript.
    eng3 = engine(m, lanes=1, clock=lambda: t["now"], prompt_buckets=(8,))
    eng3.submit(p, 20, ttl=5.0)
    rid = eng3.last_request_id
    eng3.step(2)
    t["now"] = 10.0
    eng3.step()
    res = eng3.take(rid)
    assert res.timed_out and len(res.generated) == 3
    assert eng3.free_lanes() == [0]


# ----------------------------------------------- obs, locks, load driver


def test_obs_session_metrics_and_trace(m, rng, tmp_path):
    """Disabled is the default; a session records the engine's
    counters, latency histograms and spans, and the trace ends with the
    registry snapshot.  The live plane is A10."""
    assert obs.active() is None
    path = str(tmp_path / "run.jsonl")
    with obs.session(trace_path=path) as sess:
        eng = engine(m, lanes=2, prompt_buckets=(8,))
        rid = eng.enqueue(rng.integers(0, 64, (5,)), 4)
        while eng.poll(rid) is None:
            eng.step()
        compact = sess.registry.compact()
    assert compact["serving.tokens"] == 4
    assert compact["serving.requests{status=ok}"] == 1
    assert compact["serving.ttft_s"]["count"] == 1
    recs = read_trace(path)
    assert recs[0]["kind"] == "meta" and recs[-1]["kind"] == "metrics"
    names = {r.get("name") for r in recs}
    assert {"serving.submit", "serving.admit", "serving.step",
            "serving.emit", "serving.finish"} <= names
    # The live telemetry plane is ported: serve_port=0 starts a server
    # on a free port, and disable() stops it.
    sess = obs.enable(serve_port=0)
    assert sess.server.port > 0 and sess.slo is not None
    obs.disable()
    assert obs.active() is None


def test_trace_replay_matches_jax_package(m):
    """The load driver is a pure function of (seed, tick), the same
    schedule and prompts as the JAX package's."""
    for shape in ("diurnal", "spike", "shuffle", "tenant_mix"):
        kw = dict(tenants=(("a", 1.0), ("b", 3.0)), max_new=(2, 9))
        ours, theirs = TraceReplay(shape, 7, **kw), JaxTraceReplay(shape, 7,
                                                                   **kw)
        for tick in (0, 5, 17, 40):
            a, b = ours.requests_at(tick), theirs.requests_at(tick)
            assert [r.__dict__ for r in a] == [r.__dict__ for r in b]
            for r, s in zip(a, b):
                np.testing.assert_array_equal(ours.prompt(r),
                                              theirs.prompt(s))


def test_per_request_fuzz_matches_jax_engine(m, rng):
    """Randomized arrivals x per-request parameters on a
    per_request_sampling engine, run through the JAX engine and the
    port's: greedy requests equal the JAX engine's tokens and JAX's solo
    run; sampled ones equal the port's solo generate(seed=)."""
    reqs = []
    for i in range(8):
        p = int(rng.integers(1, 10))
        prompt = rng.integers(0, 64, (p,)).astype(np.int32)
        n = int(rng.integers(1, 32 - p))
        kind = i % 4
        samp = [{}, dict(temperature=0.8),
                dict(temperature=1.1, top_p=0.85, eos_token=9),
                dict(temperature=0.6, min_p=0.25)][kind]
        reqs.append((prompt, n, samp))
    windows = [int(w) for w in rng.integers(1, 4, 64)]

    def drive(eng, key_kw):
        pending, lane_of, outs, step = list(range(len(reqs))), {}, {}, 0
        while len(outs) < len(reqs):
            while pending and eng.free_lanes():
                rid = pending.pop(0)
                prompt, n, samp = reqs[rid]
                kw = dict(samp, **key_kw(rid)) if samp else {}
                lane_of[eng.submit(prompt, n, **kw)] = rid
            eng.step(windows[step % len(windows)])
            step += 1
            for lane in list(lane_of):
                if lane not in eng.running():
                    outs[lane_of.pop(lane)] = eng.drain(lane)
        return outs

    ours = drive(engine(m, lanes=3, per_request_sampling=True),
                 lambda rid: {"seed": 100 + rid})
    theirs = drive(JaxBatcher(m["jp"], m["jcfg"], lanes=3,
                              per_request_sampling=True),
                   lambda rid: {"key": jax.random.key(100 + rid)})
    for rid, (prompt, n, samp) in enumerate(reqs):
        if not samp:
            np.testing.assert_array_equal(ours[rid], theirs[rid])
            np.testing.assert_array_equal(ours[rid], m["jsolo"](prompt, n))
            continue
        ref = tsolo(m, prompt, n, seed=100 + rid, **samp)
        out = ours[rid]
        np.testing.assert_array_equal(out, ref[:len(out)],
                                      err_msg=f"request {rid}")
        if len(out) < len(ref):
            eos = samp["eos_token"]
            assert out[-1] == eos and (ref[len(out):] == eos).all()


def test_enqueue_from_a_thread_while_stepping(m, rng):
    """enqueue from another thread while the engine steps (scale-ups
    included): every request reaches a terminal result with its solo
    tokens, and the port's lock sanitizer (on under this suite) records
    no lock-order violation."""
    import threading

    from distkeras_tpu_torch.utils import locks

    eng = engine(m, lane_tiers=(1, 2, 4), max_queue=2, scale_up_after=1,
                 prompt_buckets=(8,))
    prompts = [rng.integers(0, 64, (4,)) for _ in range(6)]
    rids = []

    def client():
        for p in prompts:
            while True:
                try:
                    rids.append(eng.enqueue(p, 5))
                    break
                except QueueFull:
                    pass

    th = threading.Thread(target=client)
    th.start()
    while th.is_alive() or any(eng.poll(r) is None for r in rids):
        eng.step()
    th.join(timeout=10)
    assert not th.is_alive(), "the client thread never finished"
    assert len(rids) == 6
    for rid, p in zip(rids, prompts):
        res = eng.take(rid)
        np.testing.assert_array_equal(res.tokens, tsolo(m, p, 5))
    assert locks.violations() == []

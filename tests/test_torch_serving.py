"""The port's ContinuousBatcher against the JAX package.

Every request the port's engine serves must emit exactly the tokens of
the JAX package's solo greedy ``generate`` at f32 (token equality, no
tolerance), under staggered admission, lane reuse, eos, rolling ring
lanes and shared prefixes.  Sampled lanes cannot match JAX's PRNG, so
each is held to the port's own solo ``generate(seed=...)`` (token
equality).  JAX transcripts are computed once per module (a memo); one
JAX engine runs the fuzz schedule for a direct engine-to-engine check.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu.models import generate as jgen
from distkeras_tpu.models import transformer as jtfm
from distkeras_tpu.serving import ContinuousBatcher as JaxBatcher
from distkeras_tpu_torch.models import generate as tgen
from distkeras_tpu_torch.models import transformer as ttfm
from distkeras_tpu_torch.serving import ContinuousBatcher
from distkeras_tpu_torch.utils.serialization import params_from_numpy

# The kv_int8 engines here run at few lanes by design; the
# construction advisory they earn is tested in
# tests/test_torch_fleet_contract.py.
pytestmark = pytest.mark.filterwarnings(
    "ignore:kv_int8=True with:RuntimeWarning")

KW = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
          max_len=32, rope=True)

ROLL_KW = dict(KW, max_len=12, attention_window=5)


def _models(kw, seed):
    jcfg = jtfm.TransformerConfig(**kw)
    jp = jax.tree.map(np.asarray, jtfm.init_params(jax.random.key(seed),
                                                   jcfg))
    return jcfg, jp, ttfm.TransformerConfig(**kw), params_from_numpy(jp,
                                                                     "cpu")


@pytest.fixture(scope="module")
def m():
    jcfg, jp, tcfg, tp = _models(KW, 0)
    memo = {}

    def jsolo(prompt, n, **kw):
        """JAX solo greedy generate, memoized per module."""
        key = (tuple(int(t) for t in prompt), n, tuple(sorted(kw.items())))
        if key not in memo:
            memo[key] = np.asarray(jgen.generate(
                jp, np.asarray(prompt, np.int32)[None], jcfg, n, **kw))[0]
        return memo[key]

    return dict(jcfg=jcfg, jp=jp, cfg=tcfg, p=tp, jsolo=jsolo)


@pytest.fixture(scope="module")
def roll():
    jcfg, jp, tcfg, tp = _models(ROLL_KW, 3)
    return dict(jcfg=jcfg, jp=jp, cfg=tcfg, p=tp)


def engine(m, **kw):
    return ContinuousBatcher(m["p"], m["cfg"], device="cpu", **kw)


def tsolo(m, prompt, n, **kw):
    return tgen.generate(m["p"], np.asarray(prompt)[None], m["cfg"], n,
                         device="cpu", **kw)[0].numpy()


def run_to_done(eng, lane):
    while lane in eng.running():
        eng.step()
    return eng.drain(lane)


def assert_eos_prefix(out, ref, eos):
    """The engine stops at eos; solo generate sticky-fills to length."""
    np.testing.assert_array_equal(out, ref[:len(out)])
    if len(out) < len(ref):
        assert out[-1] == eos and (ref[len(out):] == eos).all()


def test_single_request_matches_jax(m, rng):
    eng = engine(m, lanes=4)
    prompt = rng.integers(0, 64, (5,))
    out = run_to_done(eng, eng.submit(prompt, 8))
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, m["jsolo"](prompt, 8))


def test_staggered_admission_and_lane_reuse_after_longer_occupant(m, rng):
    """Requests admitted mid-flight, and into a lane whose previous
    occupant ran LONGER (its stale K/V sits past the new request's
    positions), still match their JAX solo runs."""
    eng = engine(m, lanes=2)
    pa, pb, pc = (rng.integers(0, 64, (n,)) for n in (6, 3, 2))
    la = eng.submit(pa, 20)
    for _ in range(3):
        eng.step()
    lb = eng.submit(pb, 5)
    out_b = run_to_done(eng, lb)
    out_a = run_to_done(eng, la)
    lc = eng.submit(pc, 4)              # reuses lane A (26 positions used)
    assert lc == la
    out_c = run_to_done(eng, lc)
    for out, p, n in ((out_a, pa, 20), (out_b, pb, 5), (out_c, pc, 4)):
        np.testing.assert_array_equal(out, m["jsolo"](p, n))


def test_eos_and_one_token_prompt(m, rng):
    eng = engine(m, lanes=2, eos_token=7)
    p1 = rng.integers(0, 64, (1,))
    out = run_to_done(eng, eng.submit(p1, 12))
    assert_eos_prefix(out, m["jsolo"](p1, 12, eos_token=7), 7)
    # A request's own eos (host bookkeeping on every engine).
    p = rng.integers(0, 64, (4,))
    base = m["jsolo"](p, 10)
    tok = int(base[len(p) + 2])
    eng = engine(m, lanes=1)
    out = run_to_done(eng, eng.submit(p, 10, eos_token=tok))
    assert out[-1] == tok and len(out) <= len(base)
    np.testing.assert_array_equal(out, base[:len(out)])


def test_capacity_and_validation(m, rng):
    eng = engine(m, lanes=1)
    p = rng.integers(0, 64, (4,))
    assert eng.submit(p, 4) == 0
    assert eng.submit(p, 4) is None      # full
    with pytest.raises(ValueError, match="still decoding"):
        eng.drain(0)
    run_to_done(eng, 0)
    assert eng.submit(p, 4) == 0         # a drained lane is reusable
    with pytest.raises(ValueError, match="max_len"):
        engine(m, lanes=1).submit(p, 40)
    with pytest.raises(ValueError, match="seed iff"):
        eng.submit(p, 4, seed=0)
    with pytest.raises(ValueError, match="temperature > 0"):
        engine(m, top_k=5)
    with pytest.raises(ValueError, match="per_request_sampling"):
        engine(m).submit(p, 4, seed=0, temperature=0.5)
    with pytest.raises(ValueError, match="lanes"):
        engine(m, lanes=0)


def test_unported_knobs_raise_naming_their_item(m):
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        engine(m, plan=object())
    # hot_swap is ported: the engine takes swap_params and counts the
    # versions it served.
    eng = engine(m, hot_swap=True)
    assert eng.param_version == 0
    assert eng.swap_params(m["p"], 1) == 1 == eng.param_version
    with pytest.raises(ValueError, match="PagedBatcher"):
        engine(m, kv_int8="prefill")


def test_engine_defaults_to_the_card(m, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatcher(m["p"], m["cfg"])


@pytest.mark.parametrize("kw,seed", [({}, None),
                                     (dict(temperature=0.8, top_k=8), 5)],
                         ids=["greedy", "sampled"])
def test_multi_token_step_matches_single_steps(m, rng, kw, seed):
    """step(n) emits exactly the tokens of n step(1) calls, including
    mid-window retirement at eos."""
    prompts = [rng.integers(0, 64, (4,)) for _ in range(2)]
    outs = {}
    for n in (1, 4):
        eng = engine(m, lanes=2, eos_token=3, **kw)
        lanes = [eng.submit(p, 9, seed=seed) for p in prompts]
        while eng.running():
            eng.step(n)
        outs[n] = [eng.drain(lane) for lane in lanes]
    for a, b in zip(outs[1], outs[4]):
        np.testing.assert_array_equal(a, b)
    if seed is not None:
        for p, out in zip(prompts, outs[4]):
            assert_eos_prefix(out, tsolo(m, p, 9, seed=seed, eos_token=3,
                                         **kw), 3)


def test_fuzz_schedule_matches_jax_engine_and_solo(m, rng):
    """A randomized arrival / length / window schedule over 3 lanes, run
    through the JAX engine and the port's on the same schedule: every
    request's tokens equal the JAX engine's and the JAX solo greedy run
    (sticky-eos truncation aside)."""
    reqs = []
    for _ in range(8):
        p = int(rng.integers(1, 12))
        reqs.append((rng.integers(0, 64, (p,)).astype(np.int32),
                     int(rng.integers(1, 32 - p))))
    windows = [int(w) for w in rng.integers(1, 5, 64)]

    def drive(eng):
        pending, lane_of, outs, step = list(range(len(reqs))), {}, {}, 0
        while len(outs) < len(reqs):
            while pending and eng.free_lanes():
                rid = pending.pop(0)
                lane_of[eng.submit(*reqs[rid])] = rid
            eng.step(windows[step % len(windows)])
            step += 1
            for lane in list(lane_of):
                if lane not in eng.running():
                    outs[lane_of.pop(lane)] = eng.drain(lane)
        return outs

    ours = drive(engine(m, lanes=3, eos_token=9))
    theirs = drive(JaxBatcher(m["jp"], m["jcfg"], lanes=3, eos_token=9))
    for rid, (prompt, n) in enumerate(reqs):
        np.testing.assert_array_equal(ours[rid], theirs[rid],
                                      err_msg=f"request {rid}")
        assert_eos_prefix(ours[rid], m["jsolo"](prompt, n, eos_token=9), 9)


def test_lane_pos_clamped_and_idle_engine_skips_device(m, rng):
    """Free / done lanes keep decoding but their position pins at
    max_len - 1; an engine with nothing to emit does no device work; a
    lane readmitted from the clamp still matches JAX."""
    eng = engine(m, lanes=2)
    pa = rng.integers(0, 64, (4,))
    la = eng.submit(pa, 3)
    np.testing.assert_array_equal(run_to_done(eng, la), m["jsolo"](pa, 3))
    pos_before = eng.pos.clone()
    assert eng.step(4) == {}
    assert torch.equal(eng.pos, pos_before)
    lb = eng.submit(rng.integers(0, 64, (2,)), m["cfg"].max_len - 3)
    while lb in eng.running():
        eng.step(4)
    assert int(eng.pos.max()) <= m["cfg"].max_len - 1
    assert int(eng.pos[1]) == m["cfg"].max_len - 1
    assert list(eng._hpos) == eng.pos.tolist()   # the host mirror holds
    eng.drain(lb)
    assert eng.submit(rng.integers(0, 64, (2,)), 2) == 0
    pc = rng.integers(0, 64, (5,))
    lc = eng.submit(pc, 6)
    assert lc == 1
    np.testing.assert_array_equal(run_to_done(eng, lc), m["jsolo"](pc, 6))


class _ScalarReads(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts device-value reads on the host (``.item()``, ``int()``,
    ``bool()`` of a tensor all dispatch ``_local_scalar_dense``)."""

    def __init__(self):
        super().__init__()
        self.reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.reads += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kw,seed", [
    ({}, None), (dict(temperature=0.9, top_p=0.9, min_p=0.05), 4),
    (dict(per_request_sampling=True), None), (dict(kv_int8=True), None)],
    ids=["greedy", "sampled", "per-request", "kv_int8"])
def test_decode_window_reads_no_device_value(m, rng, kw, seed):
    """The per-token body keeps cur, pos and the sampling values on the
    device: a step(4) window reads no device scalar on the host (its one
    device-to-host copy is the token matrix)."""
    eng = engine(m, lanes=3, **kw)
    for _ in range(2):
        eng.submit(rng.integers(0, 64, (4,)), 12, seed=seed)
    eng.step()                                   # admissions settle
    with _ScalarReads() as mode:
        out = eng.step(4)
    assert mode.reads == 0
    assert all(len(v) == 4 for v in out.values()) and len(out) == 2


def test_rolling_lanes_past_max_len_match_jax(roll, rng):
    """Windowed engines run rolling lanes: each request decodes past
    max_len on the ring and matches its JAX solo rolling run, with a lane
    admitted while another wraps and a wrapped lane reused."""
    eng = ContinuousBatcher(roll["p"], roll["cfg"], lanes=2, device="cpu")

    def jsolo(prompt, n):
        return np.asarray(jgen.generate(roll["jp"], prompt[None],
                                        roll["jcfg"], n))[0]

    pa, pb, pc = (rng.integers(0, 64, (n,)).astype(np.int32)
                  for n in (4, 6, 3))
    la = eng.submit(pa, 30)              # 4 + 30 = 34 >> 12: wraps
    for _ in range(10):
        eng.step()
    lb = eng.submit(pb, 20)
    out_a = run_to_done(eng, la)
    out_b = run_to_done(eng, lb)
    lc = eng.submit(pc, 25)
    out_c = run_to_done(eng, lc)
    np.testing.assert_array_equal(out_a, jsolo(pa, 30))
    np.testing.assert_array_equal(out_b, jsolo(pb, 20))
    np.testing.assert_array_equal(out_c, jsolo(pc, 25))
    assert lc in (la, lb)


def test_rolling_sampled_and_validation(roll, rng):
    eng = ContinuousBatcher(roll["p"], roll["cfg"], lanes=2,
                            temperature=0.8, top_k=8, device="cpu")
    p = rng.integers(0, 64, (4,))
    out = run_to_done(eng, eng.submit(p, 24, seed=21))  # 28 > 12
    ref = tgen.generate(roll["p"], p[None], roll["cfg"], 24,
                        temperature=0.8, top_k=8, seed=21,
                        device="cpu")[0].numpy()
    np.testing.assert_array_equal(out, ref)
    norope = dataclasses.replace(roll["cfg"], rope=False)
    with pytest.raises(ValueError, match="rolling lanes"):
        ContinuousBatcher(roll["p"], norope, lanes=1, device="cpu")
    with pytest.raises(ValueError, match="admission"):
        eng.submit(rng.integers(0, 64, (20,)), 4, seed=1)
    with pytest.raises(ValueError, match="full-cache"):
        ContinuousBatcher(roll["p"], roll["cfg"], prefill_chunk=4,
                          device="cpu")


def test_per_request_sampling_mixed_lanes(m, rng):
    """Greedy and differently-parameterized sampled requests decode in
    ONE batch: greedy lanes equal JAX, each sampled lane its own solo
    generate(seed=); lane reuse flips a sampled lane back to greedy."""
    eng = engine(m, lanes=4, per_request_sampling=True)
    pa, pb, pc, pd = (rng.integers(0, 64, (5,)) for _ in range(4))
    la = eng.submit(pa, 8, seed=41, temperature=0.8)
    lb = eng.submit(pb, 8)
    lc = eng.submit(pc, 8, seed=42, temperature=1.0, top_p=0.9)
    ld = eng.submit(pd, 8, seed=43, temperature=0.7, min_p=0.2)
    outs = {ln: run_to_done(eng, ln) for ln in (la, lb, lc, ld)}
    np.testing.assert_array_equal(
        outs[la], tsolo(m, pa, 8, temperature=0.8, seed=41))
    np.testing.assert_array_equal(outs[lb], m["jsolo"](pb, 8))
    np.testing.assert_array_equal(
        outs[lc], tsolo(m, pc, 8, temperature=1.0, top_p=0.9, seed=42))
    np.testing.assert_array_equal(
        outs[ld], tsolo(m, pd, 8, temperature=0.7, min_p=0.2, seed=43))
    le = eng.submit(pa, 6)
    np.testing.assert_array_equal(run_to_done(eng, le), m["jsolo"](pa, 6))
    # The same sampled request alone, and beside other lanes, draws the
    # same stream: a lane's tokens do not depend on its neighbours.
    alone = engine(m, lanes=1, per_request_sampling=True)
    np.testing.assert_array_equal(
        run_to_done(alone, alone.submit(pa, 8, seed=41, temperature=0.8)),
        outs[la])


def test_per_request_validation(m, rng):
    p = rng.integers(0, 64, (4,))
    pr = engine(m, lanes=2, per_request_sampling=True)
    with pytest.raises(ValueError, match="iff this request samples"):
        pr.submit(p, 4, temperature=0.5)
    with pytest.raises(ValueError, match="iff this request samples"):
        pr.submit(p, 4, seed=0)
    with pytest.raises(ValueError, match="top_p/min_p need"):
        pr.submit(p, 4, top_p=0.9)
    with pytest.raises(ValueError, match="top_p must be"):
        pr.submit(p, 4, seed=0, temperature=0.5, top_p=1.5)
    sd = engine(m, lanes=2, temperature=0.8, top_k=8,
                per_request_sampling=True)
    np.testing.assert_array_equal(
        run_to_done(sd, sd.submit(p, 6, temperature=0.0)),
        m["jsolo"](p, 6))
    fd = engine(m, lanes=2, temperature=0.8, min_p=0.3,
                per_request_sampling=True)
    np.testing.assert_array_equal(
        run_to_done(fd, fd.submit(p, 6, seed=77, min_p=0.0)),
        tsolo(m, p, 6, temperature=0.8, seed=77))
    with pytest.raises(ValueError, match="min_p must be"):
        engine(m, temperature=0.8, min_p=-0.5, per_request_sampling=True)


def test_top_p_one_is_unfiltered(m, rng):
    """top_p=1.0 bypasses the nucleus mask everywhere: a scalar-path
    engine built with it decodes like solo generate with no filter (and
    like generate(top_p=1.0)); the no-op values are legal on greedy
    engines too."""
    engine(m, lanes=1, temperature=0.9, min_p=0.0)
    engine(m, lanes=1, top_p=1.0, min_p=0.0)
    eng = engine(m, lanes=1, temperature=0.9, top_p=1.0,
                 prompt_buckets=(8,))
    prompt = rng.integers(0, 64, (5,))
    out = run_to_done(eng, eng.submit(prompt, 6, seed=3))
    np.testing.assert_array_equal(out, tsolo(m, prompt, 6, temperature=0.9,
                                             seed=3))
    np.testing.assert_array_equal(out, tsolo(m, prompt, 6, temperature=0.9,
                                             top_p=1.0, seed=3))


def test_shared_prefix_matches_jax_prompt_cache(m, rng):
    """An engine over one prefilled prefix emits what JAX's
    generate(prompt_cache=...) emits, the lane's second occupant and a
    1-token tail (the reseed without an admission chunk) included; the
    port's generate(prompt_cache=) agrees, batch-1 segment fanned out."""
    prefix = rng.integers(0, 64, (6,)).astype(np.int32)
    jcache, _ = jgen.prefill(m["jp"], prefix[None], m["jcfg"],
                             last_logits=False)
    tcache, _ = tgen.prefill(m["p"], prefix[None], m["cfg"],
                             last_logits=False, device="cpu")
    kept = {k: v.clone() for k, v in tcache.items()}
    eng = engine(m, lanes=1, prompt_cache=(tcache, 6))
    for tail_len in (3, 1):
        tail = rng.integers(0, 64, (tail_len,)).astype(np.int32)
        out = run_to_done(eng, eng.submit(tail, 5))
        ref = np.asarray(jgen.generate(m["jp"], tail[None], m["jcfg"], 5,
                                       prompt_cache=(jcache, 6)))[0]
        np.testing.assert_array_equal(out, ref)
        tails = np.stack([tail, tail])
        both = tgen.generate(m["p"], tails, m["cfg"], 5, device="cpu",
                             prompt_cache=(tcache, 6)).numpy()
        np.testing.assert_array_equal(both, np.stack([ref, ref]))
    for k in kept:                       # the segment was never written
        assert torch.equal(tcache[k], kept[k])
    with pytest.raises(ValueError, match="exceeds"):
        eng.submit(rng.integers(0, 64, (20,)), 10)
    with pytest.raises(ValueError, match="batch 1"):
        big = {k: v.repeat(1, 2, 1, 1, 1) for k, v in tcache.items()}
        engine(m, prompt_cache=(big, 6))
    with pytest.raises(ValueError, match="full-cache"):
        tgen.generate(m["p"], tails, dataclasses.replace(
            m["cfg"], attention_window=8), 2, device="cpu",
            prompt_cache=(tcache, 6))

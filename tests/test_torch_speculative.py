"""The port's per-row decode chunks, speculative decoding and
SpeculativeBatcher against the JAX package.

``_decode_chunk`` logits at per-row offsets (full cache and ring) are
held to JAX's at 2e-4 (the JAX tests' own tolerance for chunk vs step);
greedy ``speculative_generate`` and ``SpeculativeBatcher`` tokens equal
JAX's ``generate`` exactly at f32.  Sampled speculative decoding cannot
match JAX's PRNG: it is held to its own contract (deterministic per
seed, the batcher equal to the solo run, and the first token
distributed as the target's softmax: total variation < 0.05 over 4096
rows).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import generate as jgen
from distkeras_tpu.models import speculative as jspec
from distkeras_tpu.models import transformer as jtfm
from distkeras_tpu_torch.models import generate as tgen
from distkeras_tpu_torch.models import transformer as ttfm
from distkeras_tpu_torch.models.speculative import (speculative_accept,
                                                    speculative_generate)
from distkeras_tpu_torch.resilience import FaultInjected, FaultPlan
from distkeras_tpu_torch.serving import PrefixPool, SpeculativeBatcher
from distkeras_tpu_torch.utils.serialization import params_from_numpy

CFG = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
           max_len=32)
DRAFT = dict(vocab_size=64, d_model=16, n_heads=2, n_layers=1, d_ff=32,
             max_len=32)
WIN = dict(CFG, rope=True, attention_window=6, max_len=16)
WIN_DRAFT = dict(DRAFT, rope=True, attention_window=6, max_len=16)
TOL = dict(atol=2e-4, rtol=2e-4)


def pair(kw, seed):
    """JAX config + numpy params, port config + CPU params."""
    jcfg = jtfm.TransformerConfig(**kw)
    jp = jax.tree.map(np.asarray, jtfm.init_params(jax.random.key(seed),
                                                   jcfg))
    return jcfg, jp, ttfm.TransformerConfig(**kw), params_from_numpy(jp,
                                                                     "cpu")


@pytest.fixture(scope="module")
def models():
    return {"t": pair(CFG, 0), "d": pair(DRAFT, 9),
            "rt": pair(dict(CFG, rope=True), 0),
            "rd": pair(dict(DRAFT, rope=True), 9),
            "wt": pair(WIN, 0), "wd": pair(WIN_DRAFT, 9)}


def jgreedy(pair_, prompt, n, **kw):
    jcfg, jp = pair_[:2]
    return np.asarray(jgen.generate(jp, np.asarray(prompt, np.int32), jcfg,
                                    n, **kw))


def spec(t, d, prompt, n, **kw):
    out, stats = speculative_generate(t[3], d[3], prompt, t[2], d[2], n,
                                      device="cpu", **kw)
    return out.numpy(), stats


def test_decode_chunk_matches_steps_and_jax_per_row_offsets(models, rng):
    """Teacher-forcing T tokens through one chunk gives the logits of T
    steps; rows at different offsets in one per-row chunk give JAX's
    per-row logits and cache."""
    jcfg, jp, cfg, p = models["t"]
    toks = rng.integers(0, 64, (3, 9))
    cache = tgen.init_cache(cfg, 3, device="cpu")
    steps = [tgen._decode_step(p, cache, torch.from_numpy(toks[:, i]), i,
                               cfg)[0] for i in range(9)]
    chunk, _ = tgen._decode_chunk(p, tgen.init_cache(cfg, 3, device="cpu"),
                                  torch.from_numpy(toks),
                                  torch.zeros(3, dtype=torch.long), cfg)
    np.testing.assert_allclose(chunk.numpy(), torch.stack(steps, 1).numpy(),
                               **TOL)
    pos0 = np.array([6, 4, 0])
    nxt = rng.integers(0, 64, (3, 3))
    jc = jgen.init_cache(jcfg, 3)
    _, jc = jgen._decode_chunk(jp, jc, jnp.asarray(toks[:, :6], jnp.int32),
                               jnp.zeros(3, jnp.int32), jcfg)
    jl, jc = jgen._decode_chunk(jp, jc, jnp.asarray(nxt, jnp.int32),
                                jnp.asarray(pos0, jnp.int32), jcfg)
    tc = tgen.init_cache(cfg, 3, device="cpu")
    tgen._decode_chunk(p, tc, torch.from_numpy(toks[:, :6]),
                       torch.zeros(3, dtype=torch.long), cfg)
    tl, tc = tgen._decode_chunk(p, tc, torch.from_numpy(nxt),
                                torch.from_numpy(pos0), cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **TOL)


@pytest.mark.parametrize("t_len", [1, 3])
def test_ring_chunk_per_row_matches_jax(models, rng, t_len):
    """Windowed per-row chunks: T = 1 at divergent ring positions, and
    multi-token chunks whose modular scatter wraps mid-chunk."""
    jcfg, jp, cfg, p = models["wt"]
    jc, tc = jgen.init_cache(jcfg, 2), tgen.init_cache(cfg, 2, device="cpu")
    for pos0 in ([0, 0], [9, 3], [14, 12], [23, 18]):
        toks = rng.integers(0, 64, (2, t_len))
        jl, jc = jgen._decode_chunk(jp, jc, jnp.asarray(toks, jnp.int32),
                                    jnp.asarray(pos0, jnp.int32), jcfg)
        tl, tc = tgen._decode_chunk(p, tc, torch.from_numpy(toks),
                                    torch.tensor(pos0), cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]), **TOL)
    with pytest.raises(ValueError, match="ring size"):
        tgen._decode_chunk(p, tc, torch.zeros((2, 11), dtype=torch.long),
                           torch.tensor([0, 3]), cfg)


@pytest.mark.parametrize("case,n_draft", [("plain", 1), ("plain", 4),
                                          ("gqa", 3), ("rolling", 3)])
def test_greedy_speculative_equals_jax_generate(models, rng, case, n_draft):
    if case == "gqa":
        kw = dict(CFG, n_heads=4, n_kv_heads=2, rope=True)
        t, d = pair(kw, 1), pair(dict(kw, n_layers=1), 8)
    else:
        t, d = {"plain": ("t", "d"), "rolling": ("wt", "wd")}[case]
        t, d = models[t], models[d]
    n = 25 if case == "rolling" else 10        # rolling: 5 + 25 >> 16
    prompt = rng.integers(1, 64, (3, 5))
    out, stats = spec(t, d, prompt, n, n_draft=n_draft)
    np.testing.assert_array_equal(out, jgreedy(t, prompt, n))
    assert int(stats["iterations"]) >= 1


def test_perfect_draft_accepts_everything(models, rng):
    t = models["t"]
    prompt = rng.integers(1, 64, (2, 4))
    out, stats = spec(t, t, prompt, 12, n_draft=3)
    np.testing.assert_array_equal(out, jgreedy(t, prompt, 12))
    assert float(stats["acceptance_rate"]) == 1.0
    assert int(stats["iterations"]) == 3            # ceil(12 / (3 + 1))


def test_eos_matches_jax_and_stops_rows_early(models, rng):
    t, d = models["t"], models["d"]
    prompt = rng.integers(1, 64, (4, 5))
    eos = int(jgreedy(t, prompt, 12)[0, 8])
    out, _ = spec(t, d, prompt, 12, n_draft=3, eos_token=eos)
    np.testing.assert_array_equal(out, jgreedy(t, prompt, 12, eos_token=eos))
    same = np.repeat(rng.integers(1, 64, (1, 4)), 3, axis=0)
    eos = int(jgreedy(t, same, 1)[0, 4])
    out, stats = spec(t, t, same, 16, n_draft=4, eos_token=eos)
    assert (out[:, 4:] == eos).all() and int(stats["iterations"]) == 1


def test_sampled_deterministic_per_seed(models, rng):
    t, d = models["t"], models["d"]
    prompt = rng.integers(1, 64, (2, 4))
    a, _ = spec(t, d, prompt, 8, n_draft=2, temperature=0.8, seed=5)
    b, _ = spec(t, d, prompt, 8, n_draft=2, temperature=0.8, seed=5)
    c, _ = spec(t, d, prompt, 8, n_draft=2, temperature=0.8, seed=6)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_sampled_first_token_follows_the_target(rng):
    """The speculative-sampling theorem, empirically: with a different
    draft, the first generated token of 4096 rows is distributed as the
    target's softmax (total variation < 0.05)."""
    cfg = ttfm.TransformerConfig(vocab_size=16, d_model=16, n_heads=2,
                                 n_layers=1, d_ff=32, max_len=8)
    dcfg = dataclasses.replace(cfg, d_model=8, d_ff=16)
    params = ttfm.init_params(3, cfg, device="cpu")
    draft = ttfm.init_params(4, dcfg, device="cpu")
    prompt = torch.full((4096, 1), 7)
    out, _ = speculative_generate(params, draft, prompt, cfg, dcfg, 1,
                                  n_draft=2, temperature=0.9, seed=11,
                                  device="cpu")
    emp = np.bincount(out[:, 1].numpy(), minlength=16) / 4096
    logits, _ = ttfm.apply(params, prompt[:1], cfg, device="cpu")
    target = torch.softmax(logits[0, 0] / 0.9, -1).detach().numpy()
    assert 0.5 * np.abs(emp - target).sum() < 0.05


def test_speculative_accept_matches_jax(rng):
    p_logp = np.log(rng.dirichlet(np.ones(16), (3, 4))).astype(np.float32)
    q_logp = np.log(rng.dirichlet(np.ones(16), (3, 3))).astype(np.float32)
    d = rng.integers(0, 16, (3, 3))
    u = rng.random((3, 3)).astype(np.float32)
    jn, jr = jspec.speculative_accept(p_logp, q_logp, d, u)
    tn, tr = speculative_accept(*(torch.from_numpy(x) for x in
                                  (p_logp, q_logp, d, u)))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)


def test_validation_errors(models, rng):
    t, d = models["t"], models["d"]
    prompt = rng.integers(1, 64, (2, 4))
    cases = [
        (dict(draft_cfg=dataclasses.replace(d[2], vocab_size=32)), "vocab"),
        (dict(n=26, n_draft=4), "slack"),
        (dict(temperature=0.5), "seed"),
        (dict(n_draft=0), "n_draft"),
        (dict(eos_token=64), "eos_token"),
        (dict(cfg=dataclasses.replace(t[2], rope=True, attention_window=29)),
         "rejected tail"),
        (dict(cfg=dataclasses.replace(t[2], attention_window=8, max_len=16),
              n=20, n_draft=2), "rope"),
    ]
    for kw, match in cases:
        n = kw.pop("n", 4)
        cfg, dcfg = kw.pop("cfg", t[2]), kw.pop("draft_cfg", d[2])
        with pytest.raises(ValueError, match=match):
            speculative_generate(t[3], d[3], prompt, cfg, dcfg, n,
                                 device="cpu", **kw)
    out, _ = speculative_generate(t[3], d[3], prompt, t[2], d[2], 4,
                                  kv_int8=True, device="cpu")
    assert tuple(out.shape) == (2, 8)


# ------------------------------------------------------ SpeculativeBatcher


def batcher(t, d, **kw):
    return SpeculativeBatcher(t[3], d[3], t[2], d[2], device="cpu", **kw)


def run_to_done(eng, lane):
    while lane in eng.running():
        eng.step()
    return eng.drain(lane)


def test_batcher_greedy_matches_jax_solo(models, rng):
    """Staggered admission, a 1-token prompt, lane reuse and a
    per-request eos: every request equals JAX's greedy generate."""
    t, d = models["rt"], models["rd"]
    eng = batcher(t, d, lanes=2, n_draft=3)
    pa, pb, pc = (rng.integers(0, 64, (n,)) for n in (5, 1, 7))
    la = eng.submit(pa, 10)
    eng.step()
    lb = eng.submit(pb, 8)
    out_a, out_b = run_to_done(eng, la), run_to_done(eng, lb)
    lc = eng.submit(pc, 6, eos_token=9)
    out_c = run_to_done(eng, lc)
    np.testing.assert_array_equal(out_a, jgreedy(t, pa[None], 10)[0])
    np.testing.assert_array_equal(out_b, jgreedy(t, pb[None], 8)[0])
    ref_c = jgreedy(t, pc[None], 6, eos_token=9)[0]
    np.testing.assert_array_equal(out_c, ref_c[:len(out_c)])
    if len(out_c) < len(ref_c):
        assert out_c[-1] == 9 and (ref_c[len(out_c):] == 9).all()
    assert lc in (la, lb)


def test_batcher_sampled_matches_solo_speculative(models, rng):
    """Per-lane iteration counters: each sampled lane replays its solo
    batch-1 speculative_generate(seed=) run whenever it was admitted."""
    t, d = models["rt"], models["rd"]
    eng = batcher(t, d, lanes=2, n_draft=3, temperature=0.8)
    pa, pb = rng.integers(0, 64, (5,)), rng.integers(0, 64, (3,))
    la = eng.submit(pa, 10, seed=51)
    eng.step()
    lb = eng.submit(pb, 8, seed=52)
    out_a, out_b = run_to_done(eng, la), run_to_done(eng, lb)
    for out, p, n, s in ((out_a, pa, 10, 51), (out_b, pb, 8, 52)):
        ref, _ = spec(t, d, p[None], n, n_draft=3, temperature=0.8, seed=s)
        np.testing.assert_array_equal(out, ref[0])
    with pytest.raises(ValueError, match="seed iff"):
        eng.submit(pa, 4)


def test_batcher_validation(models, rng):
    t, d = models["rt"], models["rd"]
    p = rng.integers(0, 64, (4,))
    with pytest.raises(ValueError, match="agree"):
        batcher(t, models["wd"])
    with pytest.raises(ValueError, match="vocab"):
        SpeculativeBatcher(t[3], d[3], t[2],
                           dataclasses.replace(d[2], vocab_size=32),
                           device="cpu")
    with pytest.raises(ValueError, match=r"n_draft=4.*max_len"):
        SpeculativeBatcher(t[3], d[3], t[2],
                           dataclasses.replace(d[2], max_len=4), n_draft=4,
                           device="cpu")
    # plan= is ported (tests/test_torch_tp.py): it needs mesh= with it.
    with pytest.raises(ValueError, match="plan= and mesh= together"):
        batcher(t, d, plan=object())
    eng = batcher(t, d, lanes=1, n_draft=3)
    with pytest.raises(ValueError, match="slack"):
        eng.submit(p, 26)                    # 4 + 26 + 3 > 32
    assert eng.submit(p, 8) == 0
    assert eng.submit(p, 8) is None
    with pytest.raises(ValueError, match="still decoding"):
        eng.drain(0)
    with pytest.raises(ValueError, match="seed iff"):
        batcher(t, d, lanes=1).submit(p, 4, seed=3)


def test_batcher_pooled_prefix_pairs_match_jax_prompt_cache(models, rng):
    """Pooled (target, draft) prefix pairs: greedy requests equal JAX's
    generate(tail, prompt_cache=...), the 1-token reseed path (with the
    recorded last_token) included; refs release at drain."""
    t, d = models["rt"], models["rd"]
    cfg = dataclasses.replace(t[2], max_len=64)
    dcfg = dataclasses.replace(d[2], max_len=64)
    jcfg = dataclasses.replace(t[0], max_len=64)
    pref = rng.integers(0, 64, (10,))
    tca, _ = tgen.prefill(t[3], pref[None], cfg, last_logits=False,
                          device="cpu")
    dca, _ = tgen.prefill(d[3], pref[None], dcfg, last_logits=False,
                          device="cpu")
    pool = PrefixPool(cfg, slots=2, draft_cfg=dcfg, device="cpu")
    pid = pool.put((tca, dca), 10, last_token=int(pref[-1]))
    bare = pool.put((tca, dca), 10)
    eng = SpeculativeBatcher(t[3], d[3], cfg, dcfg, lanes=2, n_draft=3,
                             prefix_pool=pool, prompt_buckets=(8,),
                             device="cpu")
    jcache, _ = jgen.prefill(t[1], pref[None].astype(np.int32), jcfg,
                             last_logits=False)
    tail, one = rng.integers(0, 64, (4,)), np.array([5])
    la, lb = eng.submit(tail, 6, prefix_id=pid), eng.submit(one, 5,
                                                            prefix_id=pid)
    assert pool.refs_of(pid) == 2
    for lane, prompt, n in ((la, tail, 6), (lb, one, 5)):
        np.testing.assert_array_equal(
            run_to_done(eng, lane),
            np.asarray(jgen.generate(t[1], prompt[None].astype(np.int32),
                                     jcfg, n,
                                     prompt_cache=(jcache, 10)))[0])
    assert pool.refs_of(pid) == 0
    with pytest.raises(ValueError, match="prefix"):
        eng.submit(tail, 50, prefix_id=pid)
    with pytest.raises(ValueError, match="last token"):
        eng.submit(one, 5, prefix_id=bare)
    with pytest.raises(ValueError, match="speculative pool"):
        SpeculativeBatcher(t[3], d[3], cfg, dcfg, device="cpu",
                           prefix_pool=PrefixPool(cfg, slots=1,
                                                  device="cpu"))


def test_rolling_batcher_and_draft_fault_fallback(models, rng):
    """Rolling speculative lanes past max_len, then a draft fault
    mid-wrap: the engine degrades to target-only decode on the same ring
    state and every request still equals JAX's rolling greedy run."""
    t, d = models["wt"], models["wd"]
    eng = batcher(t, d, lanes=2, n_draft=3)
    pa, pb = rng.integers(1, 64, (5,)), rng.integers(1, 64, (3,))
    la = eng.submit(pa, 25)
    for _ in range(4):
        eng.step()
    lb = eng.submit(pb, 20)
    with FaultPlan().fail("serving.draft"):
        eng.step()
    assert eng.degraded and isinstance(eng.degraded_error, FaultInjected)
    while eng.running():
        eng.step()
    np.testing.assert_array_equal(eng.drain(la), jgreedy(t, pa[None], 25)[0])
    np.testing.assert_array_equal(eng.drain(lb), jgreedy(t, pb[None], 20)[0])
    with pytest.raises(ValueError, match="admission bucket"):
        eng.submit(rng.integers(1, 64, (17,)), 2)


def test_verify_fault_raises_and_keeps_the_engine(models, rng):
    """Only a draft fault degrades: a fault in the target's verify half
    raises out of ``step`` with the engine still speculative, and the
    target state it left is intact, so the next rounds finish the
    request with JAX's greedy tokens."""
    t, d = models["rt"], models["rd"]
    eng = batcher(t, d, lanes=2, n_draft=3)
    prompt = rng.integers(1, 64, (6,))
    lane = eng.submit(prompt, 12)
    eng.step()

    def broken(*args):
        raise RuntimeError("verify fault")

    eng._verify = broken
    with pytest.raises(RuntimeError, match="verify fault"):
        eng.step()
    assert not eng.degraded and eng.degraded_error is None
    del eng._verify
    np.testing.assert_array_equal(run_to_done(eng, lane),
                                  jgreedy(t, prompt[None], 12)[0])

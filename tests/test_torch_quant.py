"""The port's int8 weights and int8 KV cache against the JAX package
(CPU, f32).

- ``quantize_params`` and ``quantize_kv`` give JAX's ``q`` and ``s``
  bit for bit (no tolerance), and MoE trees raise;
- greedy ``generate`` of an int8 tree equals JAX's int8 greedy tokens
  exactly (plain, rope + GQA, rolling window past ``max_len``), and
  launches no prefill;
- ``kv_int8`` decode logits equal JAX's at 1e-5 in all three
  ``_decode_chunk`` shapes (per-row T = 1 on a ring, the uniform slab,
  per-row chunks through the modular ring scatter) at ragged per-row
  offsets, and ``kv_int8`` greedy tokens equal JAX's (prefill,
  sequential, ragged prompts, ``prompt_cache``);
- ``ContinuousBatcher(kv_int8=True)`` (full cache and rolling ring) and
  an int8-tree engine equal JAX's solo ``generate``; ``PrefixPool``
  int8 segments and their mismatch errors;
- ``speculative_generate`` and ``SpeculativeBatcher`` with the int8 tree
  drafting for its f32 parent equal plain greedy decoding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import generate as jgen
from distkeras_tpu.models import quant as jquant
from distkeras_tpu.models import transformer as jtfm
from distkeras_tpu_torch.models import generate as tgen
from distkeras_tpu_torch.models import quant as tquant
from distkeras_tpu_torch.models import transformer as ttfm
from distkeras_tpu_torch.models.speculative import speculative_generate
from distkeras_tpu_torch.serving import (ContinuousBatcher, PrefixPool,
                                         SpeculativeBatcher)
from distkeras_tpu_torch.utils.serialization import (params_from_numpy,
                                                     params_to_numpy)

BASE = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
            max_len=32)
ROPE_GQA = dict(rope=True, n_kv_heads=1)
ROLL = dict(rope=True, attention_window=6, max_len=16)
TOL = dict(atol=1e-5, rtol=1e-5)


def pair(seed=0, **kw):
    kw = {**BASE, **kw}
    jcfg = jtfm.TransformerConfig(**kw)
    jp = jax.tree.map(np.asarray, jtfm.init_params(jax.random.key(seed),
                                                   jcfg))
    return jcfg, jp, ttfm.TransformerConfig(**kw), params_from_numpy(jp,
                                                                     "cpu")


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, kw in (("plain", {}), ("rope_gqa", ROPE_GQA), ("roll", ROLL)):
        jcfg, jp, cfg, p = pair(**kw)
        jq = jax.tree.map(np.asarray, jquant.quantize_params(jp))
        out[name] = dict(jcfg=jcfg, jp=jp, cfg=cfg, p=p, jq=jq,
                         q=params_from_numpy(jq, "cpu"))
    return out


def test_quantize_params_bit_identical_to_jax_and_moe_raises(models):
    m = models["rope_gqa"]
    tq = tquant.quantize_params(m["p"])
    jq = m["jq"]
    pairs = [(tq["tok_emb"], jq["tok_emb"])]
    for group in ("attn", "ffn"):
        pairs += [(tq["layers"][group][k], v)
                  for k, v in jq["layers"][group].items()]
    for got, want in pairs:
        assert got.q.dtype == torch.int8 and got.s.dtype == torch.float32
        np.testing.assert_array_equal(got.q.numpy(), want.q)
        np.testing.assert_array_equal(got.s.numpy(), want.s)
    assert torch.equal(tq["ln_f_scale"], m["p"]["ln_f_scale"])
    assert tquant.is_quantized(tq) and not tquant.is_quantized(m["p"])
    # The carried-over tree is the same QTensor tree, and a (q, s) pair
    # round-trips through params_to_numpy.
    carried = m["q"]["layers"]["attn"]["wo"]
    assert torch.equal(carried.q, tq["layers"]["attn"]["wo"].q)
    back = params_from_numpy(params_to_numpy(tq), "cpu")["layers"]["ffn"]
    assert torch.equal(back["w2"].s, tq["layers"]["ffn"]["w2"].s)
    _, _, _, moe = pair(num_experts=2)
    with pytest.raises(ValueError, match="dense-FFN"):
        tquant.quantize_params(moe)


def test_quantize_kv_bit_identical_to_jax(rng):
    x = rng.normal(size=(3, 5, 2, 16)).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row takes the 1e-12 floor
    jqv, js = jquant.quantize_kv(jnp.asarray(x))
    tqv, ts = tquant.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("name,n", [("plain", 10), ("rope_gqa", 10),
                                    ("roll", 20)])
def test_int8_tree_greedy_equals_jax_and_launches_no_prefill(models, name,
                                                             n):
    m = models[name]
    prompt = np.random.default_rng(1).integers(0, 64, (2, 7)).astype(
        np.int32)
    ref = np.asarray(jgen.generate(m["jq"], prompt, m["jcfg"], n))
    calls = []
    real = tgen.flash_attention
    tgen.flash_attention = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        out = tgen.generate(m["q"], prompt, m["cfg"], n, device="cpu")
    finally:
        tgen.flash_attention = real
    np.testing.assert_array_equal(out.numpy(), ref)
    assert not calls
    with pytest.raises(ValueError, match="full-precision"):
        tgen.generate(m["q"], prompt, m["cfg"], n, use_prefill=True,
                      device="cpu")
    with pytest.raises(ValueError, match="full-precision"):
        tgen.prefill(m["q"], prompt, m["cfg"], device="cpu")


@pytest.mark.parametrize("name,shape", [
    ("roll", "per_row_t1"), ("roll", "uniform"), ("roll", "ring_chunk"),
    ("plain", "per_row_t1"), ("plain", "uniform"),
    ("plain", "per_row_chunk")])
def test_kv_int8_decode_chunk_logits_match_jax(models, name, shape):
    """The int8 cache's scales ride the K/V slot arithmetic: logits and
    the scale slabs equal JAX's at divergent (ragged) row offsets.

    A K/V value whose f32 pre-image lies within rounding of a .5
    boundary may round to the neighbouring int8 in one package (XLA and
    torch sum the projections in different orders).  After each step the
    torch cache takes JAX's values, so a step sees only the flips its own
    chunk wrote: a step that writes none is held at 1e-5; a step with
    such a flip must differ by at most 2 values, each by exactly 1, and
    its logits by at most 2e-3 (one int8 step of one value)."""
    m = models[name]
    jcfg, jp, cfg, p = m["jcfg"], m["jp"], m["cfg"], m["p"]
    rng = np.random.default_rng(2)
    jc = jgen.init_cache(jcfg, 2, kv_int8=True)
    tc = tgen.init_cache(cfg, 2, kv_int8=True, device="cpu")
    uniform = shape == "uniform"
    t_len = 1 if shape == "per_row_t1" else 3
    starts = ([0, 0], [5, 5], [13, 13]) if uniform else \
        ([0, 0], [4, 2], [11, 7], [19, 15])
    for pos0 in starts:
        toks = rng.integers(0, 64, (2, t_len)).astype(np.int32)
        jl, jc = jgen._decode_chunk(jp, jc, jnp.asarray(toks),
                                    jnp.asarray(pos0, jnp.int32), jcfg,
                                    uniform_pos=uniform)
        tl, tc = tgen._decode_chunk(p, tc, torch.from_numpy(toks).long(),
                                    torch.tensor(pos0), cfg,
                                    uniform_pos=uniform)
        diff = np.concatenate([
            (tc[n].numpy().astype(np.int32)
             - np.asarray(jc[n]).astype(np.int32)).ravel()
            for n in ("k", "v")])
        flips = np.count_nonzero(diff)
        if flips == 0:
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        else:
            assert flips <= 2 and np.abs(diff).max() == 1, diff
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=2e-3, rtol=0)
        np.testing.assert_allclose(tc["k_scale"].numpy(),
                                   np.asarray(jc["k_scale"]), **TOL)
        np.testing.assert_allclose(tc["v_scale"].numpy(),
                                   np.asarray(jc["v_scale"]), **TOL)
        for n in ("k", "v", "k_scale", "v_scale"):
            tc[n].copy_(torch.from_numpy(np.array(jc[n])))


@pytest.mark.parametrize("name,kw", [
    ("plain", dict(use_prefill=True)), ("plain", dict(use_prefill=False)),
    ("rope_gqa", {}), ("roll", dict(n=20)),
    ("plain", dict(prompt_lengths=[7, 4]))])
def test_kv_int8_greedy_equals_jax(models, name, kw):
    m = models[name]
    n = kw.pop("n", 10)
    prompt = np.random.default_rng(3).integers(0, 64, (2, 7)).astype(
        np.int32)
    ref = np.asarray(jgen.generate(m["jp"], prompt, m["jcfg"], n,
                                   kv_int8=True, **kw))
    out = tgen.generate(m["p"], prompt, m["cfg"], n, kv_int8=True,
                        device="cpu", **kw)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_kv_int8_prompt_cache_and_its_validation(models):
    m = models["plain"]
    rng = np.random.default_rng(4)
    prefix = rng.integers(0, 64, (1, 6)).astype(np.int32)
    suffix = rng.integers(0, 64, (2, 4)).astype(np.int32)
    jseg, _ = jgen.prefill(m["jp"], prefix, m["jcfg"], kv_int8=True)
    tseg, _ = tgen.prefill(m["p"], prefix, m["cfg"], kv_int8=True,
                           device="cpu")
    assert tseg["k"].dtype == torch.int8
    np.testing.assert_allclose(tseg["k_scale"].numpy(),
                               np.asarray(jseg["k_scale"]), **TOL)
    ref = np.asarray(jgen.generate(m["jp"], suffix, m["jcfg"], 8,
                                   kv_int8=True, prompt_cache=(jseg, 6)))
    out = tgen.generate(m["p"], suffix, m["cfg"], 8, kv_int8=True,
                        prompt_cache=(tseg, 6), device="cpu")
    np.testing.assert_array_equal(out.numpy(), ref)
    assert tseg["k"][:, :, 6:].abs().sum() == 0  # the segment is copied
    plain, _ = tgen.prefill(m["p"], prefix, m["cfg"], device="cpu")
    for seg, q8 in ((plain, True), (tseg, False)):
        with pytest.raises(ValueError, match="quantization must match"):
            tgen.generate(m["p"], suffix, m["cfg"], 4, kv_int8=q8,
                          prompt_cache=(seg, 6), device="cpu")
    with pytest.raises(ValueError, match="prompt_cache must be"):
        tgen.generate(m["p"], suffix, m["cfg"], 4, kv_int8=True,
                      prompt_cache=({**tseg, "k_scale": tseg["k"]}, 6),
                      device="cpu")


def run_engine(eng, prompts, n, *step_args):
    outs = []
    for prompt in prompts:
        lane = eng.submit(prompt, n)
        while lane in eng.running():
            eng.step(*step_args)
        outs.append(eng.drain(lane))
    return outs


@pytest.mark.parametrize("name,tree,n", [("plain", "p", 9),
                                         ("roll", "p", 22),
                                         ("rope_gqa", "q", 9)])
def test_engine_int8_cache_and_int8_tree_equal_jax_solo(models, name, tree,
                                                        n):
    """kv_int8 lanes (the rolling ring included) match JAX's solo
    ``generate(kv_int8=True, use_prefill=False)``; an int8 tree's lanes
    match JAX's int8 greedy ``generate``."""
    m = models[name]
    kv_int8 = tree == "p"
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 64, k).astype(np.int32) for k in (6, 1, 9)]
    eng = ContinuousBatcher(m[tree], m["cfg"], lanes=2, kv_int8=kv_int8,
                            device="cpu")
    outs = run_engine(eng, prompts, n, 3)
    jparams = m["jp"] if kv_int8 else m["jq"]
    for prompt, got in zip(prompts, outs):
        ref = np.asarray(jgen.generate(
            jparams, prompt[None], m["jcfg"], n, kv_int8=kv_int8,
            use_prefill=False if kv_int8 else None))[0]
        np.testing.assert_array_equal(got, ref)


def test_prefix_pool_int8_segments_and_mismatch_errors(models):
    m = models["plain"]
    rng = np.random.default_rng(6)
    prefix = rng.integers(0, 64, 6).astype(np.int32)
    tail = rng.integers(0, 64, 3).astype(np.int32)
    seg, _ = tgen.prefill(m["p"], prefix[None], m["cfg"], kv_int8=True,
                          device="cpu")
    pool = PrefixPool(m["cfg"], slots=2, kv_int8=True, device="cpu")
    pid = pool.put(seg, 6)
    eng = ContinuousBatcher(m["p"], m["cfg"], lanes=2, kv_int8=True,
                            prefix_pool=pool, device="cpu")
    lane = eng.submit(tail, 8, prefix_id=pid)
    while lane in eng.running():
        eng.step(2)
    got = eng.drain(lane)
    want = tgen.generate(m["p"], tail[None], m["cfg"], 8, kv_int8=True,
                         prompt_cache=(seg, 6), device="cpu")[0].numpy()
    np.testing.assert_array_equal(got, want)
    plain_seg, _ = tgen.prefill(m["p"], prefix[None], m["cfg"],
                                device="cpu")
    with pytest.raises(ValueError, match="spec"):
        pool.put(plain_seg, 6)
    with pytest.raises(ValueError, match="quantization must match"):
        ContinuousBatcher(m["p"], m["cfg"], lanes=2, prefix_pool=pool,
                          device="cpu")
    with pytest.raises(ValueError, match="full-precision"):
        PrefixPool(m["cfg"], slots=1, kv_int8=True, draft_cfg=m["cfg"],
                   device="cpu")


@pytest.mark.parametrize("kv_int8", [False, True])
def test_speculative_int8_draft_equals_plain_greedy(models, kv_int8):
    """The int8 tree drafts for its f32 parent: greedy tokens equal plain
    greedy decoding (with ``kv_int8``, the kv_int8 greedy of the prefill
    path; both warm the target by prefill)."""
    m = models["plain"]
    prompt = np.random.default_rng(7).integers(0, 64, (2, 6)).astype(
        np.int32)
    ref = np.asarray(jgen.generate(m["jp"], prompt, m["jcfg"], 12,
                                   kv_int8=kv_int8))
    out, stats = speculative_generate(m["p"], m["q"], prompt, m["cfg"],
                                      m["cfg"], 12, n_draft=3,
                                      kv_int8=kv_int8, device="cpu")
    np.testing.assert_array_equal(out.numpy(), ref)
    assert 0.0 < float(stats["acceptance_rate"]) <= 1.0
    if kv_int8:
        return
    eng = SpeculativeBatcher(m["p"], m["q"], m["cfg"], m["cfg"], lanes=2,
                             n_draft=3, device="cpu")
    outs = run_engine(eng, list(prompt), 12)
    for got, want in zip(outs, ref):
        np.testing.assert_array_equal(got, want)


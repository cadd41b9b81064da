"""The port's beam search against the JAX package (CPU, f32).

Mirrors the beam tests of ``tests/test_generate.py``: for the same numpy
weights and prompts the port's ``beam_search`` returns JAX's sequences
exactly and its scores within 1e-5, on every ``beam_impl``, with eos
freezing, ``length_penalty`` (frozen lengths too), ``prompt_cache``,
``kv_int8``, windowed configs and rolling beams past ``max_len``; the
ancestry path equals the physical parent gather; the size guard warns
under ``"auto"`` and raises under ``"ancestry"``; validation errors are
the reference's types.  Ties in the top-W go to the lower index, as
``jax.lax.top_k`` breaks them: an all-zero model (every candidate tied)
pins it.  Ancestry attention itself is held to JAX's ``_decode_step``
logits under a random ancestor map.  JAX calls are memoized per module.
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
from distkeras_tpu_torch.models import transformer as ttfm
from distkeras_tpu_torch.trainers.optim import Optimizer
from distkeras_tpu_torch.utils.serialization import (params_from_numpy,
                                                     params_to_numpy)

BASE = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
            max_len=16)
CFGS = {
    "plain": BASE,
    "rope": dict(BASE, rope=True),
    "gqa": dict(BASE, n_heads=4, n_kv_heads=2, rope=True),
    "win": dict(BASE, n_heads=4, n_kv_heads=2, rope=True,
                attention_window=6),
    "win4": dict(BASE, rope=True, attention_window=4),
    "roll_big": dict(BASE, n_heads=4, n_kv_heads=2, rope=True,
                     attention_window=6, max_len=64),
    "roll": dict(BASE, n_heads=4, n_kv_heads=2, rope=True,
                 attention_window=6, max_len=16),
}
SEEDS = {"plain": 1, "rope": 0, "gqa": 3, "win": 7, "win4": 3,
         "roll_big": 2, "roll": 2}
SCORE_TOL = dict(atol=1e-5, rtol=1e-5)


class Model:
    """One config's JAX and port twins on the same numpy weights, and a
    memo of JAX beam results."""

    def __init__(self, kw, np_params):
        self.jcfg = jtfm.TransformerConfig(**kw)
        self.cfg = ttfm.TransformerConfig(**kw)
        self.jp = np_params
        self.p = params_from_numpy(np_params, "cpu")
        self.memo = {}

    def jbeam(self, prompt, n, quantized=False, **kw):
        """JAX's beams, under one ``jax.jit`` per call signature (the
        weights are arguments, so configs that share shapes share the
        compiled program)."""
        key = (prompt.tobytes(), prompt.shape, n, quantized,
               tuple(sorted((k, str(v)) for k, v in kw.items())))
        if key not in self.memo:
            jp = jquant.quantize_params(self.jp) if quantized else self.jp
            pre = kw.pop("prompt_cache", None)
            cfg = self.jcfg

            def run(jp, prompt, pre):
                if pre is not None:
                    seg, _ = jgen.prefill(jp, pre, cfg, last_logits=False,
                                          kv_int8=kw.get("kv_int8", False))
                    kw["prompt_cache"] = (seg, pre.shape[1])
                return jgen.beam_search(jp, prompt, cfg, n, **kw)
            s, sc = jax.jit(run)(jp, jnp.asarray(prompt, jnp.int32),
                                 None if pre is None else jnp.asarray(pre))
            self.memo[key] = (np.asarray(s), np.asarray(sc))
        return self.memo[key]

    def beam(self, prompt, n, params=None, **kw):
        if "prompt_cache" in kw:
            pre = kw["prompt_cache"]
            kw = dict(kw, prompt_cache=(tgen.prefill(
                self.p, pre, self.cfg, last_logits=False,
                kv_int8=kw.get("kv_int8", False), device="cpu")[0],
                pre.shape[1]))
        s, sc = tgen.beam_search(self.p if params is None else params,
                                 prompt, self.cfg, n, device="cpu", **kw)
        assert s.dtype == torch.int32 and sc.dtype == torch.float32
        return s.numpy(), sc.numpy()


def _np_params(kw, seed):
    """Seeded numpy weights in the reference's tree layout."""
    cfg = ttfm.TransformerConfig(**kw)
    r = np.random.default_rng(seed)
    d, f, L, hd = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.head_dim

    def dense(*shape):
        return (r.standard_normal(shape) / np.sqrt(shape[1])).astype(
            np.float32)

    params = {
        "tok_emb": (r.standard_normal((cfg.vocab_size, d)) * 0.5
                    ).astype(np.float32),
        "ln_f_scale": np.ones(d, np.float32),
        "layers": {
            "ln1_scale": np.ones((L, d), np.float32),
            "ln2_scale": np.ones((L, d), np.float32),
            "attn": {"wq": dense(L, d, cfg.n_heads, hd),
                     "wk": dense(L, d, cfg.kv_heads, hd),
                     "wv": dense(L, d, cfg.kv_heads, hd),
                     "wo": dense(L, cfg.n_heads * hd, d).reshape(
                         L, cfg.n_heads, hd, d)},
            "ffn": {"w1": dense(L, d, f), "w2": dense(L, f, d)},
        },
    }
    if not cfg.rope:
        params["pos_emb"] = (r.standard_normal((cfg.max_len, d)) * 0.02
                             ).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, kw in CFGS.items():
        # The rolling pair shares its weights (max_len sizes no weight
        # of a rope config).
        src = "roll_big" if name == "roll" else name
        out[name] = Model(kw, _np_params(CFGS[src], SEEDS[src]))
    return out


@pytest.fixture(scope="module")
def trained():
    """The plain config trained (25 adam steps on constant rows) to emit
    token 9 forever: with eos_token=9 the best beam finishes at once."""
    cfg = ttfm.TransformerConfig(**BASE)
    params = params_from_numpy(_np_params(BASE, 0), "cpu")
    opt = Optimizer("adam", 1e-2)
    step = ttfm.make_train_step(cfg, opt)
    carry = (params, opt.init(params))
    data = torch.full((16, 16), 9, dtype=torch.long)
    for _ in range(25):
        carry, _ = step(carry, data)
    return Model(BASE, params_to_numpy(carry[0]))


def prompts(rng, b, p):
    return rng.integers(0, 64, (b, p)).astype(np.int32)


def assert_beams(out, ref, tol=SCORE_TOL):
    np.testing.assert_array_equal(out[0], ref[0])
    np.testing.assert_allclose(out[1], ref[1], **tol)


def _seq_logprob(m, seq, start):
    """Sum of log p(seq[t] | seq[:t]) for t >= start (the port's forward)."""
    with torch.no_grad():
        logits, _ = ttfm.apply(m.p, torch.as_tensor(seq[None, :-1]).long(),
                               m.cfg, device="cpu")
    logp = torch.log_softmax(logits, -1)[0]
    tgt = torch.as_tensor(seq[1:]).long()
    per = logp.gather(1, tgt[:, None])[:, 0].numpy()
    return float(per[start - 1:].sum())


# ------------------------------------------------------------ the paths


@pytest.mark.parametrize("name,pos", [("gqa", 9), ("win", 12), ("win", 3)])
@pytest.mark.parametrize("kv_int8", [False, True])
def test_ancestry_attention_logits_match_jax(models, rng, name, pos,
                                             kv_int8):
    """One decode step under a random ancestor map: the port's
    ``_decode_step(beam_anc=)`` logits against JAX's, full-cache and
    windowed (ring band mask), int8 scales included."""
    m = models[name]
    b, w = 2, 3
    cache_np = {}
    shape = (m.cfg.n_layers, b * w, m.cfg.max_len, m.cfg.kv_heads,
             m.cfg.head_dim)
    if kv_int8:
        cache_np["k"] = rng.integers(-127, 128, shape).astype(np.int8)
        cache_np["v"] = rng.integers(-127, 128, shape).astype(np.int8)
        cache_np["k_scale"] = rng.uniform(0.001, 0.02, shape[:-1]
                                          ).astype(np.float32)
        cache_np["v_scale"] = rng.uniform(0.001, 0.02, shape[:-1]
                                          ).astype(np.float32)
    else:
        cache_np["k"] = rng.normal(size=shape).astype(np.float32)
        cache_np["v"] = rng.normal(size=shape).astype(np.float32)
    anc = rng.integers(0, w, (b, w, m.cfg.max_len)).astype(np.int32)
    toks = rng.integers(0, 64, (b * w,)).astype(np.int32)
    jl, _ = jax.jit(lambda p, c, t, a: jgen._decode_step(
        p, c, t, pos, m.jcfg, beam_anc=(a, w)))(
        m.jp, cache_np, jnp.asarray(toks), jnp.asarray(anc))
    cache = {k: torch.from_numpy(v.copy()) for k, v in cache_np.items()}
    with torch.no_grad():
        tl, _ = tgen._decode_step(m.p, cache, torch.from_numpy(toks).long(),
                                  pos, m.cfg,
                                  beam_anc=(torch.from_numpy(anc).long(), w))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4,
                               rtol=2e-4)


def test_beam_anc_validation(models):
    m = models["plain"]
    cache = tgen.init_cache(m.cfg, 2, device="cpu")
    anc = (torch.zeros((1, 2, 16), dtype=torch.long), 2)
    with pytest.raises(ValueError, match="T == 1"):
        tgen._decode_chunk(m.p, cache, torch.zeros((2, 2), dtype=torch.long),
                           torch.zeros(2, dtype=torch.long), m.cfg,
                           uniform_pos=True, beam_anc=anc)
    with pytest.raises(ValueError, match="pad_lens"):
        tgen._decode_step(m.p, cache, torch.zeros(2, dtype=torch.long), 3,
                          m.cfg, pad_lens=torch.zeros(2, dtype=torch.long),
                          beam_anc=anc)


def test_top_w_ties_take_the_lower_index(models, rng):
    """``_top_w`` is ``lax.top_k``, ties included; and on an all-zero
    model every candidate ties, so JAX's and the port's beams can agree
    only by the same rule."""
    x = np.array([[0.5, 1.0, 1.0, 0.5, 1.0, -1.0, 1.0]], np.float32)
    v, i = tgen._top_w(torch.from_numpy(x), 4)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 4)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    m = models["plain"]
    zero = jax.tree.map(np.zeros_like, m.jp)
    zm = Model(BASE, zero)
    prompt = prompts(rng, 2, 4)
    out = zm.beam(prompt, 5, beam_width=3)
    assert_beams(out, zm.jbeam(prompt, 5, beam_width=3))
    # Every step's top 3 are beam 0's tokens 0, 1, 2 (the lowest flat
    # indices of W x V tied candidates).
    np.testing.assert_array_equal(out[0][:, :, 4:-1], 0)
    np.testing.assert_array_equal(out[0][:, :, -1], [[0, 1, 2]] * 2)


# ----------------------------------------------- the reference's tests


def test_beam_width_1_equals_greedy(models, rng):
    m = models["plain"]
    prompt = prompts(rng, 3, 5)
    seqs, _ = m.beam(prompt, 8, beam_width=1)
    greedy = tgen.generate(m.p, prompt, m.cfg, 8, device="cpu").numpy()
    np.testing.assert_array_equal(seqs[:, 0], greedy)
    assert_beams((seqs, _), m.jbeam(prompt, 8, beam_width=1))


def test_beam_scores_match_rescoring_and_beat_greedy(models, rng):
    m = models["plain"]
    prompt = prompts(rng, 2, 4)
    seqs, scores = m.beam(prompt, 6, beam_width=4)
    assert_beams((seqs, scores), m.jbeam(prompt, 6, beam_width=4))
    greedy = tgen.generate(m.p, prompt, m.cfg, 6, device="cpu").numpy()
    for row in range(2):
        np.testing.assert_allclose(scores[row, 0],
                                   _seq_logprob(m, seqs[row, 0], 4),
                                   atol=1e-3, rtol=1e-4)
        assert scores[row, 0] >= _seq_logprob(m, greedy[row], 4) - 1e-4
        assert np.all(np.diff(scores[row]) <= 1e-6)


def test_beam_eos_freezes_score(models, rng):
    m = models["rope"]
    prompt = prompts(rng, 2, 3)
    out = m.beam(prompt, 8, beam_width=3, eos_token=5)
    assert_beams(out, m.jbeam(prompt, 8, beam_width=3, eos_token=5))
    gen = out[0][:, :, 3:]
    for row in gen.reshape(-1, gen.shape[-1]):
        hits = np.nonzero(row == 5)[0]
        if hits.size:
            assert np.all(row[hits[0]:] == 5), row


def test_beam_validation_and_quantized(models, rng):
    m = models["plain"]
    prompt = prompts(rng, 2, 4)
    with pytest.raises(ValueError, match="beam_width"):
        m.beam(prompt, 4, beam_width=0)
    with pytest.raises(ValueError, match="max_new_tokens"):
        m.beam(prompt, 0, beam_width=2)
    with pytest.raises(ValueError, match="max_len"):
        m.beam(prompt, 64, beam_width=2)
    q = params_from_numpy(jax.tree.map(np.asarray,
                                       jquant.quantize_params(m.jp)), "cpu")
    with pytest.raises(ValueError, match="use_prefill"):
        m.beam(prompt, 4, params=q, beam_width=2, use_prefill=True)
    # The int8 tree (the reference's quantized weights, carried across)
    # decodes on the sequential prompt path: JAX's beams.
    out = m.beam(prompt, 4, params=q, beam_width=2)
    assert out[0].shape == (2, 2, 8)
    assert_beams(out, m.jbeam(prompt, 4, quantized=True, beam_width=2))
    with pytest.raises(ValueError, match="on cpu"):
        tgen.beam_search(m.p, prompt, m.cfg, 4, device="meta")


def test_beam_prefill_matches_sequential(models, rng):
    m = models["rope"]
    prompt = prompts(rng, 2, 6)
    s1 = m.beam(prompt, 5, beam_width=3, use_prefill=True)
    s2 = m.beam(prompt, 5, beam_width=3, use_prefill=False)
    assert_beams(s1, s2)
    assert_beams(s1, m.jbeam(prompt, 5, beam_width=3, use_prefill=True))


def test_beam_frozen_score_is_length_invariant(trained):
    prompt = np.full((2, 3), 9, np.int32)
    short = trained.beam(prompt, 2, beam_width=2, eos_token=9)
    long = trained.beam(prompt, 10, beam_width=2, eos_token=9)
    np.testing.assert_allclose(long[1][:, 0], short[1][:, 0], rtol=1e-5,
                               atol=1e-6)
    assert_beams(long, trained.jbeam(prompt, 10, beam_width=2, eos_token=9))


def test_beam_length_penalty(models, rng):
    """alpha 0 is the raw ordering; alpha > 0 re-ranks by the GNMT
    normalization and returns the normalized scores."""
    m = models["plain"]
    prompt = prompts(rng, 2, 4)
    s0 = m.beam(prompt, 6, beam_width=4)
    assert_beams(m.beam(prompt, 6, beam_width=4, length_penalty=0.0), s0)
    s2 = m.beam(prompt, 6, beam_width=4, length_penalty=1.0)
    np.testing.assert_array_equal(s2[0], s0[0])
    np.testing.assert_allclose(s2[1], s0[1] / ((5.0 + 6.0) / 6.0),
                               rtol=1e-5)
    assert np.all(np.diff(s2[1], axis=1) <= 1e-6)
    assert_beams(s2, m.jbeam(prompt, 6, beam_width=4, length_penalty=1.0))
    with pytest.raises(ValueError, match="length_penalty"):
        m.beam(prompt, 4, beam_width=2, length_penalty=-1.0)


def test_beam_length_penalty_frozen_lengths(trained):
    """Frozen (eos) beams stop accumulating length: the best beam's
    normalized score uses n = 1."""
    prompt = np.full((1, 3), 9, np.int32)
    raw = trained.beam(prompt, 8, beam_width=2, eos_token=9)
    norm = trained.beam(prompt, 8, beam_width=2, eos_token=9,
                        length_penalty=1.0)
    np.testing.assert_allclose(norm[1][0, 0], raw[1][0, 0] / 1.0, rtol=1e-5)
    assert_beams(norm, trained.jbeam(prompt, 8, beam_width=2, eos_token=9,
                                     length_penalty=1.0))


@pytest.mark.parametrize("kw", [{}, dict(eos_token=7),
                                dict(beam_impl="physical")],
                         ids=["ancestry", "eos", "physical"])
def test_rolling_beam_matches_large_cache(models, rng, kw):
    """Beams past max_len on the ring (slots reused; a reused slot's
    ancestry retires in the step that overwrites it) equal a big-cache
    run of the same weights, and JAX's rolling beams."""
    big, small = models["roll_big"], models["roll"]
    prompt = prompts(np.random.default_rng(5), 2, 5)
    rolled = small.beam(prompt, 30, beam_width=3, **kw)
    assert_beams(rolled, big.beam(prompt, 30, beam_width=3, **kw))
    assert_beams(rolled, small.jbeam(prompt, 30, beam_width=3, **kw),
                 tol=dict(atol=1e-4, rtol=1e-5))


def test_beam_search_windowed_cfg(models, rng):
    """Width 1 on a windowed config == windowed greedy."""
    m = models["win4"]
    prompt = prompts(rng, 2, 4)
    seqs, sc = m.beam(prompt, 6, beam_width=1)
    np.testing.assert_array_equal(
        seqs[:, 0], tgen.generate(m.p, prompt, m.cfg, 6,
                                  device="cpu").numpy())
    assert_beams((seqs, sc), m.jbeam(prompt, 6, beam_width=1))


@pytest.mark.parametrize("kw", [{}, dict(eos_token=7),
                                dict(length_penalty=0.8)],
                         ids=["plain", "eos", "length_penalty"])
def test_beam_ancestry_equals_physical_reorder(models, kw):
    """GQA + rope: the ancestry path returns the physical gather's
    hypotheses and scores, and JAX's."""
    m = models["gqa"]
    prompt = prompts(np.random.default_rng(6), 3, 5)
    anc = m.beam(prompt, 10, beam_width=3, **kw)
    assert_beams(anc, m.beam(prompt, 10, beam_width=3, beam_impl="physical",
                             **kw))
    assert_beams(anc, m.jbeam(prompt, 10, beam_width=3, **kw))


def test_beam_impl_knob_and_ancestry_size_guard(models, rng, monkeypatch):
    m = models["plain"]
    prompt = prompts(rng, 2, 4)
    sa = m.beam(prompt, 5, beam_width=3, beam_impl="ancestry")
    sp = m.beam(prompt, 5, beam_width=3, beam_impl="physical")
    assert_beams(sa, sp)
    assert_beams(m.beam(prompt, 5, beam_width=3, _force_physical=True), sp)
    est = tgen._ancestry_score_bytes(2, 3, m.cfg)
    assert est == jgen._ancestry_score_bytes(2, 3, m.jcfg)
    assert tgen.ANCESTRY_SCORE_LIMIT_BYTES == jgen.ANCESTRY_SCORE_LIMIT_BYTES
    monkeypatch.setattr(tgen, "ANCESTRY_SCORE_LIMIT_BYTES", est // 2)
    with pytest.warns(UserWarning, match="falling back to the physical"):
        sf = m.beam(prompt, 5, beam_width=3)
    assert_beams(sf, sp)
    with pytest.raises(ValueError, match="over the"):
        m.beam(prompt, 5, beam_width=3, beam_impl="ancestry")
    monkeypatch.undo()
    with pytest.raises(ValueError, match="beam_impl must be"):
        m.beam(prompt, 5, beam_width=3, beam_impl="fast")


@pytest.mark.parametrize("kw", [{}, dict(eos_token=7),
                                dict(length_penalty=0.6)],
                         ids=["plain", "eos", "length_penalty"])
def test_beam_windowed_ancestry_equals_physical(models, kw):
    m = models["win"]
    prompt = prompts(np.random.default_rng(7), 3, 5)
    sa = m.beam(prompt, 10, beam_width=3, beam_impl="ancestry", **kw)
    assert_beams(sa, m.beam(prompt, 10, beam_width=3, beam_impl="physical",
                            **kw))
    assert_beams(sa, m.jbeam(prompt, 10, beam_width=3, **kw))


def test_kv_int8_beam_ancestry_equals_physical(models, rng):
    m = models["plain"]
    prompt = prompts(rng, 2, 4)
    sa = m.beam(prompt, 6, beam_width=3, kv_int8=True)
    assert_beams(sa, m.beam(prompt, 6, beam_width=3, kv_int8=True,
                            beam_impl="physical"))
    assert_beams(sa, m.jbeam(prompt, 6, beam_width=3, kv_int8=True))


def test_kv_int8_rolling_beam_matches_large_cache(models, rng):
    big, small = models["roll_big"], models["roll"]
    prompt = prompts(rng, 2, 5)
    kw = dict(beam_width=3, kv_int8=True, use_prefill=False)
    ref = big.beam(prompt, 20, **kw)
    for impl in ("ancestry", "physical"):
        assert_beams(small.beam(prompt, 20, beam_impl=impl, **kw), ref,
                     tol=dict(atol=1e-4, rtol=1e-4))
    assert_beams(ref, big.jbeam(prompt, 20, **kw),
                 tol=dict(atol=1e-4, rtol=1e-4))


@pytest.mark.parametrize("kw", [{}, dict(kv_int8=True),
                                dict(_force_physical=True),
                                dict(eos_token=5)],
                         ids=["plain", "kv_int8", "physical", "eos"])
def test_beam_prompt_cache_matches_full_prompt(models, rng, kw):
    """Beaming past a prefilled prefix returns the hypotheses of beaming
    the concatenated prompt (scores to the reference's 1e-2: the two
    prompt passes reduce attention in different orders), and JAX's
    prompt-cache beams."""
    m = models["rope"]
    prefix, tail = prompts(rng, 2, 4), prompts(rng, 2, 3)
    full = np.concatenate([prefix, tail], axis=1)
    ref = m.beam(full, 6, beam_width=3, **kw)
    out = m.beam(tail, 6, beam_width=3, prompt_cache=prefix, **kw)
    np.testing.assert_array_equal(out[0], ref[0][:, :, 4:])
    np.testing.assert_allclose(out[1], ref[1], atol=1e-2, rtol=1e-4)
    assert_beams(out, m.jbeam(tail, 6, beam_width=3, prompt_cache=prefix,
                              **kw))
    with pytest.raises(ValueError, match="no effect with prompt_cache"):
        m.beam(tail, 4, beam_width=2, prompt_cache=prefix, use_prefill=True)


def test_beam_prompt_of_one_token_and_width_bounds(models, rng):
    """A 1-token prompt (no prompt pass), and the widest legal beam."""
    m = models["rope"]
    prompt = prompts(rng, 2, 1)
    out = m.beam(prompt, 4, beam_width=3)
    assert_beams(out, m.jbeam(prompt, 4, beam_width=3))
    wide = m.beam(prompts(rng, 1, 3), 2, beam_width=64)
    assert wide[0].shape == (1, 64, 5)
    assert len({tuple(r) for r in wide[0][0]}) == 64

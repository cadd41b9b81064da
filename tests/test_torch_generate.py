"""Port decoding vs ``distkeras_tpu.models.generate``.

Same weights and prompts on both sides: prefill caches and logits are
held at 1e-4 (f32), greedy tokens must be exactly equal.  Sampling
cannot match JAX's PRNG, so it is held to its own contract
(deterministic per seed, top_k=1 == greedy); the sampling filters are
compared with JAX on the same logits.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import generate as jgen
from distkeras_tpu.models import transformer as jtfm
from distkeras_tpu.utils.serialization import save_lm
from distkeras_tpu_torch.models import generate as tgen
from distkeras_tpu_torch.models import transformer as ttfm
from distkeras_tpu_torch.utils.serialization import load_lm, params_from_numpy

BASE = dict(vocab_size=128, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_len=48, rope=True)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def models(**extra):
    kw = {**BASE, **extra}
    jcfg = jtfm.TransformerConfig(**kw)
    params = jax.tree.map(np.asarray,
                          jtfm.init_params(jax.random.key(1), jcfg))
    return jcfg, ttfm.TransformerConfig(**kw), params, \
        params_from_numpy(params, "cpu")


def test_prefill_cache_and_logits_match_jax(rng):
    jcfg, tcfg, jp, tp = models(n_kv_heads=2)
    prompt = rng.integers(0, 128, (2, 12)).astype(np.int32)
    jcache, jlast = jgen.prefill(jp, prompt, jcfg)
    tcache, tlast = tgen.prefill(tp, prompt, tcfg, device="cpu")
    assert tcache["k"].shape == (2, 2, 48, 2, 8)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), atol=1e-4)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=1e-4)


@pytest.mark.parametrize("extra,pad", [
    (dict(), False),
    (dict(attention_window=6), False),
    (dict(rope=False), True),
    (dict(attention_window=6), True),
], ids=["plain", "window", "learned-pad", "window-pad"])
def test_decode_step_logits_match_jax(rng, extra, pad):
    """Three cached steps from a prefilled cache (window: the ring band;
    pad: the ragged pad mask and per-row position ids)."""
    jcfg, tcfg, jp, tp = models(**extra)
    prompt = rng.integers(0, 128, (2, 10)).astype(np.int32)
    jcache, _ = jgen.prefill(jp, prompt, jcfg)
    tcache, _ = tgen.prefill(tp, prompt, tcfg, device="cpu")
    jpad = jnp.asarray([0, 3]) if pad else None
    tpad = torch.tensor([0, 3]) if pad else None
    for pos in (10, 11, 12):
        tok = rng.integers(0, 128, (2,)).astype(np.int32)
        jl, jcache = jgen._decode_step(jp, jcache, jnp.asarray(tok), pos,
                                       jcfg, jpad)
        tl, tcache = tgen._decode_step(tp, tcache, torch.from_numpy(tok).long(),
                                       pos, tcfg, tpad)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               atol=1e-4)


@pytest.mark.parametrize("extra,kw", [
    (dict(), dict(use_prefill=True)),
    (dict(), dict(use_prefill=False)),
    (dict(n_kv_heads=1, attention_window=5), dict()),
    (dict(rope=False), dict(prompt_lengths=[7, 4])),
    (dict(attention_window=8, max_len=16), dict(max_new_tokens=14)),
], ids=["prefill", "sequential", "mqa-window", "ragged", "rolling"])
def test_greedy_generate_tokens_equal_jax(rng, extra, kw):
    jcfg, tcfg, jp, tp = models(**extra)
    kw = {"max_new_tokens": 10, **kw}
    prompt = rng.integers(0, 128, (2, 7)).astype(np.int32)
    ref = np.asarray(jgen.generate(jp, prompt, jcfg, **kw))
    out = tgen.generate(tp, prompt, tcfg, device="cpu", **kw)
    assert out.dtype == torch.int32 and out.shape == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)


BF16_ULPS = 4


def bf16_bound(logits):
    """The bf16 contract's bound: BF16_ULPS bf16 ulps of max |logit|
    (a bf16 ulp at x is 2 ** (floor(log2 x) - 7))."""
    top = float(np.abs(logits).max())
    return BF16_ULPS * 2.0 ** (np.floor(np.log2(top)) - 7)


def test_bf16_contract_with_jax(rng):
    """bf16 weights in both packages: the two round differently (each is
    about as far from an f32 run on the same weights), so the contract
    is a bound, not equality.  Prefill and apply logits lie within
    BF16_ULPS bf16 ulps of max |logit| of JAX's; on JAX's own greedy
    tokens the port picks JAX's token at every step whose top-2 gap in
    JAX's logits exceeds that bound, and its own greedy ``generate``
    equals JAX's in each row up to the first step that does not."""
    jcfg, tcfg, p, _ = models(dtype="bfloat16")
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    tp = params_from_numpy(p, "cpu", dtype=torch.bfloat16)
    prompt = rng.integers(0, 128, (3, 7)).astype(np.int32)
    _, jlast = jgen.prefill(jp, prompt, jcfg)
    _, tlast = tgen.prefill(tp, prompt, tcfg, device="cpu")
    jlast = np.asarray(jlast, np.float32)
    assert np.abs(tlast.float().numpy() - jlast).max() <= bf16_bound(jlast)
    n = 10
    ref = np.asarray(jgen.generate(jp, prompt, jcfg, n))
    out = tgen.generate(tp, prompt, tcfg, n, device="cpu").numpy()
    jl, _ = jtfm.apply(jp, ref, jcfg)
    jl = np.asarray(jl, np.float32)
    tl, _ = ttfm.apply(tp, ref, tcfg, device="cpu")
    tl = tl.float().numpy()
    bound = bf16_bound(jl)
    assert np.abs(tl - jl).max() <= bound
    steps = jl[:, 6:6 + n]  # the logits that chose ref[:, 7:]
    top2 = np.sort(steps, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > bound
    assert clear.sum() >= n  # the contract binds somewhere
    np.testing.assert_array_equal(
        np.where(clear, tl[:, 6:6 + n].argmax(-1), 0),
        np.where(clear, ref[:, 7:], 0))
    for row in range(len(prompt)):
        upto = n if clear[row].all() else int(np.argmin(clear[row]))
        np.testing.assert_array_equal(out[row, 7:7 + upto],
                                      ref[row, 7:7 + upto])


def test_sampling_filters_match_jax(rng):
    logits = rng.normal(size=(4, 128)).astype(np.float32) * 3
    tl = torch.from_numpy(logits)
    pairs = [
        (jgen.top_k_mask(logits, 5, exact=True), tgen.top_k_mask(tl, 5)),
        (jgen.top_p_mask(logits, 0.7), tgen.top_p_mask(tl, 0.7)),
        (jgen.min_p_mask(logits, 0.05), tgen.min_p_mask(tl, 0.05)),
    ]
    rows = np.array([[0.3], [0.95], [0.9], [0.5]], np.float32)
    pairs.append((jgen.top_p_mask(logits, rows),
                  tgen.top_p_mask(tl, torch.from_numpy(rows))))
    for ref, out in pairs:
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="min_p"):
        tgen.min_p_mask(tl, -0.1)
    with pytest.raises(ValueError, match="top_p"):
        tgen.top_p_mask(tl, 0.0)


def test_sampled_generate_deterministic_and_topk1_is_greedy(rng):
    _, tcfg, _, tp = models()
    prompt = rng.integers(0, 128, (2, 6))
    kw = dict(max_new_tokens=8, device="cpu")
    a = tgen.generate(tp, prompt, tcfg, temperature=1.0, seed=3, top_p=0.9,
                      min_p=0.01, **kw)
    b = tgen.generate(tp, prompt, tcfg, temperature=1.0, seed=3, top_p=0.9,
                      min_p=0.01, **kw)
    assert torch.equal(a, b)
    seq = tgen.generate(tp, prompt, tcfg, temperature=1.0, seed=3,
                        top_p=0.9, min_p=0.01, use_prefill=False, **kw)
    assert torch.equal(a, seq)  # position-keyed streams: paths agree
    greedy = tgen.generate(tp, prompt, tcfg, **kw)
    top1 = tgen.generate(tp, prompt, tcfg, temperature=0.7, seed=5,
                         top_k=1, **kw)
    assert torch.equal(top1, greedy)
    eos = int(greedy[0, 7])
    sticky = tgen.generate(tp, prompt, tcfg, eos_token=eos, **kw)
    assert (sticky[0, 7:] == eos).all()
    with pytest.raises(ValueError, match="seed"):
        tgen.generate(tp, prompt, tcfg, temperature=1.0, **kw)
    with pytest.raises(ValueError, match="need temperature"):
        tgen.generate(tp, prompt, tcfg, top_k=3, **kw)
    q8 = tgen.generate(tp, prompt, tcfg, temperature=1.0, seed=3,
                       kv_int8=True, **kw)
    assert torch.equal(q8, tgen.generate(tp, prompt, tcfg, temperature=1.0,
                                         seed=3, kv_int8=True, **kw))
    with pytest.raises(ValueError, match="prompt_cache"):
        tgen.generate(tp, prompt, tcfg, prompt_cache=({}, 1), **kw)
    # beam_search is ported (tests/test_torch_beam.py holds it to JAX's):
    # width 1 is greedy decoding.
    beams, _ = tgen.beam_search(tp, prompt, tcfg, 8, beam_width=1,
                                device="cpu")
    assert torch.equal(beams[:, 0], greedy)


def test_save_lm_to_load_lm_round_trip(rng, tmp_path):
    jcfg, _, jp, _ = models(n_kv_heads=2)
    path = str(tmp_path / "lm.npz")
    save_lm(path, jp, jcfg)
    tp, tcfg = load_lm(path, device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    tokens = rng.integers(0, 128, (2, 9)).astype(np.int32)
    ref, _ = jtfm.apply(jp, tokens, jcfg)
    out, _ = ttfm.apply(tp, tokens, tcfg, device="cpu")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_entry_points_without_device_raise_on_cpu_only_machine(
        rng, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg, jp, tp = models()
    prompt = rng.integers(0, 128, (1, 4))
    for call in (lambda: tgen.generate(tp, prompt, tcfg, 2),
                 lambda: tgen.prefill(tp, prompt, tcfg),
                 lambda: ttfm.apply(tp, prompt, tcfg),
                 lambda: ttfm.init_params(0, tcfg),
                 lambda: params_from_numpy(jp, None)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.time_limit(180)  # above its child's timeout=120
def test_port_imports_neither_jax_nor_reference_package():
    """Every module of the port imports, and none of them pulls in JAX,
    the reference package, or Keras / optax / flax (the card's machine
    has none of them)."""
    code = (
        "import sys, pkgutil, importlib, distkeras_tpu_torch as p\n"
        "names = [m.name for m in\n"
        "         pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "for name in ('trainers.elastic', 'native', 'data.tokenizer',\n"
        "             'data.prefetch', 'serving.lanes',\n"
        "             'serving.speculative', 'models.speculative', 'obs',\n"
        "             'utils.locks', 'models.quant', 'models.lora',\n"
        "             'parallel.exchange', 'parallel.async_tier',\n"
        "             'trainers.async_dp', 'deploy'):\n"
        "    assert 'distkeras_tpu_torch.' + name in names, names\n"
        "from distkeras_tpu_torch.trainers.lm import LoRATrainer\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'distkeras_tpu',\n"
        "                                    'keras', 'optax', 'flax'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)

"""The port's MoE against the JAX package (CPU, f32, E = 4 experts).

- training forward (capacity dispatch, with drops forced by a low
  ``capacity_factor``): logits at 1e-5 and the aux loss at 1e-6, top-1
  and top-2; ``moe_dense_routing`` logits and ``lm_nll`` at 1e-5;
- gradients of ``lm_loss`` per leaf at 1e-5, remat on and off;
  ``make_train_step`` (sgd) losses and params after 3 steps at 1e-5;
- greedy tokens equal JAX's exactly through ``generate`` with and
  without prefill (plain, rope + GQA, rolling window), the per-row
  ``_decode_chunk`` logits at 2e-4 (the JAX tests' own chunk tolerance),
  and ``ContinuousBatcher`` requests equal JAX's solo ``generate``;
- the top-k tie rule (lower expert index first, as ``jax.lax.top_k``)
  and the ``moe_top_k`` validation.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distkeras_tpu.models import generate as jgen
from distkeras_tpu.models import transformer as jtfm
from distkeras_tpu_torch.models import generate as tgen
from distkeras_tpu_torch.models import transformer as ttfm
from distkeras_tpu_torch.serving import ContinuousBatcher
from distkeras_tpu_torch.trainers.optim import Optimizer
from distkeras_tpu_torch.utils.serialization import (params_from_numpy,
                                                     params_to_numpy)

BASE = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
            max_len=32, num_experts=4)
# 32 tokens into E * cap slots: cap = int(0.5 * k * 32 / 4) holds half
# of the k * 32 assignments, so capacity drops are certain.
DROP = dict(capacity_factor=0.5)
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
def tokens():
    return np.random.default_rng(0).integers(0, 64, (2, 17)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_forward(tokens):
    """JAX's training forward, aux, dense-routing forward and lm_nll, and
    its lm_loss and gradients, per top-k, computed once (jitted)."""
    apply = jax.jit(jtfm.apply, static_argnums=2,
                    static_argnames="moe_dense_routing")
    nll = jax.jit(jtfm.lm_nll, static_argnums=2,
                  static_argnames="moe_dense_routing")
    loss_grad = jax.jit(jax.value_and_grad(jtfm.lm_loss), static_argnums=2)
    out = {}
    for k in (1, 2):
        jcfg, jp, _, _ = pair(moe_top_k=k, **DROP)
        logits, aux = apply(jp, tokens[:, :-1], jcfg)
        dense, daux = apply(jp, tokens[:, :-1], jcfg, moe_dense_routing=True)
        loss, grads = loss_grad(jp, tokens, jcfg)
        out[k] = dict(
            logits=np.asarray(logits), aux=float(aux),
            dense=np.asarray(dense), dense_aux=float(daux),
            nll=float(nll(jp, tokens, jcfg)),
            dense_nll=float(nll(jp, tokens, jcfg, moe_dense_routing=True)),
            loss=float(loss), grads=jax.tree.map(np.asarray, grads))
    return out


def assert_tree_close(got, ref, **tol):
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    for path, g in jax.tree_util.tree_flatten_with_path(got)[0]:
        np.testing.assert_allclose(g, flat_ref[path], **tol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("k", [1, 2])
def test_capacity_forward_and_aux_match_jax_with_drops(jax_forward, tokens,
                                                       k):
    _, _, cfg, p = pair(moe_top_k=k, **DROP)
    n = tokens[:, :-1].size
    cap = int(cfg.capacity_factor * k * n / cfg.num_experts)
    assert cfg.num_experts * cap < k * n  # assignments must drop
    ref = jax_forward[k]
    logits, aux = ttfm.apply(p, tokens[:, :-1], cfg, device="cpu")
    np.testing.assert_allclose(logits.numpy(), ref["logits"], **TOL)
    np.testing.assert_allclose(float(aux), ref["aux"], atol=1e-6, rtol=0)
    dense, daux = ttfm.apply(p, tokens[:, :-1], cfg, moe_dense_routing=True,
                             device="cpu")
    np.testing.assert_allclose(dense.numpy(), ref["dense"], **TOL)
    assert float(daux) == ref["dense_aux"] == 0.0
    # The drops are real: capacity routing differs from dense routing.
    assert np.abs(ref["logits"] - ref["dense"]).max() > 1e-3
    for routing, want in ((False, ref["nll"]), (True, ref["dense_nll"])):
        got = ttfm.lm_nll(p, tokens, cfg, moe_dense_routing=routing)
        np.testing.assert_allclose(float(got), want, **TOL)


@pytest.mark.parametrize("k,remat", [(1, False), (2, False), (2, True)])
def test_lm_loss_gradients_match_jax(jax_forward, tokens, k, remat):
    """Autograd through the index dispatch against jax.grad of the
    one-hot einsums (the aux loss included); remat recomputes each MoE
    block in the backward with the same result."""
    _, _, cfg, p = pair(moe_top_k=k, **DROP)
    cfg = dataclasses.replace(cfg, remat=remat)
    for _, leaf in ttfm.named_leaves(p):
        leaf.requires_grad_()
    loss = ttfm.lm_loss(p, tokens, cfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), jax_forward[k]["loss"],
                               **TOL)
    grads = {name: leaf.grad.numpy() for name, leaf in ttfm.named_leaves(p)}
    ref = {jax.tree_util.keystr(path, simple=True, separator="/"): g
           for path, g in jax.tree_util.tree_flatten_with_path(
               jax_forward[k]["grads"])[0]}
    assert set(grads) == set(ref)
    for name, g in grads.items():
        np.testing.assert_allclose(g, ref[name], atol=1e-5, rtol=1e-4,
                                   err_msg=name)


def test_train_step_three_sgd_steps_match_jax(tokens):
    jcfg, jp, cfg, p = pair(seed=2, moe_top_k=2, **DROP)
    batches = np.random.default_rng(1).integers(0, 64, (3, 2, 17))
    jstep = jax.jit(jtfm.make_train_step(jcfg, optax.sgd(0.1)))
    jcarry = (jp, optax.sgd(0.1).init(jp))
    opt = Optimizer("sgd", 0.1)
    step = ttfm.make_train_step(cfg, opt)
    carry = (p, opt.init(p))
    for b in batches:
        jcarry, jloss = jstep(jcarry, jnp.asarray(b, jnp.int32))
        carry, loss = step(carry, b)
        np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    assert_tree_close(params_to_numpy(carry[0]),
                      jax.tree.map(np.asarray, jcarry[0]), **TOL)


@pytest.mark.parametrize("kw,n", [(dict(moe_top_k=1), 12),
                                  (dict(moe_top_k=2), 12),
                                  (dict(moe_top_k=2, **ROPE_GQA), 12),
                                  (dict(moe_top_k=2, **ROLL), 20)])
def test_greedy_generate_prefill_and_sequential_equal_jax(kw, n):
    """Prefill runs the capacity-free dense block, the decode the
    per-token expert gather; both paths give JAX's greedy tokens (the
    rolling window decodes past max_len)."""
    jcfg, jp, cfg, p = pair(seed=3, **kw)
    prompt = np.random.default_rng(4).integers(0, 64, (2, 7)).astype(
        np.int32)
    ref = np.asarray(jgen.generate(jp, prompt, jcfg, n))
    for use_prefill in (True, False):
        out = tgen.generate(p, prompt, cfg, n, use_prefill=use_prefill,
                            device="cpu")
        np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("t_len", [1, 3])
def test_decode_chunk_per_row_matches_jax(t_len):
    """Rows at different offsets in one chunk: T = 1 takes the expert
    gather (unmasked combine), T > 1 the dense block."""
    jcfg, jp, cfg, p = pair(seed=5, moe_top_k=2)
    rng = np.random.default_rng(6)
    warm = rng.integers(0, 64, (2, 6)).astype(np.int32)
    jc = jgen.init_cache(jcfg, 2)
    _, jc = jgen._decode_chunk(jp, jc, jnp.asarray(warm),
                               jnp.zeros(2, jnp.int32), jcfg)
    tc = tgen.init_cache(cfg, 2, device="cpu")
    tgen._decode_chunk(p, tc, torch.from_numpy(warm).long(),
                       torch.zeros(2, dtype=torch.long), cfg)
    for pos0 in ([6, 3], [6 + t_len, 5]):
        toks = rng.integers(0, 64, (2, t_len)).astype(np.int32)
        jl, jc = jgen._decode_chunk(jp, jc, jnp.asarray(toks),
                                    jnp.asarray(pos0, jnp.int32), jcfg)
        tl, tc = tgen._decode_chunk(p, tc, torch.from_numpy(toks).long(),
                                    torch.tensor(pos0), cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4,
                                   rtol=2e-4)


def test_engine_requests_equal_jax_solo():
    jcfg, jp, cfg, p = pair(seed=7, moe_top_k=2, rope=True)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 64, n).astype(np.int32) for n in (5, 9, 1)]
    eng = ContinuousBatcher(p, cfg, lanes=2, device="cpu")
    a = eng.submit(prompts[0], 8)
    eng.step(3)
    b = eng.submit(prompts[1], 6)
    outs = {}
    for name, lane, prompt in (("a", a, prompts[0]), ("b", b, prompts[1])):
        while lane in eng.running():
            eng.step(2)
        outs[name] = (eng.drain(lane), prompt, 8 if name == "a" else 6)
    c = eng.submit(prompts[2], 7)  # a reused lane, a 1-token prompt
    while c in eng.running():
        eng.step(1)
    outs["c"] = (eng.drain(c), prompts[2], 7)
    for name, (got, prompt, n) in outs.items():
        ref = np.asarray(jgen.generate(jp, prompt[None], jcfg, n))[0]
        np.testing.assert_array_equal(got, ref, err_msg=name)


def test_top_k_ties_pick_the_lower_expert_index():
    probs = np.array([[0.1, 0.3, 0.3, 0.3],
                      [0.4, 0.2, 0.4, 0.0],
                      [0.25, 0.25, 0.25, 0.25]], np.float32)
    for k in (1, 2, 3):
        cfg = ttfm.TransformerConfig(**BASE, moe_top_k=k)
        jcfg = jtfm.TransformerConfig(**BASE, moe_top_k=k)
        gates, expert = ttfm._moe_gates(torch.from_numpy(probs), cfg)
        jg, je = jtfm._moe_gates(jnp.asarray(probs), jcfg)
        np.testing.assert_array_equal(expert.numpy(), np.asarray(je))
        np.testing.assert_allclose(gates.numpy(), np.asarray(jg), atol=1e-7)
    assert expert[:, 0].tolist() == [1, 0, 0]


def test_moe_top_k_validation():
    for bad in (0, 5):
        with pytest.raises(ValueError, match="moe_top_k"):
            ttfm.init_params(0, ttfm.TransformerConfig(**BASE,
                                                       moe_top_k=bad),
                             device="cpu")

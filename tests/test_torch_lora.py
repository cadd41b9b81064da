"""The port's LoRA against the JAX package (CPU, f32).

- ``lora_merge`` of the same adapters equals JAX's at 1e-5; a zero-B
  merge is the base exactly; ``_validate``'s errors are JAX's;
- 3 ``make_train_step`` steps with ``make_lora_loss`` (sgd) give JAX's
  adapters and losses at 1e-5 (``optax.masked`` on the JAX side) and
  leave the base bit-identical; the masked optimizer holds state for the
  adapter leaves only and the base gets no gradient;
- ``LoRATrainer``: ``train`` returns ``lora_merge(base, adapters)``, its
  first loss is the base's (B starts at 0), the caller's base is
  untouched, grad accumulation equals the large batch (1e-5), and its
  rejections; the merged tree serves through ``generate`` (JAX's greedy
  tokens of the JAX-merged tree, exactly) and speculatively with its
  int8 copy as draft.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distkeras_tpu.models import generate as jgen
from distkeras_tpu.models import lora as jlora
from distkeras_tpu.models import transformer as jtfm
from distkeras_tpu_torch.models import generate as tgen
from distkeras_tpu_torch.models import lora as tlora
from distkeras_tpu_torch.models import transformer as ttfm
from distkeras_tpu_torch.models.quant import quantize_params
from distkeras_tpu_torch.models.speculative import speculative_generate
from distkeras_tpu_torch.trainers.lm import LoRATrainer
from distkeras_tpu_torch.trainers.optim import Optimizer
from distkeras_tpu_torch.utils.serialization import (lora_from_numpy,
                                                     params_from_numpy,
                                                     params_to_numpy)

KW = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
          max_len=32)
TOL = dict(atol=1e-5, rtol=1e-5)
TARGETS = ("wq", "wv", "wo", "w1")


@pytest.fixture(scope="module")
def m():
    jcfg = jtfm.TransformerConfig(**KW, rope=True, n_kv_heads=1)
    cfg = ttfm.TransformerConfig(**KW, rope=True, n_kv_heads=1)
    jp = jax.tree.map(np.asarray, jtfm.init_params(jax.random.key(0), jcfg))
    jl = jlora.LoRAConfig(rank=4, alpha=8.0, targets=TARGETS)
    tl = tlora.LoRAConfig(rank=4, alpha=8.0, targets=TARGETS)
    ad = jlora.lora_init(jax.random.key(1), jcfg, jl)
    # Trained-like adapters: B filled, so the delta is not zero.
    ad = jax.tree.map(np.asarray, jax.tree.map(
        lambda a: a + 0.05 * jax.random.normal(jax.random.key(2), a.shape),
        ad))
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, p=params_from_numpy(jp, "cpu"),
                jl=jl, tl=tl, jad=ad, ad=lora_from_numpy(ad, "cpu"))


def rows(seed, n, width=17):
    return np.random.default_rng(seed).integers(0, 64, (n, width)).astype(
        np.int32)


def test_merge_matches_jax_and_zero_b_is_identity(m):
    want = jax.tree.map(np.asarray, jlora.lora_merge(m["jp"], m["jad"],
                                                     m["jcfg"], m["jl"]))
    got = params_to_numpy(tlora.lora_merge(m["p"], m["ad"], m["cfg"],
                                           m["tl"]))
    for path, a in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node, a, **TOL,
                                   err_msg=jax.tree_util.keystr(path))
    fresh = tlora.lora_init(0, m["cfg"], m["tl"], device="cpu")
    same = tlora.lora_merge(m["p"], fresh, m["cfg"], m["tl"])
    for (name, a), (_, b) in zip(ttfm.named_leaves(same),
                                 ttfm.named_leaves(m["p"])):
        assert torch.equal(a, b), name
    # The init's shapes are JAX's.
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)
    assert shapes(fresh) == shapes(m["jad"])


def test_validation_errors_match_jax(m):
    moe_j = jtfm.TransformerConfig(**KW, num_experts=2)
    moe_t = ttfm.TransformerConfig(**KW, num_experts=2)
    cases = [(dict(targets=("wz",)), m["cfg"], m["jcfg"], "unknown"),
             (dict(targets=()), m["cfg"], m["jcfg"], "empty"),
             (dict(targets=("wq", "wq")), m["cfg"], m["jcfg"], "duplicate"),
             (dict(rank=0), m["cfg"], m["jcfg"], "rank"),
             (dict(targets=("w1",)), moe_t, moe_j, "dense-FFN")]
    for kw, cfg, jcfg, match in cases:
        with pytest.raises(ValueError, match=match):
            jlora._validate(jcfg, jlora.LoRAConfig(**kw))
        with pytest.raises(ValueError, match=match):
            tlora._validate(cfg, tlora.LoRAConfig(**kw))
    tlora._validate(moe_t, tlora.LoRAConfig(targets=("wq", "wo")))


def test_three_masked_steps_match_jax_and_freeze_the_base(m):
    batches = rows(3, 6).reshape(3, 2, 17)
    jopt = optax.masked(optax.sgd(0.1), jlora.lora_mask)
    jstep = jax.jit(jtfm.make_train_step(
        m["jcfg"], jopt, loss_fn=jlora.make_lora_loss(m["jcfg"], m["jl"])))
    jpacked = (m["jad"], m["jp"])
    jcarry = (jpacked, jopt.init(jpacked))
    base = params_from_numpy(m["jp"], "cpu")
    packed = (lora_from_numpy(m["jad"], "cpu"), base)
    opt = Optimizer("sgd", 0.1).masked(tlora.lora_mask)
    state = opt.init(packed)
    step = ttfm.make_train_step(m["cfg"], opt,
                                loss_fn=tlora.make_lora_loss(m["cfg"],
                                                             m["tl"]))
    carry = (packed, state)
    for b in batches:
        jcarry, jloss = jstep(jcarry, jnp.asarray(b))
        carry, loss = step(carry, b)
        np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    jad = jax.tree.map(np.asarray, jcarry[0][0])
    for path, a in jax.tree_util.tree_flatten_with_path(jad)[0]:
        got = carry[0][0][path[0].key][path[1].key][path[2].key]
        np.testing.assert_allclose(got.detach().numpy(), a, **TOL)
    assert carry[0][1] is base
    for name, leaf in ttfm.named_leaves(base):
        np.testing.assert_array_equal(
            leaf.numpy(), dict(ttfm.named_leaves(m["p"]))[name].numpy())
        assert leaf.grad is None and not leaf.requires_grad, name
    n_adapter = 2 * len(TARGETS)
    assert len(state.leaves) == n_adapter
    assert sum(len(g["params"]) for g in state.torch_opt.param_groups) == \
        n_adapter


def test_adamw_state_holds_adapter_leaves_only(m):
    packed = (tlora.lora_init(0, m["cfg"], m["tl"], device="cpu"),
              params_from_numpy(m["jp"], "cpu"))
    opt = Optimizer("adamw", 1e-3).masked(tlora.lora_mask)
    state = opt.init(packed)
    step = ttfm.make_train_step(m["cfg"], opt,
                                loss_fn=tlora.make_lora_loss(m["cfg"],
                                                             m["tl"]))
    step((packed, state), rows(4, 2))
    adapters = {id(t) for _, t in ttfm.named_leaves(packed[0])}
    assert {id(t) for t in state.torch_opt.state} == adapters
    moments = [v for st in state.torch_opt.state.values()
               for v in st.values() if torch.is_tensor(v) and v.dim()]
    assert len(moments) == 2 * len(adapters)
    with pytest.raises(ValueError, match="mask"):
        Optimizer("adamw", ema_decay=0.9).masked(tlora.lora_mask)


def test_lora_trainer_returns_merged_and_keeps_base(m):
    base = params_from_numpy(m["jp"], "cpu")
    keep = {n: t.clone() for n, t in ttfm.named_leaves(base)}
    data = rows(5, 8)
    tr = LoRATrainer(m["cfg"], base, lora_rank=4, lora_alpha=8.0,
                     lora_targets=TARGETS, learning_rate=3e-2, batch_size=4,
                     num_epoch=2, eval_every=2, device="cpu")
    merged = tr.train(data, eval_tokens=rows(6, 4))
    assert len(tr.history) == 4 and len(tr.eval_history) == 2
    first = ttfm.lm_loss(base, torch.from_numpy(data[:4]).long(), m["cfg"])
    np.testing.assert_allclose(tr.history[0], float(first.detach()), **TOL)
    want = tlora.lora_merge(base, tr.adapters, m["cfg"], tr.lora)
    for (name, a), (_, b) in zip(ttfm.named_leaves(merged),
                                 ttfm.named_leaves(want)):
        assert torch.equal(a, b.detach()), name
    for name, t in ttfm.named_leaves(base):
        assert torch.equal(t, keep[name]), name
    assert len(tr.opt_state.leaves) == 2 * len(TARGETS)
    np.testing.assert_allclose(
        tr.eval_history[-1][1]["loss"],
        float(ttfm.lm_nll(merged, torch.from_numpy(rows(6, 4)).long(),
                          m["cfg"])), **TOL)


def test_lora_trainer_rejections(m):
    base = m["p"]
    with pytest.raises(ValueError, match="base_params"):
        LoRATrainer(m["cfg"], None, device="cpu")
    for kw, match in ((dict(ema_decay=0.9), "ema_decay"),
                      (dict(zero1=True), "zero1"),
                      (dict(sync_every=2), "sync_every"),
                      (dict(probe_metrics=True), "probe_metrics"),
                      (dict(lora_targets=("wz",)), "unknown")):
        with pytest.raises(ValueError, match=match):
            LoRATrainer(m["cfg"], base, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        LoRATrainer(m["cfg"], base, checkpoint_dir="/nonexistent",
                    device="cpu")
    tr = LoRATrainer(m["cfg"], base, device="cpu")
    with pytest.raises(ValueError, match="base_params"):
        tr.train(rows(7, 8), params=base)


def test_grad_accum_equals_large_batch(m):
    data = rows(8, 32)
    big = LoRATrainer(m["cfg"], m["p"], lora_rank=4, learning_rate=1e-2,
                      batch_size=32, device="cpu")
    accum = LoRATrainer(m["cfg"], m["p"], lora_rank=4, learning_rate=1e-2,
                        batch_size=16, grad_accum=2, device="cpu")
    want, got = big.train(data), accum.train(data)
    assert len(big.history) == len(accum.history) == 1
    for (name, a), (_, b) in zip(ttfm.named_leaves(want),
                                 ttfm.named_leaves(got)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL,
                                   err_msg=name)


def test_merged_tree_serves_and_drafts_speculatively(m):
    jmerged = jlora.lora_merge(m["jp"], m["jad"], m["jcfg"], m["jl"])
    merged = tlora.lora_merge(m["p"], m["ad"], m["cfg"], m["tl"])
    prompt = rows(9, 2, 6)
    ref = np.asarray(jgen.generate(jmerged, prompt, m["jcfg"], 10))
    out = tgen.generate(merged, prompt, m["cfg"], 10, device="cpu")
    np.testing.assert_array_equal(out.numpy(), ref)
    spec, stats = speculative_generate(merged, quantize_params(merged),
                                       prompt, m["cfg"], m["cfg"], 10,
                                       n_draft=3, device="cpu")
    np.testing.assert_array_equal(spec.numpy(), ref)
    assert float(stats["acceptance_rate"]) > 0.3  # the int8 self-draft

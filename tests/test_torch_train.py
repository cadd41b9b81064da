"""The port's training path vs ``distkeras_tpu``'s, on the same numpy
weights and tokens (CPU, f32, a 2-layer model).

- losses (``chunked_softmax_xent``, ``lm_loss`` with z-loss and packed
  segments, ``lm_nll``) at 1e-5, and ``lm_loss`` gradients per leaf at
  1e-4 (autograd vs ``jax.grad``: summation order only) — under a
  bfloat16 config the embedding sum is bf16, so the gradient reaching
  the embeddings is summed in bf16 and held at 2e-3 / 1e-2 (about one
  bf16 ulp);
- ``make_train_step`` against the JAX step with optax: params after 3
  sgd steps at 1e-5, losses over 5 adamw steps with weight decay, clip,
  ``grad_accum=2`` and EMA at 1e-5 and the params and EMA at 1e-4
  (torch.optim's and optax's adam round differently);
- ``LMTrainer.history`` / ``eval_history`` against the JAX ``LMTrainer``
  on a one-device mesh at 1e-4, shuffled and packed;
- the dropout contract, ``pack_documents`` and ``params_to_numpy``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distkeras_tpu.data import packing as jpacking
from distkeras_tpu.models import transformer as jtfm
from distkeras_tpu.parallel.mesh import MeshSpec, make_mesh
from distkeras_tpu.trainers import lm as jlm
from distkeras_tpu_torch.data import packing as tpacking
from distkeras_tpu_torch.models import transformer as ttfm
from distkeras_tpu_torch.trainers import lm as tlm
from distkeras_tpu_torch.trainers.optim import Optimizer
from distkeras_tpu_torch.utils.serialization import (params_from_numpy,
                                                     params_to_numpy)

BASE = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
            max_len=32)


def configs(**kw):
    return (jtfm.TransformerConfig(**BASE, **kw),
            ttfm.TransformerConfig(**BASE, **kw))


def np_params(cfg, seed=0):
    return jax.tree.map(np.asarray, jtfm.init_params(jax.random.key(seed),
                                                     cfg))


def packed(rng, n_rows, seq):
    docs = [rng.integers(1, 64, size=int(n))
            for n in rng.integers(2, 14, size=4 * n_rows)]
    rows, seg = tpacking.pack_documents(docs, seq)
    return rows[:n_rows], seg[:n_rows]


def leaves_close(got, ref, tol, rtol=None):
    got, ref = params_to_numpy(got), jax.tree.map(np.asarray, ref)
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    for path, g in jax.tree_util.tree_flatten_with_path(got)[0]:
        np.testing.assert_allclose(g, flat_ref[path], atol=tol,
                                   rtol=tol if rtol is None else rtol,
                                   err_msg=jax.tree_util.keystr(path))


def test_chunked_softmax_xent_matches_jax(rng):
    """20 rows in 3 chunks (one pad row), with excluded (-1) targets."""
    hidden = rng.normal(size=(2, 10, 16)).astype(np.float32)
    emb = rng.normal(size=(50, 16)).astype(np.float32)
    targets = rng.integers(0, 50, size=(2, 10)).astype(np.int32)
    targets[0, :3] = -1
    ref = jtfm.chunked_softmax_xent(hidden, emb, targets, 3)
    h = torch.from_numpy(hidden).requires_grad_()
    out = ttfm.chunked_softmax_xent(h, torch.from_numpy(emb),
                                    torch.from_numpy(targets), 3)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-5, rtol=1e-5)
    # The checkpointed chunks differentiate like the reference's scan.
    (out[0] + out[1]).backward()
    g_ref = jax.grad(lambda x: sum(jtfm.chunked_softmax_xent(
        x, emb, targets, 3)))(hidden)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(g_ref), atol=1e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("kw,segmented,grad_tol", [
    (dict(), False, (1e-4, 1e-4)),
    (dict(z_loss_coef=1e-2), True, (1e-4, 1e-4)),
    (dict(ce_chunks=3, z_loss_coef=1e-2, rope=True), True, (1e-4, 1e-4)),
    (dict(dtype="bfloat16", attention_window=5), False, (2e-3, 1e-2)),
], ids=["plain", "zloss-seg", "chunked-zloss-seg-rope", "bf16cfg-window"])
def test_lm_loss_nll_and_grads_match_jax(rng, kw, segmented, grad_tol):
    jcfg, tcfg = configs(**kw)
    params = np_params(jcfg)
    tokens = rng.integers(0, 64, (3, 17)).astype(np.int32)
    seg = None
    if segmented:
        tokens, seg = packed(rng, 3, 16)
    ref_loss, ref_grads = jax.value_and_grad(jtfm.lm_loss)(
        params, tokens, jcfg, segment_ids=seg)
    ref_nll = jtfm.lm_nll(params, tokens, jcfg, segment_ids=seg)
    tp = params_from_numpy(params, "cpu")
    for leaf in ttfm._leaves(tp):
        leaf.requires_grad_()
    loss = ttfm.lm_loss(tp, tokens, tcfg, segment_ids=seg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=1e-5,
                               rtol=1e-5)
    with torch.no_grad():
        nll = ttfm.lm_nll(tp, tokens, tcfg, segment_ids=seg)
    np.testing.assert_allclose(float(nll), float(ref_nll), atol=1e-5,
                               rtol=1e-5)
    leaves_close(ttfm._map_leaves(lambda p: p.grad, tp), ref_grads,
                 *grad_tol)


def test_loss_routes_and_custom_attention_guards(rng):
    """apply_fn / hidden_fn routes give the default trunk's loss; a
    custom attention_fn takes packed segments only when it declares
    ``handles_segments`` (then it is called with them), as in the
    reference."""
    jcfg, tcfg = configs(rope=True)
    tp = params_from_numpy(np_params(jcfg), "cpu")
    tokens, seg = packed(rng, 2, 16)
    ref = float(ttfm.lm_loss(tp, tokens, tcfg, segment_ids=seg))
    hidden_fn = lambda p, t: ttfm.apply_hidden(p, t, tcfg)
    apply_fn = lambda p, t: (ttfm._unembed(hidden_fn(p, t)[0], p, tcfg),
                             torch.zeros(()))
    plain = ttfm.lm_loss(tp, tokens, tcfg)
    for kw in (dict(hidden_fn=hidden_fn), dict(apply_fn=apply_fn)):
        np.testing.assert_allclose(float(ttfm.lm_loss(tp, tokens, tcfg,
                                                      **kw)),
                                   float(plain), rtol=1e-6)
    seen = []

    def attn_fn(q, k, v, segment_ids=None):
        seen.append(segment_ids)
        return ttfm.flash_attention(q, k, v, True, segment_ids=segment_ids)

    with pytest.raises(ValueError, match="handles_segments"):
        ttfm.lm_loss(tp, tokens, tcfg, attention_fn=attn_fn,
                     segment_ids=seg)
    attn_fn.handles_segments = True
    np.testing.assert_allclose(
        float(ttfm.lm_loss(tp, tokens, tcfg, attention_fn=attn_fn,
                           segment_ids=seg)), ref, rtol=1e-6)
    assert len(seen) == 2 and torch.equal(seen[0],
                                          torch.from_numpy(seg[:, :-1]))
    with pytest.raises(ValueError, match="not both"):
        ttfm.lm_loss(tp, tokens, tcfg, apply_fn=apply_fn,
                     hidden_fn=hidden_fn)
    with pytest.raises(ValueError, match="dropout_rng"):
        ttfm.lm_loss(tp, tokens, tcfg, hidden_fn=hidden_fn,
                     dropout_rng=torch.Generator())


def _decay_mask(params):
    return {k: (_decay_mask(v) if isinstance(v, dict)
                else not k.endswith("_scale")) for k, v in params.items()}


def _jax_steps(jcfg, opt, params, batches, grad_accum=1):
    step = jax.jit(jtfm.make_train_step(jcfg, opt, grad_accum=grad_accum))
    carry, losses = (params, opt.init(params)), []
    for b in batches:
        carry, loss = step(carry, b)
        losses.append(float(loss))
    return carry, losses


def _torch_steps(tcfg, opt, params, batches, grad_accum=1):
    tp = params_from_numpy(params, "cpu")
    step = ttfm.make_train_step(tcfg, opt, grad_accum=grad_accum)
    carry, losses = (tp, opt.init(tp)), []
    for b in batches:
        carry, loss = step(carry, b)
        losses.append(float(loss))
    return carry, losses


def test_train_step_sgd_params_match_jax(rng):
    jcfg, tcfg = configs(rope=True)
    params = np_params(jcfg)
    batches = [rng.integers(0, 64, (2, 17)).astype(np.int32)
               for _ in range(3)]
    (jp, _), jl = _jax_steps(jcfg, optax.sgd(0.5), params, batches)
    (tp, _), tl = _torch_steps(tcfg, Optimizer("sgd", 0.5), params, batches)
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=1e-5)
    leaves_close(tp, jp, 1e-5)


def test_train_step_adamw_clip_accum_ema_match_jax(rng):
    """5 adamw steps with the decay mask, a clip that fires, two
    microbatches per step, a schedule and an EMA shadow — the optax chain
    LMTrainer builds."""
    jcfg, tcfg = configs()
    params = np_params(jcfg)
    batches = [rng.integers(0, 64, (2, 2, 17)).astype(np.int32)
               for _ in range(5)]
    sched = optax.linear_schedule(1e-2, 2e-3, 5)
    jopt = jlm._with_ema(optax.chain(
        optax.clip_by_global_norm(0.5),
        optax.adamw(sched, weight_decay=0.1, mask=_decay_mask)), 0.9)
    (jp, jstate), jl = _jax_steps(jcfg, jopt, params, batches, grad_accum=2)
    topt = Optimizer("adamw", lambda n: float(sched(n)), weight_decay=0.1,
                     grad_clip_norm=0.5, ema_decay=0.9)
    (tp, tstate), tl = _torch_steps(tcfg, topt, params, batches,
                                    grad_accum=2)
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=1e-5)
    leaves_close(tp, jp, 1e-4)
    leaves_close(tstate.ema, jstate[1], 1e-4)


def test_train_step_probe_and_loss_fn_hook(rng):
    jcfg, tcfg = configs()
    params = np_params(jcfg)
    tokens = rng.integers(0, 64, (2, 17)).astype(np.int32)
    jstep = jax.jit(jtfm.make_train_step(jcfg, optax.adam(1e-3), probe=True))
    _, (jloss, jaux) = jstep((params, optax.adam(1e-3).init(params)), tokens)
    seen = []

    def loss_fn(*args):
        seen.append(args[1].shape)
        return ttfm.lm_loss(*args)

    opt = Optimizer("adam", 1e-3)
    tp = params_from_numpy(params, "cpu")
    step = ttfm.make_train_step(tcfg, opt, loss_fn=loss_fn, probe=True)
    (tp2, _), (loss, aux) = step((tp, opt.init(tp)), tokens)
    assert tp2 is tp and seen == [(2, 17)]
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux["grad_norm"]),
                               float(jaux["grad_norm"]), rtol=1e-5)


@pytest.mark.parametrize("variant", ["shuffle-eval", "packed"])
def test_lm_trainer_matches_jax(rng, devices, variant):
    jcfg, tcfg = configs(rope=True)
    params = np_params(jcfg)
    kw = dict(optimizer="adamw", learning_rate=3e-3, batch_size=2, seed=3)
    if variant == "shuffle-eval":
        tokens = rng.integers(0, 64, (9, 17)).astype(np.int32)
        evals = rng.integers(0, 64, (5, 17)).astype(np.int32)
        kw.update(shuffle=True, eval_every=2, num_epoch=2)
        args = dict(eval_tokens=evals)
    else:
        tokens, seg = packed(rng, 7, 16)
        evals, eseg = packed(np.random.default_rng(9), 4, 16)
        kw.update(eval_every=3, grad_accum=2)
        args = dict(segments=seg, eval_tokens=evals, eval_segments=eseg)
    jt = jlm.LMTrainer(jcfg, mesh=make_mesh(MeshSpec(data=1),
                                            devices=devices[:1]), **kw)
    jt.train(tokens, params=jax.tree.map(jnp.asarray, params), **args)
    tt = tlm.LMTrainer(tcfg, device="cpu", **kw)
    tt.train(tokens, params=params_from_numpy(params, "cpu"), **args)
    assert len(tt.history) == len(jt.history) > 0
    np.testing.assert_allclose(tt.history, jt.history, atol=1e-4, rtol=1e-4)
    assert [r for r, _ in tt.eval_history] == [r for r, _ in jt.eval_history]
    for (_, a), (_, b) in zip(tt.eval_history, jt.eval_history):
        np.testing.assert_allclose([a["loss"], a["perplexity"]],
                                   [b["loss"], b["perplexity"]], rtol=1e-4)
    assert tt.training_time > 0


def test_lm_trainer_probe_ema_and_unported_knobs(rng):
    _, tcfg = configs()
    tokens = rng.integers(0, 64, (4, 17)).astype(np.int32)
    tt = tlm.LMTrainer(tcfg, batch_size=2, probe_metrics=True,
                       ema_decay=0.5, device="cpu")
    before = tt.init_params()
    out = tt.train(tokens, params=before)
    assert len(tt.probe_history) == 2 and tt.probe_history[0]["grad_norm"] > 0
    assert not torch.equal(out["tok_emb"], before["tok_emb"])  # a copy moved
    ema = tt.ema_params["tok_emb"]
    assert not torch.equal(ema, out["tok_emb"])
    for knob, value, item in [("mesh", object(), "A7"), ("zero", 1, "A7"),
                              ("checkpoint_dir", "/x", "A8")]:
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            tlm.LMTrainer(tcfg, device="cpu", **{knob: value})
    with pytest.raises(ValueError, match="probe_metrics"):
        tlm.LMTrainer(tcfg, device="cpu", probe_metrics=True,
                      device_data=True)
    with pytest.raises(ValueError, match="profile_steps"):
        tlm.LMTrainer(tcfg, device="cpu", profile_steps=0)
    with pytest.raises(TypeError, match="unexpected"):
        tlm.LMTrainer(tcfg, device="cpu", bogus=1)
    with pytest.raises(ValueError, match="ema_decay"):
        tlm.LMTrainer(tcfg, device="cpu").ema_params
    with pytest.raises(ValueError, match="one step needs"):
        tlm.LMTrainer(tcfg, batch_size=8, device="cpu").train(tokens)


def test_dropout_contract(rng):
    """JAX's masks come from its key stream and cannot be matched; the
    port holds its own contract: dropout 0 (or no generator outside
    training) equals JAX, a generator seed fixes the masks, another seed
    changes them, the keep rate and scaling are right, and training with
    dropout but no generator raises."""
    jcfg, tcfg = configs()
    params = np_params(jcfg)
    tokens = rng.integers(0, 64, (2, 17)).astype(np.int32)
    tp = params_from_numpy(params, "cpu")
    ref = float(jtfm.lm_loss(params, tokens, jcfg,
                             dropout_rng=jax.random.key(1)))
    gen = torch.Generator().manual_seed(1)
    np.testing.assert_allclose(
        float(ttfm.lm_loss(tp, tokens, tcfg, dropout_rng=gen)), ref,
        atol=1e-5, rtol=1e-5)
    dcfg = dataclasses.replace(tcfg, dropout=0.3)
    loss = lambda s: float(ttfm.lm_loss(
        tp, tokens, dcfg, dropout_rng=torch.Generator().manual_seed(s)))
    assert loss(1) == loss(1) != loss(2)
    assert abs(loss(1) - ref) > 1e-4
    x = torch.ones(200_000)
    y = ttfm._dropout(x, 0.3, torch.Generator().manual_seed(0))
    assert abs(float((y == 0).float().mean()) - 0.3) < 5e-3
    assert torch.allclose(y[y != 0], torch.tensor(1 / 0.7))
    opt = Optimizer("sgd", 0.1)
    step = ttfm.make_train_step(dcfg, opt)
    with pytest.raises(ValueError, match="dropout_rng"):
        step((tp, opt.init(tp)), tokens)
    with pytest.raises(TypeError, match="dropout_rng"):
        ttfm.lm_loss(tp, tokens, dcfg, dropout_rng=1)


def test_pack_documents_matches_jax_copy(rng):
    docs = [rng.integers(1, 50, size=int(n))
            for n in rng.integers(1, 30, size=40)]
    for seq in (1, 7, 16):
        got, ref = (tpacking.pack_documents(docs, seq),
                    jpacking.pack_documents(docs, seq))
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
        assert (tpacking.packing_efficiency(got[1])
                == jpacking.packing_efficiency(ref[1]))
    with pytest.raises(ValueError, match="no document"):
        tpacking.pack_documents([[1]], 4)


def test_params_to_numpy_round_trips_into_jax(rng):
    """Trained port weights go back into the JAX package unchanged."""
    jcfg, tcfg = configs()
    params = np_params(jcfg)
    tp = params_from_numpy(params, "cpu")
    tp["tok_emb"].requires_grad_()
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    leaves_close(tp, params, 0)
    tokens = rng.integers(0, 64, (2, 9)).astype(np.int32)
    np.testing.assert_allclose(
        np.asarray(jtfm.apply(back, tokens, jcfg)[0]),
        ttfm.apply(tp, tokens, tcfg, device="cpu")[0].numpy(),
        atol=1e-4, rtol=1e-4)
    half = params_to_numpy(params_from_numpy(params, "cpu",
                                             dtype=torch.bfloat16))
    assert half["tok_emb"].dtype == np.float32

"""Remat in the port vs ``distkeras_tpu`` (CPU, f32, a 2-layer model).

- ``lm_loss`` and its gradients with ``remat`` off, on, and under the
  ``"dots"`` / ``"dots_no_batch"`` policies, with rope + GQA, a window
  and packed segments: each remat run equals the port's ``remat=False``
  run to 1e-6 (the recompute replays the same ops) and JAX's remat run
  at ``test_torch_train.py``'s tolerances (1e-5 loss, 1e-4 grads);
- the policies at work: which forward matmuls the backward recomputes;
- dropout under remat: the recompute redraws the forward's masks;
- inference of a remat config (``apply``, ``lm_nll``, ``prefill``,
  greedy ``generate``) equals JAX's, and an unknown ``remat_policy``
  raises in ``apply`` as it does there.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from distkeras_tpu.models import generate as jgen
from distkeras_tpu.models import transformer as jtfm
from distkeras_tpu_torch.data import packing as tpacking
from distkeras_tpu_torch.models import generate as tgen
from distkeras_tpu_torch.models import transformer as ttfm
from distkeras_tpu_torch.utils.serialization import (params_from_numpy,
                                                     params_to_numpy)

BASE = dict(vocab_size=128, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_len=32)
VARIANTS = {
    "plain": dict(),
    "rope-gqa": dict(rope=True, n_kv_heads=2),
    "window": dict(attention_window=5),
    "segments": dict(rope=True),
}
MODES = {
    "off": dict(),
    "full": dict(remat=True),
    "dots": dict(remat=True, remat_policy="dots"),
    "dots_no_batch": dict(remat=True, remat_policy="dots_no_batch"),
}


def np_params(cfg, seed=0):
    return jax.tree.map(np.asarray,
                        jtfm.init_params(jax.random.key(seed), cfg))


def batch(variant, seed=0):
    rng = np.random.default_rng(seed)
    if variant != "segments":
        return rng.integers(0, 128, (3, 17)).astype(np.int32), None
    docs = [rng.integers(1, 128, size=int(n))
            for n in rng.integers(2, 14, size=12)]
    rows, seg = tpacking.pack_documents(docs, 16)
    return rows[:3], seg[:3]


def port_loss_and_grads(params, tokens, seg, cfg, gen=None):
    tp = params_from_numpy(params, "cpu")
    for leaf in ttfm._leaves(tp):
        leaf.requires_grad_()
    loss = ttfm.lm_loss(tp, tokens, cfg, segment_ids=seg, dropout_rng=gen)
    loss.backward()
    return loss.item(), {path: p.grad.numpy()
                         for path, p in ttfm.named_leaves(tp)}


_JAX_REF = {}


def jax_loss_and_grads(variant, mode):
    """JAX's remat run of the same config (cached per case)."""
    if (variant, mode) not in _JAX_REF:
        jcfg = jtfm.TransformerConfig(**BASE, **VARIANTS[variant],
                                      **MODES[mode])
        tokens, seg = batch(variant)
        loss, grads = jax.value_and_grad(jtfm.lm_loss)(
            np_params(jcfg), tokens, jcfg, segment_ids=seg)
        flat = jax.tree_util.tree_flatten_with_path(grads)[0]
        _JAX_REF[variant, mode] = (float(loss), {
            "/".join(k.key for k in path): np.asarray(g)
            for path, g in flat})
    return _JAX_REF[variant, mode]


@pytest.mark.parametrize("mode", ["full", "dots", "dots_no_batch"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_remat_loss_and_grads_equal_no_remat_and_jax(variant, mode):
    cfg = ttfm.TransformerConfig(**BASE, **VARIANTS[variant], **MODES[mode])
    off = dataclasses.replace(cfg, remat=False, remat_policy=None)
    params = np_params(jtfm.TransformerConfig(**BASE, **VARIANTS[variant]))
    tokens, seg = batch(variant)
    loss, grads = port_loss_and_grads(params, tokens, seg, cfg)
    loss0, grads0 = port_loss_and_grads(params, tokens, seg, off)
    np.testing.assert_allclose(loss, loss0, atol=1e-6, rtol=1e-6)
    for path, g in grads.items():
        np.testing.assert_allclose(g, grads0[path], atol=1e-6, rtol=1e-6,
                                   err_msg=path)
    jloss, jgrads = jax_loss_and_grads(variant, mode)
    np.testing.assert_allclose(loss, jloss, atol=1e-5, rtol=1e-5)
    for path, g in grads.items():
        np.testing.assert_allclose(g, jgrads[path], atol=1e-4, rtol=1e-4,
                                   err_msg=path)


class _MatmulCount(TorchDispatchMode):
    """Counts the mm / addmm / bmm calls dispatched while active."""

    OPS = {torch.ops.aten.mm.default: "mm", torch.ops.aten.addmm.default: "mm",
           torch.ops.aten.bmm.default: "bmm"}

    def __init__(self):
        super().__init__()
        self.counts = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.OPS:
            self.counts[self.OPS[func]] += 1
        return func(*args, **(kwargs or {}))


def backward_matmuls(cfg, params, tokens):
    tp = params_from_numpy(params, "cpu")
    for leaf in ttfm._leaves(tp):
        leaf.requires_grad_()
    with _MatmulCount() as fwd:
        loss = ttfm.lm_loss(tp, tokens, cfg)
    with _MatmulCount() as bwd:
        loss.backward()
    return fwd.counts, bwd.counts


def test_remat_policies_recompute_what_they_name():
    """Full remat recomputes the blocks' matmuls in the backward,
    ``"dots"`` none, ``"dots_no_batch"`` only the batched ones (the
    blockwise attention's ``bmm``s on the CPU)."""
    params = np_params(jtfm.TransformerConfig(**BASE))
    tokens, _ = batch("plain")
    counts = {mode: backward_matmuls(
        ttfm.TransformerConfig(**BASE, **kw), params, tokens)
        for mode, kw in MODES.items()}
    fwd, base = counts["off"]
    # The blocks' forward matmuls: all but the tied head's one mm.
    blocks = {"mm": fwd["mm"] - 1, "bmm": fwd["bmm"]}
    assert blocks["mm"] == 6 * BASE["n_layers"] and blocks["bmm"] > 0
    extra = {mode: {k: bwd[k] - base[k] for k in bwd}
             for mode, (_, bwd) in counts.items()}
    # Non-reentrant checkpoints stop recomputing once every tensor the
    # backward needs is back: each block's last product (the FFN's
    # output projection, whose output nothing saves) is not rerun.
    assert extra["full"] == {"mm": blocks["mm"] - BASE["n_layers"],
                             "bmm": blocks["bmm"]}
    assert extra["dots"] == {"mm": 0, "bmm": 0}
    assert extra["dots_no_batch"] == {"mm": 0, "bmm": blocks["bmm"]}
    for mode, (f, _) in counts.items():
        assert f == fwd, mode  # remat changes only the backward


@pytest.mark.parametrize("mode", ["full", "dots"])
def test_remat_dropout_gives_the_same_loss_and_grads(mode):
    """The recompute redraws the forward's masks (the explicit generator
    is restored for it), and the caller's stream ends where the
    no-remat run leaves it."""
    cfg = ttfm.TransformerConfig(**BASE, rope=True, dropout=0.2,
                                 **MODES[mode])
    off = dataclasses.replace(cfg, remat=False, remat_policy=None)
    params = np_params(jtfm.TransformerConfig(**BASE, rope=True))
    tokens, _ = batch("plain")
    runs = []
    for c in (cfg, off):
        gen = torch.Generator().manual_seed(11)
        runs.append((*port_loss_and_grads(params, tokens, None, c, gen),
                     gen.get_state()))
    (loss, grads, state), (loss0, grads0, state0) = runs
    nodrop, _ = port_loss_and_grads(params, tokens, None, off)
    assert loss != nodrop  # the masks are on
    np.testing.assert_allclose(loss, loss0, atol=1e-6, rtol=1e-6)
    for path, g in grads.items():
        np.testing.assert_allclose(g, grads0[path], atol=1e-6, rtol=1e-6,
                                   err_msg=path)
    assert torch.equal(state, state0)


def test_remat_train_steps_equal_no_remat():
    """Three adamw steps through make_train_step with dropout: the same
    losses and weights as without remat."""
    from distkeras_tpu_torch.trainers.optim import Optimizer

    cfg = ttfm.TransformerConfig(**BASE, rope=True, n_kv_heads=2,
                                 dropout=0.1, remat=True,
                                 remat_policy="dots_no_batch")
    params = np_params(jtfm.TransformerConfig(**BASE, rope=True,
                                              n_kv_heads=2))
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, 128, (2, 17)) for _ in range(3)]
    out = []
    for c in (cfg, dataclasses.replace(cfg, remat=False, remat_policy=None)):
        opt = Optimizer("adamw", 1e-2)
        tp = params_from_numpy(params, "cpu")
        step = ttfm.make_train_step(c, opt)
        carry, gen, losses = (tp, opt.init(tp)), \
            torch.Generator().manual_seed(2), []
        for b in batches:
            carry, loss = step(carry, b, gen)
            losses.append(float(loss))
        out.append((losses, params_to_numpy(carry[0])))
    (l1, p1), (l0, p0) = out
    np.testing.assert_allclose(l1, l0, atol=1e-6, rtol=1e-6)
    for (path, a), (_, b) in zip(ttfm.named_leaves(p1),
                                 ttfm.named_leaves(p0)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6, err_msg=path)


@pytest.mark.parametrize("mode", ["full", "dots"])
def test_remat_config_inference_equals_jax(mode):
    """C1: remat changes only the backward, so a remat config serves:
    apply, lm_nll, prefill and greedy generate equal JAX's."""
    kw = {**BASE, "rope": True, "n_kv_heads": 2, "max_len": 48,
          **MODES[mode]}
    jcfg, tcfg = jtfm.TransformerConfig(**kw), ttfm.TransformerConfig(**kw)
    params = np_params(jcfg, seed=1)
    tp = params_from_numpy(params, "cpu")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 128, (2, 12)).astype(np.int32)
    ref, _ = jtfm.apply(params, tokens, jcfg)
    out, _ = ttfm.apply(tp, tokens, tcfg, device="cpu")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    with torch.no_grad():
        nll = ttfm.lm_nll(tp, tokens, tcfg)
    np.testing.assert_allclose(float(nll),
                               float(jtfm.lm_nll(params, tokens, jcfg)),
                               atol=1e-5, rtol=1e-5)
    _, jlast = jgen.prefill(params, tokens, jcfg)
    _, tlast = tgen.prefill(tp, tokens, tcfg, device="cpu")
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=1e-4)
    prompt = tokens[:, :7]
    want = np.asarray(jgen.generate(params, prompt, jcfg, 10))
    got = tgen.generate(tp, prompt, tcfg, 10, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_unknown_remat_policy_raises_in_apply_as_in_jax():
    """C2: the name is checked wherever the trunk runs, with or without
    remat; a known policy on a remat=False config is inert there and
    refused only by init_params (both as in JAX)."""
    params = np_params(jtfm.TransformerConfig(**BASE))
    tp = params_from_numpy(params, "cpu")
    tokens = np.zeros((1, 5), np.int32)
    for remat in (False, True):
        kw = {**BASE, "remat": remat, "remat_policy": "bogus"}
        with pytest.raises(ValueError, match="unknown remat_policy"):
            jtfm.apply(params, tokens, jtfm.TransformerConfig(**kw))
        with pytest.raises(ValueError, match="unknown remat_policy"):
            ttfm.apply(tp, tokens, ttfm.TransformerConfig(**kw),
                       device="cpu")
        with pytest.raises(ValueError, match="unknown remat_policy"):
            ttfm.lm_loss(tp, np.zeros((1, 6), np.int32),
                         ttfm.TransformerConfig(**kw))
    inert = {**BASE, "remat_policy": "dots"}
    ref, _ = jtfm.apply(params, tokens, jtfm.TransformerConfig(**inert))
    out, _ = ttfm.apply(tp, tokens, ttfm.TransformerConfig(**inert),
                        device="cpu")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    for pkg in (jtfm, ttfm):
        with pytest.raises(ValueError, match="remat=False"):
            cfg = pkg.TransformerConfig(**inert)
            if pkg is jtfm:
                pkg.init_params(jax.random.key(0), cfg)
            else:
                pkg.init_params(0, cfg, device="cpu")

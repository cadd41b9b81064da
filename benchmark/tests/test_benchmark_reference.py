"""The port held to the benchmark's plain references at tiny sizes on
the CPU: the LM's forward, loss, AdamW steps and decode through the
serving engine's cache."""

from __future__ import annotations

import bench_tiny
import numpy as np
import pytest
import torch

from reference import lm as ref_lm

SEED = 2 ** 31 + 11


def lm_cfg(**kw):
    cfg = dict(bench_tiny.lm_config(), max_len=33, dtype="float32")
    cfg.update(kw)
    return {k: cfg[k] for k in ("vocab_size", "d_model", "n_heads",
                                "n_layers", "d_ff", "rope", "rope_theta",
                                "dtype", "max_len")}


def tokens(cfg, shape, seed=3):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg["vocab_size"], shape))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_forward_and_loss(dtype):
    from distkeras_tpu_torch.models import transformer as tfm

    cfg = lm_cfg(dtype=dtype)
    params = ref_lm.init_params(cfg, SEED, "cpu")
    rows = tokens(cfg, (2, 33))
    got, _ = tfm.apply(params, rows[:, :-1], tfm.TransformerConfig(**cfg),
                       device="cpu")
    want = ref_lm.logits(params, rows[:, :-1], cfg, getattr(torch, dtype))
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    loss = tfm.lm_loss(params, rows, tfm.TransformerConfig(**cfg))
    assert float(loss) == pytest.approx(
        float(ref_lm.loss(params, rows, cfg, getattr(torch, dtype))),
        rel=1e-5)


def test_lm_adamw_steps():
    from distkeras_tpu_torch.models import transformer as tfm
    from distkeras_tpu_torch.trainers.optim import Optimizer

    cfg = lm_cfg(dtype="bfloat16")
    batches = [tokens(cfg, (2, 33), seed=s) for s in (1, 2, 3)]
    opt = Optimizer("adamw", 3e-4)
    params = ref_lm.init_params(cfg, SEED, "cpu")
    step = tfm.make_train_step(tfm.TransformerConfig(**cfg), opt)
    carry = (params, opt.init(params))
    losses = []
    for rows in batches:
        carry, loss = step(carry, rows)
        losses.append(float(loss))
    want = ref_lm.init_params(cfg, SEED, "cpu")
    r_loss, _, _, _ = ref_lm.train_readings(
        want, batches, cfg, torch.bfloat16, chunk=2)
    assert losses == pytest.approx(r_loss, rel=1e-5)
    for k, v in ref_lm.flatten(carry[0]).items():
        w = ref_lm.flatten(want)[k]
        assert (v.detach() - w).abs().max() <= 1e-5 * w.abs().max(), k


def test_lm_decode_through_the_engine_cache():
    from distkeras_tpu_torch.models.transformer import TransformerConfig
    from distkeras_tpu_torch.serving.lanes import ContinuousBatcher

    cfg = lm_cfg(max_len=64)
    params = ref_lm.init_params(cfg, SEED, "cpu")
    eng = ContinuousBatcher(params, TransformerConfig(**cfg), lanes=3,
                            prompt_buckets=(8, 32), device="cpu")
    prompts = [tokens(cfg, (n,), seed=n).numpy() for n in (5, 17, 30)]
    lanes = [eng.submit(p, 12) for p in prompts]
    while eng.running():
        eng.step(4)
    for lane, prompt in zip(lanes, prompts):
        served = torch.from_numpy(eng.drain(lane)[len(prompt):]).long()
        gaps = ref_lm.served_gaps(params, cfg, torch.from_numpy(prompt),
                                  served, torch.float32)
        assert len(served) == 12 and float(gaps.max()) <= 1e-4

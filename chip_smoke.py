"""Smoke test of the PyTorch / CUDA port on one GPU.

Builds every kernel of the port from ``distkeras_tpu_torch/ops/csrc``
and holds each against its plain PyTorch version on the card, then
drives the port's two main paths at the flagship width and checks that
each went through its kernels:

- serving: ``generate`` (prefill through the flash forward kernel, then
  the KV-cached decode), checked against the plain path;
- training: ``LMTrainer`` steps (the flash forward with lse, then the
  FA2 dQ and dK/dV kernels in the backward), with the loss falling on a
  repeated batch, kernel gradients held against the plain attention's
  at full width, and packed (segment-masked) steps;
- the paper's path (phase ``keras_train``): the CIFAR CNN at the bench
  config (``mixed_bfloat16``, batch 1024) through ``SingleTrainer``
  (device-resident data), ``ADAG``, ``DOWNPOUR`` and ``AEASGD``, each
  scored by ``ModelPredictor`` -> ``LabelIndexTransformer`` ->
  ``AccuracyEvaluator``; its throughput, step time, device idle share
  and peak memory; a float32 ``SingleTrainer`` run held against the
  same run on the CPU, and ``ADAG(communication_window=1)`` against
  ``SingleTrainer``.  This path reaches no hand-written kernel (its
  convolutions and dense products are cuDNN / cuBLAS, as the reference's
  are XLA's);
- long-context training from raw text (phase ``long_train``): a seeded
  text through the native BPE tokenizer into rows of 4096 + 1 tokens, a
  ``Dataset`` of them through ``LMTrainer(_long_cfg)`` (remat, shuffled,
  device-resident, profiled), the loss falling; the trained artefact
  through ``save_lm`` -> ``load_lm`` -> ``generate`` (phase
  ``long_serve``); the rope + GQA, window-1024, ``remat_policy="dots"``
  and remat-off variants timed (peak memory with remat below without);
  and the training kernels against their plain versions at
  [8, 4096, 8, 128].

Usage: python3 chip_smoke.py [--profile]     (needs one CUDA device)

``--profile`` adds the device time by kernel (torch.profiler) of one
prefill, a short generate and one train step.

Output: the card's name and power limit, one line per phase, then a
``{"kernels": [...]}`` line and, last, the ``{"ok": true, "device": ...}``
line.  Any failed phase raises, so the exit code is nonzero.  In the
kernels line, ``flash_fwd``'s times are the serving prefill case (bf16,
causal, no lse), with the training case (f32, causal, with lse) beside
it under ``"f32_lse_causal"``, and its launches those of all three
main-path runs (``launches_by_path``); the backward kernels' times are
the training case (f32, causal) and their launches those of the two
training runs, with the bf16 causal case beside it under
``"bf16_causal"``; each kernel also carries its seq-4096 f32 readings
(causal, and window 1024).
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

import distkeras_tpu_torch as dkt
from distkeras_tpu_torch import native as dkt_native
from distkeras_tpu_torch.ops import _build
from distkeras_tpu_torch.ops import attention as attn
from distkeras_tpu_torch.models.transformer import named_leaves

H100_BF16_FLOPS = 989e12   # dense tensor-core peak (NVIDIA data sheet)
# f32-accurate products: the 495 TFLOP/s TF32 tensor-core peak over the
# three passes of 3xTF32 (hi.lo + lo.hi + hi.hi), the way PyTorch's own
# f32 attention runs its GEMMs (OpMultiplyAddFastF32 in
# torch/include/ATen/native/transformers/cuda/mem_eff_attention/
# gemm_kernel_utils.h), and above the 67 TFLOP/s of f32 FMAs.
H100_F32_FLOPS = 495e12 / 3
H100_HBM_BYTES = 3.35e12   # bytes/s

# The flagship serving config of scripts/bench_serving.py (~152M
# weights), at full depth.
FLAGSHIP = dkt.TransformerConfig(
    vocab_size=32768, d_model=1024, n_heads=8, n_layers=8, d_ff=4096,
    max_len=1025, dtype="bfloat16", rope=True)
PREFILL_SHAPE = (8, 512, 8, 128)   # q/k/v [B, L, H, D] of that prefill
NEW_TOKENS = 64

# The transformer_d1024 row of scripts/bench_suite.py (the same trunk,
# learned positions), trained as _measure_lm trains it: adamw 3e-4,
# batch 8 x seq 1024, f32 weights (so the trunk, and attention, run f32).
FLAGSHIP_TRAIN = dkt.TransformerConfig(
    vocab_size=32768, d_model=1024, n_heads=8, n_layers=8, d_ff=4096,
    max_len=1025, dtype="bfloat16")
TRAIN_SHAPE = (8, 1024, 8, 128)    # q/k/v [B, L, H, D] of a train step
TRAIN_STEPS = 10

# The long-context family of scripts/bench_suite.py, trained as
# _measure_lm trains it (adamw 3e-4, batch 8 x seq 4096, f32 weights, so
# an f32 trunk and the f32 kernels): _long_cfg (:375-384, remat on) and
# its rope + GQA (:391-399), window-1024 (:402-410), remat_policy="dots"
# (:413-421) and remat-off (:424-430) variants.
LONG_CFG = dkt.TransformerConfig(
    vocab_size=32768, d_model=1024, n_heads=8, n_layers=8, d_ff=4096,
    max_len=4097, dtype="bfloat16", remat=True)
LONG_VARIANTS = {
    "long": LONG_CFG,
    "long_rope_gqa": dataclasses.replace(LONG_CFG, rope=True, n_kv_heads=2),
    "long_window1024": dataclasses.replace(LONG_CFG, attention_window=1024),
    "long_rematdots": dataclasses.replace(LONG_CFG, remat_policy="dots"),
    "long_noremat": dataclasses.replace(LONG_CFG, remat=False),
}
LONG_SHAPE = (8, 4096, 8, 128)     # q/k/v [B, L, H, D] of a long step
LONG_TEXT_STEPS = 6


def ptxas_summary(build_log):
    """One line per compiled kernel of an ``nvcc -Xptxas -v`` log: its
    name and template arguments (as mangled), registers and spills; and
    every warning of the log (wgmma serialization among them)."""
    out, name, spill = [], None, ""
    for line in build_log.splitlines():
        if "warning" in line.lower():
            out.append(line.strip())
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            k = re.search(r"\d(flash_\w+?_kernel)I(\w*?)EEv", m.group(1))
            name = f"{k.group(1)}<{k.group(2)}>" if k else m.group(1)
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            out.append(f"{name}: {regs.group(1) if regs else '?'} regs, "
                       f"{spill}")
            name = None
    return out


def log(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` by CUDA events over ``iters`` calls.
    The calls queue behind a device-side sleep that outlasts their host
    cost (Python, ctypes), so a kernel shorter than its launch is timed
    on the device, not on the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    # Cycles at 2 GHz, above the card's SM clock: at least the host time.
    torch.cuda._sleep(int(min(2e9 * 1.5 * host_s * iters, 2e9)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wall_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def live_pairs(lq, lk, causal, window):
    """(query, key) pairs the inputs need: all of them, or the causal
    (banded) ones."""
    if not causal:
        return lq * lk
    r = np.arange(lq)
    hi = np.minimum(r, lk - 1)
    lo = np.maximum(0, r - (window or lq + lk) + 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def bound(q, causal, window, flops_per_pair=None, n_bytes=None, pairs=None):
    """Least time the card needs: max(FLOPs / peak, bytes / HBM rate).
    Defaults: the forward (4 D FLOPs per live pair; q, k, v read once and
    O written once); ``pairs`` overrides the live-pair count (segment
    masks)."""
    b, lq, h, d = q.shape
    if pairs is None:
        pairs = b * h * live_pairs(lq, lq, causal, window)
    flops = (flops_per_pair or 4 * d) * pairs
    peak = H100_BF16_FLOPS if q.dtype == torch.bfloat16 else H100_F32_FLOPS
    t_ops = flops / peak
    t_bytes = (n_bytes or 4 * q.numel() * q.element_size()) / H100_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def keep_mask(seg, lq, causal, window):
    """[B, L, L] bool: the pairs the kernels keep (causal / window band,
    same segment), or None for full attention."""
    mask = None
    if causal:
        mask = attn._causal_mask(lq, lq, 0, 0, window, "cuda")[None]
    if seg is not None:
        same = seg[:, :, None] == seg[:, None, :]
        mask = same if mask is None else mask & same
    return mask


def packed_segments(batch, length, seed):
    """Segment ids of packed rows (``pack_documents``-style: documents of
    random length laid end to end, fresh ids per row, padding 0 in the
    last row's tail), int32 on the card."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((batch, length), np.int32)
    for row in range(batch):
        pos, sid = 0, 1
        while pos < length:
            n = int(rng.integers(30, 400))
            seg[row, pos:pos + n] = sid
            pos, sid = pos + n, sid + 1
    seg[-1, -37:] = 0
    return torch.from_numpy(seg).to("cuda")


def train_kernel_case(dtype, causal, window, segmented, seed=0,
                      shape=TRAIN_SHAPE):
    """The training kernels at a train-step shape (``shape``: q/k/v [B, L,
    H, D]): the forward with lse against flash_fwd_plain, and the dQ /
    dK/dV kernels against the plain FA2 versions on the same lse /
    delta.  Max errors, and kernel / plain / library times (SDPA:
    forward, and its backward as forward + backward minus forward)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda",
                               dtype=dtype) for _ in range(4))
    seg = packed_segments(shape[0], shape[1], seed) if segmented else None
    scale = 1.0 / shape[-1] ** 0.5
    # f32: summation order (and 3xTF32 products in the backward); bf16: P
    # (and dS in the backward) round to bf16 as tensor-core operands.
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    with torch.no_grad():
        out, lse = attn.flash_fwd_cuda(q, k, v, causal, scale, window, seg,
                                       with_lse=True)
        ref, ref_lse = attn.flash_fwd_plain(q, k, v, causal, scale, window,
                                            seg)
        delta = attn.attention_delta(do, ref)
        dq = attn.flash_bwd_dq_cuda(q, k, v, do, ref_lse, delta, causal,
                                    scale, window, seg)
        dk, dv = attn.flash_bwd_dkv_cuda(q, k, v, do, ref_lse, delta, causal,
                                         scale, window, seg)
        ref_dq = attn.flash_bwd_dq_plain(q, k, v, do, ref_lse, delta, causal,
                                         scale, window, seg)
        ref_dk, ref_dv = attn.flash_bwd_dkv_plain(q, k, v, do, ref_lse,
                                                  delta, causal, scale,
                                                  window, seg)
        torch.cuda.synchronize()
        errs = {}
        for name, got, want in (("fwd_o", out, ref), ("fwd_lse", lse, ref_lse),
                                ("dq", dq, ref_dq), ("dk", dk, ref_dk),
                                ("dv", dv, ref_dv)):
            torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                       rtol=tol, msg=lambda m: f"{name}: {m}")
            errs[name] = float((got.float() - want.float()).abs().max())
        del out, lse, ref, dq, dk, dv, ref_dq, ref_dk, ref_dv
        times = dict(
            fwd_ms=time_ms(lambda: attn.flash_fwd_cuda(
                q, k, v, causal, scale, window, seg, with_lse=True)),
            fwd_plain_ms=time_ms(lambda: attn.flash_fwd_plain(
                q, k, v, causal, scale, window, seg), iters=5),
            dq_ms=time_ms(lambda: attn.flash_bwd_dq_cuda(
                q, k, v, do, ref_lse, delta, causal, scale, window, seg)),
            dq_plain_ms=time_ms(lambda: attn.flash_bwd_dq_plain(
                q, k, v, do, ref_lse, delta, causal, scale, window, seg),
                iters=5),
            dkv_ms=time_ms(lambda: attn.flash_bwd_dkv_cuda(
                q, k, v, do, ref_lse, delta, causal, scale, window, seg)),
            dkv_plain_ms=time_ms(lambda: attn.flash_bwd_dkv_plain(
                q, k, v, do, ref_lse, delta, causal, scale, window, seg),
                iters=5))
    mask = keep_mask(seg, shape[1], causal, window)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    gt = do.transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=None if mask is None else mask[:, None],
        is_causal=causal and mask is None and seg is None)
    with torch.no_grad():
        times["library_fwd_ms"] = time_ms(sdpa)
    fwd_bwd = time_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), gt))
    times["library_bwd_ms"] = fwd_bwd - times["library_fwd_ms"]
    b, lq, h, d = shape
    pairs = (b * h * lq * lq if mask is None
             else h * int(mask.expand(b, lq, lq).sum()))
    elt = q.element_size()
    rows = 2 * b * h * lq * 4 + (0 if seg is None else b * lq * 4)
    bounds = dict(
        fwd=bound(q, causal, window, pairs=pairs,
                  n_bytes=4 * q.numel() * elt + b * h * lq * 4),
        dq=bound(q, causal, window, 6 * d, 5 * q.numel() * elt + rows,
                 pairs),
        dkv=bound(q, causal, window, 8 * d, 6 * q.numel() * elt + rows,
                  pairs))
    return dict(dtype=str(dtype).split(".")[-1], shape=shape, causal=causal,
                window=window, segmented=segmented, live_pairs=pairs,
                max_abs_err=errs, tol=tol, **times,
                **{f"{k}_bound_ms": v[0] for k, v in bounds.items()},
                **{f"{k}_bound_by": v[1] for k, v in bounds.items()})


def kernel_case(dtype, causal, window, seed=0):
    """flash kernel vs the plain (blockwise) version at the prefill
    shape: max error, and kernel / plain / library times."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(PREFILL_SHAPE, generator=gen, device="cuda",
                           dtype=dtype) for _ in range(3))
    scale = 1.0 / PREFILL_SHAPE[-1] ** 0.5
    with torch.no_grad():
        out = attn.flash_attention(q, k, v, causal, window=window)
        ref = attn.blockwise_attention(q, k, v, causal, window=window)
        torch.cuda.synchronize()
        # f32: summation order only; bf16: P rounds to bf16 before P.V.
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)
        err = float((out.float() - ref.float()).abs().max())
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = None
        if window is not None:
            mask = attn._causal_mask(q.shape[1], q.shape[1], 0, 0, window,
                                     q.device)
        sdpa = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None)
        ms = time_ms(lambda: attn.flash_fwd_cuda(q, k, v, causal, scale,
                                                 window))
        plain_ms = time_ms(lambda: attn.blockwise_attention(
            q, k, v, causal, window=window))
        library_ms = time_ms(sdpa)
    bound_ms, bound_by = bound(q, causal, window)
    return dict(dtype=str(dtype).split(".")[-1], causal=causal,
                window=window, max_abs_err=err, tol=tol, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def numpy_params(cfg, seed):
    """Random weights in the reference's layout and scales, from numpy."""
    rng = np.random.default_rng(seed)
    d, f, h, hd, L = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.head_dim, \
        cfg.n_layers

    def dense(shape, fan_in):
        return rng.standard_normal(shape, dtype=np.float32) / np.float32(
            fan_in ** 0.5)

    params = {
        "tok_emb": dense((cfg.vocab_size, d), d),
        "ln_f_scale": np.ones(d, np.float32),
        "layers": {
            "ln1_scale": np.ones((L, d), np.float32),
            "ln2_scale": np.ones((L, d), np.float32),
            "attn": {"wq": dense((L, d, h, hd), d),
                     "wk": dense((L, d, cfg.kv_heads, hd), d),
                     "wv": dense((L, d, cfg.kv_heads, hd), d),
                     "wo": dense((L, h, hd, d), d)},
            "ffn": {"w1": dense((L, d, f), d), "w2": dense((L, f, d), f)},
        },
    }
    if not cfg.rope:
        params["pos_emb"] = dense((cfg.max_len, d), 1.0) * np.float32(0.02)
    return params


def profile_window(name, fn):
    """Device time by kernel (torch.profiler) of one call of ``fn`` after
    a warm call, with the device's busy and idle share of its wall
    time (also returned)."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = wall_s(fn)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    log("profile", window=name, wall_ms=1e3 * wall, device_busy_ms=busy,
        idle_share=1 - busy / (1e3 * wall),
        top=[{"kernel": e.key[:90], "calls": e.count,
              "device_ms": e.self_device_time_total / 1e3}
             for e in top])
    return 1 - busy / (1e3 * wall)


def profile_serve(params, prompt, cfg):
    """Profiled windows of one prefill and of a short generate."""
    profile_window("prefill", lambda: dkt.prefill(params, prompt, cfg,
                                                  last_logits=False))
    profile_window("generate_8_tokens",
                   lambda: dkt.generate(params, prompt, cfg, 8))


def plain_flash(q, k, v):
    """The default attention_fn with the plain version in the kernel's
    place (for the path parity check)."""
    return attn.blockwise_attention(q, k, v, True)


def expect_launches(counts, want, what):
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if counts[name] != want:
            raise AssertionError(f"{what}: {name} launched {counts[name]} "
                                 f"times, expected {want} ({counts})")


def train_phase(np_params, profile):
    """LMTrainer at full width: one warm step, then TRAIN_STEPS steps on
    one repeated batch (the loss must fall), every step through the
    training kernels."""
    cfg = FLAGSHIP_TRAIN
    params = dkt.params_from_numpy(np_params, "cuda")
    batch = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (8, TRAIN_SHAPE[1] + 1)).astype(np.int32)
    trainer = dkt.LMTrainer(cfg, optimizer="adamw", learning_rate=3e-4,
                            batch_size=8)
    trainer.train(batch, params=params)  # warm-up: first-call set-up
    trainer.train(batch, params=params)  # one steady step
    one_s = trainer.training_time
    torch.cuda.reset_peak_memory_stats()
    for name in attn.LAUNCHES:
        attn.LAUNCHES[name] = 0
    trainer.train(np.tile(batch, (TRAIN_STEPS, 1)), params=params)
    launches = dict(attn.LAUNCHES)
    expect_launches(launches, cfg.n_layers * TRAIN_STEPS, "train")
    hist = trainer.history
    if len(hist) != TRAIN_STEPS or not all(np.isfinite(hist)):
        raise AssertionError(f"bad train losses {hist}")
    if not hist[-1] < hist[0]:
        raise AssertionError(f"loss did not fall on a repeated batch: {hist}")
    # Both runs pay the same set-up (param copy, optimizer init), so the
    # difference is TRAIN_STEPS - 1 steady steps.
    step_ms = 1e3 * (trainer.training_time - one_s) / (TRAIN_STEPS - 1)
    log("train", config=dataclasses.asdict(cfg), batch=8,
        seq=TRAIN_SHAPE[1], steps=TRAIN_STEPS, optimizer="adamw",
        learning_rate=3e-4, launches=launches, losses=hist,
        train_s=trainer.training_time, one_step_train_s=one_s,
        step_ms=step_ms,
        tokens_per_s=8 * TRAIN_SHAPE[1] * 1e3 / step_ms,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    if profile:
        opt = dkt.Optimizer("adamw", 3e-4)
        step = dkt.make_train_step(cfg, opt)
        carry = (params, opt.init(params))
        tokens = torch.from_numpy(batch).to("cuda")
        profile_window("train_step", lambda: step(carry, tokens))
    return launches


def train_parity_phase(np_params):
    """One lm_loss gradient at full width in f32 through the kernels and
    through the blockwise tier (autograd, no kernel): every leaf within
    1e-3 * max|g| of the plain one.  (Under the bf16 config the embedding
    gradients are bf16-rounded sums, a rounding of their own; the f32
    config holds the attention backward alone.)  Then two packed
    (segment-masked) steps through the kernels at the training config."""
    cfg = dataclasses.replace(FLAGSHIP_TRAIN, dtype="float32")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, TRAIN_SHAPE[1] + 1)).astype(np.int32)).cuda()
    grads = []
    for fn in (None, plain_flash):  # the blockwise tier under autograd
        params = dkt.params_from_numpy(np_params, "cuda")
        named = named_leaves(params)
        for _, leaf in named:
            leaf.requires_grad_()
        before = dict(attn.LAUNCHES)
        loss = dkt.lm_loss(params, tokens, cfg, attention_fn=fn)
        loss.backward()
        went = attn.LAUNCHES["flash_bwd_dkv"] - before["flash_bwd_dkv"]
        if went != (cfg.n_layers if fn is None else 0):
            raise AssertionError(f"parity run launched dK/dV {went} times")
        grads.append((loss.item(), {path: p.grad.cpu().numpy()
                                    for path, p in named}))
        del params, named, loss
    (loss_k, gk), (loss_p, gp) = grads
    worst = {}
    for path, a in gk.items():
        b = gp[path]
        rel = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        worst[path] = rel
        if not rel <= 1e-3:
            raise AssertionError(f"grad {path}: max|dg| = {rel} * max|g|")
    if not abs(loss_k - loss_p) <= 1e-4:
        raise AssertionError(f"losses differ: {loss_k} vs {loss_p}")

    # Packed rows: documents laid end to end, segments from pack_documents.
    rng = np.random.default_rng(4)
    docs = [rng.integers(1, cfg.vocab_size, size=int(n))
            for n in rng.integers(20, 700, size=60)]
    rows, seg = dkt.pack_documents(docs, TRAIN_SHAPE[1])
    cfg = FLAGSHIP_TRAIN
    params = dkt.params_from_numpy(np_params, "cuda")
    opt = dkt.Optimizer("adamw", 3e-4)
    step = dkt.make_train_step(cfg, opt)
    carry = (params, opt.init(params))
    for name in attn.LAUNCHES:
        attn.LAUNCHES[name] = 0
    seg_losses = []
    for i in range(2):
        carry, loss = step(carry, rows[8 * i:8 * i + 8],
                           segment_ids=seg[8 * i:8 * i + 8])
        seg_losses.append(float(loss))
    seg_launches = dict(attn.LAUNCHES)
    expect_launches(seg_launches, 2 * cfg.n_layers, "packed steps")
    if not all(np.isfinite(seg_losses)):
        raise AssertionError(f"packed losses {seg_losses}")
    log("train_parity", loss_kernel=loss_k, loss_plain=loss_p,
        grad_max_rel_err=max(worst.values()),
        worst_leaf=max(worst, key=worst.get), tol=1e-3,
        packed_rows=int(len(rows)), packed_losses=seg_losses,
        packed_launches=seg_launches)


# The CIFAR CNN as scripts/bench_suite.py:182-188 measures it: the
# mixed_bfloat16 policy, batch 1024, 32 x 32 x 3 inputs, 10 classes, sgd
# at 0.01; here over 64 batches of synthetic data per epoch.
KERAS_BATCH = 1024
KERAS_ROWS = 64 * KERAS_BATCH


def cifar_data(n, seed=0):
    """uint8 ``[n, 32, 32, 3]`` images and int64 labels from a fixed
    teacher: each image is a blocky class prototype blended with noise,
    and its label is the prototype nearest to its 8 x 8 mean-pooled
    pixels (a linear function of them, so a CNN can learn it)."""
    rng = np.random.default_rng(seed)
    protos = rng.uniform(0, 255, (10, 8, 8, 3)).astype(np.float32)
    x = np.empty((n, 32, 32, 3), np.uint8)
    for i in range(0, n, 8192):
        m = min(8192, n - i)
        low = 0.5 * protos[rng.integers(0, 10, m)] + rng.uniform(
            0, 127.5, (m, 8, 8, 3)).astype(np.float32)
        img = np.repeat(np.repeat(low, 4, 1), 4, 2) + rng.normal(
            0, 12, (m, 32, 32, 3)).astype(np.float32)
        x[i:i + m] = np.clip(np.rint(img), 0, 255)
    pooled = x.reshape(n, 8, 4, 8, 4, 3).mean((2, 4), dtype=np.float32)
    flat, t = pooled.reshape(n, -1), protos.reshape(10, -1)
    y = np.argmin((t * t).sum(1) - 2 * flat @ t.T, axis=1).astype(np.int64)
    return x, y


def to_unit(x):
    """The on-device preprocess: uint8 pixels to [0, 1] floats."""
    return x.float() / 255


def keras_trainer(cls, device, batch, epochs, **kw):
    """``cls`` over a fresh ``cifar_cnn`` (numpy-seeded weights) at the
    bench config."""
    model = dkt.zoo.cifar_cnn(seed=kw.pop("seed", 0),
                              policy=kw.pop("policy", "mixed_bfloat16"))
    return cls(model, loss="sparse_categorical_crossentropy",
               batch_size=batch, num_epoch=epochs, preprocess=to_unit,
               device=device, **kw)


def score(model, ds, rows, device):
    """Training accuracy through the predictor path, on ``rows`` rows
    (host-side ``MinMaxTransformer`` scaling: the exported module does
    not embed the trainer's preprocess)."""
    part = dkt.MinMaxTransformer(o_min=0.0, o_max=255.0).transform(
        ds.take(rows))
    scored = dkt.LabelIndexTransformer().transform(
        dkt.ModelPredictor(model, device=device).predict(part))
    return dkt.AccuracyEvaluator().evaluate(scored)


def keras_phase(device="cuda", rows=KERAS_ROWS, batch=KERAS_BATCH,
                epochs=2, profile_steps=16):
    """The paper's path at the bench config: four trainers through
    train() and the predictor path (learning rates high enough to learn
    the teacher in two epochs), then the throughput of the bench's
    measurement mode (SingleTrainer, device-resident data, sgd at 0.01),
    then the parity checks."""
    import warnings

    warnings.filterwarnings("ignore", message="export_model")
    x, y = cifar_data(rows)
    ds = dkt.Dataset.from_arrays(x, y)
    chance = float(np.bincount(y, minlength=10).max() / len(y))
    runs = {}
    # AEASGD's elastic pull slows its escape from the loss plateau of
    # the first ~60 steps (the CPU escaped in round 10 of 16, a card run
    # not by round 16), so it gets twice the epochs.
    for name, cls, n_epochs, kw in (
            ("SingleTrainer", dkt.SingleTrainer, epochs,
             dict(worker_optimizer="sgd", learning_rate=0.05,
                  device_data=True)),
            ("ADAG", dkt.ADAG, epochs, dict(worker_optimizer="adam",
                                            learning_rate=1e-3,
                                            communication_window=4)),
            ("DOWNPOUR", dkt.DOWNPOUR, epochs, {}),
            ("AEASGD", dkt.AEASGD, 2 * epochs,
             dict(learning_rate=0.05, rho=5.0, communication_window=8))):
        t = keras_trainer(cls, device, batch, n_epochs, **kw)
        trained = t.train(ds)
        hist = t.history
        acc = score(trained, ds, min(rows, 8 * batch), device)
        if not (hist and np.all(np.isfinite(hist))):
            raise AssertionError(f"{name}: bad losses {hist}")
        k = max(1, len(hist) // 4)
        if not np.mean(hist[-k:]) < np.mean(hist[:k]):
            raise AssertionError(f"{name}: loss did not fall: {hist}")
        if not acc >= max(0.5, 3 * chance):
            raise AssertionError(f"{name}: training accuracy {acc} (chance "
                                 f"{chance})")
        runs[name] = dict(epochs=n_epochs,
                          losses_first_last=[hist[0], hist[-1]],
                          n_losses=len(hist), train_s=t.training_time,
                          accuracy=acc)

    # Throughput of the measurement mode: two runs differing by two
    # epochs pay the same set-up (staging, state, export).
    t = keras_trainer(dkt.SingleTrainer, device, batch, 1,
                      worker_optimizer="sgd", learning_rate=0.01,
                      device_data=True)
    t.train(ds)
    one = t.training_time
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    t.num_epoch = 3
    t.train(ds)
    steps = 2 * (rows // batch)
    step_ms = 1e3 * (t.training_time - one) / steps
    peak = (torch.cuda.max_memory_allocated() / 2**30 if device != "cpu"
            else None)
    idle = None
    if device != "cpu":
        ad = t.adapter
        state = ad.init_state()
        step = ad.make_indexed_train_step(1)
        X = torch.as_tensor(x, device=device)
        Y = torch.as_tensor(y, device=device)
        blocks = [torch.arange(i * batch, (i + 1) * batch, device=device
                               ).reshape(1, batch)
                  for i in range(profile_steps)]
        idle = profile_window(f"keras_{profile_steps}_steps", lambda: [
            step(state, X, Y, b) for b in blocks])
        del state, X, Y
    log("keras_train", model="cifar_cnn", policy="mixed_bfloat16",
        batch=batch, rows=rows, epochs=epochs, chance=chance, runs=runs,
        cifar_cnn_train_throughput=batch * 1e3 / step_ms,
        step_ms=step_ms, steady_steps=steps, idle_share=idle,
        peak_mem_gb=peak)
    keras_parity(x, y, device, batch)


def keras_parity(x, y, device, batch, steps=4):
    """float32 SingleTrainer on ``device`` against the same run on the
    CPU (same numpy-seeded weights and batches; TF32 off), then
    ADAG(communication_window=1) == SingleTrainer on ``device``
    (deterministic cuDNN)."""
    rows = steps * (batch // 4)
    ds = dkt.Dataset.from_arrays(x[:rows], y[:rows])
    out = {}
    for dev in (device, "cpu"):
        t = keras_trainer(dkt.SingleTrainer, dev, batch // 4, 1,
                          policy="float32", seed=7, worker_optimizer="sgd",
                          learning_rate=0.01)
        m = t.train(ds)
        out[dev] = (np.array(t.history), dkt.keras_numpy_from_module(m)[0])
    (h_d, w_d), (h_c, w_c) = out[device], out["cpu"]
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(h_d, h_c, **tol)
    for a, b in zip(w_d, w_c):
        np.testing.assert_allclose(a, b, **tol)
    hist_err = float(np.abs(h_d - h_c).max())
    w_err = max(float(np.abs(a - b).max()) for a, b in zip(w_d, w_c))

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ds = dkt.Dataset.from_arrays(x[:8 * batch], y[:8 * batch])
        res = []
        for cls, kw in ((dkt.SingleTrainer, {}),
                        (dkt.ADAG, {"communication_window": 1})):
            t = keras_trainer(cls, device, batch, 1, seed=8,
                              worker_optimizer="adam", learning_rate=1e-3,
                              **kw)
            m = t.train(ds)
            res.append((np.array(t.history),
                        dkt.keras_numpy_from_module(m)[0]))
    finally:
        torch.backends.cudnn.deterministic = prev
    (h1, w1), (h2, w2) = res
    adag_hist = float(np.abs(h1 - h2).max())
    adag_w = max(float(np.abs(a - b).max()) for a, b in zip(w1, w2))
    if len(h1) != len(h2) or not max(adag_hist, adag_w) <= 1e-6:
        raise AssertionError(f"ADAG(window=1) != SingleTrainer: losses "
                             f"{adag_hist}, weights {adag_w}")
    log("keras_parity", f32_steps=steps, f32_batch=batch // 4,
        f32_device_vs_cpu_loss_max_abs_err=hist_err,
        f32_device_vs_cpu_weight_max_abs_err=w_err, tol=tol,
        adag_w1_vs_single_steps=len(h1),
        adag_w1_vs_single_loss_max_abs_diff=adag_hist,
        adag_w1_vs_single_weight_max_abs_diff=adag_w, adag_tol=1e-6)


def text_corpus(n_bytes, seed=0):
    """Seeded English-like text from numpy: sentences of 5-15 words drawn
    with Zipf frequencies from 3,000 random lowercase words, so a model
    can learn its statistics."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = ["".join(rng.choice(letters, int(n)))
             for n in rng.integers(2, 9, 3000)]
    freq = 1.0 / np.arange(1, len(words) + 1) ** 1.1
    freq /= freq.sum()
    out, size = [], 0
    while size < n_bytes:
        ids = rng.choice(len(words), size=int(rng.integers(5, 16)), p=freq)
        sentence = " ".join(words[i] for i in ids).capitalize() + ". "
        out.append(sentence)
        size += len(sentence)
    return "".join(out)[:n_bytes]


def variant_params(np_params, cfg):
    """``np_params`` (the long config's) cut to ``cfg``: its K/V heads
    (GQA keeps the first ``kv_heads``), no position table under rope."""
    attn_p = dict(np_params["layers"]["attn"])
    for name in ("wk", "wv"):
        attn_p[name] = np.ascontiguousarray(attn_p[name][:, :, :cfg.kv_heads])
    out = {**np_params, "layers": {**np_params["layers"], "attn": attn_p}}
    if cfg.rope:
        out.pop("pos_emb")
    return out


def zero_launches():
    for name in attn.LAUNCHES:
        attn.LAUNCHES[name] = 0


def expect_long_launches(counts, cfg, steps, what):
    """Per step: the forward kernel once a layer, twice under remat (the
    recompute), each backward kernel once a layer."""
    layers = cfg.n_layers * steps
    want = {"flash_fwd": layers * (2 if cfg.remat else 1),
            "flash_bwd_dq": layers, "flash_bwd_dkv": layers}
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")


def trace_device_time(path):
    """Device time in a torch.profiler chrome trace: the kernels', copies'
    and memsets' busy ms against the span of all timed events (host and
    device) and against the device's own span (first to last device
    event), the device event count, the five longest gaps (ms) between
    consecutive device events, and the device time by kernel name (the
    ten largest)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    dev = sorted((e for e in events
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")),
                 key=lambda e: e["ts"])
    busy = sum(e["dur"] for e in dev)
    wall = (max(e["ts"] + e["dur"] for e in events)
            - min(e["ts"] for e in events))
    dev_wall = dev[-1]["ts"] + dev[-1]["dur"] - dev[0]["ts"]
    gaps = [b["ts"] - (a["ts"] + a["dur"]) for a, b in zip(dev, dev[1:])]
    by_name = {}
    for e in dev:
        ms, calls = by_name.get(e["name"][:90], (0.0, 0))
        by_name[e["name"][:90]] = (ms + e["dur"] / 1e3, calls + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return dict(device_busy_ms=busy / 1e3, wall_ms=wall / 1e3,
                device_span_ms=dev_wall / 1e3, device_events=len(dev),
                idle_share=1 - busy / wall,
                idle_share_device_span=1 - busy / dev_wall,
                longest_gaps_ms=[g / 1e3 for g in sorted(gaps)[-5:]],
                top=[{"kernel": k, "calls": c, "device_ms": ms}
                     for k, (ms, c) in top])


def long_text_phase(np_params, tmp):
    """Text -> tokens -> rows -> trainer: a seeded 1 MiB corpus, the
    native BPE trainer on its first 256 KiB at vocab 2048, the corpus
    encoded into rows of 4096 + 1, and LMTrainer(_long_cfg) over a
    Dataset of 48 of them (shuffled, device-resident, profiled rounds
    2-4): the loss must fall and every step go through the kernels."""
    cfg = LONG_CFG
    t0 = time.perf_counter()
    text = text_corpus(1 << 20)
    corpus_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tok = dkt.BPETokenizer.train(text[:256 << 10], vocab_size=2048)
    bpe_train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = tok.encode_corpus(text, seq_len=LONG_SHAPE[1])
    encode_s = time.perf_counter() - t0
    if tok.last_path != "native":
        raise AssertionError(f"the native BPE library did not run: "
                             f"{dkt_native.build_errors}")
    n = 8 * LONG_TEXT_STEPS
    if len(rows) < n or int(rows.max()) >= cfg.vocab_size:
        raise AssertionError(f"rows {rows.shape}, max id {rows.max()}")
    trainer = dkt.LMTrainer(cfg, optimizer="adamw", learning_rate=3e-4,
                            batch_size=8, shuffle=True, device_data=True,
                            profile_dir=os.path.join(tmp, "profile"))
    params = dkt.params_from_numpy(np_params, "cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    trained = trainer.train(dkt.Dataset({"tokens": rows[:n]}), params=params)
    launches = dict(attn.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del params
    expect_long_launches(launches, cfg, LONG_TEXT_STEPS, "long_train")
    hist = trainer.history
    if len(hist) != LONG_TEXT_STEPS or not all(np.isfinite(hist)):
        raise AssertionError(f"bad losses {hist}")
    if not hist[-1] < hist[0]:
        raise AssertionError(f"the loss did not fall on the text: {hist}")
    path = trainer.profile_path
    if not (path and os.path.getsize(path) > 0):
        raise AssertionError(f"no profiler trace written: {path}")
    prof = trace_device_time(path)
    prof_steps = trainer.profile_steps
    log("long_train", config=dataclasses.asdict(cfg), batch=8,
        seq=LONG_SHAPE[1], steps=LONG_TEXT_STEPS, corpus_bytes=len(text),
        corpus_s=corpus_s, bpe_train_bytes=256 << 10,
        bpe_train_s=bpe_train_s, bpe_vocab=tok.vocab_size,
        encode_s=encode_s, rows=int(len(rows)), tokenizer_path=tok.last_path,
        launches=launches, losses=hist, train_s=trainer.training_time,
        trace=os.path.basename(path), trace_mb=os.path.getsize(path) / 2**20,
        profiled_steps=prof_steps, profile=prof,
        idle_share=prof["idle_share"],
        step_ms=prof["wall_ms"] / prof_steps,
        tokens_per_s=8 * LONG_SHAPE[1] * prof_steps * 1e3 / prof["wall_ms"],
        peak_mem_gb=peak)
    return trained, tok, rows, text, launches


def long_variant(name, cfg, np_params, steps=3):
    """One warm-up and ``steps`` timed train steps of ``cfg`` on seeded
    random tokens, as _measure_lm feeds them."""
    params = dkt.params_from_numpy(variant_params(np_params, cfg), "cuda")
    opt = dkt.Optimizer("adamw", 3e-4)
    step = dkt.make_train_step(cfg, opt)
    carry = [(params, opt.init(params))]
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, LONG_SHAPE[1] + 1)).astype(np.int32)).cuda()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    carry[0], _ = step(carry[0], tokens)  # warm-up
    zero_launches()

    def run():
        losses = []
        for _ in range(steps):
            carry[0], loss = step(carry[0], tokens)
            losses.append(loss)
        return torch.stack(losses).tolist()

    losses, seconds = wall_s(run)
    launches = dict(attn.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del carry, params, opt, step
    expect_long_launches(launches, cfg, steps, name)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: bad losses {losses}")
    step_ms = 1e3 * seconds / steps
    out = dict(variant=name, remat=cfg.remat, remat_policy=cfg.remat_policy,
               rope=cfg.rope, n_kv_heads=cfg.n_kv_heads,
               attention_window=cfg.attention_window, steps=steps,
               losses=losses, launches=launches, step_ms=step_ms,
               tokens_per_s=8 * LONG_SHAPE[1] * 1e3 / step_ms,
               peak_mem_gb=peak)
    log("long_variant", **out)
    return out


def long_serve_phase(params, tok, rows, text, tmp):
    """The trained _long_cfg artefact (a remat config) through save_lm ->
    load_lm -> greedy generate: a [2, 512] prompt of the text and 16
    tokens, the prompt decoded back to the corpus, the new tokens to
    text; the prefill (kernel) path against the sequential decode on a
    64-token prompt."""
    path = os.path.join(tmp, "long_lm.npz")
    t0 = time.perf_counter()
    dkt.save_lm(path, params, LONG_CFG)
    save_s = time.perf_counter() - t0
    loaded, cfg = dkt.load_lm(path)
    if cfg != LONG_CFG or not torch.equal(loaded["tok_emb"],
                                          params["tok_emb"]):
        raise AssertionError("the artefact did not round-trip")
    prompt = rows[:2, :512]
    zero_launches()
    out, gen_s = wall_s(lambda: dkt.generate(loaded, prompt, cfg, 16))
    launches = dict(attn.LAUNCHES)
    if launches != {"flash_fwd": cfg.n_layers, "flash_bwd_dq": 0,
                    "flash_bwd_dkv": 0}:
        raise AssertionError(f"generate launched {launches}")
    out = out.cpu().numpy()
    if (out.shape != (2, 528) or out.dtype != np.int32
            or not np.array_equal(out[:, :512], prompt)
            or out.min() < 0 or out.max() >= cfg.vocab_size):
        raise AssertionError(f"bad generate output {out.shape} {out.dtype}")
    prompt_text = tok.decode(prompt[0])
    if not text.startswith(prompt_text):
        raise AssertionError("the prompt does not decode to the corpus")
    new = out[:, 512:]
    texts = [tok.decode(r[r < tok.vocab_size]) for r in new]
    short = prompt[:, :64]
    via_kernel = dkt.generate(loaded, short, cfg, 16, use_prefill=True)
    sequential = dkt.generate(loaded, short, cfg, 16, use_prefill=False)
    if not torch.equal(via_kernel, sequential):
        raise AssertionError("greedy tokens differ between the prefill "
                             "(kernel) and sequential paths")
    log("long_serve", artefact_mb=os.path.getsize(path) / 2**20,
        save_s=save_s, prompt=list(prompt.shape), new_tokens=16,
        launches=launches, generate_s=gen_s,
        new_ids=new.tolist(), new_ids_in_tokenizer_vocab=int(
            (new < tok.vocab_size).sum()),
        new_text=texts, prompt_tail=prompt_text[-60:],
        f32_prefill_vs_sequential_tokens_equal=True)


def long_phase():
    """Phase long_train: the long-context family at full width on one
    card (text pipeline, served artefact, variants, seq-4096 kernel
    cases).  Returns the launches of its main-path run (the text-fed
    LMTrainer) and the kernel cases."""
    np_params = numpy_params(LONG_CFG, seed=1)
    with tempfile.TemporaryDirectory() as tmp:
        trained, tok, rows, text, launches = long_text_phase(np_params, tmp)
        long_serve_phase(trained, tok, rows, text, tmp)
    del trained
    variants = [long_variant(name, cfg, np_params)
                for name, cfg in LONG_VARIANTS.items()]
    by = {v["variant"]: v for v in variants}
    if not by["long"]["peak_mem_gb"] < by["long_noremat"]["peak_mem_gb"]:
        raise AssertionError("remat did not lower peak memory: "
                             f"{by['long']['peak_mem_gb']} GB against "
                             f"{by['long_noremat']['peak_mem_gb']} GB")
    torch.cuda.empty_cache()
    cases = []
    for window in (None, 1024):
        cases.append(train_kernel_case(torch.float32, True, window, False,
                                       shape=LONG_SHAPE))
        log("kernel_vs_plain", kernel="flash_fwd(lse)+flash_bwd",
            **cases[-1])
    return launches, cases


def main(profile=False):
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t_start = time.perf_counter()

    # 1. Build every kernel (one nvcc per source, in parallel).
    t0 = time.perf_counter()
    _build.build_all()
    log("build", seconds=time.perf_counter() - t0, sources=_build.sources(),
        ptxas=[line for log_ in _build.build_logs.values()
               for line in ptxas_summary(log_)])

    # 2. Each kernel against its plain version, at the prefill shape.
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for causal, window in ((True, None), (True, 256), (False, None)):
            cases.append(kernel_case(dtype, causal, window))
            log("kernel_vs_plain", kernel="flash_fwd", shape=PREFILL_SHAPE,
                **cases[-1])
    main_case = cases[0]   # bf16 causal: what the prefill launches

    # 2b. The training kernels at the train-step shape.
    train_cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for causal, window, segmented in ((True, None, False),
                                          (True, 256, False),
                                          (False, None, False),
                                          (True, None, True)):
            train_cases.append(train_kernel_case(dtype, causal, window,
                                                 segmented))
            log("kernel_vs_plain", kernel="flash_fwd(lse)+flash_bwd",
                **train_cases[-1])
    tmain = train_cases[0]  # f32 causal: what a train step launches
    tbf16 = train_cases[4]  # bf16 causal

    # 3. The serving path at full width: greedy generate, 8 x 512 prompt.
    cfg = FLAGSHIP
    np_params = numpy_params(cfg, seed=0)
    params = dkt.params_from_numpy(np_params, "cuda", dtype=torch.bfloat16)
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (8, 512)).astype(np.int32)
    torch.cuda.reset_peak_memory_stats()
    for name in attn.LAUNCHES:
        attn.LAUNCHES[name] = 0
    out, gen_s = wall_s(lambda: dkt.generate(params, prompt, cfg,
                                             NEW_TOKENS))
    launches = dict(attn.LAUNCHES)
    serve_fwd_launches = launches["flash_fwd"]
    if launches["flash_fwd"] != cfg.n_layers:
        raise AssertionError(f"prefill launched flash_fwd "
                             f"{launches['flash_fwd']} times, expected "
                             f"{cfg.n_layers}")
    if (tuple(out.shape) != (8, 512 + NEW_TOKENS) or out.dtype != torch.int32
            or not torch.equal(out[:, :512].cpu(), torch.from_numpy(prompt))
            or int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size):
        raise AssertionError(f"bad generate output {tuple(out.shape)} "
                             f"{out.dtype}")
    # Steady-state times (the first call above paid the warm-up).
    _, prefill_s = wall_s(lambda: dkt.prefill(params, prompt, cfg,
                                              last_logits=False))
    _, gen2_s = wall_s(lambda: dkt.generate(params, prompt, cfg,
                                            NEW_TOKENS))
    log("serve", config=dataclasses.asdict(cfg), batch=8, prompt=512,
        new_tokens=NEW_TOKENS, launches=launches, first_call_s=gen_s,
        generate_s=gen2_s, prefill_ms=1e3 * prefill_s,
        decode_ms_per_token=1e3 * (gen2_s - prefill_s) / NEW_TOKENS,
        tokens_per_s=8 * NEW_TOKENS / gen2_s,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    if profile:
        profile_serve(params, prompt, cfg)

    # 4. Path parity: kernel vs plain attention through the whole model,
    # and f32 prefill (kernel) vs sequential decode (no kernel) tokens.
    toks = torch.from_numpy(prompt)
    with torch.no_grad():
        lk, _ = dkt.apply(params, toks, cfg)
        lp, _ = dkt.apply(params, toks, cfg, attention_fn=plain_flash)
    bf16_err = float((lk - lp).abs().max())
    bf16_scale = float(lp.abs().max())
    del lk, lp
    # bf16: the kernel rounds P to bf16 before P.V, the plain version
    # does not; 8 bf16 layers carry that into the logits.
    if not bf16_err <= 2e-2 * bf16_scale:
        raise AssertionError(f"bf16 logits differ by {bf16_err} "
                             f"(max |logit| {bf16_scale})")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = dkt.params_from_numpy(np_params, "cuda", dtype=torch.float32)
    with torch.no_grad():
        lk, _ = dkt.apply(params32, toks[:2], cfg32)
        lp, _ = dkt.apply(params32, toks[:2], cfg32, attention_fn=plain_flash)
    f32_err = float((lk - lp).abs().max())
    del lk, lp
    if not f32_err <= 1e-3:
        raise AssertionError(f"f32 logits differ by {f32_err}")
    short = prompt[:2, :128]
    before = attn.LAUNCHES["flash_fwd"]
    via_kernel = dkt.generate(params32, short, cfg32, 16, use_prefill=True)
    mid = attn.LAUNCHES["flash_fwd"]
    sequential = dkt.generate(params32, short, cfg32, 16, use_prefill=False)
    if mid - before != cfg.n_layers or attn.LAUNCHES["flash_fwd"] != mid:
        raise AssertionError("the prefill / sequential runs did not take "
                             "the expected paths")
    if not torch.equal(via_kernel, sequential):
        raise AssertionError("f32 greedy tokens differ between the prefill "
                             "(kernel) and sequential paths")
    log("parity", bf16_logit_max_abs_err=bf16_err,
        bf16_logit_max_abs=bf16_scale, f32_logit_max_abs_err=f32_err,
        f32_prefill_vs_sequential_tokens_equal=True,
        seconds_total=time.perf_counter() - t_start)
    del params, params32

    # 5. The training path at full width, and its parity.
    train_np = numpy_params(FLAGSHIP_TRAIN, seed=1)
    train_launches = train_phase(train_np, profile)
    train_parity_phase(train_np)

    # 6. The paper's path: the Keras trainer family on the CIFAR CNN.
    keras_phase()

    # 7. Long-context LM training from raw text, at seq 4096.
    torch.cuda.empty_cache()
    long_launches, long_cases = long_phase()
    log("done", seconds_total=time.perf_counter() - t_start)

    bwd_source = "distkeras_tpu_torch/ops/csrc/flash_bwd.cu"

    def bwd_times(case, name, errs):
        return {"max_abs_err": max(case["max_abs_err"][e] for e in errs),
                "ms": case[f"{name}_ms"], "plain_ms": case[f"{name}_plain_ms"],
                "bound_ms": case[f"{name}_bound_ms"],
                "bound_by": case[f"{name}_bound_by"],
                "library_ms": case["library_bwd_ms"]}

    def fwd_times(case):
        return {"max_abs_err": max(case["max_abs_err"]["fwd_o"],
                                   case["max_abs_err"]["fwd_lse"]),
                "ms": case["fwd_ms"], "plain_ms": case["fwd_plain_ms"],
                "bound_ms": case["fwd_bound_ms"],
                "bound_by": case["fwd_bound_by"],
                "library_ms": case["library_fwd_ms"]}

    lcausal, lwindow = long_cases  # f32 [8, 4096, 8, 128]: causal, 1024

    def launch_counts(name, *paths):
        return {"launches": sum(p[name] for p in paths),
                "launches_by_path": {k: p[name] for k, p in zip(
                    ("serve", "train", "long_train"), paths)}}

    print(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "distkeras_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "distkeras_tpu/ops/attention.py:197",
        **launch_counts("flash_fwd", {"flash_fwd": serve_fwd_launches},
                   train_launches, long_launches),
        "max_abs_err": main_case["max_abs_err"], "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"], "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "f32_lse_causal": fwd_times(tmain),
        "f32_lse_causal_seq4096": fwd_times(lcausal),
        "f32_lse_window1024_seq4096": fwd_times(lwindow)}, {
        "name": "flash_bwd_dq", "route": "cuda", "source": bwd_source,
        "replaces": "distkeras_tpu/ops/attention.py:438",
        **launch_counts("flash_bwd_dq", {"flash_bwd_dq": 0}, train_launches,
                        long_launches),
        **bwd_times(tmain, "dq", ("dq",)),
        "bf16_causal": bwd_times(tbf16, "dq", ("dq",)),
        "f32_causal_seq4096": bwd_times(lcausal, "dq", ("dq",)),
        "f32_window1024_seq4096": bwd_times(lwindow, "dq", ("dq",))}, {
        "name": "flash_bwd_dkv", "route": "cuda", "source": bwd_source,
        "replaces": "distkeras_tpu/ops/attention.py:498",
        **launch_counts("flash_bwd_dkv", {"flash_bwd_dkv": 0},
                        train_launches, long_launches),
        **bwd_times(tmain, "dkv", ("dk", "dv")),
        "bf16_causal": bwd_times(tbf16, "dkv", ("dk", "dv")),
        "f32_causal_seq4096": bwd_times(lcausal, "dkv", ("dk", "dv")),
        "f32_window1024_seq4096": bwd_times(lwindow, "dkv",
                                            ("dk", "dv"))}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(profile="--profile" in sys.argv[1:]))

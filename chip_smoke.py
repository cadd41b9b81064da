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
  [8, 4096, 8, 128];
- continuous batching (phase ``engine``, its profiled window at the
  end of the script): ``ContinuousBatcher``
  under an open-loop load of 48 requests at 32 requests/s (TTFT, TPOT,
  tokens/s, idle share, a sample against batch-1 ``generate``); a
  ``PrefixPool`` of two ``prefill`` segments (the forward kernel)
  against ``generate(prompt_cache=)`` and against a pool-less engine
  that admits prefix + tail through the plain attention; chunked
  prefill of a 768-token prompt beside 7 decoding lanes against
  monolithic admission; ``SpeculativeBatcher`` with the target and its
  first 2 layers as drafts against plain decode (the bf16 self-draft
  may reject a proposal only at a near tie), and
  ``speculative_generate`` (whose warm prefills launch the forward
  kernel); an f32 2-layer schedule on the card against the CPU, and the
  f32 self-draft accepting every proposal.  bf16 greedy tokens of two
  paths must agree up to a near tie of the reference's logits
  (``greedy_agreement``);
- the model surface: phase ``moe_serve`` (the flagship serving config
  with 8 experts, top-1 and top-2: prefill through the forward kernel
  with the dense routing, the per-token expert gather, and f32 prefill
  == sequential tokens), phase ``int8_serve`` (``quantize_params`` on
  the card == the CPU bit for bit; the int8 tree decoding with no kernel
  launch; ``generate(kv_int8=True)`` through the kernel prefill against
  the sequential path; ``ContinuousBatcher(kv_int8=True)`` with an f32
  schedule == solo ``generate``; the int8 tree drafting for its f32
  parent with the parent's greedy tokens; a ``kv_int8`` ``PrefixPool``
  segment), phase ``moe_train`` (``LMTrainer`` over the MoE training
  rows, top-1 and top-2: step ms, tokens/s, peak GB, aux loss, drop
  share; the index dispatch against the reference's one-hot einsums on
  one layer at full width; the f32 gradient parity) and phase
  ``lora_train`` (``LoRATrainer`` rank 8 on wq / wv: the base
  bit-identical, the optimizer holding the adapters only, ``train`` ==
  ``lora_merge(base, adapters)``);
- data parallelism: phase ``dp_lm`` (``LMTrainer`` at the training
  width in a world-1 NCCL group — the card's machine has one card — with
  the plain exchange, ``zero=1``, ``zero=3``, ``merge_rule="adasum"``
  and ``compress="int8"``: step ms against phase ``train``'s, the ZeRO
  stages' losses and gradients against ``zero=None``, the int8 first
  update against the codec, the kernels' launches under ``"dp"``),
  phase ``dp_keras`` (two ranks sharing the card through
  ``deploy.Job.run_local()``: NCCL's refusal of two ranks on one
  device, then gloo over CUDA tensors — ADAG and AEASGD at
  ``num_workers=2`` on the CIFAR CNN, world-2 ADAG against world-1 at
  twice the batch) and phase ``async_dp`` (``AsyncDP(hosts=4)`` on the
  card against the CPU: event log, report and weights).  ``python3
  chip_smoke.py --dp-rank MODE DIR`` is one rank of ``dp_keras``;
- checkpoint and resilience (phase ``resume``): (a) ``LMTrainer`` at
  the training width with dropout 0.1, two straight 6-step runs (which
  must be bit-identical), then the same trainer under a ``Supervisor``
  with ``checkpoint_every=2`` and ``FaultPlan.preempt("train.round",
  at=3)``: it resumes from step 2 and must end bit-identical to the
  straight run (params, and rounds 3-6's losses), with save / restore /
  load seconds, the checkpoint's GB and the step ms after the restore
  against the straight run's; (b) the same with ``zero=1`` in a world-1
  NCCL group; (c) two gloo ranks of ADAG on the CIFAR CNN (f32) under
  ``resilience.cluster.run_cluster_local``, host 1 killed at a seeded
  round: both hosts restart under epoch 1 and the job's weights must
  equal a straight run's bit for bit.  ``python3 chip_smoke.py
  --cluster-rank SPEC`` is one host of (c).  The script sets
  ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` before CUDA starts.

Usage: python3 chip_smoke.py [--profile]     (needs one CUDA device)

``--profile`` adds the device time by kernel (torch.profiler) of one
prefill, a short generate and one train step, and of the model
surface's top-2 MoE train step and 8-token generates (MoE, int8 tree,
``kv_int8``), these last after every timed phase.

Output: the card's name and power limit, one line per phase, then a
``{"kernels": [...]}`` line and, last, the ``{"ok": true, "device": ...}``
line.  Any failed phase raises, so the exit code is nonzero.  In the
kernels line, ``flash_fwd``'s times are the serving prefill case (bf16,
causal, no lse), with the training case (f32, causal, with lse) beside
it under ``"f32_lse_causal"`` and the engine's prefill shapes under
``"bf16_causal_pool256"``, ``"bf16_causal_pool128"`` and
``"bf16_causal_spec_warm"`` and the f32 speculative warm-up of
``int8_serve`` under ``"f32_causal_spec_int8_warm"``, and its launches
those of every main-path run: serve, engine, train, long_train, the
four model-surface phases, ``dp`` and ``resume`` (the supervised runs
of (a) and (b)) (``launches_by_path``; a run that only serves a
comparison is not counted); the backward kernels' times are the
training case (f32, causal) and their launches those of the training
runs (train, long_train, moe_train, lora_train, dp, resume), with the
bf16 causal case beside it under ``"bf16_causal"``; each kernel also
carries its seq-4096 f32 readings (causal, and window 1024).
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time

# cuBLAS picks its GEMM reductions deterministically only with a fixed
# workspace, set before CUDA starts (phase resume holds a resumed run
# against a straight one bit for bit).
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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


def kernel_case(dtype, causal, window, seed=0, shape=PREFILL_SHAPE):
    """flash kernel vs the plain (blockwise) version at a prefill shape
    (``shape``: q/k/v [B, L, H, D]): max error, and kernel / plain /
    library times."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda",
                           dtype=dtype) for _ in range(3))
    scale = 1.0 / shape[-1] ** 0.5
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
    return dict(dtype=str(dtype).split(".")[-1], shape=shape, causal=causal,
                window=window, max_abs_err=err, tol=tol, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def numpy_params(cfg, seed):
    """Random weights in the reference's layout and scales, from numpy
    (the MoE FFN's ``wg`` / ``w1`` / ``w2`` for an MoE config)."""
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
        },
    }
    e = cfg.num_experts
    params["layers"].update(
        {"moe": {"wg": dense((L, d, e), d), "w1": dense((L, e, d, f), d),
                 "w2": dense((L, e, f, d), f)}} if e else
        {"ffn": {"w1": dense((L, d, f), d), "w2": dense((L, f, d), f)}})
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
    return launches, step_ms


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


# The engine phase: the flagship config, as scripts/bench_serving.py's
# engine rows drive ContinuousBatcher / SpeculativeBatcher.
ENGINE_LANES = 8
LOAD_REQUESTS, LOAD_PROMPT, LOAD_NEW, LOAD_RPS = 48, 64, 128, 32.0
SPEC_NEW, SPEC_DRAFT = 256, 3
# Random weights make the target's first 2 layers a draft that agrees
# with it by chance only (acceptance 0.001 at full width on an H100).
# Phase (d)'s target therefore scales the residual writes (wo, w2) of its
# layers 3-8 by DEEP_SCALE, as if the deep layers refined what a
# distilled shallow draft already predicts.
DEEP_SCALE = 0.1
# Two bf16 paths through the model (kernel and plain attention, or a
# chunk and single steps) differ by up to 2% of max |logit| (phase
# `parity`'s bound); greedy tokens of two such paths may part only where
# the reference's top-2 logit gap is inside that bound.
BF16_PATH_TOL = 2e-2


def top2_gap(params, cfg, seq):
    """The gap between the top two next-token logits after ``seq``
    (teacher-forced through ``apply``), as a share of max |logit|.  A
    comparison, so its kernel launches are not counted."""
    counts = dict(attn.LAUNCHES)
    with torch.no_grad():
        logits, _ = dkt.apply(params, torch.from_numpy(
            np.asarray(seq)[None]).cuda(), cfg)
    attn.LAUNCHES.update(counts)
    row = logits[0, -1].float()
    top2 = row.topk(2).values
    return float((top2[0] - top2[1]) / row.abs().max())


def greedy_agreement(out, ref, params, cfg, prompt_len, context=None):
    """Greedy tokens ``out`` against ``ref`` (both prompt + generation,
    past an optional ``context`` prefix): equal, or parted at a step
    where ``ref``'s own top-2 logit gap (teacher-forced through
    ``apply``) lies within BF16_PATH_TOL of max |logit| — a near tie that
    bf16 rounding may break either way.  Raises otherwise; returns
    ``(exact, first_diff, gap / max|logit|)``."""
    out, ref = np.asarray(out), np.asarray(ref)
    n = min(len(out), len(ref))
    diff = np.nonzero(out[:n] != ref[:n])[0]
    if not len(diff) and len(out) == len(ref):
        return True, None, None
    if not len(diff):
        raise AssertionError(f"lengths differ: {len(out)} vs {len(ref)}")
    d = int(diff[0])
    if d < prompt_len:
        raise AssertionError(f"prompts differ at {d}")
    seq = ref[:d] if context is None else np.concatenate([context, ref[:d]])
    rel = top2_gap(params, cfg, seq)
    if not rel <= BF16_PATH_TOL:
        raise AssertionError(
            f"greedy tokens part at generated step {d - prompt_len} where "
            f"the reference's top-2 gap is {rel:.4f} of max |logit| "
            f"(> {BF16_PATH_TOL}): not a near tie")
    return False, d - prompt_len, rel


def agreement_summary(results):
    """Counts of exact matches and the near-tie partings."""
    return {"requests": len(results),
            "exact": sum(1 for r in results if r[0]),
            "near_tie_partings": [{"step": r[1], "gap_rel": r[2]}
                                  for r in results if not r[0]]}


def drain_all(eng, lanes):
    return [eng.drain(lane) for lane in lanes]


def run_engine(eng, lanes, step_args=(4,)):
    while eng.running():
        eng.step(*step_args)
    return drain_all(eng, lanes)


def engine_idle_share(params, cfg):
    """The device's idle share over a profiled steady window of 4
    step(4) calls with 8 busy lanes (run at the end of the script, with
    the other profiled windows: the profiler may leave the host slower
    behind it, so the host-timed phases run before any of them)."""
    rng = np.random.default_rng(9)
    eng = dkt.ContinuousBatcher(params, cfg, lanes=ENGINE_LANES)
    lanes = [eng.submit(p, LOAD_NEW) for p in rng.integers(
        0, cfg.vocab_size, (ENGINE_LANES, LOAD_PROMPT)).astype(np.int32)]
    eng.step(4)
    idle = profile_window("engine_4x_step4",
                          lambda: [eng.step(4) for _ in range(4)])
    run_engine(eng, lanes)
    return idle


def engine_load(params, cfg):
    """(a) Open-loop load as bench_engine_load(8, 32.0): 48 requests,
    prompt 64, 128 new tokens, seeded exponential inter-arrivals at 32
    requests/s, step(4) windows, one warm-up request before the clock.
    TTFT and TPOT at p50 / p99, achieved tokens/s, peak memory, and a
    sample of 4 requests against batch-1 generate."""
    rng = np.random.default_rng(0)
    arrivals = np.cumsum(rng.exponential(1.0 / LOAD_RPS, LOAD_REQUESTS))
    prompts = rng.integers(0, cfg.vocab_size,
                           (LOAD_REQUESTS, LOAD_PROMPT)).astype(np.int32)
    eng = dkt.ContinuousBatcher(params, cfg, lanes=ENGINE_LANES)
    warm = eng.submit(prompts[0], LOAD_NEW)
    run_engine(eng, [warm])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    lane_req, outs = {}, {}
    first_t = np.full(LOAD_REQUESTS, np.nan)
    done_t = np.full(LOAD_REQUESTS, np.nan)
    n_tok = np.zeros(LOAD_REQUESTS, np.int64)
    nxt, windows = 0, 0
    t0 = time.perf_counter()
    while np.isnan(done_t).any():
        now = time.perf_counter() - t0
        while (nxt < LOAD_REQUESTS and arrivals[nxt] <= now
               and eng.free_lanes()):
            lane_req[eng.submit(prompts[nxt], LOAD_NEW)] = nxt
            nxt += 1
        if not eng.running():
            if nxt < LOAD_REQUESTS:
                time.sleep(max(0.0, arrivals[nxt]
                               - (time.perf_counter() - t0)))
            continue
        out = eng.step(4)
        windows += 1
        now = time.perf_counter() - t0
        for lane, toks in out.items():
            rid = lane_req[lane]
            if toks and np.isnan(first_t[rid]):
                first_t[rid] = now
            n_tok[rid] += len(toks)
        for lane, rid in list(lane_req.items()):
            if lane not in eng.running():
                done_t[rid] = now
                outs[rid] = eng.drain(lane)
                del lane_req[lane]
    launches = dict(attn.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if launches["flash_fwd"] != 0:
        raise AssertionError(f"engine admission launched {launches}: it "
                             "must run the plain chunk attention")
    if int(n_tok.sum()) != LOAD_REQUESTS * LOAD_NEW:
        raise AssertionError(f"emitted {int(n_tok.sum())} tokens")
    makespan = float(np.nanmax(done_t))
    ttft = first_t - arrivals
    tpot = (done_t - first_t) / np.maximum(n_tok - 1, 1)
    pct = lambda a, q: float(np.percentile(a, q)) * 1e3
    sample = (0, 13, 29, 47)
    agree = []
    for rid in sample:
        ref = dkt.generate(params, prompts[rid:rid + 1], cfg,
                           LOAD_NEW)[0].cpu().numpy()
        agree.append(greedy_agreement(outs[rid], ref, params, cfg,
                                      LOAD_PROMPT))
    log("engine_load", config=dataclasses.asdict(cfg), lanes=ENGINE_LANES,
        requests=LOAD_REQUESTS, prompt=LOAD_PROMPT, new_tokens=LOAD_NEW,
        offered_rps=LOAD_RPS, step_window=4, windows=windows,
        makespan_s=makespan, tokens=int(n_tok.sum()),
        tokens_per_s=float(n_tok.sum()) / makespan,
        achieved_rps=LOAD_REQUESTS / makespan,
        ttft_p50_ms=pct(ttft, 50), ttft_p99_ms=pct(ttft, 99),
        tpot_p50_ms=pct(tpot, 50), tpot_p99_ms=pct(tpot, 99),
        peak_mem_gb=peak, launches=launches,
        vs_generate=agreement_summary(agree), sample=list(sample))


def engine_prefix(params, cfg):
    """(b) A PrefixPool of 2 segments built by prefill (the forward
    kernel, n_layers launches each); 8 requests over the two prefixes
    against generate(tail, prompt_cache=(segment, P))."""
    rng = np.random.default_rng(5)
    prefixes = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                for n in (256, 128)]
    pool = dkt.PrefixPool(cfg, slots=2)
    zero_launches()
    ids, segs = [], []
    for pref in prefixes:
        seg, _ = dkt.prefill(params, pref[None], cfg, last_logits=False)
        segs.append(seg)
        ids.append(pool.put(seg, len(pref), last_token=int(pref[-1])))
    launches = dict(attn.LAUNCHES)
    if launches["flash_fwd"] != 2 * cfg.n_layers:
        raise AssertionError(f"pool segments launched {launches}")
    eng = dkt.ContinuousBatcher(params, cfg, lanes=ENGINE_LANES,
                                prefix_pool=pool)
    tails = rng.integers(0, cfg.vocab_size, (8, 32)).astype(np.int32)
    lanes = [eng.submit(tails[i], 64, prefix_id=ids[i % 2])
             for i in range(8)]
    t0 = time.perf_counter()
    outs = run_engine(eng, lanes)
    serve_s = time.perf_counter() - t0
    if any(pool.refs_of(i) for i in ids):
        raise AssertionError("pool pins not released at drain")
    agree = []
    for j in range(2):   # one generate per prefix, its 4 tails batched
        refs = dkt.generate(params, tails[j::2], cfg, 64,
                            prompt_cache=(segs[j], len(prefixes[j])))
        agree += [greedy_agreement(out, ref, params, cfg, 32,
                                   context=prefixes[j])
                  for out, ref in zip(outs[j::2], refs.cpu().numpy())]
    # The segments against no kernel at all: a pool-less engine admits
    # prefix + tail through the plain chunk attention.
    plain = dkt.ContinuousBatcher(params, cfg, lanes=ENGINE_LANES)
    whole = run_engine(plain, [plain.submit(np.concatenate(
        [prefixes[i % 2], tails[i]]), 64) for i in range(8)])
    no_pool = [greedy_agreement(out, ref[len(prefixes[i % 2]):], params,
                                cfg, 32, context=prefixes[i % 2])
               for i, (out, ref) in enumerate(zip(outs, whole))]
    log("engine_prefix", prefixes=[len(p) for p in prefixes], requests=8,
        tail=32, new_tokens=64, launches=launches, serve_s=serve_s,
        vs_generate_prompt_cache=agreement_summary(agree),
        vs_poolless_engine=agreement_summary(no_pool))
    return launches["flash_fwd"]


def engine_chunked(params, cfg):
    """(c) A 768-token prompt (64 new tokens) admitted with
    prefill_chunk=128 while 7 lanes decode: its tokens against monolithic
    admission's, and the largest gap between two decode windows of the
    other lanes while it admits."""
    rng = np.random.default_rng(6)
    short = rng.integers(0, cfg.vocab_size, (7, 64)).astype(np.int32)
    long_p = rng.integers(0, cfg.vocab_size, 768).astype(np.int32)
    eng = dkt.ContinuousBatcher(params, cfg, lanes=ENGINE_LANES,
                                prefill_chunk=128)
    others = [eng.submit(p, 200) for p in short]
    eng.step(4)
    torch.cuda.synchronize()
    t = time.perf_counter()
    gaps_plain = []
    for _ in range(3):
        eng.step(4)
        gaps_plain.append(time.perf_counter() - t)
        t = time.perf_counter()
    lane = eng.submit(long_p, 64)
    chunks = len(eng._lane_state[lane].chunks) + 1
    gaps = [time.perf_counter() - t]
    t = time.perf_counter()
    while eng._lane_state[lane].chunks is not None:
        out = eng.step(4)
        gaps.append(time.perf_counter() - t)
        t = time.perf_counter()
        if any(len(out.get(o, [])) != 4 for o in others):
            raise AssertionError("a decoding lane stalled during admission")
    chunked = run_engine(eng, [lane] + others)[0]
    mono = dkt.ContinuousBatcher(params, cfg, lanes=1)
    ref = run_engine(mono, [mono.submit(long_p, 64)])[0]
    agree = greedy_agreement(chunked, ref, params, cfg, 768)
    log("engine_chunked", prompt=768, new_tokens=64, prefill_chunk=128,
        chunks=chunks, decoding_lanes=7,
        window_gap_ms_before=[1e3 * g for g in gaps_plain],
        window_gaps_ms_admitting=[1e3 * g for g in gaps],
        largest_gap_ms=1e3 * max(gaps),
        vs_monolithic=agreement_summary([agree]))


def draft_layers(params, n):
    """The target's first ``n`` layers with its embedding and ln_f."""
    return {**params, "layers": {k: (v[:n] if not isinstance(v, dict) else
                                     {kk: vv[:n] for kk, vv in v.items()})
                                 for k, v in params["layers"].items()}}


def deep_scaled(np_params):
    """``np_params`` with the residual writes of layers 3.. scaled by
    DEEP_SCALE (phase (d)'s target)."""
    layers = {**np_params["layers"]}
    for grp, key in (("attn", "wo"), ("ffn", "w2")):
        w = layers[grp][key].copy()
        w[2:] *= np.float32(DEEP_SCALE)
        layers[grp] = {**layers[grp], key: w}
    return {**np_params, "layers": layers}


def self_draft_rejections(rounds, lanes, outs, params, cfg, prompt_len,
                          new, rejected):
    """The target as its own bf16 draft: the draft's chunks (T = 2, 1, 1)
    and the verify chunk (T = n_draft + 1) round apart, so a proposal
    may be rejected, but only at a near tie.  A lane's round that emits
    fewer than ``min(n_draft + 1, budget left)`` tokens rejected the
    proposal in its last token's place; the target's top-2 logit gap
    there must lie within BF16_PATH_TOL of max |logit|.  ``rejected``
    (the engine's count of rejected proposals) must be covered by the
    rejections found, but for what a lane's last, budget-cut round may
    hide.  Raises otherwise; returns the rejections' gaps."""
    found, gaps = 0, []
    for lane, out in zip(lanes, outs):
        done = 0
        for r in rounds:
            toks = r.get(lane, [])
            if len(toks) < min(SPEC_DRAFT + 1, new - done):
                found += SPEC_DRAFT - (len(toks) - 1)
                gaps.append(top2_gap(params, cfg,
                                     out[:prompt_len + done + len(toks) - 1]))
            done += len(toks)
    hidden = len(lanes) * SPEC_DRAFT    # one cut round per lane at most
    if not found <= rejected <= found + hidden:
        raise AssertionError(f"found {found} rejected proposals, the "
                             f"engine counted {rejected}")
    if gaps and not max(gaps) <= BF16_PATH_TOL:
        raise AssertionError(
            f"the target as its own draft rejected a proposal where the "
            f"top-2 gap is {max(gaps):.4f} of max |logit| (> "
            f"{BF16_PATH_TOL}): not a near tie")
    return {"rounds_with_rejection": len(gaps), "rejected_proposals":
            rejected, "gaps_rel": sorted(gaps)}


def engine_speculative(np_params, cfg):
    """(d) SpeculativeBatcher(lanes=8, n_draft=3) against
    ContinuousBatcher at step(4) over 8 x 256 tokens, as
    bench_engine_speculative drives them (a short warm-up run, then the
    timed run), with two drafts: the target itself and its first 2
    layers (the target's deep layers scaled, DEEP_SCALE); then
    speculative_generate at batch 8 (its prefill warm-up of both models:
    the forward kernel)."""
    params = dkt.params_from_numpy(deep_scaled(np_params), "cuda",
                                   dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (8, 64)).astype(np.int32)

    def drive(eng, *step_args):
        runs = []
        for new in (16, SPEC_NEW):  # warm-up, then timed
            lanes = [eng.submit(prompts[i], new) for i in range(8)]
            rounds = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            while eng.running():
                rounds.append(eng.step(*step_args))
            dt = time.perf_counter() - t0
            runs.append((drain_all(eng, lanes), lanes, rounds, dt))
        return runs[-1]

    plain, _, plain_rounds, plain_dt = drive(
        dkt.ContinuousBatcher(params, cfg, lanes=8), SPEC_DRAFT + 1)
    rows = {}
    launches = 0
    for name, n_layers in (("self", cfg.n_layers), ("first2", 2)):
        dcfg = dataclasses.replace(cfg, n_layers=n_layers)
        draft = draft_layers(params, n_layers)
        eng = dkt.SpeculativeBatcher(params, draft, cfg, dcfg, lanes=8,
                                     n_draft=SPEC_DRAFT)
        with dkt.obs.session() as sess:
            outs, lanes, rounds, dt = drive(eng)
            reg = sess.registry
            proposed = reg.counter("serving.spec.proposed").value()
            accepted = reg.counter("serving.spec.accepted").value()
        acc = accepted / proposed
        if eng.degraded:
            raise AssertionError(f"draft {name}: the engine degraded "
                                 f"({eng.degraded_error!r})")
        agree = [greedy_agreement(o, r, params, cfg, 64)
                 for o, r in zip(outs, plain)]
        rows[name] = dict(draft_layers=n_layers, rounds=len(rounds),
                          seconds=dt, tokens_per_s=8 * SPEC_NEW / dt,
                          acceptance_rate=acc,
                          vs_plain=agreement_summary(agree))
        if name == "self":
            rows[name]["rejections"] = self_draft_rejections(
                rounds, lanes, outs, params, cfg, 64, SPEC_NEW,
                int(proposed - accepted))
        zero_launches()
        out, stats = dkt.speculative_generate(params, draft, prompts, cfg,
                                              dcfg, 32, n_draft=SPEC_DRAFT)
        launched = dict(attn.LAUNCHES)
        if launched["flash_fwd"] != cfg.n_layers + n_layers:
            raise AssertionError(f"speculative warm-up launched {launched}")
        launches += launched["flash_fwd"]
        out = out.cpu().numpy()
        solo = [greedy_agreement(out[i], plain[i][:64 + 32], params, cfg, 64)
                for i in range(8)]
        rows[name]["speculative_generate"] = dict(
            iterations=int(stats["iterations"]),
            acceptance_rate=float(stats["acceptance_rate"]),
            launches=launched, vs_plain=agreement_summary(solo))
    if not 0.1 < rows["first2"]["acceptance_rate"] < 0.95:
        raise AssertionError("the 2-layer draft is not a partial draft: "
                             f"{rows['first2']['acceptance_rate']}")
    log("engine_speculative", lanes=8, n_draft=SPEC_DRAFT,
        new_tokens=SPEC_NEW, prompt=64, deep_scale=DEEP_SCALE,
        plain=dict(step_window=SPEC_DRAFT + 1, rounds=len(plain_rounds),
                   seconds=plain_dt, tokens_per_s=8 * SPEC_NEW / plain_dt),
        **rows)
    return launches


def engine_schedule(params, cfg, device):
    """(e)'s schedule: 4 lanes, staggered admissions, a 1-token prompt
    and a reused lane; returns every request's tokens."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (16, 9, 1, 12, 5)]
    eng = dkt.ContinuousBatcher(params, cfg, lanes=4, device=device)
    outs = {}
    a = eng.submit(prompts[0], 24)
    eng.step(4)
    eng.step(2)
    b, c = eng.submit(prompts[1], 20), eng.submit(prompts[2], 16)
    eng.step(3)
    d = eng.submit(prompts[3], 12)
    for name, lane in zip("abcd", (a, b, c, d)):
        while lane in eng.running():
            eng.step(4)
        outs[name] = eng.drain(lane)
    e = eng.submit(prompts[4], 20)     # a reused lane
    while e in eng.running():
        eng.step(1)
    outs["e"] = eng.drain(e)
    return outs


def engine_f32(np_params):
    """(e) An f32 copy of a 2-layer engine schedule on the card and on
    the CPU: the same greedy tokens.  And on the card, the f32 target as
    its own draft: every proposal accepted, the plain engine's tokens."""
    cfg = dataclasses.replace(FLAGSHIP, n_layers=2, dtype="float32")
    two = draft_layers(np_params, 2)
    params = dkt.params_from_numpy(two, "cuda", dtype=torch.float32)
    card = engine_schedule(params, cfg, "cuda")
    cpu = engine_schedule(dkt.params_from_numpy(two, "cpu",
                                                dtype=torch.float32),
                          cfg, "cpu")
    for name in card:
        if not np.array_equal(card[name], cpu[name]):
            raise AssertionError(f"request {name}: card {card[name]} != "
                                 f"cpu {cpu[name]}")
    prompts = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (8, 64)).astype(np.int32)
    plain = dkt.ContinuousBatcher(params, cfg, lanes=8)
    ref = run_engine(plain, [plain.submit(p, 64) for p in prompts])
    spec = dkt.SpeculativeBatcher(params, params, cfg, cfg, lanes=8,
                                  n_draft=SPEC_DRAFT)
    with dkt.obs.session() as sess:
        outs = run_engine(spec, [spec.submit(p, 64) for p in prompts], ())
        reg = sess.registry
        acc = (reg.counter("serving.spec.accepted").value()
               / reg.counter("serving.spec.proposed").value())
    if spec.degraded:
        raise AssertionError(f"f32 self-draft: the engine degraded "
                             f"({spec.degraded_error!r})")
    if acc != 1.0 or not all(np.array_equal(a, b)
                             for a, b in zip(outs, ref)):
        raise AssertionError(f"f32 self-draft: acceptance {acc}, tokens "
                             "differ from plain decode")
    log("engine_f32", layers=2, dtype="float32", card_vs_cpu=dict(
        lanes=4, requests=len(card),
        tokens=sum(len(v) for v in card.values()), equal=True),
        self_draft=dict(lanes=8, n_draft=SPEC_DRAFT, new_tokens=64,
                        acceptance_rate=acc, tokens_equal_plain=True))


def engine_phase(np_params):
    """Phase engine: the continuous-batching serving path at the
    flagship width, bf16, seed-0 weights.  Returns the forward kernel's
    launches on its main paths (pool segments, speculative warm-up)."""
    t0 = time.perf_counter()
    cfg = FLAGSHIP
    params = dkt.params_from_numpy(np_params, "cuda", dtype=torch.bfloat16)
    engine_load(params, cfg)
    launches = engine_prefix(params, cfg)
    engine_chunked(params, cfg)
    launches += engine_speculative(np_params, cfg)
    engine_f32(np_params)
    log("engine", seconds=time.perf_counter() - t0, fwd_launches=launches)
    return launches


# The model surface.  MoE: the transformer_moe_top1 / _top2 rows of
# scripts/bench_suite.py (:313-330), 8 experts over the d1024 L8 trunk at
# capacity_factor 1.25, trained as _measure_lm trains (adamw 3e-4, batch
# 8 x seq 1024, f32 weights: an f32 trunk and the f32 kernels), and
# bench_serving.py's bench_moe (:366) over the flagship serving config.
# LoRA: bench_suite.py's lora_finetune (:332-372), rank 8, alpha 16,
# wq / wv over the d1024 L8 base.  int8: bench_serving.py's bench_int8
# (:218), bench_kv_int8 (:178), bench_speculative_int8draft (:327) and
# the kv_int8 engine (:480), with fewer new tokens.
MOE_EXPERTS, MOE_CAPACITY = 8, 1.25
SURFACE_STEPS = 4
MOE_SERVE_PROMPT, MOE_SERVE_NEW = 64, 64
INT8_PROMPT, INT8_NEW = 16, 128
KV8_PROMPT, KV8_NEW = 64, 64
# The index dispatch against the reference's one-hot einsums on one layer
# at full width: the dispatch is exact and each token's top-k combine
# sums the same terms in another order, so the two outputs may differ in
# the last bits only.
MOE_DISPATCH_TOL = 1e-6


def moe_cfg(base, top_k):
    return dataclasses.replace(base, num_experts=MOE_EXPERTS,
                               moe_top_k=top_k,
                               capacity_factor=MOE_CAPACITY)


def expect_fwd(fn, want, what, counted=True):
    """Run ``fn``; it must launch the forward kernel ``want`` times and no
    backward kernel.  A run that only serves a comparison
    (``counted=False``) leaves the launch counts as they were.  Returns
    what ``fn`` returns."""
    before = dict(attn.LAUNCHES)
    out = fn()
    went = {k: attn.LAUNCHES[k] - before[k] for k in before}
    if not counted:
        attn.LAUNCHES.update(before)
    if went != {"flash_fwd": want, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}:
        raise AssertionError(f"{what}: launched {went}, expected {want} "
                             "forward launches")
    return out


def expect_tokens(out, prompt, new, vocab, what):
    """``out`` must be the int32 ``prompt`` rows, each followed by ``new``
    tokens in [0, vocab)."""
    prompt = torch.as_tensor(np.asarray(prompt))
    b, p = prompt.shape
    if (tuple(out.shape) != (b, p + new) or out.dtype != torch.int32
            or not torch.equal(out[:, :p].cpu(), prompt)
            or int(out.min()) < 0 or int(out.max()) >= vocab):
        raise AssertionError(f"bad {what} output {tuple(out.shape)} "
                             f"{out.dtype}")


def moe_route_stats(params, cfg, tokens):
    """One no-grad training forward (capacity routing): its aux loss, and
    the share of top-k assignments every layer drops at capacity, as
    ``_moe_block`` counts them."""
    tfm = dkt.models.transformer
    real, stats = tfm._moe_block, {}
    tfm._moe_block = lambda lp, x, cfg_: real(lp, x, cfg_, stats=stats)
    try:
        with torch.no_grad():
            _, aux = dkt.apply(params, torch.from_numpy(tokens).cuda(), cfg)
    finally:
        tfm._moe_block = real
    return float(aux), float(stats["dropped"]) / stats["assigned"]


def moe_einsum_block(lp, x, cfg):
    """The reference's ``_moe_block`` as written: one-hot slots [k, N, E,
    C] and the dispatch / expert / combine einsums, in f32."""
    b, s, d = x.shape
    n, e, k = b * s, cfg.num_experts, cfg.moe_top_k
    cap = max(1, int(cfg.capacity_factor * k * n / e))
    flat = x.reshape(n, d).float()
    probs = torch.softmax(flat @ lp["wg"].float(), dim=-1)
    gates, expert = dkt.models.transformer._moe_gates(probs, cfg)
    one_hot = F.one_hot(expert, e).float()                    # [N, k, E]
    aux = (one_hot[:, 0].mean(0) * probs.mean(0)).sum() * e \
        * cfg.aux_loss_coef
    oh_cm = one_hot.transpose(0, 1).reshape(k * n, e)
    pos = oh_cm.cumsum(0) * oh_cm                             # 1-based
    keep = (pos <= cap).float() * oh_cm
    slot = F.one_hot((pos - 1).clamp(0, cap - 1).long(), cap).float()
    slot_k = (slot * keep[..., None]).reshape(k, n, e, cap)
    del slot
    xe = torch.einsum("knec,nd->ecd", slot_k, flat)
    h = F.gelu(torch.einsum("ecd,edf->ecf", xe, lp["w1"].float()),
               approximate="tanh")
    ye = torch.einsum("ecf,efd->ecd", h, lp["w2"].float())
    comb = slot_k * gates.t().reshape(k, n)[:, :, None, None]
    out = torch.einsum("ecd,knec->nd", ye, comb)
    return out.reshape(b, s, d), aux


def moe_dispatch_check(np_moe):
    """The index dispatch (``_moe_block``) against ``moe_einsum_block`` on
    layer 0 at the bench row's full width: 8 x 1024 tokens, d 1024, 8
    experts, top-1 (C = 1280) and top-2 (C = 2560)."""
    lp = {k: torch.from_numpy(v[0]).cuda()
          for k, v in np_moe["layers"]["moe"].items()}
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (8, TRAIN_SHAPE[1], FLAGSHIP_TRAIN.d_model),
        dtype=np.float32)).cuda()
    out = {}
    for k in (1, 2):
        cfg = moe_cfg(FLAGSHIP_TRAIN, k)
        with torch.no_grad():
            got, aux = dkt.models.transformer._moe_block(lp, x, cfg)
            want, want_aux = moe_einsum_block(lp, x, cfg)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        if not err <= MOE_DISPATCH_TOL * scale or float(
                (aux - want_aux).abs()) > 1e-7:
            raise AssertionError(
                f"top-{k} index dispatch differs from the einsums: "
                f"{err} (max |out| {scale}), aux {float(aux)} vs "
                f"{float(want_aux)}")
        out[f"top{k}"] = dict(max_abs_err=err, max_abs_out=scale,
                              aux=float(aux))
        del got, want
        torch.cuda.empty_cache()
    return out


def moe_parity(np_moe):
    """One f32 top-2 lm_loss gradient at full width (2 x 1024 tokens)
    through the kernels and through the blockwise tier: every leaf within
    1e-3 * max|g| of the plain one (PERF.md section 2), as
    train_parity_phase holds the dense model."""
    cfg = dataclasses.replace(moe_cfg(FLAGSHIP_TRAIN, 2), dtype="float32")
    tokens = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab_size, (2, TRAIN_SHAPE[1] + 1))).cuda()
    runs = []
    for fn in (None, plain_flash):
        params = dkt.params_from_numpy(np_moe, "cuda")
        named = named_leaves(params)
        for _, leaf in named:
            leaf.requires_grad_()
        before = attn.LAUNCHES["flash_bwd_dkv"]
        loss = dkt.lm_loss(params, tokens, cfg, attention_fn=fn)
        loss.backward()
        went = attn.LAUNCHES["flash_bwd_dkv"] - before
        if went != (cfg.n_layers if fn is None else 0):
            raise AssertionError(f"moe parity run launched dK/dV {went}")
        runs.append((float(loss.detach()),
                     {path: p.grad for path, p in named}))
        del params, named, loss
    (loss_k, gk), (loss_p, gp) = runs
    worst = {path: float((g - gp[path]).abs().max()
                         / gp[path].abs().max().clamp(min=1e-30))
             for path, g in gk.items()}
    bad = {p: r for p, r in worst.items() if not r <= 1e-3}
    if bad or not abs(loss_k - loss_p) <= 1e-4:
        raise AssertionError(f"moe grads {bad}, losses {loss_k} {loss_p}")
    del runs, gk, gp
    torch.cuda.empty_cache()
    return dict(loss_kernel=loss_k, loss_plain=loss_p,
                grad_max_rel_err=max(worst.values()),
                worst_leaf=max(worst, key=worst.get), tol=1e-3)


def timed_trainer(trainer, first, timed, **kw):
    """A warm-up run and a one-step run of ``first``, then ``timed``
    (SURFACE_STEPS steps) with the launches zeroed and the peak memory
    reset; returns (what the timed run returns, its launches, steady
    step ms, peak GB).  Both runs pay the same set-up (param copy,
    optimizer init), so their difference is SURFACE_STEPS - 1 steps."""
    trainer.train(first, **kw)
    trainer.train(first, **kw)
    one_s = trainer.training_time
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    out = trainer.train(timed, **kw)
    launches = dict(attn.LAUNCHES)
    step_ms = 1e3 * (trainer.training_time - one_s) / (SURFACE_STEPS - 1)
    return (out, launches, step_ms,
            torch.cuda.max_memory_allocated() / 2**30)


def moe_train_phase(np_moe, dense_step_ms):
    """Phase moe_train: LMTrainer over the MoE rows, top-1 and top-2
    (a warm-up step, then SURFACE_STEPS timed steps on one repeated
    batch), every step through the training kernels; the aux loss and
    the capacity drop share of the trained weights; the index dispatch
    against the einsums; the f32 gradient parity."""
    batch = np.random.default_rng(2).integers(
        0, FLAGSHIP_TRAIN.vocab_size, (8, TRAIN_SHAPE[1] + 1)).astype(
            np.int32)
    rows, total = {}, dict.fromkeys(attn.LAUNCHES, 0)
    for k in (1, 2):
        cfg = moe_cfg(FLAGSHIP_TRAIN, k)
        params = dkt.params_from_numpy(np_moe, "cuda")
        trainer = dkt.LMTrainer(cfg, optimizer="adamw", learning_rate=3e-4,
                                batch_size=8)
        trained, launches, step_ms, peak = timed_trainer(
            trainer, batch, np.tile(batch, (SURFACE_STEPS, 1)),
            params=params)
        expect_launches(launches, cfg.n_layers * SURFACE_STEPS,
                        f"moe_train top-{k}")
        hist = trainer.history
        if not all(np.isfinite(hist)) or not hist[-1] < hist[0]:
            raise AssertionError(f"moe top-{k} losses {hist}")
        aux, dropped = moe_route_stats(trained, cfg, batch[:, :-1])
        rows[f"top{k}"] = dict(
            losses=hist, step_ms=step_ms,
            tokens_per_s=8 * TRAIN_SHAPE[1] * 1e3 / step_ms,
            vs_dense_step=step_ms / dense_step_ms, peak_mem_gb=peak,
            aux_loss=aux, dropped_share=dropped, launches=launches)
        for name in total:
            total[name] += launches[name]
        del trainer, trained, params
        torch.cuda.empty_cache()
    log("moe_train", config=dataclasses.asdict(moe_cfg(FLAGSHIP_TRAIN, 2)),
        batch=8, seq=TRAIN_SHAPE[1], steps=SURFACE_STEPS,
        optimizer="adamw", learning_rate=3e-4, dense_step_ms=dense_step_ms,
        **rows, dispatch_vs_einsum=dict(moe_dispatch_check(np_moe),
                                        tol_rel=MOE_DISPATCH_TOL),
        parity=moe_parity(np_moe))
    return total


def lora_train_phase(np_params, dense_step_ms):
    """Phase lora_train: LoRATrainer (rank 8, alpha 16, wq / wv) over a
    token Dataset on the d1024 L8 f32 base: a warm-up step, then
    SURFACE_STEPS timed steps.  The caller's base and the trainer's copy
    come out bit-identical, the optimizer holds the adapter leaves only,
    and ``train`` returns ``lora_merge(base, adapters)`` exactly."""
    cfg = FLAGSHIP_TRAIN
    base = dkt.params_from_numpy(np_params, "cuda")
    rows = np.random.default_rng(14).integers(
        0, cfg.vocab_size, (8, TRAIN_SHAPE[1] + 1)).astype(np.int32)
    trainer = dkt.LoRATrainer(cfg, base, lora_rank=8, lora_alpha=16.0,
                              lora_targets=("wq", "wv"), optimizer="adamw",
                              learning_rate=3e-4, batch_size=8)
    merged, launches, step_ms, peak = timed_trainer(
        trainer, dkt.Dataset({"tokens": rows}),
        dkt.Dataset({"tokens": np.tile(rows, (SURFACE_STEPS, 1))}))
    expect_launches(launches, cfg.n_layers * SURFACE_STEPS, "lora_train")
    if not all(np.isfinite(trainer.history)):
        raise AssertionError(f"lora losses {trainer.history}")
    fresh = dkt.params_from_numpy(np_params, "cuda")
    fresh_named = dict(named_leaves(fresh))
    for path, t in named_leaves(base):
        if not torch.equal(t, fresh_named[path]):
            raise AssertionError(f"the caller's base changed at {path}")
    with torch.no_grad():
        want = dkt.lora_merge(fresh, trainer.adapters, cfg, trainer.lora)
    for (path, a), (_, b) in zip(named_leaves(merged), named_leaves(want)):
        if not torch.equal(a, b):
            raise AssertionError(f"train() != lora_merge(base, adapters) "
                                 f"at {path}")
    adapters = [t for _, t in named_leaves(trainer.adapters)]
    state = trainer.opt_state
    if ({id(t) for t in state.leaves} != {id(t) for t in adapters}
            or {id(t) for t in state.torch_opt.state}
            != {id(t) for t in adapters}):
        raise AssertionError("the optimizer holds more than the adapters")
    log("lora_train", config=dataclasses.asdict(cfg), rank=8, alpha=16.0,
        targets=["wq", "wv"], batch=8, seq=TRAIN_SHAPE[1],
        steps=SURFACE_STEPS, losses=trainer.history, step_ms=step_ms,
        tokens_per_s=8 * TRAIN_SHAPE[1] * 1e3 / step_ms,
        dense_step_ms=dense_step_ms, vs_dense_step=step_ms / dense_step_ms,
        peak_mem_gb=peak, adapter_leaves=len(adapters),
        adapter_params=sum(t.numel() for t in adapters),
        optimizer_state_tensors=len(state.torch_opt.state),
        base_bit_identical=True, train_returns_merge=True,
        launches=launches)
    return launches


def moe_serve_phase(np_moe):
    """Phase moe_serve: bench_moe(8, top_k) for top-1 and top-2: the
    flagship serving config with 8 experts, bf16, batch 8, prompt 64, 64
    new tokens (prefill through the kernel with the dense routing, then
    the per-token expert gather); at f32 on 2 rows, prefill (kernel)
    tokens equal sequential (no kernel) tokens, a comparison whose
    launches are not counted."""
    np_serve = moe_serve_tree(np_moe)
    prompt = moe_serve_prompt()
    zero_launches()
    rows = {}
    for k in (1, 2):
        cfg = moe_cfg(FLAGSHIP, k)
        n = cfg.n_layers
        params = dkt.params_from_numpy(np_serve, "cuda", dtype=torch.bfloat16)
        gen = lambda: dkt.generate(params, prompt, cfg, MOE_SERVE_NEW)
        out, first_s = expect_fwd(lambda: wall_s(gen), n, "moe generate")
        _, prefill_s = expect_fwd(lambda: wall_s(lambda: dkt.prefill(
            params, prompt, cfg, last_logits=False)), n, "moe prefill")
        again, gen_s = expect_fwd(lambda: wall_s(gen), n, "moe generate")
        expect_tokens(out, prompt, MOE_SERVE_NEW, cfg.vocab_size,
                      "moe generate")
        if not torch.equal(out, again):
            raise AssertionError("moe generate is not deterministic")
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        p32 = dkt.params_from_numpy(np_serve, "cuda", dtype=torch.float32)
        short = prompt[:2, :32]
        via = expect_fwd(lambda: dkt.generate(p32, short, cfg32, 16,
                                              use_prefill=True), n,
                         "moe f32 prefill", counted=False)
        seq = expect_fwd(lambda: dkt.generate(p32, short, cfg32, 16,
                                              use_prefill=False), 0,
                         "moe f32 sequential", counted=False)
        if not torch.equal(via, seq):
            raise AssertionError(f"moe top-{k}: f32 prefill (kernel) and "
                                 "sequential tokens differ")
        rows[f"top{k}"] = dict(
            first_call_s=first_s, prefill_ms=1e3 * prefill_s,
            generate_s=gen_s,
            decode_ms_per_token=1e3 * (gen_s - prefill_s) / MOE_SERVE_NEW,
            tokens_per_s=8 * MOE_SERVE_NEW / gen_s,
            f32_prefill_vs_sequential_tokens_equal=True)
        del p32
    launches = dict(attn.LAUNCHES)
    log("moe_serve", config=dataclasses.asdict(moe_cfg(FLAGSHIP, 2)),
        batch=8, prompt=MOE_SERVE_PROMPT, new_tokens=MOE_SERVE_NEW,
        launches=launches, **rows)
    return launches


def argmax_agreement(a_params, b_params, seq, cfg, start):
    """Share of the positions past ``start`` of the token rows ``seq``
    where two trees' teacher-forced argmax agree (the plain chunk
    attention, no kernel)."""
    toks = torch.as_tensor(seq, device="cuda").long()
    pos0 = torch.zeros(toks.shape[0], dtype=torch.long, device="cuda")
    picks = []
    with torch.no_grad():
        for p in (a_params, b_params):
            cache = dkt.init_cache(cfg, toks.shape[0])
            logits, _ = dkt.models.generate._decode_chunk(
                p, cache, toks[:, :-1], pos0, cfg, uniform_pos=True)
            picks.append(logits[:, start - 1:].argmax(-1))
            del cache, logits
    return float((picks[0] == picks[1]).float().mean())


def kv8_schedule(params, cfg):
    """A small kv_int8 engine schedule (4 lanes, staggered admissions, a
    1-token prompt, a reused lane): each request's tokens and prompt."""
    rng = np.random.default_rng(16)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (16, 9, 1, 12, 5)]
    eng = dkt.ContinuousBatcher(params, cfg, lanes=4, kv_int8=True)
    lanes = [eng.submit(prompts[0], 24)]
    eng.step(4)
    lanes += [eng.submit(prompts[1], 20), eng.submit(prompts[2], 16)]
    eng.step(3)
    lanes.append(eng.submit(prompts[3], 12))
    outs = [run_engine(eng, [lane])[0] for lane in lanes]
    outs += run_engine(eng, [eng.submit(prompts[4], 20)], (1,))
    return outs, prompts


def int8_serve_phase(np_params):
    """Phase int8_serve over the flagship serving config: (a)
    quantize_params on the card equals the CPU's bit for bit; (b)
    bench_int8: the int8 tree decodes sequentially (no kernel launch),
    ms per token and the argmax agreement with the bf16 tree; (c)
    bench_kv_int8: generate(kv_int8=True) through the kernel prefill
    against the sequential path (greedy_agreement) and beside bf16 decode;
    (d) ContinuousBatcher(kv_int8=True) over 16 requests, and an f32
    2-layer schedule equal to solo generate(kv_int8=True,
    use_prefill=False); (e) the int8 tree drafting for its f32 parent:
    greedy tokens equal the parent's; (f) a kv_int8 PrefixPool segment.
    The bf16, f32 and sequential runs that only serve a comparison are
    not counted in the launches."""
    cfg = FLAGSHIP
    n = cfg.n_layers
    rng = np.random.default_rng(17)
    zero_launches()
    p32 = dkt.params_from_numpy(np_params, "cuda")
    # (a)
    q8 = dkt.quantize_params(p32)
    cpu_q = dkt.quantize_params(dkt.params_from_numpy(np_params, "cpu"))
    qleaves = lambda t: [t["tok_emb"]] + [t["layers"][g][k] for g in (
        "attn", "ffn") for k in sorted(t["layers"][g])]
    for got, want in zip(qleaves(q8), qleaves(cpu_q)):
        if not (torch.equal(got.q.cpu(), want.q)
                and torch.equal(got.s.cpu(), want.s)):
            raise AssertionError("quantize_params on the card != the CPU")
    del cpu_q
    # (b)
    pb = dkt.params_from_numpy(np_params, "cuda", dtype=torch.bfloat16)
    prompt16 = rng.integers(0, cfg.vocab_size, (8, INT8_PROMPT)).astype(
        np.int32)
    gen8 = lambda: wall_s(lambda: dkt.generate(q8, prompt16, cfg, INT8_NEW))
    expect_fwd(gen8, 0, "int8 generate")
    out8, int8_s = expect_fwd(gen8, 0, "int8 generate")
    ref16 = expect_fwd(lambda: dkt.generate(pb, prompt16, cfg, INT8_NEW), n,
                       "bf16 generate", counted=False)
    expect_tokens(out8, prompt16, INT8_NEW, cfg.vocab_size, "int8 generate")
    expect_tokens(ref16, prompt16, INT8_NEW, cfg.vocab_size, "bf16 generate")
    steps = INT8_PROMPT - 1 + INT8_NEW
    int8_row = dict(
        batch=8, prompt=INT8_PROMPT, new_tokens=INT8_NEW, generate_s=int8_s,
        ms_per_step=1e3 * int8_s / steps, sequential_steps=steps,
        argmax_agreement_vs_bf16=argmax_agreement(q8, pb, ref16.cpu(), cfg,
                                                  INT8_PROMPT),
        rows_equal_bf16_rollout=int(
            (out8 == ref16).all(dim=1).sum()))
    # (c)
    prompt64 = rng.integers(0, cfg.vocab_size, (8, KV8_PROMPT)).astype(
        np.int32)
    kv8 = lambda: wall_s(lambda: dkt.generate(pb, prompt64, cfg, KV8_NEW,
                                              kv_int8=True))
    expect_fwd(kv8, n, "kv_int8 generate")
    out_kv, kv_s = expect_fwd(kv8, n, "kv_int8 generate")
    expect_tokens(out_kv, prompt64, KV8_NEW, cfg.vocab_size,
                  "kv_int8 generate")
    _, bf16_s = expect_fwd(lambda: wall_s(lambda: dkt.generate(
        pb, prompt64, cfg, KV8_NEW)), n, "bf16 generate", counted=False)
    seq_kv = expect_fwd(lambda: dkt.generate(
        pb, prompt64, cfg, KV8_NEW, kv_int8=True, use_prefill=False), 0,
        "kv_int8 sequential", counted=False)
    kv_agree = [greedy_agreement(a, b, pb, cfg, KV8_PROMPT)
                for a, b in zip(out_kv.cpu().numpy(), seq_kv.cpu().numpy())]
    kv_row = dict(batch=8, prompt=KV8_PROMPT, new_tokens=KV8_NEW,
                  generate_s=kv_s, bf16_generate_s=bf16_s,
                  ms_per_token=1e3 * kv_s / KV8_NEW,
                  bf16_ms_per_token=1e3 * bf16_s / KV8_NEW,
                  prefill_vs_sequential=agreement_summary(kv_agree))
    # (d)
    prompts = rng.integers(0, cfg.vocab_size, (16, KV8_PROMPT)).astype(
        np.int32)
    eng = dkt.ContinuousBatcher(pb, cfg, lanes=ENGINE_LANES, kv_int8=True)
    run_engine(eng, [eng.submit(prompts[0], 8)])   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending, outs, live = list(range(16)), {}, {}
    while pending or live:
        while pending and eng.free_lanes():
            i = pending.pop(0)
            live[eng.submit(prompts[i], KV8_NEW)] = i
        eng.step(4)
        for lane in [ln for ln in live if ln not in eng.running()]:
            outs[live.pop(lane)] = eng.drain(lane)
    engine_s = time.perf_counter() - t0
    sample = (0, 7, 15)
    solo = expect_fwd(lambda: dkt.generate(
        pb, prompts[list(sample)], cfg, KV8_NEW, kv_int8=True,
        use_prefill=False), 0, "kv_int8 solo", counted=False)
    eng_agree = [greedy_agreement(outs[i], r, pb, cfg, KV8_PROMPT)
                 for i, r in zip(sample, solo.cpu().numpy())]
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    two = dkt.params_from_numpy(draft_layers(np_params, 2), "cuda")
    sched, sched_prompts = expect_fwd(lambda: kv8_schedule(two, cfg2), 0,
                                      "kv_int8 schedule")
    for got, p in zip(sched, sched_prompts):
        want = dkt.generate(two, p[None], cfg2, len(got) - len(p),
                            kv_int8=True, use_prefill=False)[0]
        if not np.array_equal(got, want.cpu().numpy()):
            raise AssertionError("f32 kv_int8 engine request differs from "
                                 "its solo generate(kv_int8=True, "
                                 "use_prefill=False)")
    engine_row = dict(lanes=ENGINE_LANES, requests=16, prompt=KV8_PROMPT,
                      new_tokens=KV8_NEW, step_window=4, seconds=engine_s,
                      tokens_per_s=16 * KV8_NEW / engine_s,
                      vs_solo=agreement_summary(eng_agree),
                      f32_schedule_requests=len(sched),
                      f32_schedule_equal_solo=True)
    # (e)
    prompt_spec = prompts[:8]
    spec = lambda: wall_s(lambda: dkt.speculative_generate(
        p32, q8, prompt_spec, cfg, cfg, KV8_NEW, n_draft=SPEC_DRAFT))
    expect_fwd(spec, n, "int8-draft speculative warm-up")
    (spec_out, stats), spec_s = expect_fwd(spec, n,
                                           "int8-draft speculative")
    plain = expect_fwd(lambda: dkt.generate(p32, prompt_spec, cfg, KV8_NEW),
                       n, "f32 generate", counted=False)
    expect_tokens(plain, prompt_spec, KV8_NEW, cfg.vocab_size,
                  "f32 generate")
    if not torch.equal(spec_out, plain):
        raise AssertionError("int8-draft speculative tokens differ from the "
                             "f32 target's greedy tokens")
    spec_row = dict(batch=8, prompt=KV8_PROMPT, new_tokens=KV8_NEW,
                    n_draft=SPEC_DRAFT, seconds=spec_s,
                    tokens_per_s=8 * KV8_NEW / spec_s,
                    acceptance_rate=float(stats["acceptance_rate"]),
                    target_passes=int(stats["iterations"]),
                    tokens_equal_target=True)
    del p32, q8
    # (f)
    prefix = rng.integers(0, cfg.vocab_size, 128).astype(np.int32)
    seg, _ = expect_fwd(lambda: dkt.prefill(pb, prefix[None], cfg,
                                            last_logits=False, kv_int8=True),
                        n, "kv_int8 pool segment")
    pool = dkt.PrefixPool(cfg, slots=1, kv_int8=True)
    pid = pool.put(seg, 128)
    eng = dkt.ContinuousBatcher(pb, cfg, lanes=4, kv_int8=True,
                                prefix_pool=pool)
    tails = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    pooled = expect_fwd(lambda: run_engine(eng, [
        eng.submit(t, 32, prefix_id=pid) for t in tails]), 0, "pooled lanes")
    refs = expect_fwd(lambda: dkt.generate(
        pb, tails, cfg, 32, kv_int8=True, prompt_cache=(seg, 128)), 0,
        "kv_int8 prompt_cache", counted=False).cpu().numpy()
    pool_agree = [greedy_agreement(a, b, pb, cfg, 32, context=prefix)
                  for a, b in zip(pooled, refs)]
    launches = dict(attn.LAUNCHES)
    log("int8_serve", config=dataclasses.asdict(cfg),
        quantize_card_equals_cpu=True, int8_decode=int8_row,
        kv_int8_decode=kv_row, kv_int8_engine=engine_row,
        speculative_int8_draft=spec_row,
        kv_int8_prefix_pool=dict(prefix=128, requests=4, tail=32,
                                 new_tokens=32,
                                 vs_prompt_cache=agreement_summary(
                                     pool_agree)),
        launches=launches)
    return launches


def moe_serve_tree(np_moe):
    """The MoE weights for the (rope) serving config: no pos_emb."""
    return {k: v for k, v in np_moe.items() if k != "pos_emb"}


def moe_serve_prompt():
    return np.random.default_rng(15).integers(
        0, FLAGSHIP.vocab_size, (8, MOE_SERVE_PROMPT)).astype(np.int32)


def profile_surface(np_params, np_moe):
    """``--profile``: the model surface's profiled windows, after every
    timed phase (the profiler leaves the host slower behind it): the
    top-2 MoE decode and train step, and the int8 tree's and the
    ``kv_int8`` cache's 8-token generates."""
    cfg = moe_cfg(FLAGSHIP, 2)
    params = dkt.params_from_numpy(moe_serve_tree(np_moe), "cuda",
                                   dtype=torch.bfloat16)
    prompt = moe_serve_prompt()
    profile_window("moe_top2_generate_8_tokens", lambda: dkt.generate(
        params, prompt, cfg, 8))
    del params
    cfg = moe_cfg(FLAGSHIP_TRAIN, 2)
    params = dkt.params_from_numpy(np_moe, "cuda")
    opt = dkt.Optimizer("adamw", 3e-4)
    step = dkt.make_train_step(cfg, opt)
    carry = (params, opt.init(params))
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (8, TRAIN_SHAPE[1] + 1)).astype(np.int32)).cuda()
    profile_window("moe_top2_train_step", lambda: step(carry, tokens))
    del params, opt, step, carry
    torch.cuda.empty_cache()
    cfg = FLAGSHIP
    q8 = dkt.quantize_params(dkt.params_from_numpy(np_params, "cuda"))
    rng = np.random.default_rng(17)
    prompt16 = rng.integers(0, cfg.vocab_size, (8, INT8_PROMPT)).astype(
        np.int32)
    profile_window("int8_generate_8_tokens", lambda: dkt.generate(
        q8, prompt16, cfg, 8))
    del q8
    pb = dkt.params_from_numpy(np_params, "cuda", dtype=torch.bfloat16)
    prompt64 = rng.integers(0, cfg.vocab_size, (8, KV8_PROMPT)).astype(
        np.int32)
    profile_window("kv_int8_generate_8_tokens", lambda: dkt.generate(
        pb, prompt64, cfg, 8, kv_int8=True))


# ------------------------------------------------------ data parallelism

DP_STEPS = 4
DP_VARIANTS = {"dp": {}, "zero1": dict(zero=1), "zero3": dict(zero=3),
               "adasum": dict(merge_rule="adasum"),
               "int8": dict(compress="int8")}
# The CIFAR CNN at keras_train's bench config over two ranks sharing the
# card: 16 global microbatches of 2 x 1024 rows.
DP_KERAS_ROWS = 16 * 2 * KERAS_BATCH


def leaf_grads(trainer, np_params, batch):
    """``p0 - p1`` of one sgd step at rate 1: the step's gradient, per
    leaf, on the host."""
    params = dkt.params_from_numpy(np_params, "cuda")
    start = {k: v.detach().cpu() for k, v in named_leaves(params)}
    out = trainer.train(batch, params=params)
    return {k: start[k] - v.detach().cpu() for k, v in named_leaves(out)}


def int8_first_update(np_params, batch):
    """The int8 exchange's first update on the card: its merged gradient
    equals ``decode(encode(.))`` of the plain gradient per fusion bucket,
    twice (the reduce-scatter leg, then the re-quantized chunk; at world
    1 the chunk is the bucket), bit for bit, and the sgd update applies
    exactly that."""
    from distkeras_tpu_torch.parallel import exchange as ex
    from distkeras_tpu_torch.parallel.mesh import make_mesh

    cfg = FLAGSHIP_TRAIN
    params = dkt.params_from_numpy(np_params, "cuda")
    inner = dkt.Optimizer("sgd", 1.0)
    opt = ex.ExchangeOptimizer(inner, make_mesh(),
                               ex.ExchangeConfig(compress="int8"))
    state = opt.init(params)
    loss = dkt.lm_loss(params, torch.from_numpy(batch).to("cuda"), cfg)
    loss.backward()
    from distkeras_tpu_torch.parallel.tree import tree_leaves

    leaves = tree_leaves(params)
    plain = [p.grad.clone() for p in leaves]
    layout = state.layout
    want = []
    for b in layout.pack(plain):
        q, sc = ex.int8_encode(b)
        q2, s2 = ex.int8_encode(ex.int8_decode(q, sc))
        want.append(ex.int8_decode(q2, s2))
    want = layout.unpack(want)
    before = [p.detach().clone() for p in leaves]
    opt.exchange(params, state)
    exact = all(torch.equal(p.grad, w) for p, w in zip(leaves, want))
    opt.update(params, state)
    applied = all(torch.equal(p.detach(), b - w) for p, b, w in
                  zip(leaves, before, want))
    quant_err = max(float((w - g).abs().max() / g.abs().max().clamp(
        min=1e-30)) for w, g in zip(want, plain))
    if not (exact and applied):
        raise AssertionError(f"int8 first update: merged == codec(g) "
                             f"{exact}, update applied {applied}")
    return {"buckets": len(layout.bucket_cols), "merged_equals_codec": exact,
            "update_equals_sgd_of_codec": applied,
            "max_rel_quant_err": quant_err}


def dp_lm_phase(np_params, train_step_ms):
    """LMTrainer in a world-1 NCCL group at full width (phase train's
    config: adamw 3e-4, 8 x 1024): the plain exchange, zero=1, zero=3,
    adasum and int8, DP_STEPS steps each, every step through the three
    kernels.  zero=1 / zero=3 hold zero=None's losses within 1e-6
    relative and its gradient (one sgd step at rate 1) within 1e-3 x
    max|g|; the int8 first update is the codec's, bit for bit.  Each
    variant's step ms beside phase train's: the cost of the bucket
    packing and the collectives at world 1."""
    import torch.distributed as dist

    cfg = FLAGSHIP_TRAIN
    rdv = tempfile.mkdtemp()
    device = dkt.initialize_multihost(init_method=f"file://{rdv}/rdv",
                                      world_size=1, rank=0, timeout=120)
    try:
        backend = dist.get_backend()
        if backend != "nccl":
            raise AssertionError(f"dp_lm joined a {backend} group")
        rng = np.random.default_rng(12)
        rows = rng.integers(0, cfg.vocab_size, (8 * DP_STEPS,
                                                TRAIN_SHAPE[1] + 1)
                            ).astype(np.int32)
        runs, launches_total = {}, {k: 0 for k in attn.LAUNCHES}
        for name, kw in DP_VARIANTS.items():
            trainer = dkt.LMTrainer(cfg, optimizer="adamw",
                                    learning_rate=3e-4, batch_size=8, **kw)
            for _ in range(2):  # a warm-up, then one timed step
                trainer.train(rows[:8], params=dkt.params_from_numpy(
                    np_params, "cuda"))
            one = trainer.training_time
            zero_launches()
            trainer.train(rows, params=dkt.params_from_numpy(np_params,
                                                             "cuda"))
            launches = dict(attn.LAUNCHES)
            expect_launches(launches, cfg.n_layers * DP_STEPS,
                            f"dp_lm {name}")
            for k in launches_total:
                launches_total[k] += launches[k]
            hist = trainer.history
            if len(hist) != DP_STEPS or not all(np.isfinite(hist)):
                raise AssertionError(f"dp_lm {name}: bad losses {hist}")
            step_ms = 1e3 * (trainer.training_time - one) / (DP_STEPS - 1)
            runs[name] = dict(losses=hist, step_ms=step_ms,
                              step_ms_over_train=step_ms / train_step_ms,
                              residual_norm=trainer.residual_norm)
        base = np.array(runs["dp"]["losses"])
        loss_rel = {}
        for name in ("zero1", "zero3"):
            rel = float(np.abs(np.array(runs[name]["losses"]) - base).max()
                        / np.abs(base).max())
            loss_rel[name] = rel
            if not rel <= 1e-6:
                raise AssertionError(f"dp_lm {name} losses differ from "
                                     f"zero=None by {rel} (relative)")
        grads = {}
        for name in ("dp", "zero1", "zero3"):
            t = dkt.LMTrainer(cfg, optimizer="sgd", learning_rate=1.0,
                              batch_size=8, **DP_VARIANTS[name])
            grads[name] = leaf_grads(t, np_params, rows[:8])
        grad_rel = {}
        for name in ("zero1", "zero3"):
            worst = 0.0
            for k, g in grads["dp"].items():
                worst = max(worst, float((grads[name][k] - g).abs().max()
                                         / g.abs().max().clamp(min=1e-30)))
            grad_rel[name] = worst
            if not worst <= 1e-3:
                raise AssertionError(f"dp_lm {name} gradient differs by "
                                     f"{worst} x max|g|")
        del grads
        int8 = int8_first_update(np_params, rows[:8])
    finally:
        dist.destroy_process_group()
    log("dp_lm", config="transformer_d1024", backend=backend, world=1,
        device=str(device), batch=8, seq=TRAIN_SHAPE[1], steps=DP_STEPS,
        optimizer="adamw", learning_rate=3e-4, runs=runs,
        train_step_ms=train_step_ms, zero_loss_max_rel_diff=loss_rel,
        zero_grad_max_rel_diff=grad_rel, grad_tol=1e-3, loss_tol=1e-6,
        int8_first_update=int8, launches=launches_total)
    return launches_total


def nccl_two_ranks_on_one_card(tmp):
    """What NCCL does with two ranks on one device (it is expected to
    refuse them): the ranks' first error line, or what happened
    instead.  Informational: the phase then runs gloo either way."""
    job = dkt.deploy.Job("chip_smoke.py", world=2,
                         init_method=f"file://{tmp}/rdv_nccl",
                         args=("--dp-rank", "nccl", tmp),
                         env={"NCCL_DEBUG": "WARN"})
    try:
        done = job.run_local(check=False, timeout=90, capture=True)
    except TimeoutError:
        return "no error: the ranks hung (killed after 90 s)"
    errs = [open(p).read() for p in (os.path.join(tmp, f"nccl_r{r}.txt")
                                     for r in range(2)) if os.path.exists(p)]
    if not errs:
        return (f"no error: returncodes {[c.returncode for c in done]}, "
                f"stderr {(done[0].stderr or '')[-300:]!r}")
    # NCCL's own reason (NCCL_DEBUG=WARN) is in the ranks' output.
    why = [line.strip() for c in done for line in
           (c.stdout or "").splitlines() + (c.stderr or "").splitlines()
           if "NCCL WARN" in line]
    return "; ".join([errs[0].strip().splitlines()[0][:300]] + why[:2])


def dp_rank_main(mode, tmp):
    """One rank of phase dp_keras (started by ``deploy.Job``).  ``nccl``:
    join NCCL on cuda:0 and all-reduce (the second rank on the same card
    must fail; the error is written for the parent).  ``gloo``: join
    gloo over CUDA tensors, then ADAG(num_workers=2) and
    AEASGD(num_workers=2) at the bench config and the f32 parity ADAG;
    rank 0 writes the results."""
    import torch.distributed as dist

    rank = int(os.environ["RANK"])
    if mode == "nccl":
        try:
            dkt.deploy.init_from_env(device="cuda:0", backend="nccl",
                                     timeout=120)
            t = torch.ones(4, device="cuda:0")
            dist.all_reduce(t)
            torch.cuda.synchronize()
            dist.destroy_process_group()
            return 0
        except Exception as e:  # the refusal being confirmed
            with open(os.path.join(tmp, f"nccl_r{rank}.txt"), "w") as f:
                f.write(f"{type(e).__name__}: {e}")
            return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dkt.deploy.init_from_env(device="cuda:0", backend="gloo", timeout=300)
    import warnings

    warnings.filterwarnings("ignore", message="export_model")
    x, y = cifar_data(DP_KERAS_ROWS)
    ds = dkt.Dataset.from_arrays(x, y)
    out = {}
    for name, cls, kw in (
            ("ADAG", dkt.ADAG, dict(worker_optimizer="adam",
                                    learning_rate=1e-3,
                                    communication_window=4)),
            ("AEASGD", dkt.AEASGD, dict(learning_rate=0.05, rho=5.0,
                                        communication_window=4))):
        t = keras_trainer(cls, "cuda:0", KERAS_BATCH, 1, num_workers=2, **kw)
        t.train(ds)
        out[name] = dict(losses=t.history, train_s=t.training_time,
                         world=t.num_workers, backend=t.mesh.backend)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        n = 8 * 256 * 2
        t = keras_trainer(dkt.ADAG, "cuda:0", 256, 1, policy="float32",
                          seed=9, num_workers=2, worker_optimizer="sgd",
                          learning_rate=0.01, communication_window=2)
        m = t.train(dkt.Dataset.from_arrays(x[:n], y[:n]))
    finally:
        torch.backends.cudnn.deterministic = prev
    if rank == 0:
        w = dkt.keras_numpy_from_module(m)[0]
        np.savez(os.path.join(tmp, "gloo_parity.npz"), history=t.history,
                 **{f"w{i}": a for i, a in enumerate(w)})
        with open(os.path.join(tmp, "gloo.json"), "w") as f:
            json.dump(out, f)
    dist.destroy_process_group()
    return 0


def dp_keras_phase():
    """Two ranks on the one card through ``deploy.Job.run_local()``:
    NCCL's refusal of two ranks on one device (its error logged), then
    gloo over CUDA tensors: ADAG and AEASGD at num_workers=2 on the CIFAR
    CNN at keras_train's bench config (the losses falling), and an f32
    ADAG at world 2 held against world-1 ADAG at twice the batch on the
    same rows (weights atol 1e-4, PERF §2's Keras tolerance)."""
    tmp = tempfile.mkdtemp()
    nccl_err = nccl_two_ranks_on_one_card(tmp)
    t0 = time.perf_counter()
    dkt.deploy.Job("chip_smoke.py", world=2,
                   init_method=f"file://{tmp}/rdv_gloo",
                   args=("--dp-rank", "gloo", tmp)).run_local(
        timeout=600, capture=True)
    wall = time.perf_counter() - t0
    runs = json.load(open(os.path.join(tmp, "gloo.json")))
    for name, r in runs.items():
        hist = r["losses"]
        if not (hist and np.all(np.isfinite(hist))):
            raise AssertionError(f"dp_keras {name}: losses {hist}")
        # AEASGD's elastic pull holds it on the loss plateau for its
        # first rounds (phase keras_train gives it twice the epochs).
        if name == "ADAG" and not hist[-1] < hist[0]:
            raise AssertionError(f"dp_keras {name}: losses {hist}")
        if r["world"] != 2 or r["backend"] != "gloo":
            raise AssertionError(f"dp_keras {name}: {r}")
    got = np.load(os.path.join(tmp, "gloo_parity.npz"))
    x, y = cifar_data(DP_KERAS_ROWS)
    n = 8 * 256 * 2
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t = keras_trainer(dkt.ADAG, "cuda", 512, 1, policy="float32", seed=9,
                          worker_optimizer="sgd", learning_rate=0.01,
                          communication_window=2)
        m = t.train(dkt.Dataset.from_arrays(x[:n], y[:n]))
    finally:
        torch.backends.cudnn.deterministic = prev
    want = dkt.keras_numpy_from_module(m)[0]
    w_err = max(float(np.abs(got[f"w{i}"] - a).max())
                for i, a in enumerate(want))
    h_err = float(np.abs(got["history"] - np.array(t.history)).max())
    if not (w_err <= 1e-4 and h_err <= 1e-4):
        raise AssertionError(f"dp_keras: world-2 ADAG differs from world 1 "
                             f"at twice the batch: weights {w_err}, losses "
                             f"{h_err}")
    log("dp_keras", ranks=2, backend="gloo", tensors="cuda",
        nccl_two_ranks_one_card_error=nccl_err, runs={
            k: dict(losses_first_last=[v["losses"][0], v["losses"][-1]],
                    n_losses=len(v["losses"]), train_s=v["train_s"])
            for k, v in runs.items()},
        job_wall_s=wall, parity_steps=len(t.history),
        parity_weight_max_abs_err=w_err, parity_loss_max_abs_err=h_err,
        tol=1e-4)


def async_dp_phase():
    """AsyncDP(hosts=4) in one process on the card against the same
    seed and schedule on the CPU: the async.* event log and the audit
    report equal, the center's weights within 1e-4."""
    from distkeras_tpu_torch import obs

    rng = np.random.default_rng(0)
    centers = rng.normal(0, 4.0, (4, 16))
    labels = rng.integers(0, 4, 512)
    x = (centers[labels] + rng.normal(0, 0.5, (512, 16))).astype(np.float32)
    ds = dkt.Dataset.from_arrays(x, labels.astype(np.int64))
    tmp = tempfile.mkdtemp()
    res = {}
    for dev in ("cuda", "cpu"):
        sched = dkt.AsyncSchedule(seed=3).stall(1, 2, 50.0).join(
            5, at_time=2.0)
        t = dkt.AsyncDP(dkt.zoo.MLP(16, (32,), 4, seed=0), hosts=4, tau=2,
                        beat_window=1.5, schedule=sched,
                        loss="sparse_categorical_crossentropy",
                        worker_optimizer="sgd", learning_rate=0.05,
                        batch_size=4, num_epoch=2, communication_window=2,
                        device=dev)
        path = os.path.join(tmp, f"{dev}.jsonl")
        with obs.session(path):
            m = t.train(ds)
        ev = [(r["name"], r["fields"]) for r in obs.read_trace(path)
              if r.get("kind") == "event" and r["name"].startswith("async.")]
        res[dev] = (t, ev, dkt.keras_numpy_from_module(m)[0])
    (tc, evc, wc), (tp, evp, wp) = res["cuda"], res["cpu"]
    w_err = max(float(np.abs(a - b).max()) for a, b in zip(wc, wp))
    if evc != evp or tc.async_report != tp.async_report:
        raise AssertionError("AsyncDP's event log on the card differs from "
                             "the CPU run's")
    if not w_err <= 1e-4:
        raise AssertionError(f"AsyncDP center weights differ by {w_err}")
    log("async_dp", hosts=4, events=len(evc), report=tc.async_report,
        event_log_equal=True, weight_max_abs_err=w_err, tol=1e-4,
        train_s=tc.training_time)



# ----------------------------------------------------- checkpoint / resume

RESUME_STEPS = 6       # rounds of the straight run
RESUME_EVERY = 2       # checkpoint_every of the supervised run
RESUME_PREEMPT = 3     # the round FaultPlan.preempt stops
# Phase resume (c): the CIFAR CNN (f32) over two gloo ranks sharing the
# card, CLUSTER_ROUNDS rounds of window 2 x 2 ranks x CLUSTER_BATCH rows.
CLUSTER_BATCH = 512
CLUSTER_ROUNDS = 8
CLUSTER_ROWS = CLUSTER_ROUNDS * 2 * 2 * CLUSTER_BATCH


def round_clock(trainer):
    """Time an LMTrainer's rounds: wrap its ``_checkpoint`` (called once
    a round, after the step) and ``_load_carry`` (the restored state into
    the live one) with a device sync and a timestamp at entry and exit.
    Returns ``{"rounds": {round: (entry, exit)}, "loaded": (entry,
    exit)}``; a round's step ms is its entry minus the previous round's
    exit (so no save is inside it)."""
    stamps = {"rounds": {}, "loaded": None}
    ckpt, load = trainer._checkpoint, trainer._load_carry

    def timed_ckpt(state, rnd, final=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return ckpt(state, rnd, final)
        finally:
            if not final:
                stamps["rounds"][rnd] = (t0, time.perf_counter())

    def timed_load(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        load(*args)
        torch.cuda.synchronize()
        stamps["loaded"] = (t0, time.perf_counter())

    trainer._checkpoint, trainer._load_carry = timed_ckpt, timed_load
    return stamps


def step_ms(stamps, first, last):
    """Mean step ms of rounds ``first..last`` (each after the previous
    round's exit)."""
    r = stamps["rounds"]
    return 1e3 * sum(r[i][0] - r[i - 1][1]
                     for i in range(first, last + 1)) / (last - first + 1)


def lm_resume_case(np_params, rows, name, **kw):
    """Phase resume (a) / (b): the training config with dropout 0.1 (so
    the CUDA generator's state is part of the checkpoint): two straight
    runs of RESUME_STEPS steps, which must be bit-identical; then the
    same trainer under a Supervisor with checkpoint_every=2 and
    FaultPlan.preempt("train.round", at=3), which resumes from step 2,
    ends at step 6 and must equal the straight run bit for bit (params,
    and rounds 3-6's losses), every step through the three kernels.
    Returns (its record, the supervised run's launches)."""
    from distkeras_tpu_torch import obs

    cfg = dataclasses.replace(FLAGSHIP_TRAIN, dropout=0.1)

    def trainer(**ck):
        return dkt.LMTrainer(cfg, optimizer="adamw", learning_rate=3e-4,
                             batch_size=8, seed=0, **kw, **ck)

    straight = []
    for _ in range(2):
        t = trainer()
        clock = round_clock(t)
        out = t.train(rows, params=dkt.params_from_numpy(np_params, "cuda"))
        straight.append((t.history, {k: v.detach().cpu() for k, v in
                                     named_leaves(out)}, clock))
        del t, out
    (hist, ref, _), (hist2, ref2, straight_clock) = straight
    differ = [k for k in ref if not torch.equal(ref[k], ref2[k])]
    if hist != hist2 or differ:
        raise AssertionError(f"resume {name}: two straight runs differ "
                             f"(losses equal: {hist == hist2}; leaves "
                             f"{differ[:4]})")
    del ref2
    tmp = tempfile.mkdtemp()
    ckdir, trace = os.path.join(tmp, "ckpt"), os.path.join(tmp, "t.jsonl")
    t = trainer(checkpoint_dir=ckdir, checkpoint_every=RESUME_EVERY,
                max_checkpoints=2)
    clock = round_clock(t)
    sup = dkt.Supervisor(t, max_retries=0, handle_sigterm=False)
    torch.cuda.synchronize()
    zero_launches()
    with obs.session(trace), dkt.FaultPlan().preempt(
            "train.round", at=RESUME_PREEMPT):
        out = sup.run(rows, params=dkt.params_from_numpy(np_params, "cuda"))
    torch.cuda.synchronize()
    launches = dict(attn.LAUNCHES)
    executed = RESUME_PREEMPT + RESUME_STEPS - RESUME_EVERY
    expect_launches(launches, cfg.n_layers * executed, f"resume {name}")
    attempts = [(a.outcome, a.resumed_from) for a in sup.attempts]
    if attempts != [("preempted", None), ("ok", RESUME_EVERY)]:
        raise AssertionError(f"resume {name}: attempts {attempts}")
    got = {k: v.detach().cpu() for k, v in named_leaves(out)}
    differ = [k for k in ref if not torch.equal(got[k], ref[k])]
    if differ or t.history != hist[RESUME_EVERY:]:
        raise AssertionError(
            f"resume {name}: the resumed run differs from the straight "
            f"run (leaves {differ[:4]}; losses {t.history} vs "
            f"{hist[RESUME_EVERY:]})")
    spans = [r for r in obs.read_trace(trace) if r.get("kind") == "span"]
    restore = [r["dur"] for r in spans if r["name"] == "checkpoint.restore"]
    saves = [r["dur"] for r in spans if r["name"] == "checkpoint.save"]
    first = RESUME_EVERY + 1  # the first round after the restore
    rounds = clock["rounds"]
    resumed_s = sup.attempts[1].duration
    gb = os.path.getsize(os.path.join(ckdir, str(RESUME_STEPS),
                                      "state.pkl")) / 1e9
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    del out, got, ref, t, sup
    return dict(
        name=name, steps=RESUME_STEPS, checkpoint_every=RESUME_EVERY,
        preempted_at=RESUME_PREEMPT, resumed_from=RESUME_EVERY,
        straight_runs_bit_identical=True, resumed_bit_identical=True,
        losses_rounds_3_6=hist[RESUME_EVERY:], launches=dict(launches),
        # Save: tree, device-to-host copy, pickle, fsync, rename (steps
        # 2, 4, 6); restore: read and unpickle onto the host; load: the
        # host tree into the live state on the card.
        save_s=saves, restore_s=restore[0],
        load_s=clock["loaded"][1] - clock["loaded"][0], checkpoint_gb=gb,
        # Step ms: the warm straight run's rounds 2-6, the resumed run's
        # first round after the load, and its rounds 4-6.
        step_ms_straight=step_ms(straight_clock, 2, RESUME_STEPS),
        first_step_ms_after_restore=1e3 * (rounds[first][0]
                                           - clock["loaded"][1]),
        step_ms_after_restore=step_ms(clock, first + 1, RESUME_STEPS),
        resumed_attempt_s=resumed_s), launches


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def cluster_rank_main(spec_path):
    """One host of phase resume (c), started by a ClusterSupervisor
    driver (``run_cluster_local``) with the ``DKT_CLUSTER_*``
    environment: its ClusterMember (heartbeats, the collective
    watchdog), the epoch's gloo group over CUDA tensors on the one card,
    then ADAG(num_workers=2) on the CIFAR CNN (f32, cuDNN deterministic)
    under a per-host Supervisor, checkpointing every round into the
    shared directory.  On epoch 0 the spec's host dies at the spec's
    round (FaultPlan.kill: exit 137, no cleanup).  Host 0 writes the
    weights and losses of the run it finished."""
    import warnings

    import torch.distributed as dist
    from distkeras_tpu_torch.resilience import cluster

    warnings.filterwarnings("ignore", message="export_model")
    spec = json.load(open(spec_path))
    member = cluster.member_from_env()
    member.start()
    try:
        member.join_group(device="cuda:0", backend="gloo", timeout=300)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        x, y = cifar_data(CLUSTER_ROWS, seed=4)
        t = keras_trainer(dkt.ADAG, "cuda:0", CLUSTER_BATCH, 1,
                          policy="float32", seed=9, num_workers=2,
                          worker_optimizer="sgd", learning_rate=0.01,
                          communication_window=2,
                          checkpoint_dir=spec["ckpt"], checkpoint_every=1,
                          max_checkpoints=100)
        sup = dkt.Supervisor(t, max_retries=0, handle_sigterm=False)
        plan = dkt.FaultPlan(seed=spec["seed"])
        if spec["kill"] and member.epoch == 0 \
                and member.host == spec["kill_host"]:
            plan.kill("train.round", at=spec["kill"])
        with plan:
            m = sup.run(dkt.Dataset.from_arrays(x, y))
        member.complete()
        if member.host == 0:
            w = dkt.keras_numpy_from_module(m)[0]
            np.savez(os.path.join(spec["out"], "final.npz"),
                     history=np.asarray(t.history),
                     resumed_from=np.asarray(
                         sup.attempts[-1].resumed_from or 0),
                     **{f"w{i}": a for i, a in enumerate(w)})
        dist.destroy_process_group()
    finally:
        member.stop()
    return 0


def cluster_job(tmp, kill, kill_host=1, seed=0):
    """Two hosts of ``--cluster-rank`` under ``run_cluster_local``;
    returns (the drivers' summaries, host 0's final.npz, wall s)."""
    from distkeras_tpu_torch.resilience import cluster

    os.makedirs(tmp)
    spec = os.path.join(tmp, "spec.json")
    with open(spec, "w") as f:
        json.dump({"out": tmp, "ckpt": os.path.join(tmp, "ckpt"),
                   "kill": kill, "kill_host": kill_host, "seed": seed}, f)
    t0 = time.perf_counter()
    summaries = cluster.run_cluster_local(
        [sys.executable, os.path.abspath(__file__), "--cluster-rank", spec],
        num_hosts=2, coord_dir=os.path.join(tmp, "coord"),
        base_port=free_port(), checkpoint_dirs=[os.path.join(tmp, "ckpt")],
        window=10.0, poll=0.2, heartbeat_interval=0.5, grace=240.0,
        max_restarts=2, barrier_timeout=300.0, attempt_timeout=400.0)
    wall = time.perf_counter() - t0
    return summaries, dict(np.load(os.path.join(tmp, "final.npz"))), wall


def cluster_restart_case():
    """Phase resume (c): a straight two-host run, then the same job with
    a seeded FaultPlan.kill of host 1 mid-run: both drivers restart
    under epoch 1 (host 0 trims to the cluster-consistent step), the
    hosts join the epoch-1 group on its own port and resume, and the
    restarted job's weights and resumed losses must equal the straight
    run's bit for bit."""
    kill = int(np.random.default_rng(10).integers(3, CLUSTER_ROUNDS - 1))
    tmp = tempfile.mkdtemp()
    s_sum, straight, s_wall = cluster_job(os.path.join(tmp, "straight"),
                                          None)
    if any(s["epochs"] != 1 or s["restarts"] for s in s_sum):
        raise AssertionError(f"resume cluster: straight run {s_sum}")
    k_sum, got, k_wall = cluster_job(os.path.join(tmp, "killed"), kill)
    if any(s["epochs"] != 2 or s["restarts"] != 1 for s in k_sum):
        raise AssertionError(f"resume cluster: killed run {k_sum}")
    start = int(got["resumed_from"])
    n_w = len([k for k in straight if k.startswith("w")])
    w_err = max(float(np.abs(got[f"w{i}"] - straight[f"w{i}"]).max())
                for i in range(n_w))
    if not (w_err == 0.0 and np.array_equal(got["history"],
                                            straight["history"][start:])):
        raise AssertionError(f"resume cluster: restarted job differs from "
                             f"the straight run (weights {w_err}, resumed "
                             f"from {start})")
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    rcs = {s["host"]: [a["rc"] for a in s["history"]
                       if a["event"] == "attempt"] for s in k_sum}
    return dict(model="cifar_cnn", policy="float32", ranks=2,
                backend="gloo", tensors="cuda", batch=CLUSTER_BATCH,
                rounds=CLUSTER_ROUNDS, killed_host=1, killed_at_round=kill,
                resumed_from=start, epochs=[s["epochs"] for s in k_sum],
                restarts=[s["restarts"] for s in k_sum], attempt_rcs=rcs,
                weights_bit_identical=True, straight_wall_s=s_wall,
                restarted_wall_s=k_wall)


def resume_phase(np_params):
    """Phase resume: (a) the LM at full width with dropout, preempted at
    round 3 and resumed by a Supervisor; (b) the same with zero=1 in a
    world-1 NCCL group; (c) the two-host cluster restart.  Returns the
    launches of (a) and (b)'s supervised runs."""
    import torch.distributed as dist

    rows = np.random.default_rng(13).integers(
        0, FLAGSHIP_TRAIN.vocab_size,
        (8 * RESUME_STEPS, TRAIN_SHAPE[1] + 1)).astype(np.int32)
    rec_a, launches = lm_resume_case(np_params, rows, "lm")
    torch.cuda.empty_cache()
    rdv = tempfile.mkdtemp()
    dkt.initialize_multihost(init_method=f"file://{rdv}/rdv", world_size=1,
                             rank=0, timeout=120)
    try:
        backend = dist.get_backend()
        rec_b, launches_b = lm_resume_case(np_params, rows, "lm_zero1",
                                           zero=1)
    finally:
        dist.destroy_process_group()
    rec_b["backend"] = backend
    for k in launches:
        launches[k] += launches_b[k]
    torch.cuda.empty_cache()
    rec_c = cluster_restart_case()
    log("resume", config="transformer_d1024", dropout=0.1, batch=8,
        seq=TRAIN_SHAPE[1], optimizer="adamw", learning_rate=3e-4,
        cublas_workspace_config=os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
        deterministic_algorithms=torch.are_deterministic_algorithms_enabled(),
        lm=rec_a, lm_zero1=rec_b, cluster=rec_c, launches=launches)
    return launches



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
            log("kernel_vs_plain", kernel="flash_fwd", **cases[-1])
    main_case = cases[0]   # bf16 causal: what the prefill launches
    # The engine's prefills: pool segments of 256 and 128 tokens at batch
    # 1, and the speculative warm-up of 8 x 64-token prompts.
    engine_cases = {}
    for name, shape in (("pool256", (1, 256, 8, 128)),
                        ("pool128", (1, 128, 8, 128)),
                        ("spec_warm", (8, 64, 8, 128))):
        engine_cases[name] = kernel_case(torch.bfloat16, True, None,
                                         shape=shape)
        log("kernel_vs_plain", kernel="flash_fwd", **engine_cases[name])
    # The f32 target's warm-up under its int8 draft (phase int8_serve).
    spec32 = kernel_case(torch.float32, True, None, shape=(8, 64, 8, 128))
    log("kernel_vs_plain", kernel="flash_fwd", **spec32)

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
    expect_tokens(out, prompt, NEW_TOKENS, cfg.vocab_size, "generate")
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

    # 5. The continuous-batching serving path at full width (no profiled
    # window: its idle share is read at the end).
    torch.cuda.empty_cache()
    engine_launches = engine_phase(np_params)

    # 5b. The model surface at inference: MoE, int8 weights, the int8
    # KV cache.
    np_moe = numpy_params(moe_cfg(FLAGSHIP_TRAIN, 1), seed=11)
    torch.cuda.empty_cache()
    moe_serve_launches = moe_serve_phase(np_moe)
    torch.cuda.empty_cache()
    int8_launches = int8_serve_phase(np_params)

    # 6. The training path at full width, and its parity.
    train_np = numpy_params(FLAGSHIP_TRAIN, seed=1)
    torch.cuda.empty_cache()
    train_launches, dense_step_ms = train_phase(train_np, profile)
    train_parity_phase(train_np)

    # 6b. The model surface in training: MoE and LoRA.
    torch.cuda.empty_cache()
    moe_train_launches = moe_train_phase(np_moe, dense_step_ms)
    torch.cuda.empty_cache()
    lora_launches = lora_train_phase(train_np, dense_step_ms)

    # 7. The paper's path: the Keras trainer family on the CIFAR CNN.
    keras_phase()

    # 8. Long-context LM training from raw text, at seq 4096.
    torch.cuda.empty_cache()
    long_launches, long_cases = long_phase()

    # 8b. Data parallelism: the LM in a world-1 NCCL group, two Keras
    # ranks sharing the card over gloo, and the async tier.
    torch.cuda.empty_cache()
    dp_launches = dp_lm_phase(train_np, dense_step_ms)
    torch.cuda.empty_cache()
    dp_keras_phase()
    async_dp_phase()

    # 8c. Checkpoint, resume and resilience: the LM preempted and
    # resumed at full width (also under zero=1), and the cluster restart.
    torch.cuda.empty_cache()
    resume_launches = resume_phase(train_np)

    # 9. The engine's profiled window.
    torch.cuda.empty_cache()
    log("engine_idle", idle_share_4x_step4=engine_idle_share(
        dkt.params_from_numpy(np_params, "cuda", dtype=torch.bfloat16),
        FLAGSHIP))
    if profile:
        torch.cuda.empty_cache()
        profile_surface(np_params, np_moe)
    del np_moe
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

    surface = (moe_train_launches, lora_launches, moe_serve_launches,
               int8_launches, dp_launches, resume_launches)

    def launch_counts(name, *paths):
        paths = paths + surface
        return {"launches": sum(p[name] for p in paths),
                "launches_by_path": {k: p[name] for k, p in zip(
                    ("serve", "engine", "train", "long_train", "moe_train",
                     "lora_train", "moe_serve", "int8_serve", "dp",
                     "resume"),
                    paths)}}

    print(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "distkeras_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "distkeras_tpu/ops/attention.py:197",
        **launch_counts("flash_fwd", {"flash_fwd": serve_fwd_launches},
                        {"flash_fwd": engine_launches}, train_launches,
                        long_launches),
        "max_abs_err": main_case["max_abs_err"], "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"], "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        **{f"bf16_causal_{name}": {k: c[k] for k in (
            "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")} for name, c in engine_cases.items()},
        "f32_causal_spec_int8_warm": {k: spec32[k] for k in (
            "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")},
        "f32_lse_causal": fwd_times(tmain),
        "f32_lse_causal_seq4096": fwd_times(lcausal),
        "f32_lse_window1024_seq4096": fwd_times(lwindow)}, {
        "name": "flash_bwd_dq", "route": "cuda", "source": bwd_source,
        "replaces": "distkeras_tpu/ops/attention.py:438",
        **launch_counts("flash_bwd_dq", {"flash_bwd_dq": 0},
                        {"flash_bwd_dq": 0}, train_launches, long_launches),
        **bwd_times(tmain, "dq", ("dq",)),
        "bf16_causal": bwd_times(tbf16, "dq", ("dq",)),
        "f32_causal_seq4096": bwd_times(lcausal, "dq", ("dq",)),
        "f32_window1024_seq4096": bwd_times(lwindow, "dq", ("dq",))}, {
        "name": "flash_bwd_dkv", "route": "cuda", "source": bwd_source,
        "replaces": "distkeras_tpu/ops/attention.py:498",
        **launch_counts("flash_bwd_dkv", {"flash_bwd_dkv": 0},
                        {"flash_bwd_dkv": 0}, train_launches, long_launches),
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
    if sys.argv[1:2] == ["--dp-rank"]:
        sys.exit(dp_rank_main(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--cluster-rank"]:
        sys.exit(cluster_rank_main(sys.argv[2]))
    sys.exit(main(profile="--profile" in sys.argv[1:]))

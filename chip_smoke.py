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
- the paper's other workloads (phase ``keras_zoo``): ``imdb_lstm``
  (``FusedLSTM`` and the stock LSTM on cuDNN's fused kernel), ``resnet50``
  and the two MLPs at their bench configs (mixed bf16, sgd 0.01, device
  data: step ms over two timed windows of ~1.5 s, samples/s, idle
  share, peak GB; ResNet-50's FLOP share of the bf16 peak), card runs
  against the CPU's (f32 ``imdb_lstm`` both ways; ResNet-50 at 64 x 64
  in float64, and its f32 loss and moving statistics), the reference's
  BN model on two gloo ranks sharing the card against world 1 at twice
  the batch (synchronized statistics), and ResNet-50 under ADAG in a
  world-1 NCCL group against the run without one (equal, and timed).
  ``python3 chip_smoke.py --dp-rank sync_bn DIR`` is one of those ranks.
  These models reach no hand-written kernel (cuDNN, cuBLAS and ATen, as
  the reference's are XLA's);
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
- paged KV serving and beam search (phases ``paged`` and ``beam``, their
  profiled windows ``paged_4x_step4`` and ``beam_16_steps`` at the end of
  the script): ``PagedBatcher(lanes=8, block=41)`` against
  ``ContinuousBatcher`` (equal tokens on a staggered schedule, also with
  ``prefill_chunk=128``; an f32 2-layer copy on the card equal to the
  CPU's), 8 paged lanes on the KV bytes of 4 monolithic ones (measured
  peak concurrency >= 2), a shared 492-token stem (84 stem-hit blocks on
  a fresh engine), a copy-on-write fork (one block copied, none leaked),
  ``kv_int8="prefill"`` admissions through the forward kernel (8 launches
  each; the f32 first-step logit delta against the decode-built cache),
  and ``engine_load`` on both engines (the allocator's reserved bytes and
  device allocations unchanged over the serve phase, one device-to-host
  copy a ``step``); ``beam_search`` as bench_beam4 (batch 8, prompt 64,
  256 new, width 4) with ancestry attention and the physical gather, on
  the flagship and on its window-256 ring (bf16 ancestry and physical
  beams part only at a near tie of their own candidate scores, checked
  by running both in lockstep), and an f32 2-layer copy on the card
  equal to the CPU's;
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
  ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` before CUDA starts;
- the serving fleet (phase ``fleet``, its profiled windows
  ``fleet_lone_wave`` / ``fleet_routed_wave`` at the end): (a) two
  ``InProcessReplica(PagedBatcher(lanes=8))`` under
  ``Router(policy="affinity")``, 4 stems of 492 tokens x 8 requests in 4
  waves, every request ok, tokens against one engine under the same
  waves (``greedy_agreement``), every request of a stem after its first
  on the replica that holds it; (b) a ``role="prefill"`` and a
  ``role="decode"`` ``PagedBatcher(kv_int8="prefill")``: each cold stem
  exported through the forward kernel, carried through
  ``encode_shipment`` / ``decode_shipment`` and imported, tokens equal to
  one engine that pins the same stems first, a warm wave shipping
  nothing, an export that raises falling back to the raw prompt (tokens
  equal a cold solo admission), no block in use after shutdown; (c)
  three replica processes (``python3 chip_smoke.py --replica SPEC``: one
  prefill, two decode, each an ``EngineEndpoint`` and a federated
  telemetry session) found by ``discover_replicas``, (b)'s traffic over
  HTTP with equal tokens, then a decode replica SIGKILLed mid-stream
  (every accepted request ends ok, ``/metrics/cluster`` drops the dead
  host); (d) an SLO breach on one replica scaling a warm pool's replica
  in and a lossless scale-down, the allocator unchanged through the
  join, and (b)'s request waterfall with its block-transfer hop; and the
  weight push (phase ``weight_push``): an ``LMTrainer`` at the serving
  config in f32 publishing 2 rounds into a ``CanaryController`` over two
  ``ContinuousBatcher(hot_swap=True)`` replicas (each version promoted
  and equal to a fresh engine on it, a request in flight across a swap,
  a corrupted snapshot never adopted, a drifting candidate rolled back,
  swaps that allocate nothing and move no tensor, a refused swap leaving
  the weights bit for bit; swap ms, publish / load s raw and int8).

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
four model-surface phases, ``dp``, ``resume`` (the supervised runs
of (a) and (b)), ``paged`` (the ``kv_int8="prefill"`` admissions),
``beam`` (the bench runs' prompt passes), ``fleet`` (the prefill
replica's exports and the fallback's raw admissions in this process;
each replica process prints its own) and ``weight_push`` (the
publishing trainer's rounds) (``launches_by_path``; a run that only serves a
comparison is not counted); the backward kernels' times are the
training case (f32, causal) and their launches those of the training
runs (train, long_train, moe_train, lora_train, dp, resume,
weight_push), with the
bf16 causal case beside it under ``"bf16_causal"``; each kernel also
carries its seq-4096 f32 readings (causal, and window 1024).
"""

import dataclasses
import json
import math
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
from distkeras_tpu_torch.utils.serialization import weight_paths

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


def profile_window(name, fn, count=()):
    """Device time by kernel (torch.profiler) of one call of ``fn`` after
    a warm call, with the device's busy and idle share of its wall
    time (also returned).  ``count``: substrings of device event names
    (e.g. ``"DtoH"``) whose calls are logged under ``counts``."""
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
    extra = {}
    if count:
        extra["counts"] = {c: sum(e.count for e in kernels if c in e.key)
                           for c in count}
    log("profile", window=name, wall_ms=1e3 * wall, device_busy_ms=busy,
        idle_share=1 - busy / (1e3 * wall),
        top=[{"kernel": e.key[:90], "calls": e.count,
              "device_ms": e.self_device_time_total / 1e3}
             for e in top], **extra)
    if count:
        return 1 - busy / (1e3 * wall), extra["counts"]
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


# The paper's other bench configs (scripts/bench_suite.py:173-229), each
# in mixed_bfloat16 with sgd at 0.01 through SingleTrainer over
# device-resident data: imdb_lstm (vocab 20000, maxlen 128, batch 512;
# FusedLSTM and the stock LSTM on torch's fused kernel), resnet50
# (224 x 224 x 3, 1000 classes, batch 128; also ADAG in a world-1 NCCL
# group and without one), and the MLPs at batch 4096 with 8 steps a call.
LSTM_BENCH = dict(vocab_size=20000, embed_dim=128, lstm_units=128,
                  maxlen=128)
LSTM_BATCH = 512
RESNET_BATCH = 128
MLP_BATCH = 4096
PARITY_TOL = dict(rtol=1e-4, atol=1e-5)
ZOO_WINDOW_S = 1.5      # seconds of steps in each timed window


def zoo_throughput(name, model, x, y, loss, batch, preprocess=None,
                   profile_calls=0, deferred=None, trainer=dkt.SingleTrainer,
                   **kw):
    """Steady step ms of ``trainer(device_data=True)``.  After a warm-up
    epoch (cuDNN's algorithm search, the allocator), calls of 1 and of
    1 + E epochs pay the same set-up (staging, state, export), so their
    difference is E epochs of steps; E is sized from a 1- and a 2-epoch
    call so that a window holds ~``ZOO_WINDOW_S`` of steps.  Two windows
    in turn (``step_ms`` is their mean, ``window_spread`` how far they
    part), and the peak memory of the timed calls.  With
    ``profile_calls``, a callable appended to ``deferred`` later fills in
    the device's idle share over that many calls of the indexed step: a
    profiled window leaves the host's later launches slower, so the
    phase profiles after all its timing."""
    ds = dkt.Dataset.from_arrays(x, y)
    t = trainer(model, loss=loss, worker_optimizer="sgd", learning_rate=0.01,
                batch_size=batch, num_epoch=1, device_data=True,
                preprocess=preprocess, device="cuda", **kw)

    def epochs_s(n):
        t.num_epoch = n
        t.train(ds)
        return t.training_time

    epochs_s(1)
    epoch = max(epochs_s(2) - epochs_s(1), 1e-3)
    extra = max(1, min(400, math.ceil(ZOO_WINDOW_S / epoch)))
    spc = kw.get("steps_per_call", 1)
    steps = len(ds) // (batch * spc) * spc
    torch.cuda.reset_peak_memory_stats()
    windows = []
    for _ in range(2):
        one = epochs_s(1)
        windows.append(1e3 * (epochs_s(1 + extra) - one) / (extra * steps))
    hist = t.history
    if not (hist and np.all(np.isfinite(hist))):
        raise AssertionError(f"{name}: bad losses {hist}")
    step_ms = float(np.mean(windows))
    out = dict(batch=batch, steps_per_call=spc, steps_a_window=extra * steps,
               window_step_ms=windows,
               window_spread=abs(windows[0] - windows[1]) / step_ms,
               step_ms=step_ms, samples_per_s=batch * 1e3 / step_ms,
               idle_share=None,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
               losses_first_last=[hist[0], hist[-1]])

    def profile():
        ad = t.adapter
        state = ad.init_state()
        step = ad.make_indexed_train_step(spc)
        X = torch.as_tensor(x, device="cuda")
        Y = torch.as_tensor(y, device="cuda")
        blocks = [torch.arange(i * batch * spc, (i + 1) * batch * spc,
                               device="cuda").reshape(spc, batch)
                  for i in range(profile_calls)]
        out["idle_share"] = profile_window(f"keras_zoo_{name}", lambda: [
            step(state, X, Y, b) for b in blocks])

    if profile_calls:
        deferred.append(profile)
    return out


def conv_flops(model, x):
    """Forward FLOPs of ``model`` on ``x``: 2 x MACs of every Conv2d and
    Linear, counted by forward hooks (in inference mode, so that the
    moving statistics stay as they are)."""
    total = [0]

    def hook(mod, inp, out):
        if isinstance(mod, torch.nn.Conv2d):
            k = mod.weight[0].numel()          # C_in x kh x kw
            total[0] += 2 * out.numel() * k
        elif isinstance(mod, torch.nn.Linear):
            total[0] += 2 * out.numel() * mod.in_features

    hooks = [m.register_forward_hook(hook) for m in model.modules()]
    model.eval()
    try:
        with torch.no_grad():
            model(x)
    finally:
        model.train()
        for h in hooks:
            h.remove()
    return total[0]


def lstm_data(n, vocab, maxlen, seed=0):
    """int32 tokens and a learnable label: whether the first token is in
    the lower half of the vocabulary."""
    x = np.random.default_rng(seed).integers(0, vocab, (n, maxlen)
                                             ).astype(np.int32)
    return x, (x[:, 0] < vocab // 2).astype(np.int64)


def imagenet_like(n, seed=0, side=224):
    """uint8 ``[n, side, side, 3]`` noise images, labels in [0, 1000)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (n, side, side, 3), dtype=np.uint8)
    return x, rng.integers(0, 1000, n).astype(np.int64)


def zoo_run(builder, device, x, y, loss, batch, steps, dtype=None,
            trainer=dkt.SingleTrainer, **kw):
    """An sgd run of ``builder()`` (numpy-seeded weights) on ``device``
    (``dtype``: the module cast, e.g. float64): ``(losses, Keras
    weights, step-0 Keras weights)``."""
    model = builder()
    w0 = dkt.get_weights(model)
    if dtype is not None:
        model = model.to(dtype)
    t = trainer(model, loss=loss, worker_optimizer="sgd", batch_size=batch,
                num_epoch=1, device=device, **kw)
    n = batch * steps
    out = t.train(dkt.Dataset.from_arrays(x[:n], y[:n]))
    return np.array(t.history), dkt.get_weights(out), w0


def update_gap(a, b, w0):
    """``|| (a - w0) - (b - w0) || / || b - w0 ||`` over every variable
    at once."""
    du = np.concatenate([(np.float64(u) - z).ravel() for u, z in zip(a, w0)])
    dv = np.concatenate([(np.float64(v) - z).ravel() for v, z in zip(b, w0)])
    return float(np.linalg.norm(du - dv) / np.linalg.norm(dv))


def max_gap(a, b):
    return max(float(np.abs(np.float64(u) - v).max()) for u, v in zip(a, b))


def resnet_parity(x, y, steps=4, batch=8):
    """ResNet-50 at 64 x 64 on the card against the CPU.  float64,
    ``steps`` sgd steps at 0.01: the losses, the weights and the moving
    statistics at keras_parity's tolerances (tests/test_torch_resnet.py
    holds the CPU's float64 step to the reference's at 1e-8).  f32 one
    step: the loss and the moving statistics (the forward from equal
    weights) at the same tolerances; the update of this random-init net
    is ill-conditioned in f32 (in JAX too), so the card's and the CPU's
    f32 updates are read against the float64 one, not held."""
    build = lambda: dkt.zoo.resnet50(num_classes=1000,  # noqa: E731
                                     input_shape=(64, 64, 3), seed=21)
    loss = "sparse_categorical_crossentropy"
    x64 = x.astype(np.float64) / 255
    kw = dict(learning_rate=0.01)
    card64 = zoo_run(build, "cuda", x64, y, loss, batch, steps,
                     dtype=torch.float64, **kw)
    cpu64 = zoo_run(build, "cpu", x64, y, loss, batch, steps,
                    dtype=torch.float64, **kw)
    np.testing.assert_allclose(card64[0], cpu64[0], **PARITY_TOL)
    for a, b in zip(card64[1], cpu64[1]):
        np.testing.assert_allclose(a, b, **PARITY_TOL)
    ref = zoo_run(build, "cpu", x64, y, loss, batch, 1, dtype=torch.float64,
                  **kw)
    card = zoo_run(build, "cuda", x, y, loss, batch, 1, preprocess=to_unit,
                   **kw)
    cpu = zoo_run(build, "cpu", x, y, loss, batch, 1, preprocess=to_unit,
                  **kw)
    names = weight_paths(build())
    moving = [n.endswith(("moving_mean", "moving_variance")) for n in names]
    np.testing.assert_allclose(card[0], cpu[0], **PARITY_TOL)
    for a, b, m in zip(card[1], cpu[1], moving):
        if m:
            np.testing.assert_allclose(a, b, **PARITY_TOL)
    return dict(
        f64_steps=steps, batch=batch, f64_losses=card64[0].tolist(),
        f64_loss_max_abs_err=float(np.abs(card64[0] - cpu64[0]).max()),
        f64_weight_max_abs_err=max_gap(card64[1], cpu64[1]),
        f32_loss_rel_err=float(abs(card[0][0] - cpu[0][0]) / cpu[0][0]),
        f32_moving_stat_max_abs_err=max_gap(
            [a for a, m in zip(card[1], moving) if m],
            [b for b, m in zip(cpu[1], moving) if m]),
        f32_update_gap_to_f64_card=update_gap(card[1], ref[1], ref[2]),
        f32_update_gap_to_f64_cpu=update_gap(cpu[1], ref[1], ref[2]))


def lstm_parity(fused, steps=4, batch=64):
    """f32 imdb_lstm (vocab 1000, width 32, maxlen 32) on the card
    against the CPU: losses and weights at keras_parity's tolerances."""
    x, y = lstm_data(batch * steps, 1000, 32, seed=5)
    build = lambda: dkt.zoo.imdb_lstm(  # noqa: E731
        vocab_size=1000, embed_dim=32, lstm_units=32, maxlen=32, seed=6,
        fused=fused)
    kw = dict(learning_rate=0.1)
    card = zoo_run(build, "cuda", x, y, "binary_crossentropy", batch, steps,
                   **kw)
    cpu = zoo_run(build, "cpu", x, y, "binary_crossentropy", batch, steps,
                  **kw)
    np.testing.assert_allclose(card[0], cpu[0], **PARITY_TOL)
    for a, b in zip(card[1], cpu[1]):
        np.testing.assert_allclose(a, b, **PARITY_TOL)
    return dict(loss_max_abs_err=float(np.abs(card[0] - cpu[0]).max()),
                weight_max_abs_err=max_gap(card[1], cpu[1]))


def bn_model(seed=0):
    """The reference's BN model (tests/test_batchnorm_dp.py::bn_mlp, as
    tests/torch_dp_ranks.py ports it) with Keras' init from ``seed``.
    The rank script is imported from its directory: a package named
    ``tests`` elsewhere on the path would shadow the repo's."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    from torch_dp_ranks import BNMLP

    rng = np.random.default_rng(seed)
    glorot = lambda a, b: rng.uniform(  # noqa: E731
        -np.sqrt(6 / (a + b)), np.sqrt(6 / (a + b)), (a, b))
    return dkt.module_from_keras_numpy(BNMLP(), [
        glorot(16, 32), np.zeros(32), np.ones(32), np.zeros(32),
        glorot(32, 4), np.zeros(4)], [np.zeros(32), np.ones(32)])


def bn_blobs(n=512, seed=0):
    """Four Gaussian blobs in 16 dimensions."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 3, (4, 16))
    y = rng.integers(0, 4, n)
    return (centers[y] + rng.normal(0, 1, (n, 16))).astype(np.float32), y


def bn_adag(device, batch, **kw):
    """ADAG on the BN model (the reference test's run: global batch 64,
    window 2, 2 epochs, sgd at 0.05): ``(losses, tv, ntv)``."""
    x, y = bn_blobs()
    t = dkt.ADAG(bn_model(), loss="sparse_categorical_crossentropy",
                 worker_optimizer="sgd", learning_rate=0.05,
                 batch_size=batch, communication_window=2, num_epoch=2,
                 device=device, **kw)
    tv, ntv = dkt.keras_numpy_from_module(t.train(
        dkt.Dataset.from_arrays(x, y)))
    return np.array(t.history), tv, ntv


def sync_bn_rank(tmp):
    """One rank of the two-rank sync-BN check (gloo over CUDA tensors)."""
    import torch.distributed as dist

    dkt.deploy.init_from_env(device="cuda:0", backend="gloo", timeout=300)
    hist, tv, ntv = bn_adag("cuda:0", 32, num_workers=2)
    if dist.get_rank() == 0:
        np.savez(os.path.join(tmp, "sync_bn.npz"), history=hist,
                 **{f"w{i}": a for i, a in enumerate(tv + ntv)})
    dist.destroy_process_group()
    return 0


def keras_zoo_phase():
    """The paper's remaining workloads on the card: throughput of
    imdb_lstm (both LSTMs), resnet50 and the two MLPs at their bench
    configs, resnet50 under ADAG in a world-1 NCCL group against the run
    without a group (equal: one rank takes the local BN path; and timed
    at the bench config), the profiled windows, then parity with the CPU
    (f32 imdb_lstm both ways, resnet50 at 64 x 64 in float64 and f32)
    and the BN model's synchronized statistics over two gloo ranks
    sharing the card against world 1 at twice the batch."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    runs, deferred = {}, []
    x, y = lstm_data(8 * LSTM_BATCH, LSTM_BENCH["vocab_size"],
                     LSTM_BENCH["maxlen"])
    for fused in (True, False):
        name = "imdb_lstm" + ("" if fused else "_keras_lstm")
        runs[name] = zoo_throughput(
            name, dkt.zoo.imdb_lstm(**LSTM_BENCH, seed=0, fused=fused,
                                    policy="mixed_bfloat16"),
            x, y, "binary_crossentropy", LSTM_BATCH, profile_calls=2,
            deferred=deferred)
    model = dkt.zoo.resnet50(seed=0, policy="mixed_bfloat16")
    fwd = conv_flops(model, torch.zeros(1, 224, 224, 3))
    rx, ry = imagenet_like(6 * RESNET_BATCH)
    r = zoo_throughput("resnet50", model, rx, ry,
                       "sparse_categorical_crossentropy", RESNET_BATCH,
                       preprocess=to_unit, profile_calls=2,
                       deferred=deferred)
    step_flops = 3 * fwd * RESNET_BATCH
    r.update(forward_gflop_per_image=fwd / 1e9, step_tflop=step_flops / 1e12,
             flop_share_of_bf16_peak=step_flops / (r["step_ms"] / 1e3)
             / H100_BF16_FLOPS,
             bound_ms=1e3 * step_flops / H100_BF16_FLOPS)
    runs["resnet50"] = r
    del model

    # ResNet-50 under ADAG (window 1): without a group, then in a
    # world-1 NCCL group, where one rank normalizes with local
    # statistics and the exchange sums one gradient.  Equal to the run
    # without a group (deterministic cuDNN, 2 steps at 224 x 224, batch
    # 8), and the bench config timed in turn with the run without one.
    adag = dict(trainer=dkt.ADAG, communication_window=1)
    runs["resnet50_adag_no_group"] = zoo_throughput(
        "resnet50_adag_no_group",
        dkt.zoo.resnet50(seed=0, policy="mixed_bfloat16"), rx, ry,
        "sparse_categorical_crossentropy", RESNET_BATCH, preprocess=to_unit,
        **adag)
    build = lambda: dkt.zoo.resnet50(num_classes=1000,  # noqa: E731
                                     input_shape=(224, 224, 3), seed=22)
    gx, gy = imagenet_like(16, seed=6)
    one = dict(adag, learning_rate=0.01, preprocess=to_unit)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        plain = zoo_run(build, "cuda", gx, gy,
                        "sparse_categorical_crossentropy", 8, 2, **one)
        rdv = tempfile.mkdtemp()
        dkt.initialize_multihost(init_method=f"file://{rdv}/rdv",
                                 world_size=1, rank=0, timeout=120)
        try:
            if dist.get_backend() != "nccl":
                raise AssertionError("keras_zoo: not an NCCL group")
            grouped = zoo_run(build, "cuda", gx, gy,
                              "sparse_categorical_crossentropy", 8, 2, **one)
            torch.backends.cudnn.deterministic = prev
            runs["resnet50_adag_world1_nccl"] = zoo_throughput(
                "resnet50_adag_world1_nccl",
                dkt.zoo.resnet50(seed=0, policy="mixed_bfloat16"), rx, ry,
                "sparse_categorical_crossentropy", RESNET_BATCH,
                preprocess=to_unit, **adag)
        finally:
            dist.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic = prev
    nccl = dict(steps=len(grouped[0]),
                loss_max_abs_err=float(np.abs(grouped[0] - plain[0]).max()),
                weight_max_abs_err=max_gap(grouped[1], plain[1]),
                step_ms_group_over_no_group=(
                    runs["resnet50_adag_world1_nccl"]["step_ms"]
                    / runs["resnet50_adag_no_group"]["step_ms"]))
    if not (len(grouped[0]) == 2 and nccl["loss_max_abs_err"] <= 1e-6
            and nccl["weight_max_abs_err"] <= 1e-6):
        raise AssertionError(f"resnet50 in a world-1 NCCL group: {nccl}")
    del rx, ry
    torch.cuda.empty_cache()

    rng = np.random.default_rng(3)
    for name, shape, classes in (("mnist_mlp", (784,), 10),
                                 ("higgs_mlp", (28,), 2)):
        n = MLP_BATCH * 8 * 2
        x = rng.normal(0, 1, (n, *shape)).astype(np.float32)
        y = rng.integers(0, classes, n)
        runs[name] = zoo_throughput(
            name, dkt.zoo.ZOO[name](seed=0, policy="mixed_bfloat16"), x, y,
            "sparse_categorical_crossentropy", MLP_BATCH, steps_per_call=8,
            profile_calls=1, deferred=deferred)
    bench_s = time.perf_counter() - t0
    for profile in deferred:
        profile()
    del deferred

    parity = {f"imdb_lstm_fused_{f}": lstm_parity(f) for f in (True, False)}
    px, py = imagenet_like(32, seed=4, side=64)
    parity["resnet50_64x64"] = resnet_parity(px, py)

    # Synchronized BN: two gloo ranks on the card == world 1 at twice the
    # batch.
    tmp = tempfile.mkdtemp()
    dkt.deploy.Job("chip_smoke.py", world=2,
                   init_method=f"file://{tmp}/rdv_bn",
                   args=("--dp-rank", "sync_bn", tmp)).run_local(
        timeout=300, capture=True)
    got = np.load(os.path.join(tmp, "sync_bn.npz"))
    h1, tv, ntv = bn_adag("cuda", 64)
    w2 = [got[f"w{i}"] for i in range(len(tv) + len(ntv))]
    sync = dict(loss_max_abs_err=float(np.abs(got["history"] - h1).max()),
                weight_max_abs_err=max_gap(w2[:len(tv)], tv),
                moving_stat_max_abs_err=max_gap(w2[len(tv):], ntv))
    if not max(sync.values()) <= 1e-4:
        raise AssertionError(f"sync BN world 2 != world 1: {sync}")
    log("keras_zoo", policy="mixed_bfloat16", optimizer="sgd",
        learning_rate=0.01, runs=runs, bench_s=bench_s, parity=parity,
        parity_tol=PARITY_TOL, sync_bn_world2_vs_world1=sync,
        sync_bn_tol=1e-4, resnet50_world1_nccl_vs_no_group=nccl,
        seconds=time.perf_counter() - t0)


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


def next_logits(params, cfg, seq):
    """The next-token logits after ``seq`` (teacher-forced through
    ``apply``).  A comparison, so its kernel launches are not counted."""
    counts = dict(attn.LAUNCHES)
    with torch.no_grad():
        logits, _ = dkt.apply(params, torch.from_numpy(
            np.asarray(seq)[None]).cuda(), cfg)
    attn.LAUNCHES.update(counts)
    return logits[0, -1].float()


def top2_gap(params, cfg, seq):
    """The gap between the top two next-token logits after ``seq``, as a
    share of max |logit|."""
    row = next_logits(params, cfg, seq)
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


def engine_load(params, cfg, make=None, name="engine_load"):
    """(a) Open-loop load as bench_engine_load(8, 32.0): 48 requests,
    prompt 64, 128 new tokens, seeded exponential inter-arrivals at 32
    requests/s, step(4) windows, one warm-up request before the clock.
    TTFT and TPOT at p50 / p99, achieved tokens/s, peak memory, and a
    sample of 4 requests against batch-1 generate.  ``make`` builds the
    engine (``ContinuousBatcher(lanes=8)`` by default).  The allocator's
    reserved bytes and device-allocation count are read when the clock
    starts and when the load ends: they must not change (the port's
    counterpart of the reference's zero serve-phase compiles).  Returns
    the logged record."""
    rng = np.random.default_rng(0)
    arrivals = np.cumsum(rng.exponential(1.0 / LOAD_RPS, LOAD_REQUESTS))
    prompts = rng.integers(0, cfg.vocab_size,
                           (LOAD_REQUESTS, LOAD_PROMPT)).astype(np.int32)
    eng = (make or (lambda: dkt.ContinuousBatcher(params, cfg,
                                                  lanes=ENGINE_LANES)))()
    warm = [eng.submit(prompts[i], LOAD_NEW) for i in range(ENGINE_LANES)]
    run_engine(eng, warm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = (torch.cuda.memory_reserved(),
            torch.cuda.memory_stats()["num_device_alloc"])
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
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    mem1 = (torch.cuda.memory_reserved(),
            torch.cuda.memory_stats()["num_device_alloc"])
    if mem1 != mem0:
        raise AssertionError(f"{name}: the serve phase changed the "
                             f"allocator's (reserved bytes, device "
                             f"allocations) from {mem0} to {mem1}")
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
    rec = dict(engine=type(eng).__name__, lanes=ENGINE_LANES,
               requests=LOAD_REQUESTS, prompt=LOAD_PROMPT,
               new_tokens=LOAD_NEW, offered_rps=LOAD_RPS, step_window=4,
               windows=windows, makespan_s=makespan,
               tokens=int(n_tok.sum()),
               tokens_per_s=float(n_tok.sum()) / makespan,
               achieved_rps=LOAD_REQUESTS / makespan,
               ttft_p50_ms=pct(ttft, 50), ttft_p99_ms=pct(ttft, 99),
               tpot_p50_ms=pct(tpot, 50), tpot_p99_ms=pct(tpot, 99),
               peak_mem_gb=peak, reserved_bytes=mem1[0],
               device_allocs=mem1[1], allocator_constant=True,
               launches=launches, vs_generate=agreement_summary(agree),
               sample=list(sample))
    log(name, config=dataclasses.asdict(cfg), **rec)
    return rec


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


# Phase paged: scripts/bench_serving.py's paged rows over the flagship
# serving config, at its block (_paged_block(1025) = 41, :967: the
# largest divisor of max_len at or under max_len // 8).
PAGED_BLOCK = 41
PAGED_NEW = 64
STEM_TAIL, STEM_NEW = 16, 32


def paged_block_bytes(cfg):
    """K and V bytes of one slab block (bf16)."""
    return 2 * cfg.n_layers * PAGED_BLOCK * cfg.kv_heads * cfg.head_dim * 2


def paged_engine(params, cfg, lanes=ENGINE_LANES, device=None, **kw):
    return dkt.PagedBatcher(params, cfg, lanes=lanes, block=PAGED_BLOCK,
                            device=device, **kw)


def staggered(make, cfg, n_req=16, new=PAGED_NEW, seed=21):
    """(a)'s schedule: ``n_req`` greedy requests (prompts of 32-300
    tokens), two admitted before every step(4) window while a lane is
    free, drained as they finish (lanes reused).  The schedule depends
    on token counts only, so two engines run it identically.  Returns
    every request's tokens and the engine."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(32, 301, n_req)]
    eng = make()
    outs, lane_req, nxt = {}, {}, 0
    while len(outs) < n_req:
        for _ in range(2):
            if nxt < n_req and eng.free_lanes():
                lane_req[eng.submit(prompts[nxt], new)] = nxt
                nxt += 1
        eng.step(4)
        for lane, rid in list(lane_req.items()):
            if lane not in eng.running():
                outs[rid] = eng.drain(lane)
                del lane_req[lane]
    return [outs[i] for i in range(n_req)], eng


def equal_outs(a, b, what):
    for i, (x, y) in enumerate(zip(a, b)):
        if not np.array_equal(x, y):
            raise AssertionError(f"{what}: request {i} differs")


def serve_all(eng, prompts, new):
    """bench_paged_lanes / _shared_stem's loop: admit while a lane is
    free (a decline ends the round), step(), drain.  Returns the seconds,
    the measured peak of simultaneously decoding lanes, each request's
    first-token time (s from the start) and tokens."""
    n = len(prompts)
    done, nxt, lane_req, peak = 0, 0, {}, 0
    first, outs = [None] * n, [None] * n
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while done < n:
        while nxt < n and eng.free_lanes():
            lane = eng.submit(prompts[nxt], new)
            if lane is None:
                break
            lane_req[lane] = nxt
            nxt += 1
        peak = max(peak, len(eng.running()))
        out = eng.step()
        now = time.perf_counter() - t0
        for lane, toks in out.items():
            if toks and first[lane_req[lane]] is None:
                first[lane_req[lane]] = now
        for lane in [la for la in lane_req if la not in eng.running()]:
            outs[lane_req[lane]] = eng.drain(lane)
            del lane_req[lane]
            done += 1
    return time.perf_counter() - t0, peak, first, outs


def kv8_prefill_logit_delta(np_params, cfg, p_len=257, seed=23):
    """(e) in f32: the first decode step's logits after a prefill-BUILT
    int8 admission against the decode-built one (the reference's
    KV_INT8_PREFILL_LOGIT_TOL measurement, at full width).  A
    comparison: its prefill launches are not counted."""
    from distkeras_tpu_torch.models import generate as tgen
    from distkeras_tpu_torch.serving.paged import KV_INT8_PREFILL_LOGIT_TOL

    p32 = dkt.params_from_numpy(np_params, "cuda")
    prompt = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, p_len)).astype(np.int32)
    warm = torch.from_numpy(prompt[:, :-1]).long().cuda()
    w = warm.shape[1]
    with torch.no_grad():
        cache_d = tgen.init_cache(cfg, 1, kv_int8=True)
        tgen._decode_chunk(p32, cache_d, warm,
                           torch.zeros(1, dtype=torch.long, device="cuda"),
                           cfg, uniform_pos=True)
        cache_p, _ = expect_fwd(lambda: tgen.prefill(
            p32, warm, cfg, last_logits=False, kv_int8=True),
            cfg.n_layers, "kv_int8 prefill build", counted=False)
        pos = torch.full((1,), w, dtype=torch.long, device="cuda")
        last = torch.from_numpy(prompt[:, -1:]).long().cuda()
        lg_d = tgen._decode_chunk(p32, cache_d, last, pos, cfg)[0][0, 0]
        lg_p = tgen._decode_chunk(p32, cache_p, last, pos, cfg)[0][0, 0]
    delta = float((lg_d - lg_p).abs().max())
    top2 = lg_d.topk(2).values
    gap = float(top2[0] - top2[1])
    same = int(lg_d.argmax()) == int(lg_p.argmax())
    if not math.isfinite(delta) or delta <= 0.0:
        raise AssertionError(f"kv_int8 prefill logit delta {delta}")
    if not same and gap > delta:
        raise AssertionError("the prefill-built int8 cache changed the "
                             f"first token outside a near tie (gap {gap}, "
                             f"delta {delta})")
    del p32, cache_d, cache_p
    return dict(prompt=p_len, max_abs_logit_delta=delta,
                tol=KV_INT8_PREFILL_LOGIT_TOL,
                within_tol=delta < KV_INT8_PREFILL_LOGIT_TOL,
                max_abs_logit=float(lg_d.abs().max()), top2_gap=gap,
                argmax_equal=same)


def paged_phase(np_params):
    """Phase paged: PagedBatcher at the flagship width, bf16, seed-0
    weights.  (a) 16 staggered greedy requests: tokens equal
    ContinuousBatcher's, also with prefill_chunk=128, and an f32 2-layer
    copy on the card equals the CPU's; (b) bench_paged_lanes(2): 8 paged
    lanes on the slab of 4 monolithic lanes (the KV bytes within one
    block), the measured peak concurrency ratio >= 2, tokens/s of both;
    (c) bench_paged_shared_stem(8): 84 stem-hit blocks on a fresh engine,
    each request against its run on a fresh engine, TTFT and tokens/s
    against distinct stems; (d) a fork with the runner-up token copies
    one block, its tokens against a fresh engine's run of the forked
    transcript, no block leaked; (e) kv_int8="prefill": 8 forward
    launches per from-scratch admission (the path's launches), and the
    f32 first-step logit delta against the decode-built cache; (f, g)
    engine_load on the monolithic and the paged engine (tokens/s, TTFT,
    TPOT, the allocator constant over the serve phase).  Returns the
    forward kernel's launches on the paged path."""
    t0 = time.perf_counter()
    cfg = FLAGSHIP
    params = dkt.params_from_numpy(np_params, "cuda", dtype=torch.bfloat16)
    zero_launches()
    # (a)
    mono, _ = staggered(lambda: dkt.ContinuousBatcher(
        params, cfg, lanes=ENGINE_LANES), cfg)
    paged, eng = staggered(lambda: paged_engine(params, cfg), cfg)
    equal_outs(paged, mono, "paged vs monolithic")
    if eng.allocator.stats()["used"]:
        raise AssertionError(f"blocks leaked: {eng.allocator.stats()}")
    mono_c, _ = staggered(lambda: dkt.ContinuousBatcher(
        params, cfg, lanes=ENGINE_LANES, prefill_chunk=128), cfg)
    paged_c, _ = staggered(lambda: paged_engine(
        params, cfg, prefill_chunk=128), cfg)
    equal_outs(paged_c, mono_c, "paged vs monolithic, prefill_chunk=128")
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    two = draft_layers(np_params, 2)
    card32, _ = staggered(lambda: paged_engine(
        dkt.params_from_numpy(two, "cuda"), cfg32), cfg32, n_req=6, new=16)
    cpu32, _ = staggered(lambda: paged_engine(
        dkt.params_from_numpy(two, "cpu"), cfg32, device="cpu"), cfg32,
        n_req=6, new=16)
    equal_outs(card32, cpu32, "f32 paged, card vs cpu")
    rec = dict(parity=dict(requests=16, new_tokens=PAGED_NEW,
                           tokens_equal_monolithic=True,
                           chunked128_equal_monolithic=True,
                           f32_card_equal_cpu=dict(requests=6, equal=True)))
    # (b)
    mono_lanes, block = 4, PAGED_BLOCK
    mb = cfg.max_len // block
    budget = cfg.max_len // 2
    p_len, new = 32, cfg.max_len // 2 - 32 - block
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2 * mono_lanes, p_len)).astype(np.int32)
    peng = paged_engine(params, cfg, lanes=2 * mono_lanes,
                        n_blocks=mono_lanes * mb + 1,
                        prompt_buckets=(p_len - 1,))
    meng = dkt.ContinuousBatcher(params, cfg, lanes=mono_lanes,
                                 prompt_buckets=(p_len - 1,))
    kv_p = peng.memory_footprint()["kv_bytes"]
    kv_m = meng.memory_footprint()["kv_bytes"]
    if abs(kv_p - kv_m) > paged_block_bytes(cfg):
        raise AssertionError(f"KV bytes: paged {kv_p}, monolithic {kv_m}")
    dt_p, peak_p, _, outs_p = serve_all(peng, prompts, new)
    dt_m, peak_m, _, outs_m = serve_all(meng, prompts, new)
    ratio = peak_p / max(peak_m, 1)
    if ratio < 2:
        raise AssertionError(f"peak lanes paged {peak_p} / monolithic "
                             f"{peak_m} < 2 at equal KV bytes")
    total = 2 * mono_lanes * new
    rec["lanes"] = dict(
        mono_lanes=mono_lanes, paged_lanes=2 * mono_lanes, budget=budget,
        prompt=p_len, new_tokens=new, slab_blocks=mono_lanes * mb,
        kv_bytes_paged=kv_p, kv_bytes_mono=kv_m,
        block_bytes=paged_block_bytes(cfg), peak_lanes_paged=peak_p,
        peak_lanes_mono=peak_m, lanes_ratio=ratio,
        paged_tokens_per_s=total / dt_p, mono_tokens_per_s=total / dt_m,
        vs_monolithic=agreement_summary([
            greedy_agreement(a, b, params, cfg, p_len)
            for a, b in zip(outs_p, outs_m)]))
    del peng, meng
    # (c)
    stem_len = (cfg.max_len // 2 // block) * block
    rng = np.random.default_rng(0)
    stem = rng.integers(0, cfg.vocab_size, stem_len).astype(np.int32)
    tails = rng.integers(0, cfg.vocab_size, (8, STEM_TAIL)).astype(np.int32)
    alt = rng.integers(0, cfg.vocab_size, (8, stem_len)).astype(np.int32)
    shared_p = [np.concatenate([stem, t]) for t in tails]
    distinct_p = [np.concatenate([a, t]) for a, t in zip(alt, tails)]
    buckets = (STEM_TAIL, stem_len + STEM_TAIL)
    serve_all(paged_engine(params, cfg, prompt_buckets=buckets), shared_p,
              STEM_NEW)                    # warm-up, as the bench's
    seng = paged_engine(params, cfg, prompt_buckets=buckets)
    dt_s, _, first_s, outs_s = serve_all(seng, shared_p, STEM_NEW)
    hits = seng.stem_hit_blocks
    want_hits = 7 * ((stem_len + STEM_TAIL - 1) // block)
    if hits != want_hits:
        raise AssertionError(f"stem hits {hits}, expected {want_hits}")
    dt_d, _, first_d, _ = serve_all(seng, distinct_p, STEM_NEW)
    if seng.stem_hit_blocks != hits:
        raise AssertionError("distinct stems hit resident blocks")
    fresh = []
    for prompt, out in zip(shared_p, outs_s):
        one = paged_engine(params, cfg, lanes=1, prompt_buckets=buckets)
        ref = run_engine(one, [one.submit(prompt, STEM_NEW)], ())[0]
        fresh.append(greedy_agreement(out, ref, params, cfg, len(prompt)))
    rec["shared_stem"] = dict(
        requests=8, stem=stem_len, tail=STEM_TAIL, new_tokens=STEM_NEW,
        stem_hit_blocks=hits,
        first_token_ms_shared=[1e3 * f for f in first_s],
        first_token_ms_distinct=[1e3 * f for f in first_d],
        tokens_per_s_shared=8 * STEM_NEW / dt_s,
        tokens_per_s_distinct=8 * STEM_NEW / dt_d,
        vs_fresh_engine=agreement_summary(fresh))
    del seng
    # (d)
    feng = paged_engine(params, cfg)
    fprompt = np.random.default_rng(24).integers(
        0, cfg.vocab_size, 100).astype(np.int32)
    src = feng.submit(fprompt, PAGED_NEW)
    for _ in range(3):
        feng.step(4)
    st = feng._lane_state[src]
    alt_tok = int(next_logits(params, cfg,
                              st.tokens[:-1]).topk(2).indices[1])
    shared_n = (len(st.tokens) - 1) // block
    with dkt.obs.session() as sess:
        fork = feng.fork(src, token=alt_tok)
        forks = sess.registry.counter("serving.cow_forks").value()
    copied = len(feng._lane_blocks[fork]) - shared_n
    if (forks != 1 or copied != 1
            or feng._lane_blocks[fork][:shared_n]
            != feng._lane_blocks[src][:shared_n]):
        raise AssertionError(f"fork: {forks} forks, {copied} copied "
                             "blocks")
    transcript = list(feng._lane_state[fork].tokens)
    o_src, o_fork = run_engine(feng, [src, fork])
    if feng.allocator.stats()["used"]:
        raise AssertionError(f"fork leaked: {feng.allocator.stats()}")
    one = paged_engine(params, cfg, lanes=1)
    ref = run_engine(one, [one.submit(np.asarray(transcript, np.int32),
                                      PAGED_NEW - 12)])[0]
    rec["fork"] = dict(prompt=100, forked_at=len(transcript),
                       shared_blocks=shared_n, copied_blocks=copied,
                       cow_forks=forks, token=alt_tok, leaked_blocks=0,
                       vs_fresh_engine=agreement_summary([greedy_agreement(
                           o_fork, ref, params, cfg, len(transcript))]))
    del feng, one
    # (e): the path's launches.
    kprompts = np.random.default_rng(25).integers(
        0, cfg.vocab_size, (4, 100)).astype(np.int32)
    kv8 = {}
    for mode in (True, "prefill"):
        keng = paged_engine(params, cfg, kv_int8=mode)
        want = cfg.n_layers * len(kprompts) if mode == "prefill" else 0
        lanes = expect_fwd(lambda: [keng.submit(p, 32) for p in kprompts],
                           want, f"kv_int8={mode!r} admission")
        kv8[mode] = run_engine(keng, lanes)
    launches = dict(attn.LAUNCHES)
    rec["kv_int8_prefill"] = dict(
        requests=len(kprompts), prompt=100, new_tokens=32,
        launches=launches["flash_fwd"],
        launches_per_admission=cfg.n_layers,
        token_agreement_vs_decode_built=float(np.mean(
            [np.mean(a[100:] == b[100:])
             for a, b in zip(kv8[True], kv8["prefill"])])),
        f32=kv8_prefill_logit_delta(np_params, dataclasses.replace(
            cfg, dtype="float32")))
    expect_launches_paged = cfg.n_layers * len(kprompts)
    if launches["flash_fwd"] != expect_launches_paged:
        raise AssertionError(f"paged path launched {launches}")
    # (f, g)
    keys = ("tokens_per_s", "ttft_p50_ms", "ttft_p99_ms", "tpot_p50_ms",
            "tpot_p99_ms", "reserved_bytes", "device_allocs")
    for name, make in (("mono", None),
                       ("paged", lambda: paged_engine(params, cfg))):
        load = engine_load(params, cfg, make=make, name=f"paged_load_{name}")
        rec[f"load_{name}"] = {k: load[k] for k in keys}
    attn.LAUNCHES.update(launches)
    log("paged", config=dataclasses.asdict(cfg), block=PAGED_BLOCK,
        seconds=time.perf_counter() - t0, **rec)
    return launches


def paged_idle_share(params, cfg):
    """The paged engine's profiled steady window (4 step(4) calls over
    8 busy lanes): idle share, one device-to-host copy per step, and the
    gather and the scatter of one window timed alone (CUDA events) at
    the engine's shapes."""
    from distkeras_tpu_torch.serving.paged import _gather_view

    rng = np.random.default_rng(9)
    eng = paged_engine(params, cfg)
    lanes = [eng.submit(p, LOAD_NEW) for p in rng.integers(
        0, cfg.vocab_size, (ENGINE_LANES, LOAD_PROMPT)).astype(np.int32)]
    eng.step(4)
    idle, counts = profile_window(
        "paged_4x_step4", lambda: [eng.step(4) for _ in range(4)],
        count=("DtoH",))
    if counts["DtoH"] != 4:
        raise AssertionError(f"4 paged step(4) calls made "
                             f"{counts['DtoH']} device-to-host copies")
    tables, n = eng.tables, 4
    view = {k: _gather_view(a, tables) for k, a in eng.cache.items()}
    gather_ms = time_ms(lambda: {k: _gather_view(a, tables)
                                 for k, a in eng.cache.items()})
    q = torch.clamp(eng.pos[:, None] + torch.arange(n, device="cuda"),
                    max=cfg.max_len - 1)
    blk, off = tables.gather(1, q // PAGED_BLOCK), q % PAGED_BLOCK
    lane = torch.arange(eng.lanes, device="cuda")[:, None]

    def scatter():
        for k, a in eng.cache.items():
            a[:, blk, off] = view[k][:, lane, q]
    scatter_ms = time_ms(scatter)
    view_bytes = sum(v.numel() * v.element_size() for v in view.values())
    run_engine(eng, lanes)
    return dict(idle_share_4x_step4=idle, dtoh_copies_per_step=1.0,
                gather_ms_per_window=gather_ms,
                scatter_ms_per_window=scatter_ms,
                gather_bytes=2 * view_bytes,
                gather_bound_ms=2 * view_bytes / H100_HBM_BYTES * 1e3)


# Phase beam: bench_beam4 (scripts/bench_serving.py:265-330): batch 8,
# prompt 64, 256 new, width 4, over the flagship config and over its
# window-256 ring of 384 slots.
BEAM_BATCH, BEAM_PROMPT, BEAM_NEW, BEAM_WIDTH = 8, 64, 256, 4


def beam_lockstep(params, cfg, prompt, new, w, anc_out, phys_out):
    """Ancestry against physical beams in bf16, in the spirit of
    ``greedy_agreement``.  The two read the cache through different f32
    reductions, so their candidate scores differ by a little and a row's
    kept set may part where the top-W boundary is that close.  This runs
    ``beam_search``'s loop for both impls in lockstep from one prompt
    pass (it must end in the library's ``anc_out`` / ``phys_out`` beams
    exactly: the harness is the library's loop) and, at the first step
    where a row's kept hypotheses part, holds the physical run's gap
    between its weakest kept candidate and the strongest one it dropped
    that the ancestry run kept to twice the largest difference between
    the two runs' scores of the candidates either kept.  A comparison:
    its prefill launches are not counted.  Raises otherwise; returns the
    summary."""
    from distkeras_tpu_torch.models import generate as tgen

    b, p = prompt.shape
    pr = torch.from_numpy(prompt).long().cuda()
    counts = dict(attn.LAUNCHES)
    with torch.no_grad():
        cache, _ = tgen.prefill(params, pr, cfg, last_logits=False)
        attn.LAUNCHES.update(counts)
        logits, cache = tgen._decode_step(params, cache, pr[:, p - 1],
                                          p - 1, cfg)
        scores0, first = tgen._top_w(torch.log_softmax(logits, dim=-1), w)
        total = p + new
        rows = torch.arange(b, device="cuda")[:, None]
        lane_ids = torch.arange(w, device="cuda")
        st = {}
        for impl in ("ancestry", "physical"):
            buf = torch.zeros((b, w, total), dtype=torch.long, device="cuda")
            buf[:, :, :p] = pr[:, None]
            buf[:, :, p] = first
            st[impl] = dict(
                buf=buf, scores=scores0.clone(),
                cache={n: a.repeat_interleave(w, dim=1)
                       for n, a in cache.items()},
                anc=lane_ids[None, :, None].expand(b, w, cfg.max_len).clone())
        del cache
        parted = {}
        for q in range(p, total - 1):
            prefix = {impl: s["buf"][:, :, :q + 1].cpu().numpy()
                      for impl, s in st.items()}
            picks = {}
            for impl, s in st.items():
                lg, _ = tgen._decode_step(
                    params, s["cache"], s["buf"][:, :, q].reshape(b * w), q,
                    cfg, beam_anc=(s["anc"], w) if impl == "ancestry"
                    else None)
                cand = (s["scores"][:, :, None]
                        + torch.log_softmax(lg, dim=-1).reshape(b, w, -1))
                v = cand.shape[-1]
                sc, idx = tgen._top_w(cand.reshape(b, w * v), w)
                picks[impl] = (cand, idx.cpu().numpy())
                parent, token = idx // v, idx % v
                s["buf"] = s["buf"][rows, parent]
                s["buf"][:, :, q + 1] = token
                s["scores"] = sc
                if impl == "ancestry":
                    s["anc"] = s["anc"][rows, parent]
                    s["anc"][:, :, (q + 1) % cfg.max_len] = lane_ids
                else:
                    flat = (parent + rows * w).reshape(b * w)
                    s["cache"] = {n: a.index_select(1, flat)
                                  for n, a in s["cache"].items()}
            (ca, ia), (cp, ip) = picks["ancestry"], picks["physical"]
            for r in range(b):
                if r in parted:
                    continue
                # Physical slot of each ancestry slot (same hypotheses,
                # possibly in another order after an earlier tie).
                where = {tuple(x): j for j, x in
                         enumerate(prefix["physical"][r])}
                perm = [where[tuple(x)] for x in prefix["ancestry"][r]]
                ka = {(int(i) // v, int(i) % v) for i in ia[r]}
                kp = {(perm.index(int(i) // v), int(i) % v) for i in ip[r]}
                if ka == kp:
                    continue
                a_r = ca[r].float().cpu().numpy()
                p_r = cp[r].float().cpu().numpy()[perm]
                both = ka | kp
                delta = max(abs(a_r[k] - p_r[k]) for k in both)
                gap = (min(p_r[k] for k in kp)
                       - max(p_r[k] for k in ka - kp))
                if not gap <= 2 * delta + 1e-6:
                    raise AssertionError(
                        f"ancestry and physical beams part in row {r} at "
                        f"generated step {q - p + 1} where the physical "
                        f"gap {gap:.5f} exceeds twice the runs' score "
                        f"difference {delta:.5f}: not a near tie")
                parted[r] = {"step": q - p + 1, "gap": float(gap),
                             "score_delta": float(delta)}
    for impl, (seqs, scores) in (("ancestry", anc_out),
                                 ("physical", phys_out)):
        if not (torch.equal(st[impl]["buf"].to(torch.int32), seqs)
                and torch.equal(st[impl]["scores"], scores)):
            raise AssertionError(f"the lockstep {impl} run is not "
                                 "beam_search's")
    sa, sp = anc_out[1].float().cpu().numpy(), phys_out[1].float().cpu(
        ).numpy()
    return dict(rows=b, rows_equal=int(sum(
        np.array_equal(x, y) for x, y in zip(anc_out[0].cpu().numpy(),
                                             phys_out[0].cpu().numpy()))),
        rows_kept_sets_never_parted=b - len(parted),
        near_tie_partings=[parted[r] for r in sorted(parted)],
        score_max_rel_diff=float(np.abs(sa - sp).max() / np.abs(sp).max()))


def beam_step_peak_bytes(params, cfg, w=BEAM_WIDTH, b=BEAM_BATCH):
    """Peak bytes above the live set of one beam step at the bench shape
    (the tiled cache, one token per lane): ancestry and physical."""
    from distkeras_tpu_torch.models import generate as tgen

    cache = tgen.init_cache(cfg, b * w)
    anc = torch.zeros((b, w, cfg.max_len), dtype=torch.long, device="cuda")
    tok = torch.zeros(b * w, dtype=torch.long, device="cuda")
    parent = torch.arange(b * w, device="cuda")
    out = {}
    for impl in ("ancestry", "physical"):
        with torch.no_grad():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            tgen._decode_step(params, cache, tok, BEAM_PROMPT, cfg,
                              beam_anc=(anc, w) if impl == "ancestry"
                              else None)
            if impl == "physical":
                cache = {k: a.index_select(1, parent)
                         for k, a in cache.items()}
            torch.cuda.synchronize()
            out[impl] = torch.cuda.max_memory_allocated() - base
    del cache
    return out


def beam_phase(np_params):
    """Phase beam: beam_search at the flagship width, bf16.  (a)
    bench_beam4 with beam_impl "auto" (ancestry) and "physical"
    (agreement: beam_lockstep), the ancestry score bytes and one step's
    peak bytes; (b) the same on the window-256 ring config (max_len
    384); (c) an f32 2-layer copy: the card's beams equal the CPU's
    (scores to 1e-5), width 1 == greedy generate, the prefill prompt pass
    == the sequential one; (d) ms per beam step, kept tokens/s (batch x
    new).  Each call's prefill launches the forward kernel once a layer.
    Returns the path's launches."""
    from distkeras_tpu_torch.models import generate as tgen

    t0 = time.perf_counter()
    cfg = FLAGSHIP
    ring = dataclasses.replace(cfg, attention_window=256, max_len=384)
    params = dkt.params_from_numpy(np_params, "cuda", dtype=torch.bfloat16)
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BEAM_BATCH, BEAM_PROMPT)).astype(np.int32)
    rec = {}
    expect_fwd(lambda: tgen.beam_search(params, prompt, cfg, 4,
                                        beam_width=BEAM_WIDTH),
               cfg.n_layers, "beam warm-up", counted=False)
    zero_launches()
    for name, c in (("full", cfg), ("ring256", ring)):
        runs = {}
        for impl in ("auto", "physical"):
            out, dt = wall_s(lambda: tgen.beam_search(
                params, prompt, c, BEAM_NEW, beam_width=BEAM_WIDTH,
                beam_impl=impl))
            runs[impl] = (out, dt)
            if tuple(out[0].shape) != (BEAM_BATCH, BEAM_WIDTH,
                                       BEAM_PROMPT + BEAM_NEW) or not \
                    torch.isfinite(out[1]).all():
                raise AssertionError(f"beam {name}/{impl}: bad output")
        rec[name] = dict(
            config=dict(max_len=c.max_len, window=c.attention_window),
            ancestry_score_bytes=tgen._ancestry_score_bytes(
                BEAM_BATCH, BEAM_WIDTH, c),
            agreement=beam_lockstep(params, c, prompt, BEAM_NEW,
                                    BEAM_WIDTH, runs["auto"][0],
                                    runs["physical"][0]),
            **{impl: dict(seconds=dt, ms_per_step=1e3 * dt / BEAM_NEW,
                          tokens_per_s=BEAM_BATCH * BEAM_NEW / dt)
               for impl, (_, dt) in runs.items()})
    launches = dict(attn.LAUNCHES)
    if launches != {"flash_fwd": 4 * cfg.n_layers, "flash_bwd_dq": 0,
                    "flash_bwd_dkv": 0}:
        raise AssertionError(f"beam path launched {launches}")
    rec["step_peak_bytes"] = beam_step_peak_bytes(params, cfg)
    # (c)
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    two = draft_layers(np_params, 2)
    card32 = dkt.params_from_numpy(two, "cuda")
    cpu32 = dkt.params_from_numpy(two, "cpu")
    kw = dict(beam_width=BEAM_WIDTH, eos_token=7)
    card = {}
    for impl in ("ancestry", "physical"):
        card[impl] = s, sc = expect_fwd(lambda: tgen.beam_search(
            card32, prompt, cfg32, 16, beam_impl=impl, **kw),
            cfg32.n_layers, "f32 beam", counted=False)
        cs, csc = tgen.beam_search(cpu32, prompt, cfg32, 16, beam_impl=impl,
                                   device="cpu", **kw)
        if not torch.equal(s.cpu(), cs):
            raise AssertionError(f"f32 beams ({impl}): card != cpu")
        torch.testing.assert_close(sc.cpu(), csc, atol=1e-5, rtol=1e-5)
    s, sc = card["ancestry"]
    s1, _ = expect_fwd(lambda: tgen.beam_search(card32, prompt, cfg32, 16,
                                                beam_width=1),
                       cfg32.n_layers, "f32 width 1", counted=False)
    g = expect_fwd(lambda: dkt.generate(card32, prompt, cfg32, 16),
                   cfg32.n_layers, "f32 greedy", counted=False)
    if not torch.equal(s1[:, 0], g):
        raise AssertionError("f32 beam width 1 != greedy generate")
    sp, scp = tgen.beam_search(card32, prompt, cfg32, 16,
                               use_prefill=False, **kw)
    if not torch.equal(sp, s):
        raise AssertionError("f32 beams: prefill != sequential prompt pass")
    torch.testing.assert_close(scp, sc, atol=1e-4, rtol=1e-5)
    attn.LAUNCHES.update(launches)
    rec["f32_2layer"] = dict(card_equal_cpu=True, score_tol=1e-5,
                             width1_equal_greedy=True,
                             prefill_equal_sequential=True,
                             prefill_vs_sequential_score_tol=1e-4)
    log("beam", batch=BEAM_BATCH, prompt=BEAM_PROMPT, new_tokens=BEAM_NEW,
        beam_width=BEAM_WIDTH, launches=launches,
        seconds=time.perf_counter() - t0, **rec)
    return launches


def beam_idle_share(params, cfg):
    from distkeras_tpu_torch.models import generate as tgen

    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BEAM_BATCH, BEAM_PROMPT)).astype(np.int32)
    return profile_window("beam_16_steps", lambda: tgen.beam_search(
        params, prompt, cfg, 16, beam_width=BEAM_WIDTH))


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
    if mode == "sync_bn":
        return sync_bn_rank(tmp)
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


# Phases fleet and weight_push: the serving fleet at the flagship
# serving width.  The traffic of (a) is bench_paged_shared_stem(8)
# (scripts/bench_serving.py:1059) times four stems.
FLEET_STEMS, FLEET_PER_STEM = 4, 8
FLEET_STEM = 12 * PAGED_BLOCK          # 492 tokens: 12 full blocks
FLEET_LANES = 8
FLEET_KILL_REQUESTS = 8
# The canary gate of weight_push (e): a finite logit-drift budget for the
# trained versions; the gate test then tightens it to GATE_MARGIN times
# the largest promoted drift and pushes a candidate whose embedding is
# scaled by GATE_SCALE (its logits move by many times their size).
PUSH_MAX_DRIFT = 50.0
GATE_MARGIN, GATE_SCALE = 4.0, 16.0
PUSH_PROMPTS = 4
# A wave of the fleet phase (at most 32 requests of 32 tokens) takes a
# few seconds on the card; one that is not done in this many has failed.
FLEET_WAVE_S = 120.0


def fleet_prompts(cfg, seed, stems=FLEET_STEMS, per_stem=FLEET_PER_STEM):
    """``stems`` stems of FLEET_STEM tokens, each with ``per_stem``
    16-token tails; returned stem-major as (stem index, prompt)."""
    rng = np.random.default_rng(seed)
    heads = rng.integers(0, cfg.vocab_size, (stems, FLEET_STEM)).astype(
        np.int32)
    tails = rng.integers(0, cfg.vocab_size,
                         (stems, per_stem, STEM_TAIL)).astype(np.int32)
    return heads, [(s, np.concatenate([heads[s], tails[s, j]]))
                   for s in range(stems) for j in range(per_stem)]


def fleet_engine(params, cfg, **kw):
    import warnings

    kw.setdefault("max_queue", 4 * FLEET_LANES)
    with warnings.catch_warnings():
        # kv_int8 below 16 lanes: the advisory is about speed, and these
        # engines are sized for the comparison.
        warnings.simplefilter("ignore", RuntimeWarning)
        return paged_engine(params, cfg, lanes=FLEET_LANES, **kw)


class StrictReplica(dkt.serving.InProcessReplica):
    """An in-process replica whose engine faults surface.  ``Router.step``
    swallows a replica's step exception (health probing's to report, as
    in the reference), so the first fault is kept here and
    :func:`strict_step` raises it."""

    fault = None

    def step(self):
        try:
            super().step()
        except Exception as e:
            self.fault = self.fault or e
            raise


def strict_step(router):
    """``router.step`` that raises the first engine fault of any
    :class:`StrictReplica` it stepped."""
    def step():
        router.step()
        for name, h in router.replica_handles().items():
            if getattr(h, "fault", None) is not None:
                raise RuntimeError(
                    f"replica {name}: its engine's step failed") from h.fault
    return step


def drive_waves(submit, step, partial, waves, new, timeout=FLEET_WAVE_S):
    """Submit each wave at once, then step until every request of it is
    done; record each request's first-token time from its submission.
    ``submit(prompt) -> id``, ``partial(id) -> RequestResult | None``.
    A wave not done within ``timeout`` seconds raises.  Returns (results
    by id, TTFT seconds by id, wall seconds)."""
    results, ttft = {}, {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for wave in waves:
        born = {}
        for prompt in wave:
            born[submit(prompt)] = (time.perf_counter(), len(prompt))
        live = set(born)
        deadline = time.monotonic() + timeout
        while live:
            if time.monotonic() > deadline:
                raise AssertionError(f"requests not done within {timeout} "
                                     f"s: {sorted(live)}")
            step()
            now = time.perf_counter()
            for rid in list(live):
                res = partial(rid)
                if res is None:
                    continue
                if rid not in ttft and len(res.tokens) > born[rid][1]:
                    ttft[rid] = now - born[rid][0]
                if res.status not in ("queued", "decoding"):
                    results[rid] = res
                    live.discard(rid)
    torch.cuda.synchronize()
    return results, ttft, time.perf_counter() - t0


def pct_ms(values, q):
    return float(np.percentile(np.asarray(list(values)), q)) * 1e3


def router_partial(router):
    """A routed request's live transcript: its terminal result once the
    router holds it, else the serving replica's (``Router.stream``'s
    read, one poll)."""
    def partial(rid):
        if router.poll(rid) is not None:
            return router.take(rid)
        req = router._requests.get(rid)
        if req is None or req.replica is None:
            return None
        return router.replica_handles()[req.replica].partial(
            req.replica_rid)
    return partial


def fleet_affinity(params, cfg):
    """(a) Two InProcessReplica(PagedBatcher(lanes=8)) under
    Router(policy="affinity"), 32 requests in 4 waves of 2 requests per
    stem; the same waves through one PagedBatcher.  Every request ends
    ok, tokens agree with the lone engine's (greedy_agreement), and
    every request of a stem after its first goes to the replica that
    holds the stem."""
    heads, reqs = fleet_prompts(cfg, seed=31)
    order = [reqs[s * FLEET_PER_STEM + w * 2 + j] for w in range(4)
             for s in range(FLEET_STEMS) for j in range(2)]
    waves = [[p for _, p in order[8 * w:8 * (w + 1)]] for w in range(4)]
    stem_of = [s for s, _ in order]
    buckets = (STEM_TAIL, FLEET_STEM + STEM_TAIL)
    warm = fleet_engine(params, cfg, prompt_buckets=buckets)
    drive_waves(lambda p: warm.enqueue(p, STEM_NEW), warm.step,
                warm.partial, waves[:1], STEM_NEW)
    del warm
    # The lone engine.
    lone = fleet_engine(params, cfg, prompt_buckets=buckets)
    res_l, ttft_l, dt_l = drive_waves(
        lambda p: lone.enqueue(p, STEM_NEW), lone.step, lone.partial,
        waves, STEM_NEW)
    lone_out = [np.asarray(res_l[r].tokens) for r in sorted(res_l)]
    # The router.
    engines = [fleet_engine(params, cfg, prompt_buckets=buckets)
               for _ in range(2)]
    router = dkt.serving.Router([StrictReplica(f"r{i}", e)
                                 for i, e in enumerate(engines)],
                                policy="affinity")
    placed = []

    def submit(prompt):
        rid = router.enqueue(prompt, STEM_NEW)
        placed.append(router._requests[rid].replica)
        return rid

    with dkt.obs.session() as sess:
        res_r, ttft_r, dt_r = drive_waves(submit, strict_step(router),
                                          router_partial(router), waves,
                                          STEM_NEW)
        hits = sess.registry.counter("router.affinity_hits").value()
    if not all(r.ok for r in res_r.values()) or len(res_r) != 32:
        raise AssertionError("fleet (a): a routed request did not end ok")
    holder = {}
    for s, rep in zip(stem_of, placed):
        holder.setdefault(s, rep)
        if rep != holder[s]:
            raise AssertionError(f"fleet (a): stem {s} went to {rep} after "
                                 f"it was resident on {holder[s]}")
    routed_out = [np.asarray(res_r[r].tokens) for r in sorted(res_r)]
    agree = [greedy_agreement(a, b, params, cfg, len(order[i][1]))
             for i, (a, b) in enumerate(zip(routed_out, lone_out))]
    if router.shutdown() != {} or any(e.allocator.stats()["used"]
                                      for e in engines):
        raise AssertionError("fleet (a): shutdown left work or blocks")
    n_tok = 32 * STEM_NEW
    return dict(
        replicas=2, lanes=FLEET_LANES, stems=FLEET_STEMS, stem=FLEET_STEM,
        tail=STEM_TAIL, new_tokens=STEM_NEW, requests=32, waves=4,
        affinity_hits=hits, holders=holder,
        requests_by_replica={n: placed.count(n) for n in ("r0", "r1")},
        stem_hit_blocks=[e.stem_hit_blocks for e in engines],
        lone_stem_hit_blocks=lone.stem_hit_blocks,
        routed=dict(tokens_per_s=n_tok / dt_r,
                    ttft_p50_ms=pct_ms(ttft_r.values(), 50),
                    ttft_p99_ms=pct_ms(ttft_r.values(), 99)),
        lone=dict(tokens_per_s=n_tok / dt_l,
                  ttft_p50_ms=pct_ms(ttft_l.values(), 50),
                  ttft_p99_ms=pct_ms(ttft_l.values(), 99)),
        vs_lone_engine=agreement_summary(agree))


class WireReplica(StrictReplica):
    """An in-process decode replica whose imports cross the wire codec
    (``encode_shipment`` -> bytes -> ``decode_shipment``), as an HTTP hop
    would carry them, timing each leg."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.legs = []

    def import_blocks(self, shipment):
        from distkeras_tpu_torch.serving import (decode_shipment,
                                                 encode_shipment)

        t0 = time.perf_counter()
        data = encode_shipment(shipment)
        back = decode_shipment(data)
        t1 = time.perf_counter()
        out = self.engine.import_blocks(back)
        torch.cuda.synchronize()
        self.legs.append(dict(bytes=len(data), payload=shipment.nbytes,
                              codec_ms=1e3 * (t1 - t0),
                              import_ms=1e3 * (time.perf_counter() - t1)))
        return out


class TimedPrefill(StrictReplica):
    """The prefill replica, timing each export (synchronous: the host
    copy is complete when it returns)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.export_ms = []

    def prefill_blocks(self, prompt):
        t0 = time.perf_counter()
        ship = super().prefill_blocks(prompt)
        self.export_ms.append(1e3 * (time.perf_counter() - t0))
        return ship


def pinned_solo(params, cfg, heads, prompts, new):
    """The disaggregated run's reference: one PagedBatcher(kv_int8=
    "prefill") that first pins every stem (the same kernel at the same
    shapes as the prefill replica's export), then serves the requests
    one wave at a time.  A comparison: its launches are not counted."""
    def run():
        eng = fleet_engine(params, cfg, kv_int8="prefill")
        for h in heads:
            eng.pin_prefix(h)
        res, _, _ = drive_waves(lambda p: eng.enqueue(p, new), eng.step,
                                eng.partial, [prompts], new)
        return [np.asarray(res[r].tokens) for r in sorted(res)]
    return expect_fwd(run, cfg.n_layers * len(heads), "pinned solo",
                      counted=False)


def fleet_disagg(params, cfg, trace):
    """(b) A role="prefill" and a role="decode" PagedBatcher(kv_int8=
    "prefill") under one Router: each cold stem exported on the prefill
    replica (the forward kernel), through the wire codec, imported on
    the decode replica.  Tokens equal the pinned solo engine's exactly;
    a second wave on the same stems ships nothing; a prefill replica
    whose export raises falls back to the raw prompt (every request ok,
    tokens equal a solo engine's cold admission); both allocators hold
    zero used blocks after shutdown.  Returns (record, tokens)."""
    heads, reqs = fleet_prompts(cfg, seed=32, per_stem=2)
    first = [p for s, p in reqs[0::2]]
    second = [p for s, p in reqs[1::2]]
    pre_e = fleet_engine(params, cfg, kv_int8="prefill")
    dec_e = fleet_engine(params, cfg, kv_int8="prefill")
    pre = TimedPrefill("pre", pre_e, role="prefill")
    dec = WireReplica("dec", dec_e, role="decode")
    router = dkt.serving.Router([pre, dec])
    router.refresh_residency()
    with dkt.obs.session(trace_path=trace) as sess:
        cold_ttft = {}
        res1, ttft1, _ = drive_waves(
            lambda p: router.enqueue(p, STEM_NEW), strict_step(router),
            router_partial(router), [first], STEM_NEW)
        shipped = count_series(sess, "router.disagg_requests")
        res2, _, _ = drive_waves(
            lambda p: router.enqueue(p, STEM_NEW), strict_step(router),
            router_partial(router), [second], STEM_NEW)
        counters = {n: count_series(sess, n) for n in (
            "router.disagg_requests", "router.disagg_warm_skips",
            "router.disagg_fallbacks", "serving.disagg.blocks_out",
            "serving.disagg.blocks_in", "serving.disagg.adopt_hits",
            "serving.disagg.bytes_out", "serving.disagg.bytes_in",
            "router.transfer_bytes")}
    launches = dict(attn.LAUNCHES)
    want = cfg.n_layers * FLEET_STEMS
    if launches["flash_fwd"] != want:
        raise AssertionError(f"fleet (b): exports launched {launches}, "
                             f"expected {want} forward launches")
    if shipped != FLEET_STEMS or \
            counters["router.disagg_requests"] != FLEET_STEMS:
        raise AssertionError(f"fleet (b): the second wave shipped "
                             f"({counters})")
    got = ([np.asarray(res1[r].tokens) for r in sorted(res1)]
           + [np.asarray(res2[r].tokens) for r in sorted(res2)])
    ref = (pinned_solo(params, cfg, heads, first, STEM_NEW)
           + pinned_solo(params, cfg, heads, second, STEM_NEW))
    equal_outs(got, ref, "fleet (b): disaggregated vs pinned solo")
    # The prefill replica dies mid-build: the raw prompt is routed.
    fheads, freqs = fleet_prompts(cfg, seed=33, stems=2, per_stem=1)
    fprompts = [p for _, p in freqs]

    def boom(tokens):
        raise RuntimeError("prefill replica died mid-build")

    pre_e.export_blocks = boom
    with dkt.obs.session() as sess:
        res3, ttft3, _ = drive_waves(
            lambda p: router.enqueue(p, STEM_NEW), strict_step(router),
            router_partial(router), [fprompts], STEM_NEW)
        fallbacks = count_series(sess, "router.disagg_fallbacks")
    del pre_e.export_blocks
    if fallbacks != len(fprompts) or not all(r.ok for r in res3.values()):
        raise AssertionError(f"fleet (b): fallback {fallbacks}, "
                             f"{[r.status for r in res3.values()]}")
    fell_back = attn.LAUNCHES["flash_fwd"] - launches["flash_fwd"]
    cold = fleet_engine(params, cfg, kv_int8="prefill")
    cres, cttft, _ = expect_fwd(lambda: drive_waves(
        lambda p: cold.enqueue(p, STEM_NEW), cold.step, cold.partial,
        [fprompts], STEM_NEW), cfg.n_layers * len(fprompts),
        "cold solo admissions", counted=False)
    equal_outs([np.asarray(res3[r].tokens) for r in sorted(res3)],
               [np.asarray(cres[r].tokens) for r in sorted(cres)],
               "fleet (b): fallback vs cold solo")
    if router.shutdown() != {}:
        raise AssertionError("fleet (b): shutdown left results")
    used = [e.allocator.stats()["used"] for e in (pre_e, dec_e)]
    if any(used):
        raise AssertionError(f"fleet (b): blocks in use after shutdown "
                             f"{used}")
    legs = dec.legs
    rec = dict(
        stems=FLEET_STEMS, stem=FLEET_STEM, new_tokens=STEM_NEW,
        requests=len(first) + len(second), counters=counters,
        fallback=dict(requests=len(fprompts), fallbacks=fallbacks,
                      forward_launches=fell_back,
                      tokens_equal_cold_solo=True),
        tokens_equal_pinned_solo=True,
        bytes_per_stem=[g["payload"] for g in legs],
        wire_bytes_per_stem=[g["bytes"] for g in legs],
        export_ms=pre.export_ms, codec_ms=[g["codec_ms"] for g in legs],
        import_ms=[g["import_ms"] for g in legs],
        first_token_ms_shipped=[1e3 * ttft1[r] for r in sorted(ttft1)],
        first_token_ms_cold_local=[1e3 * cttft[r] for r in sorted(cttft)],
        allocator_used_after_shutdown=used)
    return rec, got, (heads, first + second), launches["flash_fwd"] \
        + fell_back


def count_series(sess, name):
    doc = sess.registry.snapshot().get(name)
    return sum(s["value"] for s in doc["series"]) if doc else 0.0


def replica_main(spec_path):
    """One replica process of fleet (c): an EngineEndpoint over a
    PagedBatcher(kv_int8="prefill") on the card at the flagship width
    (seed-0 weights), with a telemetry session federated under the
    coordination directory.  Serves until SIGTERM, then prints its
    kernel launches on one line."""
    import signal
    import threading

    spec = json.load(open(spec_path))
    os.environ["DKT_CLUSTER_DIR"] = spec["coord"]
    os.environ["DKT_CLUSTER_HOST"] = str(spec["host"])
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    cfg = FLAGSHIP
    params = dkt.params_from_numpy(numpy_params(cfg, seed=0), "cuda",
                                   dtype=torch.bfloat16)
    eng = fleet_engine(params, cfg, kv_int8="prefill")
    # Warm every path the fleet drives before the address is published (a
    # fresh process's first kernel loads and cuBLAS set-up would outlast
    # the router's control-plane timeout): an export, an import, an
    # admission on the imported stem, and a cold admission.
    rng = np.random.default_rng(1000 + spec["host"])
    warm = rng.integers(0, cfg.vocab_size, (2, FLEET_STEM + STEM_TAIL))
    other = fleet_engine(params, cfg, kv_int8="prefill")
    pin = eng.import_blocks(other.export_blocks(warm[0]))
    del other
    rids = [eng.enqueue(p, 4) for p in warm]
    while any(eng.poll(r) is None for r in rids):
        eng.step()
    eng.unpin_prefix(pin["prefix_id"])
    torch.cuda.synchronize()
    zero_launches()
    with dkt.obs.session(serve_port=0):
        ep = dkt.serving.EngineEndpoint(eng, role=spec["role"])
        ep.start(step=True)
        try:
            while not stop.wait(0.1):
                pass
        finally:
            ep.stop()
    print(json.dumps({"replica": spec["host"], "role": spec["role"],
                      "launches": dict(attn.LAUNCHES)}), flush=True)
    return 0


def scrape_cluster(url):
    """``/metrics/cluster``: {host: up} and the hosts that carry any
    series besides cluster_scrape_up."""
    import urllib.request

    with urllib.request.urlopen(url + "/metrics/cluster",
                                timeout=30) as resp:
        text = resp.read().decode()
    up, hosts = {}, set()
    for line in text.splitlines():
        m = re.match(r'^(\w+)\{(.*)\} (\S+)$', line)
        if not m:
            continue
        host = re.search(r'host="(\d+)"', m.group(2))
        if host is None:
            continue
        if m.group(1) == "cluster_scrape_up":
            up[host.group(1)] = float(m.group(3))
        else:
            hosts.add(host.group(1))
    return up, hosts


def fleet_processes(cfg, disagg_tokens, disagg_prompts, tmp):
    """(c) Three replica processes (``--replica SPEC``: one prefill, two
    decode) on the card, found by discover_replicas; (b)'s traffic over
    POST /prefill and POST /blocks (tokens equal (b)'s), then one decode
    replica SIGKILLed mid-stream: every accepted request ends ok on the
    survivor, none lost or finished twice, and the parent's
    /metrics/cluster drops the dead host."""
    import signal
    import urllib.request

    coord = os.path.join(tmp, "coord")
    os.makedirs(coord)
    roles = ["prefill", "decode", "decode"]
    procs = []
    t0 = time.perf_counter()
    try:
        for host, role in enumerate(roles):
            spec = os.path.join(tmp, f"replica{host}.json")
            with open(spec, "w") as f:
                json.dump({"coord": coord, "host": host, "role": role}, f)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--replica",
                 spec], stdout=subprocess.PIPE,
                stderr=open(os.path.join(tmp, f"replica{host}.err"), "w"),
                text=True))
        deadline = time.monotonic() + 300
        while True:
            found = dkt.serving.discover_replicas(coord, timeout=2.0)
            if len(found) == 3 and all(r.healthy() for r in found):
                break
            for p in procs:
                if p.poll() is not None:
                    raise AssertionError(f"fleet (c): a replica exited "
                                         f"with {p.returncode}")
            if time.monotonic() > deadline:
                raise AssertionError("fleet (c): replicas did not come up")
            time.sleep(0.5)
        up_s = time.perf_counter() - t0
        old = {k: os.environ.get(k) for k in ("DKT_CLUSTER_DIR",
                                              "DKT_CLUSTER_HOST")}
        os.environ["DKT_CLUSTER_DIR"] = coord
        os.environ["DKT_CLUSTER_HOST"] = "3"
        try:
            with dkt.obs.session(serve_port=0) as sess:
                rec = fleet_over_http(found, disagg_tokens, disagg_prompts,
                                      procs, sess)
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        rec["replicas_up_s"] = up_s
        lines = []
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            out, _ = p.communicate(timeout=60)
            lines += [ln for ln in out.splitlines() if ln.startswith("{")]
        rec["replica_lines"] = [json.loads(ln) for ln in lines]
        for ln in rec["replica_lines"]:
            print(json.dumps({"phase": "fleet_replica", **ln}), flush=True)
        return rec
    except BaseException:
        for host in range(len(procs)):
            err = os.path.join(tmp, f"replica{host}.err")
            if os.path.exists(err):
                with open(err) as f:
                    print(f"replica {host} stderr:", f.read()[-3000:],
                          file=sys.stderr, flush=True)
        raise
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


def fleet_over_http(found, disagg_tokens, disagg_prompts, procs, sess):
    heads, prompts = disagg_prompts
    url = sess.server.url
    for r in found:
        r.timeout = 5.0             # a killed replica refuses at once
        r.transfer_timeout = 60.0
    router = dkt.serving.Router(found, health_interval=0.2)
    router.refresh_residency()
    t0 = time.perf_counter()
    rids = [router.enqueue(p, STEM_NEW) for p in prompts[:FLEET_STEMS]]
    rids += [router.enqueue(p, STEM_NEW) for p in prompts[FLEET_STEMS:]]
    results = pump_until(router, rids, 300)
    dt = time.perf_counter() - t0
    got = [np.asarray(results[r].tokens) for r in rids]
    equal_outs(got, disagg_tokens, "fleet (c): HTTP replicas vs (b)")
    up0, hosts0 = scrape_cluster(url)
    if up0 != {"0": 1.0, "1": 1.0, "2": 1.0, "3": 1.0}:
        raise AssertionError(f"fleet (c): cluster scrape {up0}")
    # Kill one decode replica mid-stream.
    kheads, kreqs = fleet_prompts(FLAGSHIP, seed=34, stems=2,
                                  per_stem=FLEET_KILL_REQUESTS // 2)
    krids = [router.enqueue(p, 2 * STEM_NEW) for _, p in kreqs]
    on = {}
    victim = None
    deadline = time.monotonic() + 120
    while victim is None:
        router.pump()
        for rid in krids:
            req = router._requests.get(rid)
            if req is None or req.replica in (None, "host0"):
                continue
            part = router.replica_handles()[req.replica].partial(
                req.replica_rid)
            if part is not None and len(part.tokens) > len(kreqs[0][1]):
                victim = req.replica
                break
        if time.monotonic() > deadline:
            raise AssertionError("fleet (c): no request started decoding")
        time.sleep(0.01)
    for rid in krids:
        req = router._requests.get(rid)
        if req is not None:
            on[rid] = req.replica
    vhost = int(victim.removeprefix("host"))
    procs[vhost].kill()
    procs[vhost].wait(timeout=30)
    t_kill = time.perf_counter()
    reroutes0 = count_series(sess, "router.reroutes")
    kres = pump_until(router, krids, 300)
    reroutes = count_series(sess, "router.reroutes") - reroutes0
    statuses = [kres[r].status for r in krids]
    if len(kres) != len(krids) or any(s != "ok" for s in statuses):
        raise AssertionError(f"fleet (c): after the kill {statuses}")
    if router.replicas_up() != sorted(n for n in ("host0", "host1",
                                                  "host2") if n != victim):
        raise AssertionError(f"fleet (c): up {router.replicas_up()}")
    up1, hosts1 = scrape_cluster(url)
    if up1.get(str(vhost)) != 0.0 or str(vhost) in hosts1:
        raise AssertionError(f"fleet (c): the dead host stayed in "
                             f"/metrics/cluster ({up1}, {hosts1})")
    leftover = router.shutdown()
    if leftover:
        raise AssertionError(f"fleet (c): shutdown returned {leftover}")
    return dict(
        replicas=["prefill", "decode", "decode"], requests=len(rids),
        tokens_equal_in_process=True,
        tokens_per_s=len(rids) * STEM_NEW / dt,
        killed=victim, on_victim=sum(1 for v in on.values()
                                     if v == victim),
        kill_requests=len(krids), reroutes=reroutes,
        all_ok_after_kill=True, recovery_s=time.perf_counter() - t_kill,
        cluster_up_before=up0, cluster_up_after=up1,
        hosts_with_series_after=sorted(hosts1))


def pump_until(router, rids, timeout):
    deadline = time.monotonic() + timeout
    out = {}
    while len(out) < len(rids):
        router.pump()
        for rid in rids:
            if rid not in out:
                res = router.poll(rid)
                if res is not None:
                    out[rid] = router.take(rid)
        if time.monotonic() > deadline:
            raise AssertionError(f"requests did not finish: "
                                 f"{sorted(set(rids) - set(out))}")
        time.sleep(0.005)
    return out


def fleet_autoscale(params, cfg, trace_b):
    """(d) One replica plus a WarmPool holding a second, warmed one,
    under Autoscaler and obs.session(serve_port=0, slo_rules=router.
    slo_rules(TTFT p99 rule)): a burst the single replica cannot serve
    within the rule scales the fleet up (the pooled replica joins), then
    idle scales it back down losslessly.  The allocator's reserved bytes
    and device allocations are unchanged from the warm-up through the
    joined replica's first requests.  Also renders (b)'s trace
    waterfall with its block-transfer hop."""
    import urllib.request

    from distkeras_tpu_torch.obs.report import (render_waterfall,
                                                request_waterfall)

    rng = np.random.default_rng(35)
    prompts = rng.integers(0, cfg.vocab_size, (256, 64)).astype(np.int32)
    engines = [fleet_engine(params, cfg, max_queue=256) for _ in range(2)]
    for e in engines:                     # warm both, as a pool holds them
        run_engine(e, [e.submit(p, 8) for p in prompts[:FLEET_LANES]])
    r0 = StrictReplica("r0", engines[0])
    pool = dkt.serving.WarmPool([StrictReplica(
        "w0", engines[1])])
    router = dkt.serving.Router([r0])
    rule = dkt.obs.SloRule("serving.ttft_s", percentile=0.99,
                           threshold=0.5, window_s=30.0)
    asc = dkt.serving.Autoscaler(router, pool, policy=dkt.serving.
                                 AutoscalePolicy(
                                     min_replicas=1, max_replicas=2,
                                     up_threshold=1e9, up_after=1,
                                     down_after=2, cooldown_ticks=0,
                                     breach_ticks=1))
    torch.cuda.synchronize()
    mem0 = (torch.cuda.memory_reserved(),
            torch.cuda.memory_stats()["num_device_alloc"])
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "autoscale.jsonl")
        with dkt.obs.session(trace_path=trace, serve_port=0,
                             slo_rules=router.slo_rules(rule),
                             slo_tick_s=3600.0) as sess:
            sess.slo.subscribe(asc.on_breach)
            # The burst: 4 requests every 4 decode steps (one a step; a
            # replica of 8 lanes serves 8 every 64), until the pooled
            # replica has joined and taken 8 of them; then idle.
            rids, placed = [], {}
            scaled, down, scrape, ticks = None, None, None, []

            def bursting():
                on_w0 = list(placed.values()).count("w0")
                return len(rids) < len(prompts) and (scaled is None
                                                     or on_w0 < 8)

            step = strict_step(router)
            deadline = time.monotonic() + 3 * FLEET_WAVE_S
            while bursting() or any(router.poll(r) is None for r in rids):
                if time.monotonic() > deadline:
                    raise AssertionError(
                        f"fleet (d): the burst not served within "
                        f"{3 * FLEET_WAVE_S} s ({ticks})")
                for p in (prompts[len(rids):len(rids) + 4]
                          if bursting() else ()):
                    rids.append(router.enqueue(p, 64))
                    placed[rids[-1]] = router._requests[rids[-1]].replica
                for _ in range(4):
                    step()
                sess.slo.tick()
                rec = asc.tick()
                ticks.append(rec["action"])
                if rec["action"] == "up":
                    scaled = rec
                    with urllib.request.urlopen(sess.server.url
                                                + "/metrics") as resp:
                        scrape = resp.read().decode()
                elif rec["action"] == "down":
                    down = rec      # the burst's tail already went cold
            results = [router.take(r) for r in rids]
            torch.cuda.synchronize()
            mem1 = (torch.cuda.memory_reserved(),
                    torch.cuda.memory_stats()["num_device_alloc"])
            for _ in range(6):           # idle
                if down is not None:
                    break
                rec = asc.tick()
                ticks.append(rec["action"])
                if rec["action"] == "down":
                    down = rec
            breaches = sess.registry.counter("slo.breaches").value(
                metric="serving.ttft_s", q="p99", replica="r0")
        recs = dkt.obs.read_trace(trace)
    events = {r["name"] for r in recs if r.get("kind") == "event"}
    if scaled is None or scaled["replica"] != "w0" or \
            scaled["reason"] != "breach" or "w0" not in placed.values():
        raise AssertionError(f"fleet (d): no scale-up ({ticks})")
    if down is None or pool.names() != (down["replica"],):
        raise AssertionError(f"fleet (d): no lossless scale-down ({ticks})")
    if not {"slo.breach", "autoscale.decision"} <= events:
        raise AssertionError(f"fleet (d): trace events {sorted(events)}")
    if not all(r.ok for r in results):
        raise AssertionError("fleet (d): a request did not end ok")
    samples = [ln for ln in (scrape or "").splitlines()
               if ln and not ln.startswith("#")]
    if not (samples and all(re.match(r"^[a-zA-Z_:][\w:]*(\{.*\})? \S+$", ln)
                            for ln in samples)
            and "slo_breaches" in scrape
            and "autoscale_scale_ups" in scrape):
        raise AssertionError("fleet (d): /metrics during the burst")
    if mem1 != mem0:
        raise AssertionError(f"fleet (d): the join changed the allocator's "
                             f"(reserved, device allocs) {mem0} -> {mem1}")
    # (b)'s waterfall: the request whose stem shipped.
    brecs = dkt.obs.read_trace(trace_b)
    hop = next(r for r in brecs if r.get("name") == "router.block_transfer")
    wf = request_waterfall(brecs, hop["fields"]["request_id"])
    text = render_waterfall(wf)
    names = [s["name"] for s in wf["stages"]]
    if not ({"router.prefill", "router.block_transfer",
             "serving.finish"} <= set(names)
            and "router.block_transfer" in text):
        raise AssertionError(f"fleet (b) waterfall: {names}")
    return dict(
        requests=len(rids), prompt=64, new_tokens=64, rule=dict(
            metric=rule.metric, percentile=rule.percentile,
            threshold_s=rule.threshold, window_s=rule.window_s),
        breaches=breaches, decisions=ticks, scale_up=scaled,
        requests_by_replica={n: list(placed.values()).count(n)
                             for n in ("r0", "w0")},
        scale_down=down, pool_after=list(pool.names()),
        allocator_constant_through_join=True, reserved_bytes=mem1[0],
        device_allocs=mem1[1], waterfall_stages=names,
        waterfall_hop={k: hop["fields"][k] for k in ("src", "dst",
                                                     "bytes", "blocks")})


def fleet_phase(np_params):
    """Phase fleet: the serving fleet at the flagship serving width
    (bf16, seed-0 weights, PagedBatcher(block=41)): (a) affinity
    routing in process against one engine, (b) the disaggregated
    prefill -> decode hop in process, (c) three replica processes over
    HTTP with a SIGKILLed decode replica and the federated telemetry,
    (d) SLO breaches driving the autoscaler.  Returns the forward
    kernel's in-process launches (the prefill replica's exports and the
    fallback's raw admissions)."""
    t0 = time.perf_counter()
    cfg = FLAGSHIP
    params = dkt.params_from_numpy(np_params, "cuda", dtype=torch.bfloat16)
    zero_launches()
    rec = {"affinity": fleet_affinity(params, cfg)}
    if attn.LAUNCHES["flash_fwd"]:
        raise AssertionError(f"fleet (a) launched {attn.LAUNCHES}")
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp()
    trace_b = os.path.join(tmp, "disagg.jsonl")
    rec["disagg"], tokens, prompts, fwd = fleet_disagg(params, cfg, trace_b)
    launches = {"flash_fwd": fwd, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    attn.LAUNCHES.update(launches)
    torch.cuda.empty_cache()
    rec["processes"] = fleet_processes(cfg, tokens, prompts, tmp)
    torch.cuda.empty_cache()
    rec["autoscale"] = fleet_autoscale(params, cfg, trace_b)
    if dict(attn.LAUNCHES) != launches:
        raise AssertionError(f"fleet: launches {attn.LAUNCHES}, expected "
                             f"{launches}")
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    log("fleet", config=dataclasses.asdict(cfg), block=PAGED_BLOCK,
        launches=launches, seconds=time.perf_counter() - t0, **rec)
    return launches


def fleet_idle_share(params, cfg):
    """The device's idle share over one wave of (a) (8 requests, 2 per
    stem) through the router against the same wave on one engine, both
    warm (a profiled window, run at the end of the script)."""
    heads, reqs = fleet_prompts(cfg, seed=31)
    wave = [p for i, (_, p) in enumerate(reqs) if i % FLEET_PER_STEM < 2]
    buckets = (STEM_TAIL, FLEET_STEM + STEM_TAIL)
    lone = fleet_engine(params, cfg, prompt_buckets=buckets)
    engines = [fleet_engine(params, cfg, prompt_buckets=buckets)
               for _ in range(2)]
    router = dkt.serving.Router([StrictReplica(f"r{i}", e)
                                 for i, e in enumerate(engines)])
    lone_idle = profile_window("fleet_lone_wave", lambda: drive_waves(
        lambda p: lone.enqueue(p, STEM_NEW), lone.step, lone.partial,
        [wave], STEM_NEW))
    routed_idle = profile_window("fleet_routed_wave", lambda: drive_waves(
        lambda p: router.enqueue(p, STEM_NEW), strict_step(router),
        router_partial(router), [wave], STEM_NEW))
    router.shutdown()
    return dict(idle_share_routed_wave=routed_idle,
                idle_share_lone_wave=lone_idle)


def leaf_ptrs(params):
    return [t.data_ptr() for _, t in named_leaves(params)]


def swap_checked(handle, swaps):
    """Wrap a replica's swap_params: the swap must allocate nothing on
    the device and move no leaf; its ms are recorded."""
    inner = handle.swap_params

    def swap(tree, version, allow_downgrade=False):
        eng = handle.engine
        torch.cuda.synchronize()
        before = (torch.cuda.memory_reserved(),
                  torch.cuda.memory_stats()["num_device_alloc"],
                  leaf_ptrs(eng.params))
        t0 = time.perf_counter()
        out = inner(tree, version, allow_downgrade=allow_downgrade)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        after = (torch.cuda.memory_reserved(),
                 torch.cuda.memory_stats()["num_device_alloc"],
                 leaf_ptrs(eng.params))
        if after != before:
            raise AssertionError(f"swap to v{version} on {handle.name} "
                                 "allocated or moved a tensor")
        swaps.append(dict(replica=handle.name, version=version, ms=ms))
        return out
    handle.swap_params = swap


def greedy_on(eng, prompts, new):
    lanes = [eng.submit(p, new) for p in prompts]
    return run_engine(eng, lanes, ())


def weight_push_phase(np_params):
    """Phase weight_push: (e) an LMTrainer at the serving config in f32
    (the training kernels) takes 2 rounds with attach_publisher(
    SnapshotPublisher(dir), every=1); each publish is polled by a
    CanaryController over two ContinuousBatcher(hot_swap=True) replicas
    under a Router (bf16 compute on the f32 weights the trainer
    publishes).  Each version goes to the canary (its drift printed) and
    is promoted; every replica's greedy tokens then equal a fresh
    engine's on that version; a request in flight across the second swap
    ends ok with its pre-swap tokens the old version's; a corrupted
    bucket aborts the poll (SnapshotCorrupt, never adopted); a candidate
    with a scaled embedding trips the drift gate and rolls back; every
    swap allocates nothing and moves no leaf; a swap forced to fail
    leaves the weights bit-identical.  Readings: swap ms, publish / load
    seconds raw and int8, the int8 coding's max error against its
    bound.  Returns the training kernels' launches."""
    from distkeras_tpu_torch.parallel.tree import tree_leaves, tree_map
    from distkeras_tpu_torch.serving import (CanaryController, Router,
                                             SnapshotCorrupt,
                                             SnapshotPublisher,
                                             SnapshotReader)

    t0 = time.perf_counter()
    cfg = FLAGSHIP
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    tmp = tempfile.mkdtemp()
    root = os.path.join(tmp, "snapshots")
    # Both replicas are built on ONE tree, as a deployment builds them:
    # each hot-swap engine serves its own copy, so a canary's swap must
    # leave the other replica and this tree alone (checked at the end).
    served = dkt.params_from_numpy(np_params, "cuda")
    engines = [dkt.ContinuousBatcher(served, cfg, lanes=8, hot_swap=True)
               for _ in range(2)]
    handles = [StrictReplica(f"s{i}", e)
               for i, e in enumerate(engines)]
    swaps = []
    for h in handles:
        swap_checked(h, swaps)
    router = Router(handles)
    template = dkt.params_from_numpy(np_params, "cuda")
    reader = SnapshotReader(root)
    ctl = CanaryController(router, reader, cfg, template, canary=1,
                           max_drift=PUSH_MAX_DRIFT)
    prompts = np.random.default_rng(36).integers(
        0, cfg.vocab_size, (PUSH_PROMPTS, 32)).astype(np.int32)
    rollouts, inflight, loaded = [], {}, {}

    def check_version(version):
        """Every replica against a fresh engine on that version's
        weights (loaded by a reader of its own)."""
        if version not in loaded:
            loaded[version] = SnapshotReader(root).load(version, template)
        fresh = dkt.ContinuousBatcher(loaded[version], cfg, lanes=8)
        ref = greedy_on(fresh, prompts, 16)
        for e in engines:
            equal_outs(greedy_on(e, prompts, 16), ref,
                       f"weight_push: v{version} vs a fresh engine")

    class Polled(SnapshotPublisher):
        """The trainer's publisher; each publish is polled by the canary
        controller before the next round."""

        def publish(self, tree, version):
            t1 = time.perf_counter()
            out = super().publish(tree, version)
            pub_s = time.perf_counter() - t1
            if version == 2:
                # A request in flight across this swap.
                old = [np.asarray(greedy_on(dkt.ContinuousBatcher(
                    loaded[1], cfg, lanes=8), prompts[:1], 24)[0])]
                rid = engines[0].enqueue(prompts[0], 24)
                for _ in range(6):
                    engines[0].step()
                head = list(engines[0].partial(rid).tokens)
                inflight.update(rid=rid, head=head, old=old[0])
            t2 = time.perf_counter()
            rec = ctl.poll()
            rec["poll_s"] = time.perf_counter() - t2
            rec["publish_s"] = pub_s
            rollouts.append(rec)
            if rec["action"] != "promote":
                raise AssertionError(f"weight_push: v{version} {rec}")
            check_version(version)
            return out

    rows = np.random.default_rng(37).integers(
        0, cfg.vocab_size, (16, TRAIN_SHAPE[1] + 1)).astype(np.int32)
    trainer = dkt.LMTrainer(cfg32, optimizer="adamw", learning_rate=3e-4,
                            batch_size=8)
    trainer.attach_publisher(Polled(root), every=1)
    zero_launches()
    trained = trainer.train(rows, params=dkt.params_from_numpy(np_params,
                                                               "cuda"))
    launches = dict(attn.LAUNCHES)
    expect_launches(launches, cfg.n_layers * 2, "weight_push trainer")
    # The in-flight request ends ok, its pre-swap tokens the old
    # version's.
    while engines[0].poll(inflight["rid"]) is None:
        engines[0].step()
    res = engines[0].take(inflight["rid"])
    n = len(inflight["head"])
    if not res.ok or list(res.tokens[:n]) != inflight["head"] or \
            not np.array_equal(inflight["old"][:n], inflight["head"]):
        raise AssertionError("weight_push: the in-flight request's "
                             "pre-swap tokens are not the old version's")
    if [r["version"] for r in rollouts] != [1, 2] or any(
            e.param_version != 2 for e in engines):
        raise AssertionError(f"weight_push: rollouts {rollouts}")
    if not all(torch.equal(a, b) for a, b in zip(
            tree_leaves(loaded[2]), tree_leaves(trained))):
        raise AssertionError("weight_push: the fleet's v2 is not the "
                             "trained weights")
    # A corrupted bucket: never adopted.
    pub = SnapshotPublisher(root)
    pub.publish(trained, 3)
    vdir = os.path.join(root, "v00000003")
    with open(os.path.join(vdir, "MANIFEST.json")) as f:
        first = json.load(f)["buckets"][0]["file"]
    raw = np.load(os.path.join(vdir, first))["raw"].copy()
    raw[0] ^= 0xFF
    np.savez(os.path.join(vdir, first[:-4]), raw=raw)
    abort = ctl.poll()
    try:
        SnapshotReader(root).load(3, template)
        raise AssertionError("weight_push: a corrupted bucket loaded")
    except SnapshotCorrupt:
        pass
    if abort["action"] != "abort" or any(e.param_version != 2
                                         for e in engines):
        raise AssertionError(f"weight_push: corrupted v3 {abort}")
    # A candidate past the drift gate rolls back.
    ctl.max_drift = GATE_MARGIN * max(r["drift"] for r in rollouts)
    far = dict(trained, tok_emb=trained["tok_emb"] * GATE_SCALE)
    pub.publish(far, 4)
    back = ctl.poll()
    if back["action"] != "rollback" or any(e.param_version != 2
                                           for e in engines):
        raise AssertionError(f"weight_push: v4 {back}")
    check_version(2)
    # A swap forced to fail leaves the weights bit-identical.
    before = [t.clone() for _, t in named_leaves(engines[1].params)]
    wrong = tree_map(lambda t: t, trained)
    wrong["ln_f_scale"] = wrong["ln_f_scale"].double()
    try:
        engines[1].swap_params(wrong, 9)
        raise AssertionError("weight_push: a mistyped swap was taken")
    except ValueError:
        pass
    if not all(torch.equal(a, b) for a, (_, b) in zip(
            before, named_leaves(engines[1].params))):
        raise AssertionError("weight_push: a refused swap changed weights")
    del before
    if not all(torch.equal(a, b) for a, b in zip(tree_leaves(served),
                                                 tree_leaves(template))):
        raise AssertionError("weight_push: a swap wrote the tree the "
                             "engines were built on")
    del served
    # Readings: publish / load at the snapshot's GB, raw and int8.
    codings = {}
    gb = sum(t.numel() * t.element_size()
             for t in tree_leaves(trained)) / 2**30
    for coding in (None, "int8"):
        croot = os.path.join(tmp, f"coding_{coding}")
        cpub = SnapshotPublisher(croot, coding=coding)
        t1 = time.perf_counter()
        cpub.publish(trained, 1)
        pub_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        got = SnapshotReader(croot).load(1, template)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t1
        with torch.no_grad():
            errs = [float((a - b).abs().max()) for a, b in zip(
                tree_leaves(got), tree_leaves(trained))]
        # The codec's bound, leaf by leaf: half a step of the scale of
        # the bucket that holds the leaf (one symmetric scale per bucket:
        # its max |x| / 127), read from the snapshot itself; raw is exact.
        scales = []
        vdir = os.path.join(croot, "v00000001")
        with open(os.path.join(vdir, "MANIFEST.json")) as f:
            for entry in json.load(f)["buckets"]:
                scales.append(float(np.load(os.path.join(
                    vdir, entry["file"]))["scale"].max())
                    if entry["coding"] == "int8" else 0.0)
        bounds = [scales[slot.bucket] / 2 for slot in cpub._layout.slots]
        over = [(e, b) for e, b in zip(errs, bounds) if e > b * (1 + 1e-4)]
        if over:
            raise AssertionError(f"weight_push: {coding} coding error past "
                                 f"its bucket's bound: {over[:4]}")
        codings[coding or "raw"] = dict(
            publish_s=pub_s, load_s=load_s, max_abs_err=max(errs),
            bound=max(bounds), buckets=len(scales),
            worst_err_over_bound=max((e / b for e, b in zip(errs, bounds)
                                      if b), default=0.0))
        del got
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    router.shutdown()
    log("weight_push", config=dataclasses.asdict(cfg), trainer_dtype="float32",
        fleet_compute_dtype=cfg.dtype, rounds=2, batch=8,
        seq=TRAIN_SHAPE[1], launches=launches, snapshot_gb=gb,
        rollouts=[{k: r.get(k) for k in ("action", "version", "drift",
                                         "canaries", "promoted", "poll_s",
                                         "publish_s")} for r in rollouts],
        corrupted=dict(action=abort["action"]),
        drift_gate=dict(max_drift=ctl.max_drift, action=back["action"],
                        drift=back["drift"], reason=back.get("reason"),
                        embedding_scale=GATE_SCALE),
        inflight=dict(pre_swap_tokens=n - len(prompts[0]),
                      ok=True, pre_swap_equal_old_version=True),
        swaps=swaps, swap_ms=[s["ms"] for s in swaps],
        swaps_allocate_nothing=True, refused_swap_bit_identical=True,
        shared_tree_unchanged=True,
        codings=codings, seconds=time.perf_counter() - t0)
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
    # 1, and the speculative warm-up of 8 x 64-token prompts.  The same
    # two last shapes are the paged kv_int8="prefill" admission of a
    # 100-token prompt (its 128-wide bucket) and beam_search's prompt
    # pass (8 x 64).
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

    # 5c. Paged KV serving and beam search.
    torch.cuda.empty_cache()
    paged_launches = paged_phase(np_params)
    torch.cuda.empty_cache()
    beam_launches = beam_phase(np_params)

    # 5d. The serving fleet (router, disaggregation, replica processes,
    # autoscaling) and the train -> serve weight push.
    torch.cuda.empty_cache()
    fleet_launches = fleet_phase(np_params)
    torch.cuda.empty_cache()
    push_launches = weight_push_phase(np_params)

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

    # 7b. The paper's other workloads: imdb_lstm, resnet50, the MLPs,
    # and synchronized BatchNorm.
    torch.cuda.empty_cache()
    keras_zoo_phase()

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
    bf16 = dkt.params_from_numpy(np_params, "cuda", dtype=torch.bfloat16)
    log("engine_idle", idle_share_4x_step4=engine_idle_share(bf16,
                                                             FLAGSHIP))
    log("paged_idle", **paged_idle_share(bf16, FLAGSHIP))
    log("beam_idle", idle_share_16_steps=beam_idle_share(bf16, FLAGSHIP))
    log("fleet_idle", **fleet_idle_share(bf16, FLAGSHIP))
    del bf16
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
               int8_launches, dp_launches, resume_launches, paged_launches,
               beam_launches, fleet_launches, push_launches)

    def launch_counts(name, *paths):
        paths = paths + surface
        return {"launches": sum(p[name] for p in paths),
                "launches_by_path": {k: p[name] for k, p in zip(
                    ("serve", "engine", "train", "long_train", "moe_train",
                     "lora_train", "moe_serve", "int8_serve", "dp",
                     "resume", "paged", "beam", "fleet", "weight_push"),
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
        "bf16_case_paths": {"pool256": ["engine"],
                            "pool128": ["engine", "paged"],
                            "spec_warm": ["engine", "beam"]},
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
    if sys.argv[1:2] == ["--replica"]:
        sys.exit(replica_main(sys.argv[2]))
    sys.exit(main(profile="--profile" in sys.argv[1:]))

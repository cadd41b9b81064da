"""Smoke test of the PyTorch / CUDA port on one GPU.

Builds every kernel of the port from ``distkeras_tpu_torch/ops/csrc``,
holds each against its plain PyTorch version on the card, drives the
serving path (``generate``: prefill through the flash kernel, then the
KV-cached decode) at the flagship serving width, checks that the path
launched the kernel, and checks the outputs against the plain path.

Usage: python3 chip_smoke.py [--profile]     (needs one CUDA device)

``--profile`` adds the device time by kernel (torch.profiler) of one
prefill and of a short generate at the same shapes.

Output: the card's name and power limit, one line per phase, then a
``{"kernels": [...]}`` line and, last, the ``{"ok": true, "device": ...}``
line.  Any failed phase raises, so the exit code is nonzero.
"""

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

import distkeras_tpu_torch as dkt
from distkeras_tpu_torch.ops import _build
from distkeras_tpu_torch.ops import attention as attn

H100_BF16_FLOPS = 989e12   # dense tensor-core peak (NVIDIA data sheet)
H100_F32_FLOPS = 67e12     # f32 outside the tensor cores
H100_HBM_BYTES = 3.35e12   # bytes/s

# The flagship serving config of scripts/bench_serving.py (~152M
# weights), at full depth.
FLAGSHIP = dkt.TransformerConfig(
    vocab_size=32768, d_model=1024, n_heads=8, n_layers=8, d_ff=4096,
    max_len=1025, dtype="bfloat16", rope=True)
PREFILL_SHAPE = (8, 512, 8, 128)   # q/k/v [B, L, H, D] of that prefill
NEW_TOKENS = 64


def log(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
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


def bound(q, causal, window):
    """Least time the card needs: max(FLOPs / peak, bytes / HBM rate),
    q, k, v read once and O written once."""
    b, lq, h, d = q.shape
    flops = 4 * b * h * d * live_pairs(lq, lq, causal, window)
    peak = H100_BF16_FLOPS if q.dtype == torch.bfloat16 else H100_F32_FLOPS
    t_ops = flops / peak
    t_bytes = 4 * q.numel() * q.element_size() / H100_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


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

    return {
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


def profile_serve(params, prompt, cfg):
    """Device time by kernel (torch.profiler) for one prefill and for
    the decode steps of a short generate, with the device's busy share
    of each window's wall time."""
    from torch.profiler import ProfilerActivity, profile

    def window(name, fn):
        fn()  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = wall_s(fn)
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: e.self_device_time_total,
                     reverse=True)[:12]
        log("profile", window=name, wall_ms=1e3 * wall, device_busy_ms=busy,
            idle_share=1 - busy / (1e3 * wall),
            top=[{"kernel": e.key[:90], "calls": e.count,
                  "device_ms": e.self_device_time_total / 1e3}
                 for e in top])

    window("prefill", lambda: dkt.prefill(params, prompt, cfg,
                                          last_logits=False))
    window("generate_8_tokens", lambda: dkt.generate(params, prompt, cfg, 8))


def plain_flash(q, k, v):
    """The default attention_fn with the plain version in the kernel's
    place (for the path parity check)."""
    return attn.blockwise_attention(q, k, v, True)


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
        ptxas=[ln.strip() for log_ in _build.build_logs.values()
               for ln in log_.splitlines()
               if "registers" in ln or "spill" in ln])

    # 2. Each kernel against its plain version, at the prefill shape.
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for causal, window in ((True, None), (True, 256), (False, None)):
            cases.append(kernel_case(dtype, causal, window))
            log("kernel_vs_plain", kernel="flash_fwd", shape=PREFILL_SHAPE,
                **cases[-1])
    main_case = cases[0]   # bf16 causal: what the prefill launches

    # 3. The serving path at full width: greedy generate, 8 x 512 prompt.
    cfg = FLAGSHIP
    np_params = numpy_params(cfg, seed=0)
    params = dkt.params_from_numpy(np_params, "cuda", dtype=torch.bfloat16)
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (8, 512)).astype(np.int32)
    for name in attn.LAUNCHES:
        attn.LAUNCHES[name] = 0
    out, gen_s = wall_s(lambda: dkt.generate(params, prompt, cfg,
                                             NEW_TOKENS))
    launches = dict(attn.LAUNCHES)
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

    print(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "distkeras_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "distkeras_tpu/ops/attention.py:197",
        "launches": launches["flash_fwd"],
        "max_abs_err": main_case["max_abs_err"], "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"], "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(profile="--profile" in sys.argv[1:]))

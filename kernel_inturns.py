"""Compare two builds of the port's flash kernels on one card, in turns.

The working tree's ``distkeras_tpu_torch/ops/csrc`` is held against the
same sources of another commit (``--parent DIR``: a directory holding that
commit's ``flash_fwd.cu`` and ``flash_bwd.cu``, and ``flash_common.cuh``
where it had one), in the order parent / change / change / parent:

- every forward case of ``chip_smoke.py``: the 6 prefill cases at
  [8, 512, 8, 128] (no lse) and the 8 training cases at [8, 1024, 8, 128]
  (with lse), by CUDA events behind a device-side sleep
  (``chip_smoke.time_ms``);
- the dQ and dK/dV kernels on the training cases;
- the d1024 L8 train step (8 x 1024, f32, adamw), host clock over 8 steady
  steps.

It also diffs the SASS of the two ``flash_bwd.cu`` builds (``cuobjdump``),
function by function.  Further ``NAME=path.cu`` arguments are variant
forward sources, built with this tree's headers beside them and timed
twice each after the four turns, with their largest difference from this
tree's output.

Usage (needs one CUDA device, run from the repository root):

    git show <commit>:distkeras_tpu_torch/ops/csrc/flash_fwd.cu > DIR/flash_fwd.cu
    git show <commit>:distkeras_tpu_torch/ops/csrc/flash_bwd.cu > DIR/flash_bwd.cu
    python3 kernel_inturns.py --parent DIR [NAME=path.cu ...]

Writes ``chiprun_out/inturns.json`` (``--out`` to change) and prints one
JSON line per case.
"""

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import distkeras_tpu_torch as dkt  # noqa: E402
from distkeras_tpu_torch.ops import _build  # noqa: E402
from distkeras_tpu_torch.ops import attention as attn  # noqa: E402

SOURCES = ("flash_fwd", "flash_bwd")


def nvcc(src, out):
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc {src}: {res.stdout}{res.stderr}")
    return res.stdout + res.stderr


def sass(lib):
    """SASS of a library by function (anonymous-namespace hash and
    addresses stripped), or {} without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    funcs = {}
    for chunk in text.split("Function : ")[1:]:
        name, body = chunk.split("\n", 1)
        name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "ANON", name.strip())
        body = re.sub(r"/\*[^*]*\*/", "", body)
        funcs[name] = [x.strip() for x in body.splitlines() if x.strip()]
    return funcs


def use(libs):
    for name, lib in libs.items():
        _build._libs[name] = lib


def step_ms(n=8):
    """Steady train step of the d1024 L8 config at 8 x 1024 (f32)."""
    cfg = cs.FLAGSHIP_TRAIN
    params = dkt.params_from_numpy(cs.numpy_params(cfg, seed=1), "cuda")
    opt = dkt.Optimizer("adamw", 3e-4)
    step = dkt.make_train_step(cfg, opt)
    carry = (params, opt.init(params))
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (8, cs.TRAIN_SHAPE[1] + 1)).astype(np.int32)).cuda()
    for _ in range(2):
        carry, _ = step(carry, tokens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        carry, _ = step(carry, tokens)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / n
    del carry, params
    torch.cuda.empty_cache()
    return ms


def make_cases():
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for causal, window in ((True, None), (True, 256), (False, None)):
            g = torch.Generator(device="cuda").manual_seed(0)
            q, k, v = (torch.randn(cs.PREFILL_SHAPE, generator=g,
                                   device="cuda", dtype=dtype)
                       for _ in range(3))
            cases.append(dict(kind="prefill", dtype=str(dtype)[6:],
                              causal=causal, window=window, seg=None,
                              qkv=(q, k, v), lse=False))
    for dtype in (torch.float32, torch.bfloat16):
        for causal, window, segd in ((True, None, False), (True, 256, False),
                                     (False, None, False), (True, None, True)):
            g = torch.Generator(device="cuda").manual_seed(0)
            q, k, v, do = (torch.randn(cs.TRAIN_SHAPE, generator=g,
                                       device="cuda", dtype=dtype)
                           for _ in range(4))
            seg = (cs.packed_segments(8, cs.TRAIN_SHAPE[1], 0) if segd
                   else None)
            ref, lse = attn.flash_fwd_plain(q, k, v, causal,
                                            cs.TRAIN_SHAPE[-1] ** -0.5,
                                            window, seg)
            cases.append(dict(kind="train", dtype=str(dtype)[6:],
                              causal=causal, window=window, seg=seg,
                              qkv=(q, k, v), lse=True,
                              bwd=(do, lse, attn.attention_delta(do, ref))))
    return cases


def run_fwd(c):
    q, k, v = c["qkv"]
    return attn.flash_fwd_cuda(q, k, v, c["causal"], q.shape[-1] ** -0.5,
                               c["window"], c["seg"], with_lse=c["lse"])


def bwd_args(c):
    q, k, v = c["qkv"]
    do, lse, delta = c["bwd"]
    return (q, k, v, do, lse, delta, c["causal"], q.shape[-1] ** -0.5,
            c["window"], c["seg"])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out" /
                    "inturns.json")
    ap.add_argument("variants", nargs="*", metavar="NAME=path.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_inturns: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)

    # Builds: this tree's through _build, the others by nvcc into _build.
    bdir = _build.BUILD_DIR / "inturns"
    jobs = {}
    for name in SOURCES:
        jobs[("parent", name)] = (args.parent / f"{name}.cu",
                                  bdir / f"libparent_{name}.so")
    for spec in args.variants:
        vname, path = spec.split("=", 1)
        vdir = bdir / vname
        vdir.mkdir(parents=True, exist_ok=True)
        for header in _build.SRC_DIR.glob("*.cuh"):
            shutil.copy(header, vdir)
        shutil.copy(path, vdir / "flash_fwd.cu")
        jobs[(vname, "flash_fwd")] = (vdir / "flash_fwd.cu",
                                      bdir / f"lib{vname}_flash_fwd.so")
    bdir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs) + 1) as pool:
        own = pool.submit(_build.build_all)
        logs = {key: pool.submit(nvcc, *job) for key, job in jobs.items()}
        own.result()
        logs = {key: f.result() for key, f in logs.items()}
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    for key, log in logs.items():
        print(json.dumps({"build": key, "ptxas": cs.ptxas_summary(log)}),
              flush=True)
    libs = {"change": {n: ctypes.CDLL(str(_build.build(n)))
                       for n in SOURCES}}
    libs["parent"] = {n: ctypes.CDLL(str(jobs[("parent", n)][1]))
                      for n in SOURCES}
    names = [s.split("=", 1)[0] for s in args.variants]
    for vname in names:
        libs[vname] = {"flash_fwd": ctypes.CDLL(str(jobs[(vname,
                                                          "flash_fwd")][1])),
                       "flash_bwd": libs["change"]["flash_bwd"]}

    old, new = sass(jobs[("parent", "flash_bwd")][1]), sass(
        _build.build("flash_bwd"))
    same = [f for f in old if new.get(f) == old[f]]
    sass_line = {"bwd_sass_functions": len(old), "identical": len(same)}
    print(json.dumps(sass_line), flush=True)

    cases = make_cases()
    times = [{} for _ in cases]
    outs = {}
    steps = {}
    for turn, who in enumerate(("parent", "change", "change", "parent")):
        use(libs[who])
        for i, c in enumerate(cases):
            r = times[i].setdefault(who, {"fwd": [], "dq": [], "dkv": []})
            with torch.no_grad():
                if turn < 2:
                    outs[(i, who)] = run_fwd(c)[0]
                r["fwd"].append(cs.time_ms(lambda: run_fwd(c)))
                if c["kind"] == "train":
                    a = bwd_args(c)
                    r["dq"].append(cs.time_ms(
                        lambda: attn.flash_bwd_dq_cuda(*a)))
                    r["dkv"].append(cs.time_ms(
                        lambda: attn.flash_bwd_dkv_cuda(*a)))
        steps.setdefault(who, []).append(step_ms())
        print(json.dumps({"turn": turn, "who": who,
                          "step_ms": steps[who][-1]}), flush=True)
    for vname in names:
        use(libs[vname])
        for i, c in enumerate(cases):
            with torch.no_grad():
                out = run_fwd(c)[0]
                times[i][vname] = {
                    "fwd": [cs.time_ms(lambda: run_fwd(c)) for _ in range(2)],
                    "max_abs_diff_vs_change": float(
                        (out.float() - outs[(i, "change")].float())
                        .abs().max())}
        steps[vname] = [step_ms()]
    use(libs["change"])

    rows = []
    for i, c in enumerate(cases):
        row = {key: c[key] for key in ("kind", "dtype", "causal", "window")}
        row["segmented"] = c["seg"] is not None
        row["max_abs_diff_change_vs_parent"] = float(
            (outs[(i, "change")].float() - outs[(i, "parent")].float())
            .abs().max())
        for who, r in times[i].items():
            row[who] = {key: val for key, val in r.items() if val != []}
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"step_ms": steps}), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "bwd_sass": sass_line,
                                    "cases": rows, "step_ms": steps},
                                   indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The flagship LM served by ``ContinuousBatcher`` under a closed loop
of clients.

Each client sends a request, waits for all of its tokens, and sends the
next at once; there are as many clients as lanes.  The loop admits what
the clients have sent (``submit``), then advances every lane by a
window of decode steps (``step``) and drains the lanes that finished.
Time to first token is the client's: from the moment it sent the
request to the return of the step that brought its first token.

A traced run profiles ``TRACE_S`` seconds of the window from
``TRACE_AFTER_S`` on (the device's activity), then ``LABEL_S`` more
(the host's as well), and leaves them out of its counts.

Set-up makes the weights on the card from the seed, admits one request
through every admission bucket, and runs the closed loop for
``WARMUP_S`` so that the lanes' lengths are spread when the window
opens.  The window counts the tokens emitted in it; after it closes, no
client sends again, and the loop steps until every request sent in the
window has its first token (a late token is late, not missing).

``correct``: a sample of the requests finished in the window, drawn
from the seed and holding the one with the most served tokens, goes
through the plain reference (``reference/lm.py``, f32 on the served
bf16 weights): the widest gap by which a served token's logit lies
below the best logit at its position, averaged over the sample's
served tokens, is the number compared (the widest such gap is kept
beside it; why the mean: PERF.md).
"""

from __future__ import annotations

import json
import os
import random
import statistics
import time
from collections import deque

import numpy as np

from harness import device, reckon
from harness.traffic import ClosedLoop
from reference import lm as ref

WARMUP_S, TRACE_AFTER_S, TRACE_S, LABEL_S = 3, 4, 2, 0.5
CHECK_REQUESTS = 256       # finished requests the reference judges


def model_cfg(run) -> dict:
    cfg = {k: run.config[k] for k in ("vocab_size", "d_model", "n_heads",
                                      "n_layers", "d_ff", "rope",
                                      "rope_theta")}
    return dict(cfg, dtype=run.params["dtype"], max_len=run.params["max_len"])


def _spans(path: str, t0: float, t1: float) -> list:
    out = []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("kind") == "span" and t0 <= rec["t0"] < t1:
                out.append(rec)
    return out


def run(run):
    import torch

    from distkeras_tpu_torch import obs
    from distkeras_tpu_torch.models.quant import quantize_params
    from distkeras_tpu_torch.models.transformer import TransformerConfig
    from distkeras_tpu_torch.serving.lanes import ContinuousBatcher

    p, dev = run.params, run.device
    cfg = model_cfg(run)
    dtype = getattr(torch, cfg["dtype"])
    params = ref.init_params(cfg, run.seed, dev, dtype)
    int8 = bool(p.get("int8"))
    served = quantize_params(params) if int8 else params
    eng = ContinuousBatcher(served, TransformerConfig(**cfg),
                            lanes=p["lanes"], kv_int8=int8,
                            prompt_buckets=tuple(p["buckets"]), device=dev)
    traffic = ClosedLoop(p, cfg["vocab_size"], run.seed)
    width = p["step_window"]
    run.mark("engine")

    # Every admission bucket once (the prompt fills it), then decode.
    rng = np.random.default_rng(run.seed ^ 0xB0C)
    lanes = [eng.submit(rng.integers(0, cfg["vocab_size"], w + 1), 2)
             for w in p["buckets"]]
    while eng.running():
        eng.step(width)
    for lane in lanes:
        eng.drain(lane)
    run.mark("buckets")

    k = 0                          # requests sent so far
    ready = deque((c, None) for c in range(p["clients"]))
    live = {}                      # lane -> request record
    finished = []
    sent_in_window = []
    state = {"window": None, "closed": None, "tokens": 0, "flops": 0}

    def send(now):
        nonlocal k
        while ready and eng.free_lanes():
            c, since = ready.popleft()
            prompt, n_out = traffic.request(k)
            if k < p["clients"]:
                # The first fill is a closed loop already running: each
                # client part-way through its request, so that the
                # lanes' completions are spread when the window opens.
                n_out = max(1, round(n_out * (c + 0.5) / p["clients"]))
            k += 1
            lane = eng.submit(prompt, n_out)
            rec = {"prompt": prompt, "sent": since or now,
                   "first": None, "out": None, "client": c}
            live[lane] = rec
            if (state["window"] is not None and state["closed"] is None
                    and not run.tracing):
                sent_in_window.append(rec)
                state["flops"] += reckon.lm_forward_flops(
                    cfg, 0, prompt.size - 1)

    def turn():
        out = eng.step(width)
        now = time.perf_counter()
        counting = (state["window"] is not None and state["closed"] is None
                    and not run.tracing)
        for lane, toks in out.items():
            rec = live[lane]
            if toks and rec["first"] is None:
                rec["first"] = now
            if counting:
                state["tokens"] += len(toks)
                done = len(rec.get("emitted", ()))
                start = rec["prompt"].size - 1 + done
                state["flops"] += reckon.lm_forward_flops(
                    cfg, start, len(toks))
            rec.setdefault("emitted", []).extend(toks)
        running = set(eng.running())
        for lane in [ln for ln in live if ln not in running]:
            rec = live.pop(lane)
            rec["out"] = eng.drain(lane)[rec["prompt"].size:]
            rec["done"] = now
            finished.append(rec)
            if state["closed"] is None:
                ready.append((rec["client"], now))
        return now

    now = time.perf_counter()
    end_warm = now + WARMUP_S
    while now < end_warm:
        send(now)
        now = turn()
    finished.clear()
    for rec in live.values():
        rec["warm"] = True

    device.reset_peak(dev)
    sess = None
    if run.trace:
        sess = obs.enable(trace_path=os.path.join(run.out_dir,
                                                  "obs.jsonl"))
    t0 = state["window"] = run.window_opens()
    now = t0
    while now - t0 - run.paused_s < run.seconds:
        send(now)
        if run.trace and not run.trace_taken and now >= t0 + TRACE_AFTER_S:
            for host, seconds in ((False, TRACE_S), (True, LABEL_S)):
                with run.traced(host):
                    end = time.perf_counter() + seconds
                    while now < end:
                        send(now)
                        now = turn()
        else:
            now = turn()
    state["closed"] = now
    window_s = now - t0 - run.paused_s
    run.memory_peak_bytes = device.peak(dev)
    # Late first tokens of requests sent in the window.
    while any(r["first"] is None for r in sent_in_window):
        turn()
    if sess is not None:
        obs.disable()
        a, b = run.traced_at
        run.spans = [s for s in _spans(sess.trace.path, t0, state["closed"])
                     if not a <= s["t0"] <= b]

    ttft = [1e3 * (r["first"] - r["sent"]) for r in sent_in_window]
    run.attempted, run.failed = len(ttft), 0
    run.e2e["serve_tokens_per_s"] = (state["tokens"] / window_s, "tokens/s")
    run.counters.update({"kind": "serve", "window_s": window_s,
                         "serve.ttft_p95_ms": statistics.quantiles(
                             ttft, n=100, method="inclusive")[94],
                         "serve.model_flops": state["flops"],
                         "serve.requests": len(ttft),
                         "serve.tokens": state["tokens"]})

    done = [r for r in finished if r["done"] <= state["closed"]
            and not r.get("warm")]
    del eng, served, live
    device.free(dev)
    t = time.perf_counter()
    gaps = served_gaps(run, cfg, params, sample(done, run.seed,
                                                CHECK_REQUESTS))
    run.counters["reference_s"] = time.perf_counter() - t
    run.counters["serve.gaps"] = gap_stats(gaps)
    for name in run.limits:
        run.check(name, run.counters["serve.gaps"][name])


def sample(done: list, seed: int, n: int) -> list:
    """``n`` of the finished requests, drawn from the seed, the one with
    the most served tokens among them."""
    longest = max(range(len(done)), key=lambda i: len(done[i]["out"]))
    rest = [i for i in range(len(done)) if i != longest]
    pick = random.Random(seed).sample(rest, min(n - 1, len(rest)))
    return [done[i] for i in [longest] + pick]


def served_gaps(run, cfg, params, requests):
    """By how much each of the requests' served tokens' logits lies
    below the reference's best at its position (f32 on the served
    weights), as one flat array."""
    import torch

    full = ref.nest({k: v.float() for k, v in ref.flatten(params).items()})
    out = []
    for r in requests:
        prompt = torch.as_tensor(r["prompt"], device=run.device)
        toks = torch.as_tensor(np.asarray(r["out"], dtype="int64"),
                               device=run.device)
        out.append(ref.served_gaps(full, cfg, prompt, toks,
                                   torch.float32).cpu().numpy())
    return np.concatenate(out)


def gap_stats(gaps) -> dict:
    """The widest gap, the mean gap, the mean squared gap, and the share
    of served tokens that are not the reference's first choice."""
    return {"served_gap": float(gaps.max()),
            "served_gap_mean": float(gaps.mean()),
            "served_gap_sq_mean": float((gaps.astype("float64") ** 2).mean()),
            "served_off_share": float((gaps > 0).mean()),
            "served_tokens_judged": int(gaps.size)}



def calibrate(ctx) -> dict:
    """The program's gap statistics and its control's: the same run with
    the program's own int8 path switched on (``quantize_params``'s int8
    weights and the ``kv_int8`` cache, one precision below the bf16 the
    cell serves), judged as a run judges the program."""
    import time

    from harness import core

    cell = dict(ctx.cell, params=dict(ctx.params, int8=True))
    twin = core.Run(ctx.workload, ctx.seed, ctx.seconds, False, ctx.out_dir,
                    time.time(), cell=cell, config=ctx.config,
                    device=ctx.device)
    run(twin)
    own = core.Run(ctx.workload, ctx.seed, ctx.seconds, False, ctx.out_dir,
                   time.time(), cell=ctx.cell, config=ctx.config,
                   device=ctx.device)
    run(own)
    return {"program": own.counters["serve.gaps"],
            "control_int8": twin.counters["serve.gaps"],
            "control_int8_rate": {k: v for k, (v, _) in twin.e2e.items()}}

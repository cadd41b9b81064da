"""The port's trace on the profiler's clock: ``obs`` spans as
``record_function`` regions of a running ``torch.profiler`` capture and,
through the trace's clock anchor, on the capture's own timeline;
``obs.device_span``; the trace's records kept in memory and written in
batches; and the spans the LM train step and the serving engine record
(the decode turn's dispatch and readback, admission's real tokens).
"""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from distkeras_tpu_torch import obs
from distkeras_tpu_torch.models import transformer as ttfm
from distkeras_tpu_torch.obs import trace as otrace
from distkeras_tpu_torch.obs.trace import EventTrace, read_trace, tail_trace
from distkeras_tpu_torch.serving import ContinuousBatcher
from distkeras_tpu_torch.trainers import lm as tlm
from distkeras_tpu_torch.trainers.optim import Optimizer

KW = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
          max_len=64)


def spans_of(path, name=None):
    return [r for r in read_trace(path) if r["kind"] == "span"
            and (name is None or r["name"] == name)]


# ------------------------------------------------ the profiler's clock


def test_span_is_a_profiler_region_on_the_capture_clock(tmp_path):
    a = torch.randn(96, 96)
    path = str(tmp_path / "t.jsonl")
    with obs.session(trace_path=path) as sess:
        prof = profile(activities=[ProfilerActivity.CPU])
        prof.start()
        with obs.span("warm"):       # the capture's first region pays
            a @ a                     # its set-up
        with obs.span("x"):
            a @ a
        prof.stop()
        clock = sess.trace.clock
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    events = prof.events()
    (mark,) = [e for e in events if e.name == "x"]
    assert mark.is_user_annotation
    mms = [e for e in events if e.name == "aten::mm"
           and mark.time_range.start <= e.time_range.start]
    assert mms and mms[0].time_range.end <= mark.time_range.end
    (rec,) = spans_of(path, "x")
    assert read_trace(path)[0]["clock"] == clock
    assert clock["gap_ns"] >= 0
    s, e = obs.span_unix_ns(rec, clock)
    assert abs((s - start_ns) / 1e3 - mark.time_range.start) < 200
    assert abs((e - start_ns) / 1e3 - mark.time_range.end) < 200


def test_off_hooks_are_the_shared_null_and_mark_nothing():
    assert obs.active() is None
    a = torch.randn(8, 8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for hook in (obs.span, obs.device_span):
            cm = hook("x", k=1)
            assert cm is obs._NULL
            with cm:
                a @ a
    assert not [e for e in prof.events() if e.name == "x"]


def test_device_span_on_cpu_tensors_has_no_device_time(tmp_path):
    path = str(tmp_path / "t.jsonl")
    with obs.session(trace_path=path):
        with obs.device_span("y", k=2) as sp:
            torch.ones(4) * 2
        with obs.span("p"):
            pass
        assert sp.fields == {"k": 2}
    (rec,) = spans_of(path, "y")
    assert rec["dev_dur"] is None and rec["fields"] == {"k": 2}
    (plain,) = spans_of(path, "p")
    assert "dev_dur" not in plain


def test_device_span_inside_held_keeps_its_times(tmp_path):
    import threading

    path = str(tmp_path / "t.jsonl")
    lock = threading.Lock()
    with obs.session(trace_path=path):
        with obs.held(lock):
            with obs.span("outer"):
                with obs.device_span("inner"):
                    pass
    outer, inner = sorted(spans_of(path), key=lambda r: r["t0"])
    assert inner["parent"] == outer["id"]
    assert outer["t0"] <= inner["t0"]
    assert inner["t0"] + inner["dur"] <= outer["t0"] + outer["dur"]


# ---------------------------------------------------- buffered writes


def test_trace_writes_in_batches(tmp_path, monkeypatch):
    path = str(tmp_path / "t.jsonl")
    tr = EventTrace(path)
    (meta,) = read_trace(path)                 # written when it opens
    assert meta["kind"] == "meta"
    size = os.path.getsize(path)
    for i in range(10):
        tr.event("x.y", i=i)
    assert os.path.getsize(path) == size       # nothing per record
    tr.flush()
    assert [r["fields"]["i"] for r in tail_trace(path, 3)] == [7, 8, 9]
    tr.event("x.y", i=10)
    assert len(read_trace(path)) == 11         # meta + ten events
    tr.close()
    recs = read_trace(path)
    assert recs[0]["kind"] == "meta" and len(recs) == 12
    # A full batch is written without a flush.
    monkeypatch.setattr(otrace, "BATCH", 4)
    path2 = str(tmp_path / "b.jsonl")
    tr = EventTrace(path2)
    for i in range(5):
        tr.event("x.y", i=i)
    assert len(read_trace(path2)) == 1 + 4
    tr.close()


class PendingTimer(otrace.DeviceTimer):
    """A device timer whose end the card has not reached until
    ``finish()``; waiting for it finishes it."""

    def __init__(self):
        self.end = self
        self.passed = False

    def finish(self):
        self.passed = True

    synchronize = finish

    def done(self):
        return self.passed

    def seconds(self):
        assert self.passed, "a write waited on the card"
        return 0.25


def test_a_full_batch_never_waits_on_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(otrace, "BATCH", 2)
    path = str(tmp_path / "t.jsonl")
    tr = EventTrace(path)
    timer = PendingTimer()
    tr.event("x.a")
    tr._write({"kind": "span", "name": "x.d", "dev_dur": timer})
    tr.event("x.b")
    tr.event("x.c")
    # Written up to the span the card has not finished; the rest waits.
    assert [r.get("name") for r in read_trace(path)] == [None, "x.a"]
    timer.finish()
    tr.event("x.e")
    assert [r.get("name") for r in read_trace(path)][1:] == [
        "x.a", "x.d", "x.b", "x.c", "x.e"]
    later = PendingTimer()
    tr._write({"kind": "span", "name": "x.f", "dev_dur": later})
    tr.close()                                 # waits, then writes
    recs = read_trace(path)
    assert [r["dev_dur"] for r in recs if "dev_dur" in r] == [0.25, 0.25]


def test_only_a_device_timer_is_read_when_written(tmp_path):
    class Clock:
        def seconds(self):
            raise AssertionError("called")

        def __str__(self):
            return "clock"

    path = str(tmp_path / "t.jsonl")
    with EventTrace(path) as tr:
        tr.event("x.y", c=Clock())
    assert read_trace(path)[1]["fields"] == {"c": "clock"}


@pytest.mark.time_limit(180)  # above its child's timeout=120
def test_an_exit_without_close_writes_the_buffer(tmp_path):
    """A session never disabled (an exception escaped, say) is written
    out when the interpreter exits."""
    import subprocess
    import sys

    path = str(tmp_path / "x.jsonl")
    code = (
        "from distkeras_tpu_torch import obs\n"
        f"obs.enable(trace_path={path!r})\n"
        "obs.event('serving.submit', request_id=1)\n"
        "raise SystemExit(3)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, timeout=120)
    assert out.returncode == 3, out.stderr
    assert [r.get("name") for r in read_trace(path)] == [
        None, "serving.submit"]


def test_a_torn_batch_leaves_a_parseable_prefix(tmp_path):
    path = str(tmp_path / "t.jsonl")
    tr = EventTrace(path)
    for i in range(3):
        tr.event("x.y", i=i)
    tr.flush()
    tr.close()
    with open(path, "a") as f:                  # a crash mid-batch
        f.write(json.dumps({"kind": "event", "name": "x.y", "t": 1.0})
                + "\n" + '{"kind": "ev')
    recs = read_trace(path)
    assert [r.get("fields", {}).get("i") for r in recs[1:4]] == [0, 1, 2]
    assert len(recs) == 5
    assert len(tail_trace(path, 10)) == 5


def test_live_trace_tail_flushes_the_session(tmp_path):
    import urllib.request

    path = str(tmp_path / "t.jsonl")
    with obs.session(trace_path=path, serve_port=0) as sess:
        obs.event("serving.submit", request_id=1)
        url = f"http://127.0.0.1:{sess.server.port}/trace/tail?n=5"
        with urllib.request.urlopen(url, timeout=10) as resp:
            names = [json.loads(line).get("name")
                     for line in resp.read().decode().splitlines()]
    assert "serving.submit" in names


# ----------------------------------------------- spans where work is


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_records_forward_backward_update(tmp_path, grad_accum):
    cfg = ttfm.TransformerConfig(**KW)
    params = ttfm.init_params(0, cfg, "cpu")
    opt = Optimizer("adamw", 1e-3)
    step = ttfm.make_train_step(cfg, opt, grad_accum=grad_accum)
    carry = (params, opt.init(params))
    shape = (2, 17) if grad_accum == 1 else (grad_accum, 2, 17)
    data = torch.randint(0, 64, shape)
    path = str(tmp_path / "t.jsonl")
    with obs.session(trace_path=path):
        carry, _ = step(carry, data)
    got = [(r["name"], r["fields"].get("micro")) for r in
           sorted(spans_of(path), key=lambda r: r["t0"])]
    pairs = [("train.forward", None), ("train.backward", None)]
    if grad_accum > 1:
        pairs = [(n, i) for i in range(grad_accum)
                 for n in ("train.forward", "train.backward")]
    assert got == pairs + [("train.update", None)]
    assert all(r["dev_dur"] is None for r in spans_of(path))


def test_profile_dir_trace_shows_the_train_spans(tmp_path):
    cfg = ttfm.TransformerConfig(**KW)
    tokens = np.random.default_rng(0).integers(0, 64, (8, 17)).astype(
        np.int32)
    t = tlm.LMTrainer(cfg, batch_size=2, profile_dir=str(tmp_path / "p"),
                      profile_steps=1, device="cpu")
    with obs.session(trace_path=str(tmp_path / "t.jsonl")):
        t.train(tokens)
    assert t.profile_path.endswith("lm_trainer_rounds_2-2.trace.json")
    with open(t.profile_path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"train.forward", "train.backward", "train.update"} <= names


def test_serving_turn_splits_into_dispatch_and_readback(tmp_path):
    cfg = ttfm.TransformerConfig(**KW)
    eng = ContinuousBatcher(ttfm.init_params(0, cfg, "cpu"), cfg, lanes=2,
                            prompt_buckets=(8, 32), device="cpu")
    path = str(tmp_path / "t.jsonl")
    rng = np.random.default_rng(1)
    with obs.session(trace_path=path):
        for n in (3, 12):
            eng.submit(rng.integers(0, 64, n), 4)
        while eng.running():
            eng.step(2)
    recs = spans_of(path)
    by_id = {r["id"]: r for r in recs}
    steps = [r for r in recs if r["name"] == "serving.step"]
    for name in ("serving.dispatch", "serving.readback"):
        kids = [r for r in recs if r["name"] == name]
        assert len(kids) == len(steps)
        for r in kids:
            parent = by_id[r["parent"]]
            assert parent["name"] == "serving.step"
            assert r["fields"]["n"] == parent["fields"]["n"] == 2
    for st in steps:
        kids = [r for r in recs if r["parent"] == st["id"]]
        assert sum(r["dur"] for r in kids) <= st["dur"]
    admits = [r["fields"] for r in recs if r["name"] == "serving.admit"]
    assert sorted((f["tokens"], f["bucket"]) for f in admits) == [
        (2, 8), (11, 32)]


def test_chunked_admission_counts_real_tokens(tmp_path):
    cfg = ttfm.TransformerConfig(**KW)
    eng = ContinuousBatcher(ttfm.init_params(0, cfg, "cpu"), cfg, lanes=1,
                            prompt_buckets=(8, 16), prefill_chunk=16,
                            device="cpu")
    path = str(tmp_path / "t.jsonl")
    prompt = np.random.default_rng(2).integers(0, 64, 40)
    with obs.session(trace_path=path):
        eng.submit(prompt, 2)
        while eng.running():
            eng.step(1)
    recs = spans_of(path)
    chunks = [r["fields"] for r in recs
              if r["name"] in ("serving.admit", "serving.admit_chunk")]
    assert all(0 < f["tokens"] <= f["bucket"] for f in chunks)
    assert len(chunks) >= 2


@pytest.mark.time_limit(180)  # above its child's timeout=120
def test_chaos_kill_flushes_the_trace_before_the_process_dies(tmp_path):
    """A host-kill fault exits without cleanup: the trace's buffered
    records, its ``chaos.fault`` event among them, are written first."""
    import subprocess
    import sys

    path = str(tmp_path / "k.jsonl")
    code = (
        "from distkeras_tpu_torch import obs\n"
        "from distkeras_tpu_torch.resilience import chaos\n"
        f"obs.enable(trace_path={path!r})\n"
        "obs.event('serving.submit', request_id=1)\n"
        "with chaos.FaultPlan().kill('serving.step', rc=7):\n"
        "    chaos.probe('serving.step')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, timeout=120)
    assert out.returncode == 7, out.stderr
    names = [r.get("name") for r in read_trace(path)]
    assert names[0] is None and names[1:] == ["serving.submit",
                                               "chaos.fault"]

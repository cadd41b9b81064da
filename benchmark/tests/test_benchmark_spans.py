"""The program's spans as per-layer readings: the decode split into
dispatch and wait, and admission's padding."""

from __future__ import annotations

import types

import bench_tiny
import pytest

from harness import core, trace


def span(name, t0, dur, **fields):
    return {"kind": "span", "name": name, "t0": t0, "dur": dur,
            "fields": fields}


def reading(name, run_spans):
    mod = {m.NAME: m for m in core.readers()}[name]
    return mod.read(types.SimpleNamespace(spans=run_spans))


def test_decode_split_divides_by_the_steps_each_span_ran():
    run_spans = [span("serving.step", 0.0, 0.030, n=1),
                 span("serving.dispatch", 0.0, 0.010, n=1),
                 span("serving.readback", 0.010, 0.019, n=1),
                 span("serving.step", 1.0, 0.090, n=2),
                 span("serving.dispatch", 1.0, 0.020, n=2),
                 span("serving.readback", 1.02, 0.066, n=2)]
    assert reading("decode_dispatch_ms.serve", run_spans) == \
        pytest.approx(10.0)
    assert reading("decode_wait_ms.serve", run_spans) == pytest.approx(
        85 / 3)
    assert reading("decode_step_ms.serve", run_spans) == pytest.approx(40)


def test_admit_pad_share_over_admissions_and_chunks():
    run_spans = [span("serving.admit", 0, 1, bucket=64, tokens=48),
                 span("serving.admit_chunk", 1, 1, bucket=256, tokens=200),
                 span("serving.step", 2, 1, n=1)]
    assert reading("admit_pad_share.serve", run_spans) == pytest.approx(
        100 * (1 - 248 / 320))


def test_readers_give_nothing_for_a_program_without_the_spans():
    # The parent program: one serving.step span, admissions without
    # ``tokens``.
    run_spans = [span("serving.step", 0, 0.03, n=1),
                 span("serving.admit", 0, 0.01, bucket=64, chunks=1)]
    for name in ("decode_dispatch_ms.serve", "decode_wait_ms.serve",
                 "admit_pad_share.serve"):
        assert reading(name, run_spans) is None


class NoDevice:
    """A capture of no device activity (the CPU run's)."""

    def __init__(self, host):
        pass

    def stop(self):
        pass

    def events(self):
        return []


def test_a_traced_serving_run_reports_the_split(tmp_path, monkeypatch):
    monkeypatch.setattr(trace, "start", NoDevice)
    run = bench_tiny.serve_run(tmp_path, seconds=3)
    run.trace = True
    bench_tiny.drive(run)
    got = run.per_layer()
    step = got["decode_step_ms.serve"]["value"]
    split = (got["decode_dispatch_ms.serve"]["value"]
             + got["decode_wait_ms.serve"]["value"])
    assert 0.8 * step < split <= step
    assert 0 <= got["admit_pad_share.serve"]["value"] < 100

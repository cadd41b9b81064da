"""Reading a profiler trace: busy time, the traced window, the longest
idle gaps with the host operation beside them, and a kernel's share of
its roofline."""

from __future__ import annotations

import json
import types

import bench_tiny
import pytest

from harness import kernels, reckon, trace


def event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_read(tmp_path):
    events = [event("cpu_op", "aten::mm", 0, 50),
              event("cpu_op", "aten::copy_", 60, 30),
              event("kernel", "gemm", 10, 40),
              event("kernel", "gemm", 45, 10),        # overlaps the first
              event("gpu_memcpy", "Memcpy HtoD", 100, 20),
              event("cuda_runtime", "cudaLaunchKernel", 5, 1)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = trace.read(str(path))
    assert got["busy_s"] == pytest.approx(65e-6)      # [10, 55) + [100, 120)
    assert got["window_s"] == pytest.approx(120e-6)   # [0, 120)
    assert got["device_ops"] == [["gemm", pytest.approx(50e-6)],
                                 ["Memcpy HtoD", pytest.approx(20e-6)]]
    assert got["idle_gaps"][0] == ["aten::copy_", pytest.approx(45e-6)]
    assert got["idle_gaps"][1] == ["aten::mm", pytest.approx(10e-6)]


def test_roofline_share():
    least, _ = reckon.attention_bound_s("fwd", 8, 4096, 8, 128, True,
                                        "float32")
    run = types.SimpleNamespace(
        counters={"call": {"b": 8, "l": 4096, "h": 8, "d": 128,
                           "causal": True, "dtype": "float32"}},
        trace_summary={"kernels": [("flash_fwd_f32_kernel<128>",
                                    2 * least * 1e6)] * 4
                       + [("gemm", 1.0)]})
    share = kernels.roofline_share(run, "call", {"fwd": ("flash_fwd",)})
    assert share == pytest.approx(50.0)
    assert kernels.roofline_share(run, "other", {"fwd": ("x",)}) is None
    assert kernels.roofline_share(run, "call", {"fwd": ("absent",)}) is None


def test_summarise_takes_the_window_it_is_given():
    # The device capture records no host operation: its window is the
    # host's clock over the capture.
    got = trace.summarise([event("kernel", "gemm", 10, 40),
                           event("kernel", "gemm", 70, 20)], [],
                          window_s=200e-6)
    assert got["window_s"] == pytest.approx(200e-6)
    assert got["busy_s"] == pytest.approx(60e-6)
    run = types.SimpleNamespace(trace_summary=got)
    assert kernels.idle_share(run) == pytest.approx(70.0)


class FakeProfile:
    """A capture of two device operations, with a gap between them that
    the host's operations (when it records them) fill."""

    def __init__(self, host):
        self.host = host

    def stop(self):
        pass

    def events(self):
        from torch.autograd import DeviceType

        def op(start, end, annotation=False):
            return types.SimpleNamespace(
                name="gemm", device_type=DeviceType.CUDA,
                is_user_annotation=annotation,
                time_range=types.SimpleNamespace(start=start, end=end))
        return [op(0, 10), op(30, 40), op(0, 40, annotation=True)]

    def export_chrome_trace(self, path):
        events = [event("kernel", "gemm", 0, 10),
                  event("kernel", "gemm", 30, 10)]
        if self.host:
            events.append(event("cpu_op", "aten::zero_", 5, 30))
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)


def test_a_traced_run_takes_a_device_capture_then_a_host_one(
        tmp_path, monkeypatch):
    monkeypatch.setattr(trace, "start", FakeProfile)
    run = bench_tiny.train_run(tmp_path)
    run.trace = True
    bench_tiny.drive(run)
    run.read_trace()
    got = run.trace_summary
    # The device capture's window is the host's clock over it, not the
    # span of its events; the gap's label is the host capture's.
    assert got["window_s"] > 40e-6
    assert got["busy_s"] == pytest.approx(20e-6)
    assert got["idle_gaps"][0] == ["aten::zero_", pytest.approx(20e-6)]
    a, b = run.traced_at
    assert 0 < a < b and 0 < run.paused_s <= b - a
    assert run.per_layer()["idle_share.lm_train"]["value"] > 0

"""Reading ``torch.profiler`` captures of part of the measured window:
the device's busy time, the operations that took it, and the idle gaps
labelled by what the host was doing meanwhile.

A traced run takes two captures.  The first records device activity
only, and gives the busy time, the window and the device operations:
recording the host's operations as well costs the host microseconds
an operation, which would show as idle time in a cell whose host paces
the device.  The second, short, records the host's operations too, and
gives only the labels of the longest idle gaps (whose lengths carry
that cost).
"""

from __future__ import annotations

import bisect
import json
import os

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "python_function")


def start(host: bool):
    """Start a capture of device activity (``host``: and of the host's
    operations)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + [ProfilerActivity.CPU] * host
    prof = profile(activities=acts)
    prof.start()
    return prof


def export(prof, out_dir: str, name: str) -> str:
    """Write the chrome trace (after the window: it takes seconds)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.trace.json")
    prof.export_chrome_trace(path)
    return path


def _merge(intervals):
    """Union of ``[(start, end)]`` as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def device_ops(prof) -> list[dict]:
    """The capture's device operations as trace events (``name``,
    ``ts`` and ``dur`` in microseconds), from the profiler's own events:
    the chrome trace of a capture without host activity gives its
    device operations no duration.  Annotations, which span others, are
    left out."""
    from torch.autograd import DeviceType

    return [{"name": e.name, "ts": e.time_range.start,
             "dur": e.time_range.end - e.time_range.start}
            for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.is_user_annotation]


def read(path: str) -> dict:
    """Summarise a chrome trace (see :func:`summarise`)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    return summarise([e for e in events if e.get("cat") in DEVICE_CATS],
                     [e for e in events if e.get("cat") in HOST_CATS])


def summarise(dev: list, host: list, window_s: float | None = None) -> dict:
    """Summarise a capture's device and host operations (trace events).

    Returns ``busy_s`` (the union of device operations' intervals),
    ``window_s`` (the traced window: as given, else from the first
    recorded operation, host or device, to the end of the last),
    ``device_ops`` (``[[name, seconds]]`` by total time, at most 10),
    ``idle_gaps`` (the 10 longest gaps with no device operation, each
    labelled by the host operation that overlapped it most) and
    ``kernels`` (``[(name, dur_us)]`` of every device operation, for
    the per-layer readers)."""
    if not dev:
        return {"busy_s": 0.0, "window_s": window_s or 0.0, "device_ops": [],
                "idle_gaps": [], "kernels": []}
    t0 = min(e["ts"] for e in host + dev)
    t1 = max(e["ts"] + e["dur"] for e in host + dev)
    busy = _merge((e["ts"], e["ts"] + e["dur"]) for e in dev)
    busy_us = sum(e - s for s, e in busy)
    by_name: dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:10]
    host = sorted(host, key=lambda e: e["ts"])
    starts = [e["ts"] for e in host]
    labelled = []
    for length, s, e in gaps:
        best, best_ov = "host idle", 0.0
        for h in host[:bisect.bisect_right(starts, e)]:
            ov = min(e, h["ts"] + h["dur"]) - max(s, h["ts"])
            # The innermost operation wins a tie: it starts later.
            if ov > 0 and ov >= best_ov:
                best, best_ov = h["name"], ov
        labelled.append([best, length / 1e6])
    if window_s is None:
        window_s = (t1 - t0) / 1e6
    return {"busy_s": busy_us / 1e6, "window_s": window_s,
            "device_ops": [[n, us / 1e6] for n, us in top],
            "idle_gaps": labelled,
            "kernels": [(e["name"], e["dur"]) for e in dev]}

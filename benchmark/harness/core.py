"""The harness's common part: finding a cell's files by name, the run's
context that drivers fill in, the per-layer readers, the guard against
JAX, and the result line.

A cell is ``workloads/<name>.json``: ``{"config": <name>, "driver":
<name>, "chips": n, "params": {...}, "limits": {...}}``.  The config is
``configs/<config>.json``, the driver ``drivers/<driver>.py`` (a module
with ``run(ctx)``), and every ``metrics/*.py`` is a per-layer reader
(``NAME``, ``UNIT``, ``MOVES`` and ``read(ctx)``, which returns a number
or None where the cell gives it nothing to read).  Adding a cell, a
configuration or a metric adds files; nothing here changes.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent       # the benchmark folder
FORBIDDEN = ("jax", "jaxlib", "flax", "distkeras_tpu")


def load_json(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no {kind[:-1]} named {name!r} ({path} is "
                         "missing)")
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """Import a harness file by its path (metric files carry dots in
    their names, so they are not importable by name)."""
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    path = ROOT / "drivers" / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no driver named {name!r} ({path} is missing)")
    return load_module(path)


def cells() -> list[str]:
    """Every cell's name, by file name."""
    return sorted(p.stem for p in (ROOT / "workloads").glob("*.json"))


def readers() -> list:
    """Every per-layer reader, by file name."""
    return [load_module(p) for p in sorted((ROOT / "metrics").glob("*.py"))]


def imported_forbidden() -> list[str]:
    """Top-level names of loaded modules that belong to JAX or to the
    JAX package (compared whole: ``distkeras_tpu_torch`` is the port)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


class Run:
    """What one run of one cell knows and reports.

    Drivers set ``e2e`` (end-to-end values by metric name), ``counters``
    (what the per-layer readers read), ``spans`` (obs trace records),
    ``memory_peak_bytes``, ``attempted`` / ``failed``, and add each
    compared number with :meth:`check`; they call :meth:`window_opens`
    when set-up ends, and wrap the traced parts of the window in
    :meth:`traced`."""

    def __init__(self, workload: str, seed: int, seconds: int, trace: bool,
                 out_dir: str, t_start: float, cell: dict | None = None,
                 config: dict | None = None, device: str = "cuda"):
        self.workload = workload
        self.cell = cell or load_json("workloads", workload)
        self.config = config or load_json("configs", self.cell["config"])
        self.device = device
        self.params = self.cell.get("params", {})
        self.limits = self.cell.get("limits", {})
        self.seed = int(seed)
        self.seconds = seconds
        self.trace = trace
        self.out_dir = out_dir
        self.t_start = t_start            # time.time() of the process
        self.setup_s = None
        self.e2e: dict[str, tuple[float, str]] = {}
        self.counters: dict = {}
        self.spans: list[dict] = []
        self.trace_summary: dict | None = None
        self.tracing = self.trace_taken = False
        self.paused_s = 0.0
        self.traced_at = (0.0, 0.0)
        self._captures: dict = {}
        self.memory_peak_bytes = 0
        self.attempted = 0
        self.failed = 0
        self.checks: list[tuple[str, float, float]] = []
        self.phases: list[tuple[str, float]] = []

    # ---------------------------------------------------------- timing
    def mark(self, phase: str) -> None:
        """A set-up phase ends here (reported beside the result, so that
        set-up's parts show)."""
        self.phases.append((phase, time.time() - self.t_start))

    def window_opens(self) -> float:
        """Set-up ends here: the first timed step follows."""
        now = time.time()
        self.setup_s = now - self.t_start
        self.mark("window")
        return time.perf_counter()

    @contextlib.contextmanager
    def traced(self, host: bool = False):
        """Profile the block when this is a ``--trace 1`` run: the
        device's activity (the first such block of a run), or with
        ``host`` the host's operations as well (the first such block;
        it only labels the idle gaps); a plain block otherwise.  The
        block is paused out of the window's accounting (``paused_s``;
        drivers leave out the work done in it while ``tracing`` is set),
        ``traced_at`` spans the run's traced blocks, and the captures
        are read after the window (:meth:`read_trace`)."""
        kind = "host" if host else "device"
        if not self.trace or kind in self._captures:
            yield
            return
        from harness import device
        from harness import trace as tr

        t = time.perf_counter()
        self.tracing = True
        self.trace_taken |= not host
        prof = tr.start(host)
        t_in = time.perf_counter()
        try:
            yield
        finally:
            device.sync(self.device)
            wall = time.perf_counter() - t_in
            prof.stop()
            self.tracing = False
            self._captures[kind] = (prof, wall)
            now = time.perf_counter()
            self.traced_at = (self.traced_at[0] or t, now)
            self.paused_s += now - t

    def read_trace(self) -> None:
        """The device capture's busy time, window and operations; the
        host capture's labelled idle gaps, where there is one."""
        if "device" not in self._captures:
            return
        from harness import trace as tr

        prof, wall = self._captures.pop("device")
        self.trace_summary = tr.summarise(tr.device_ops(prof), [], wall)
        if "host" in self._captures:
            prof, _ = self._captures.pop("host")
            path = tr.export(prof, self.out_dir, "host")
            self.trace_summary["idle_gaps"] = tr.read(path)["idle_gaps"]
            os.remove(path)

    # ----------------------------------------------------- correctness
    def check(self, name: str, value: float) -> None:
        """A compared number, against its limit from the cell's file."""
        limit = self.limits[name]
        self.checks.append((name, float(value), float(limit)))

    @property
    def correct(self) -> bool:
        return within_limits(self.checks)

    # ---------------------------------------------------------- output
    def per_layer(self) -> dict:
        out = {}
        for mod in readers():
            value = mod.read(self)
            if value is not None:
                out[mod.NAME] = {"value": float(value), "unit": mod.UNIT}
        return out

    def summary(self) -> dict:
        """What the result line is made from."""
        self.read_trace()
        return {"setup_s": self.setup_s,
                "e2e": self.e2e, "memory_peak_bytes": self.memory_peak_bytes,
                "attempted": self.attempted, "failed": self.failed,
                "checks": self.checks, "phases": self.phases,
                "reference_s": self.counters.get("reference_s"),
                "per_layer": self.per_layer() if self.trace else {},
                "trace": None if self.trace_summary is None else {
                    k: self.trace_summary[k]
                    for k in ("busy_s", "window_s", "device_ops",
                              "idle_gaps")},
                "forbidden": imported_forbidden()}


def within_limits(checks) -> bool:
    """Correct: some number was compared, and each is within its
    limit."""
    return bool(checks) and all(
        math.isfinite(v) and v <= lim for _, v, lim in checks)


def device_info(peak: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(peak)}


def result_line(part: dict, trace: bool) -> dict:
    """The last line of standard output, from the run's summary."""
    checks = part["checks"]
    correct = within_limits(checks)
    if trace:
        metrics = part["per_layer"]
    else:
        metrics = {k: {"value": v, "unit": u}
                   for k, (v, u) in part["e2e"].items()}
        metrics["setup_s"] = {"value": part["setup_s"], "unit": "s"}
    line = {"correct": correct, "attempted": part["attempted"],
            "failed": part["failed"], "metrics": metrics,
            "device": device_info(part["memory_peak_bytes"])}
    if trace:
        t = part["trace"]
        line["device"]["busy_s"] = t["busy_s"]
        line["device"]["window_s"] = t["window_s"]
        line["breakdown"] = {"device_ops": t["device_ops"],
                             "idle_gaps": t["idle_gaps"]}
    line["setup_phases"] = part["phases"]
    line["reference_s"] = part["reference_s"]
    line["checks"] = {n: {"value": v, "limit": lim}
                      for n, v, lim in checks}
    return line


def print_result(line: dict) -> None:
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)

"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell's file (``workloads/<cell>.json``)
names its configuration, its driver and its traffic; the driver makes
weights and data on the card from ``--seed``, warms up the cell's own
shapes, measures for ``--seconds``, checks what the timed path produced
against the plain reference, and the last line of standard output is
one JSON object (``--trace 0``: the end-to-end metrics; ``--trace 1``:
the per-layer ones, with the device's busy time and a breakdown).

No card, too few cards, or JAX in the process: a non-zero exit and no
result.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
CHECKOUT = BENCH.parent
sys.path[:0] = [str(BENCH), str(CHECKOUT)]

from harness import core  # noqa: E402


def _args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _environment() -> None:
    """Caches inside the checkout, at fixed paths; no library loads JAX
    on its own."""
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / ".cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CHECKOUT / ".cache"
                                             / "torch_extensions")


def _need_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark measures the card "
                         "and reports nothing without one")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"the cell needs {n} cards, "
                         f"{torch.cuda.device_count()} are visible")


def _guard(found) -> None:
    if found:
        raise SystemExit(f"JAX is loaded in the measuring process: "
                         f"{', '.join(found)}")


def run_cell(a, out_dir: str) -> dict:
    """The driver on this card; returns its summary."""
    run = core.Run(a.workload, a.seed, a.seconds, bool(a.trace), out_dir,
                   T_START)
    _need_cards(int(run.cell.get("chips", 1)))
    core.driver(run.cell["driver"]).run(run)
    return run.summary()


def main(argv=None) -> int:
    a = _args(argv)
    _environment()
    out_dir = tempfile.mkdtemp(prefix="bench_")
    try:
        summary = run_cell(a, out_dir)
        _guard(core.imported_forbidden())
        core.print_result(core.result_line(summary, bool(a.trace)))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

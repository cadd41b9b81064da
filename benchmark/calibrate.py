"""Readings that the limits of ``correct`` are set from: a cell's
control (the reference in the precision below the configuration's, or
the program's own lower-precision path) and the faults its driver can
plant, on several seeds at the cell's own size.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3

One JSON line a seed: ``{"seed": n, <reading>: {<number>: value}}``.
The driver's ``calibrate(run)`` gives the readings; the program's own
readings come from the benchmark's runs.  Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import core  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=int, default=8)
    a = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    for seed in (int(s) for s in a.seeds.split(",")):
        with tempfile.TemporaryDirectory() as out:
            run = core.Run(a.workload, seed, a.seconds, False, out,
                           time.time())
            readings = core.driver(run.cell["driver"]).calibrate(run)
        print(json.dumps({"seed": seed, **readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

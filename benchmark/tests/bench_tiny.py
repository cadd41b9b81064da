"""Tiny versions of the benchmark's cells, for the CPU tests: the
configuration's widths cut down, the traffic shortened; the cell's
limits are kept."""

from __future__ import annotations

import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import core  # noqa: E402

LM = {"vocab_size": 256, "d_model": 64, "n_heads": 4, "n_layers": 2,
      "d_ff": 128}


def lm_config() -> dict:
    return dict(core.load_json("configs", "lm_d1024"), **LM)


def train_run(tmp, seed: int = 2 ** 31 + 7, seconds: int = 1) -> core.Run:
    cell = core.load_json("workloads", "lm_d1024.train_s4096")
    cell["params"].update(batch=4, seq=32, max_len=33, row_blocks=8)
    return core.Run("lm_d1024.train_s4096", seed, seconds, False, str(tmp),
                    time.time(), cell=cell, config=lm_config(),
                    device="cpu")


def serve_run(tmp, seed: int = 2 ** 31 + 5, seconds: int = 1) -> core.Run:
    cell = core.load_json("workloads", "lm_d1024.serve_c128")
    cell["params"].update(
        max_len=96, lanes=6, clients=6, buckets=[8, 16, 64],
        prompt={"median": 12, "sigma": 0.8, "min": 2, "max": 64},
        output={"median": 8, "sigma": 0.6, "min": 2, "max": 30})
    return core.Run("lm_d1024.serve_c128", seed, seconds, False, str(tmp),
                    time.time(), cell=cell, config=lm_config(),
                    device="cpu")


def drive(run: core.Run) -> core.Run:
    core.driver(run.cell["driver"]).run(run)
    return run

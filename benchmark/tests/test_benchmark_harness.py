"""The harness is driven by data: a cell, a configuration and a
per-layer metric added as new files are found by name and run, with no
edit to a file that exists.  A run without a card fails and prints no
result."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

import bench_tiny

BENCH = bench_tiny.BENCH
ROOT = BENCH.parent

DUMMY_METRIC = '''"""A metric added as a file: the steps the window ran."""

NAME, UNIT, MOVES = "steps.dummy", "steps", "train_tokens_per_s"


def read(run):
    return run.counters.get("lm_train.steps")
'''

PROBE = r'''
import json, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from harness import core
run = core.Run("dummy.train", 2 ** 31 + 3, 1, False, sys.argv[3],
               time.time(), device="cpu")
core.driver(run.cell["driver"]).run(run)
run.trace = True                      # read the per-layer metrics
print(json.dumps({"cells": core.cells(),
                  "metrics": [m.NAME for m in core.readers()],
                  "per_layer": run.per_layer(),
                  "correct": run.correct}))
'''


def digest(tree) -> dict:
    return {str(p.relative_to(tree)): hashlib.sha256(p.read_bytes()
                                                     ).hexdigest()
            for p in sorted(tree.rglob("*")) if p.is_file()}


def test_a_cell_config_and_metric_added_as_files(tmp_path):
    copy = tmp_path / "benchmark"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns(
        "__pycache__"))
    before = digest(copy)
    (copy / "configs" / "dummy_lm.json").write_text(json.dumps(
        bench_tiny.lm_config()))
    cell = json.loads((copy / "workloads" / "lm_d1024.train_s4096.json"
                       ).read_text())
    cell["config"] = "dummy_lm"
    cell["params"].update(batch=4, seq=32, max_len=33, row_blocks=8)
    (copy / "workloads" / "dummy.train.json").write_text(json.dumps(cell))
    (copy / "metrics" / "steps.dummy.py").write_text(DUMMY_METRIC)
    out = subprocess.run(
        [sys.executable, "-c", PROBE, str(copy), str(ROOT), str(tmp_path)],
        capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert "dummy.train" in got["cells"]
    assert "steps.dummy" in got["metrics"]
    assert got["per_layer"]["steps.dummy"]["value"] >= 1
    assert got["correct"]
    after = digest(copy)
    assert {k: v for k, v in after.items() if k in before} == before


def test_no_card_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "lm_d1024.train_s4096", "--seed", str(2 ** 31 + 1), "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
        env=env, cwd=ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "lm_d1024.serve_c128", "--seed", "5", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_each_per_layer_metric_has_its_reader():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    found = {m.NAME: (m.UNIT, m.MOVES) for m in bench_tiny.core.readers()}
    for m in spec["per_layer"]:
        assert found.get(m["name"]) == (m["unit"], m["moves"]), m["name"]


def test_serving_reports_its_tail_per_layer(tmp_path):
    run = bench_tiny.drive(bench_tiny.serve_run(tmp_path))
    assert set(run.e2e) == {"serve_tokens_per_s"}
    run.trace = True
    assert run.per_layer()["ttft_p95_ms.serve"]["value"] > 0

"""Each cell's control comes out as not correct, on the card, at a size
a test run holds (full widths, fewer rows, lanes and seconds): the LM
training reference with TF32 products, and the serving engine on the
program's own int8 path (int8 weights and KV cache).  The training
fault "half of the batch left out" fails too.  Run on the card:

    python -m pytest -m cuda benchmark/tests/test_benchmark_controls.py
"""

from __future__ import annotations

import time

import bench_tiny  # noqa: F401  (puts the benchmark on the path)
import pytest

from harness import core

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def fails(numbers: dict, limits: dict) -> list:
    return [n for n in limits if numbers[n] > limits[n]]


def test_lm_training_control_and_fault(card, tmp_path):
    from drivers import lm_train

    cell = core.load_json("workloads", "lm_d1024.train_s4096")
    cell["params"].update(batch=2, seq=512, max_len=513, row_blocks=4)
    run = core.Run("lm_d1024.train_s4096", 2 ** 31 + 41, 1, False,
                   str(tmp_path), time.time(), cell=cell)
    got = lm_train.calibrate(run)
    assert fails(got["control_tf32"], cell["limits"])
    assert fails(got["fault_half_batch"], cell["limits"])


def test_serving_control(card, tmp_path):
    from drivers import lm_serve

    cell = core.load_json("workloads", "lm_d1024.serve_c128")
    cell["params"].update(lanes=16, clients=16)
    run = core.Run("lm_d1024.serve_c128", 2 ** 31 + 43, 6, False,
                   str(tmp_path), time.time(), cell=cell)
    got = lm_serve.calibrate(run)
    assert fails(got["control_int8"], cell["limits"])
    assert not fails(got["program"], cell["limits"])

"""What decides ``correct`` catches the faults a cell can have: the
rest of a run is driven (on the CPU, at a tiny size) with the timed
path broken underneath, and ``correct`` comes out false.  The sound
run beside them comes out true."""

from __future__ import annotations

import bench_tiny
import pytest
import torch


def test_training_sound(tmp_path):
    assert bench_tiny.drive(bench_tiny.train_run(tmp_path)).correct


def test_training_step_leaves_the_state_unchanged(tmp_path, monkeypatch):
    from distkeras_tpu_torch.trainers.optim import Optimizer

    update = Optimizer.update

    def undone(self, params, state, norm_fn=None):
        keep = [p.detach().clone() for p in state.leaves]
        update(self, params, state, norm_fn)
        with torch.no_grad():
            for p, k in zip(state.leaves, keep):
                p.copy_(k)

    monkeypatch.setattr(Optimizer, "update", undone)
    run = bench_tiny.drive(bench_tiny.train_run(tmp_path))
    assert not run.correct
    assert dict((n, v) for n, v, _ in run.checks)["change3_gap"] == \
        pytest.approx(1.0)


def test_training_on_half_the_batch(tmp_path, monkeypatch):
    from distkeras_tpu_torch.trainers.lm import LMTrainer

    host_block = LMTrainer._host_block

    def half(self, tokens, segments, rows, feed, b):
        block, seg = host_block(self, tokens, segments, rows, feed, b)
        return block[: len(block) // 2], seg

    monkeypatch.setattr(LMTrainer, "_host_block", half)
    assert not bench_tiny.drive(bench_tiny.train_run(tmp_path)).correct


def test_serving_sound(tmp_path):
    assert bench_tiny.drive(bench_tiny.serve_run(tmp_path)).correct


def test_serving_alters_a_token_where_it_is_produced(tmp_path,
                                                     monkeypatch):
    from distkeras_tpu_torch.serving.lanes import ContinuousBatcher

    pick = ContinuousBatcher._pick

    def altered(self, logits, draw_lanes, hpos):
        return (pick(self, logits, draw_lanes, hpos) + 1) % logits.shape[-1]

    monkeypatch.setattr(ContinuousBatcher, "_pick", altered)
    assert not bench_tiny.drive(bench_tiny.serve_run(tmp_path)).correct

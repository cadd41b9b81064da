"""The port's Supervisor (``distkeras_tpu_torch/resilience/supervisor.py``)
against the reference's contract (tests/test_resilience.py), on the CPU.

Resume correctness is *bit for bit*: an injected kill at round N
followed by the Supervisor's auto-resume reproduces the uninterrupted
run's loss trajectory and lands on identical parameters (the port's
steps are deterministic on the CPU, so the weights are held exactly).
The backoff schedule equals the JAX package's ``Supervisor`` for the
same seed.
"""

import threading
import time
import types

import numpy as np
import pytest
import torch

import distkeras_tpu_torch as dkt
from distkeras_tpu_torch.models.transformer import named_leaves
from distkeras_tpu_torch.resilience import (FaultInjected, FaultPlan,
                                            Preempted, Supervisor)
from tests.helpers import make_blobs

COMMON = dict(loss="sparse_categorical_crossentropy",
              worker_optimizer="sgd", learning_rate=0.05,
              batch_size=16, num_epoch=2, device="cpu")  # 16 rounds


def mlp():
    return dkt.zoo.MLP(16, (32,), 4, seed=0)


def weights(m):
    return [p.detach().clone() for p in m.parameters()]


def blobs():
    x, y = make_blobs(n=128)
    return dkt.Dataset.from_arrays(x, y)


def durable(tmp_path, every=1, **kw):
    return dkt.SingleTrainer(mlp(), checkpoint_dir=str(tmp_path / "c"),
                             checkpoint_every=every,
                             checkpoint_backend="pickle", **COMMON, **kw)


def test_supervisor_requires_durable_trainer(tmp_path):
    with pytest.raises(ValueError, match="checkpoint_dir"):
        Supervisor(dkt.SingleTrainer(mlp(), **COMMON))
    with pytest.raises(ValueError, match="checkpoint_every"):
        Supervisor(dkt.SingleTrainer(
            mlp(), checkpoint_dir=str(tmp_path / "c"), **COMMON))
    unseeded = durable(tmp_path, shuffle=True)
    with pytest.raises(ValueError, match="fixed seed"):
        Supervisor(unseeded)
    with pytest.raises(ValueError, match="max_retries"):
        Supervisor(durable(tmp_path), max_retries=-1)
    with pytest.raises(ValueError, match="backoff"):
        Supervisor(durable(tmp_path), backoff=2.0, max_backoff=1.0)


def test_backoff_matches_jax_supervisor():
    """The seeded exponential backoff with jitter is the reference's,
    draw for draw."""
    from distkeras_tpu.resilience.supervisor import Supervisor as JSup

    stub = types.SimpleNamespace(checkpoint_dir="/x", checkpoint_every=1,
                                 shuffle=False, seed=None)
    for seed, kw in ((0, {}), (7, dict(backoff=0.1, backoff_factor=3.0,
                                        max_backoff=2.0, jitter=0.9))):
        ours = Supervisor(stub, seed=seed, **kw)
        ref = JSup(stub, seed=seed, **kw)
        assert [ours.backoff_for(k) for k in range(1, 9)] == \
            [ref.backoff_for(k) for k in range(1, 9)]


@pytest.mark.chaos
@pytest.mark.parametrize("kill_round,via_signal", [(7, False), (6, True)])
def test_kill_at_step_then_autoresume_bit_for_bit(tmp_path, kill_round,
                                                  via_signal):
    """Injected kill at a round -> the Supervisor auto-resumes -> final
    parameters and the resumed loss trajectory identical to an
    uninterrupted run.  Exception kills die BEFORE the round commits
    (resume replays it); a graceful SIGTERM forces a synchronous
    checkpoint of the preempted round first (resume continues one round
    later) — even at a round the periodic cadence would have skipped."""
    ds = blobs()
    straight = dkt.SingleTrainer(mlp(), **COMMON)
    ref = straight.train(ds)

    every = 4 if via_signal else 1  # sigterm: prove the forced sync save
    t = durable(tmp_path, every=every)
    sup = Supervisor(t, max_retries=2, backoff=0.0, max_backoff=0.0,
                     jitter=0.0)
    plan = FaultPlan()
    if via_signal:
        plan.preempt("train.round", at=kill_round, via_signal=True)
    else:
        plan.fail("train.round", at=kill_round)
    with plan:
        out = sup.run(ds)

    for a, b in zip(weights(out), weights(ref)):
        assert torch.equal(a, b)
    resume_at = kill_round if via_signal else kill_round - 1
    assert t.history == straight.history[resume_at:]
    outcomes = [a.outcome for a in sup.attempts]
    assert outcomes == (["preempted", "ok"] if via_signal
                        else ["fault", "ok"])
    if via_signal:
        # 6 is not a multiple of checkpoint_every=4: only the forced
        # preemption save can have committed it.
        assert sup.attempts[1].resumed_from == kill_round
    # run() hands the trainer back as it found it.
    assert t.resume is False and t.preempt_event is None


@pytest.mark.chaos
def test_supervisor_retries_checkpoint_save_fault(tmp_path):
    t = durable(tmp_path)
    sup = Supervisor(t, max_retries=2, backoff=0.0, max_backoff=0.0,
                     jitter=0.0)
    with FaultPlan().fail("checkpoint.save", at=5):
        sup.run(blobs())
    assert [a.outcome for a in sup.attempts] == ["fault", "ok"]
    assert sup.attempts[1].resumed_from == 4  # durable through round 4


@pytest.mark.chaos
def test_sigterm_interrupts_backoff_immediately(tmp_path):
    """A SIGTERM arriving during the backoff window cuts the sleep short
    (the backoff waits on the preempt event), and the next attempt's
    first round boundary runs the forced-sync-checkpoint path."""
    t = durable(tmp_path)
    sup = Supervisor(t, max_retries=2, backoff=30.0, max_backoff=30.0,
                     jitter=0.0, handle_sigterm=False)
    threading.Timer(0.5, sup.preempt_event.set).start()
    t0 = time.monotonic()
    with FaultPlan().fail("train.round", at=1):
        sup.run(blobs())
    elapsed = time.monotonic() - t0
    assert elapsed < 15.0, (
        f"backoff was not interrupted: run took {elapsed:.1f}s against "
        "a 30s backoff")
    outcomes = [a.outcome for a in sup.attempts]
    # fault -> (interrupted backoff) -> preempted at the next round
    # boundary -> clean resumed finish.
    assert outcomes == ["fault", "preempted", "ok"], outcomes


@pytest.mark.chaos
def test_supervisor_exhausts_retries_and_reraises(tmp_path):
    t = durable(tmp_path)
    sup = Supervisor(t, max_retries=1, backoff=0.0, max_backoff=0.0,
                     jitter=0.0)
    with FaultPlan().fail("train.round", at=1, times=None):
        with pytest.raises(FaultInjected):
            sup.run(blobs())
    assert [a.outcome for a in sup.attempts] == ["fault", "fault"]


@pytest.mark.chaos
def test_supervisor_preemption_budget(tmp_path):
    """Preemptions are resumable lifecycle events with their own budget:
    past ``max_preemptions`` the Preempted re-raises."""
    t = durable(tmp_path)
    sup = Supervisor(t, max_preemptions=0, handle_sigterm=False)
    with FaultPlan().preempt("train.round", at=3):
        with pytest.raises(Preempted):
            sup.run(blobs())
    assert [a.outcome for a in sup.attempts] == ["preempted"]


def test_supervisor_refuses_a_store_that_moved_backward(tmp_path):
    """Between attempts the latest valid step must never fall: a store
    that lost committed state is not resumed from."""
    import shutil

    t = durable(tmp_path)
    sup = Supervisor(t, max_retries=3, backoff=0.0, max_backoff=0.0,
                     jitter=0.0)

    class LoseState(FaultPlan):
        def probe(self, site, step=None):
            if site == "train.round" and step == 3 and sup.attempts:
                for e in (tmp_path / "c").iterdir():
                    shutil.rmtree(e)
            super().probe(site, step)

    # Round 3 faults twice: the first attempt commits rounds 1-2, the
    # second finds the store emptied at round 3.
    with LoseState().fail("train.round", at=3, times=2):
        with pytest.raises(RuntimeError, match="moved backward"):
            sup.run(blobs())


@pytest.mark.chaos
def test_supervisor_wraps_lm_trainer(tmp_path):
    """The Supervisor is trainer-family-wide: LMTrainer with dropout (its
    generator state rides the checkpoint) resumes through an injected
    kill and a SIGTERM to the straight run's params, bit for bit."""
    rows = np.random.default_rng(0).integers(0, 64, (64, 17)).astype(
        np.int32)
    cfg = dkt.TransformerConfig(vocab_size=64, d_model=32, n_heads=2,
                                n_layers=2, d_ff=64, max_len=17,
                                dropout=0.1)
    kw = dict(optimizer="adamw", learning_rate=1e-2, batch_size=8,
              num_epoch=1, seed=3, device="cpu")
    straight = dkt.LMTrainer(cfg, **kw)
    ref = straight.train(rows)
    t = dkt.LMTrainer(cfg, checkpoint_dir=str(tmp_path / "c"),
                      checkpoint_every=2, **kw)
    sup = Supervisor(t, max_retries=2, backoff=0.0, max_backoff=0.0,
                     jitter=0.0)
    with FaultPlan().fail("train.round", at=3).preempt(
            "train.round", at=7, via_signal=True):
        out = sup.run(rows)
    assert [a.outcome for a in sup.attempts] == ["fault", "preempted", "ok"]
    assert [a.resumed_from for a in sup.attempts] == [None, 2, 7]
    assert t.history == straight.history[7:]
    for (n, a), (_, b) in zip(named_leaves(out), named_leaves(ref)):
        assert torch.equal(a, b), n

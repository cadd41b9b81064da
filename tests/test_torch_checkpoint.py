"""The port's checkpoint / resume (``distkeras_tpu_torch/checkpoint.py``,
``trainers/base.py::CheckpointingBase``) against the reference's
contract (tests/test_checkpoint.py, tests/test_resilience.py), on the
CPU.

- The manager: roundtrip (bfloat16 and int leaves, nested containers,
  Python values, placement on the template's device and dtype), missing
  step, ``max_to_keep``, refusal to overwrite, the backends' names, the
  ``checkpoint.save`` chaos probe; the sharded backend against the
  reference's real orbax manager on one table of operations (exact
  leaves), its asynchronous contract (save returns with the write in
  flight, in-place updates after it do not reach the step, a writer's
  error is re-raised and commits nothing, a killed writer leaves no
  valid step).
- Resume is *bit for bit*: a run stopped by a fault and resumed from its
  latest checkpoint ends with exactly the straight run's weights, and
  its history is exactly the straight run's tail — for SingleTrainer,
  ADAG, DynSGD, AEASGD, EAMSGD, DOWNPOUR, LMTrainer (dropout, EMA,
  ``grad_accum``, ``device_data``) and LoRATrainer; and at world 2 over
  gloo (``zero=1``, ``zero=3``, ``compress="int8"``, the replica family,
  the LM's per-rank dropout generators), under the pickle backend and
  the sharded one (no gather inside a save, each rank's own pieces in
  its file, the assembled step equal to the pickle step bit for bit).
- Across packages: a port run resumed at round k equals the JAX
  package's straight run, weights carried across, at the tolerances of
  tests/test_torch_keras_trainers.py (1e-4 / 1e-5) and
  tests/test_torch_train.py (1e-4); the port's world-2 ``zero=1``
  sharded resume equals the JAX package's orbax resume of
  tests/test_zero1.py's configuration (histories rtol 2e-4, weights
  1e-4).
- The refusals: each ``ValueError`` of ``_setup_checkpointing``, a
  populated directory without ``resume``, the ``steps_per_call``
  mismatch, resume past the end, a final round that is also periodic.
"""

import os

import numpy as np
import pytest
import torch

import distkeras_tpu_torch as dkt
from distkeras_tpu_torch.checkpoint import CheckpointManager
from distkeras_tpu_torch.models.transformer import named_leaves
from distkeras_tpu_torch.resilience.chaos import FaultInjected, FaultPlan
from tests.helpers import make_blobs

KERAS = dict(loss="sparse_categorical_crossentropy", batch_size=16,
             device="cpu")
LM_CFG = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
              max_len=17)


def mlp(seed=0):
    return dkt.zoo.MLP(16, (32,), 4, seed=seed)


def module_weights(m):
    return [p.detach().clone() for p in m.parameters()]


def tree_weights(tree):
    return [t.detach().clone() for _, t in named_leaves(tree)]


def assert_bitwise(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ------------------------------------------------------------- the manager


def test_manager_roundtrip(tmp_path):
    state = {"a": torch.arange(12.0).reshape(3, 4),
             "b": [torch.zeros(5, dtype=torch.bfloat16) + 1.5,
                   (torch.arange(3), None)],
             "step": 7, "name": "x"}
    with CheckpointManager(str(tmp_path / "ckpt"), backend="pickle") as mngr:
        assert mngr.backend == "pickle" and mngr.latest_step() is None
        assert mngr.save(state, step=3)
        mngr.wait_until_finished()
        assert mngr.latest_step() == 3 and mngr.valid_steps() == [3]
        template = {"a": torch.zeros((3, 4), dtype=torch.float64),
                    "b": [torch.ones(5, dtype=torch.bfloat16), None]}
        out = mngr.restore(template)
        bare = mngr.restore()
    # Placed by the template: its dtype where it holds a tensor.
    assert out["a"].dtype == torch.float64
    assert torch.equal(out["a"], state["a"].double())
    assert out["b"][0].dtype == torch.bfloat16
    assert torch.equal(out["b"][0], state["b"][0])
    assert torch.equal(out["b"][1][0], state["b"][1][0])
    assert out["b"][1][1] is None
    assert out["step"] == 7 and out["name"] == "x"
    # Without a template: CPU tensors of the stored dtype (bf16 is kept
    # as float32, which holds it exactly).
    assert bare["b"][0].dtype == torch.float32
    assert torch.equal(bare["b"][0], state["b"][0].float())


def test_manager_missing_raises(tmp_path):
    with CheckpointManager(str(tmp_path / "empty")) as mngr:
        with pytest.raises(FileNotFoundError):
            mngr.restore({"x": torch.zeros(2)})
        with pytest.raises(FileNotFoundError, match="step 4"):
            mngr.restore(step=4)


def test_manager_max_to_keep_and_refuses_overwrite(tmp_path):
    with CheckpointManager(str(tmp_path / "k"), max_to_keep=2) as mngr:
        for s in (1, 2, 3):
            mngr.save({"v": torch.tensor(float(s))}, step=s, force=True)
        mngr.wait_until_finished()  # the default backend saves async
        assert mngr.all_steps() == [2, 3]
        with pytest.raises(ValueError, match="already exists"):
            mngr.save({"v": torch.tensor(9.0)}, step=3, force=True)
        assert float(mngr.restore()["v"]) == 3.0


def test_manager_backends(tmp_path):
    """``"orbax"`` and ``"auto"`` resolve to the sharded backend (named
    ``"orbax"``, as in the reference), ``"pickle"`` stays pickle, an
    unknown name raises."""
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        CheckpointManager(str(tmp_path / "c"), backend="zarr")
    for b, want in (("auto", "orbax"), ("orbax", "orbax"),
                    ("pickle", "pickle")):
        assert CheckpointManager(str(tmp_path / "c"),
                                 backend=b).backend == want
    assert CheckpointManager(str(tmp_path / "c")).backend == "orbax"


def _orbax_ops():
    """One table of manager operations: ``(step, force)`` saves with
    ``max_to_keep=3`` and ``save_interval_steps=2`` (the first save,
    interval skips, ``force``, a step at or below the latest, a forced
    save of a committed step, collection)."""
    return [(1, False), (2, False), (3, False), (3, True), (4, False),
            (2, False), (2, True), (4, False), (4, True), (6, False),
            (7, False), (8, False), (10, False), (12, True), (13, False)]


def _manager_log(mngr, state_of, ops):
    log = []
    for step, force in ops:
        try:
            got = mngr.save(state_of(step), step, force=force)
            mngr.wait_until_finished()
        except ValueError as e:  # orbax: StepAlreadyExistsError(ValueError)
            assert "already exists" in str(e)
            got = "refused"
        log.append((step, force, got, mngr.all_steps(), mngr.latest_step()))
    return log


def test_manager_semantics_match_orbax(tmp_path):
    """The sharded backend against the reference's real orbax manager on
    the same table of operations: what each save returns or refuses,
    ``all_steps`` and ``latest_step`` after it; then a restore of a
    nested tree of f32, int32 and bf16 leaves and Python values, bit for
    bit.  (A refusal is a ValueError on both sides; orbax's is its
    subclass StepAlreadyExistsError.)"""
    import jax
    import jax.numpy as jnp

    import distkeras_tpu as dk

    def jstate(s):
        return {"a": jnp.arange(6.0).reshape(2, 3) * s,
                "b": [jnp.full((3,), s, jnp.int32),
                      (jnp.full((2,), 1.5 * s, jnp.bfloat16), None)],
                "n": s, "f": 0.25 * s}

    def tstate(s):
        return {"a": torch.arange(6.0).reshape(2, 3) * s,
                "b": [torch.full((3,), s, dtype=torch.int32),
                      (torch.full((2,), 1.5 * s, dtype=torch.bfloat16),
                       None)],
                "n": s, "f": 0.25 * s}

    kw = dict(max_to_keep=3, save_interval_steps=2)
    with dk.CheckpointManager(str(tmp_path / "j"), backend="orbax",
                              **kw) as jm:
        want = _manager_log(jm, jstate, _orbax_ops())
        jout = jm.restore(jstate(0))
    with CheckpointManager(str(tmp_path / "t"), backend="orbax",
                           **kw) as tm:
        got = _manager_log(tm, tstate, _orbax_ops())
        tout = tm.restore()
    assert got == want
    assert [s for s, _, r, _, _ in got if r == "refused"] == [2, 4]

    def bits(t, j):  # bf16 -> f32 is exact
        if t.dtype == torch.bfloat16:
            return t.float().numpy(), np.asarray(j, np.float32)
        return t.numpy(), np.asarray(j)

    assert tout["n"] == jout["n"] == 12 and tout["f"] == jout["f"] == 3.0
    assert tout["b"][1][1] is None and jout["b"][1][1] is None
    for t, j in ((tout["a"], jout["a"]), (tout["b"][0], jout["b"][0]),
                 (tout["b"][1][0], jout["b"][1][0])):
        assert str(t.dtype).split(".")[1] == str(j.dtype)
        np.testing.assert_array_equal(*bits(t, j))  # exact
    assert tout["b"][1][0].dtype == torch.bfloat16  # raw 16-bit words


def test_async_save_returns_before_commit(tmp_path, monkeypatch):
    """``save`` returns with the write in flight (held at its fsync): the
    step is not yet listed, an in-place update of the saved tensor after
    the return does not reach the committed bytes, and
    ``wait_until_finished`` commits it."""
    import threading

    gate, entered = threading.Event(), threading.Event()
    real = os.fsync

    def held(fd):
        entered.set()
        assert gate.wait(60)
        real(fd)

    monkeypatch.setattr(os, "fsync", held)
    w = torch.arange(6.0)
    with CheckpointManager(str(tmp_path / "c")) as m:
        assert m.async_save and m.save({"w": w, "n": 1}, step=1)
        assert entered.wait(60)             # the writer is in flight
        assert m.all_steps() == [] and m.latest_step() is None
        w.add_(100.0)                       # the next step, in place
        gate.set()
        m.wait_until_finished()
        assert m.all_steps() == [1] and m.valid_steps() == [1]
        out = m.restore()
    assert torch.equal(out["w"], torch.arange(6.0)) and out["n"] == 1


def test_async_save_error_reraised_no_step(tmp_path, monkeypatch):
    """An error in the writer is re-raised by ``wait_until_finished`` and
    leaves no committed step and no tmp dir (no fallback to pickle); the
    next save lands."""
    real = os.fsync

    def broken(fd):
        raise OSError("disk gone")

    d = tmp_path / "c"
    with CheckpointManager(str(d)) as m:
        monkeypatch.setattr(os, "fsync", broken)
        assert m.save({"w": torch.ones(3)}, step=1)
        with pytest.raises(OSError, match="disk gone"):
            m.wait_until_finished()
        assert m.all_steps() == [] and os.listdir(d) == []
        monkeypatch.setattr(os, "fsync", real)
        m.save({"w": torch.ones(3)}, step=1)
        m.wait_until_finished()
        assert m.valid_steps() == [1]


def test_killed_writer_leaves_no_valid_step(tmp_path):
    """A process SIGKILLed while its writer is in flight leaves no valid
    (or committed) step, and a new manager on the directory saves."""
    import subprocess
    import sys

    d = str(tmp_path / "c")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import os, sys, time\n"
        f"sys.path.insert(0, {repo!r})\n"
        "import torch\n"
        "from distkeras_tpu_torch.checkpoint import CheckpointManager\n"
        "def held(fd):\n"
        "    print('inflight', flush=True)\n"
        "    time.sleep(600)\n"
        "os.fsync = held\n"
        f"m = CheckpointManager({d!r})\n"
        "m.save({'w': torch.arange(1000.0)}, step=1)\n"
        "time.sleep(600)\n")
    child = subprocess.Popen([sys.executable, "-c", code],
                             stdout=subprocess.PIPE, text=True)
    try:
        assert child.stdout.readline().strip() == "inflight"
    finally:
        child.kill()
        child.wait(30)
    with CheckpointManager(d) as m:
        assert m.all_steps() == [] and m.valid_steps() == []
        assert os.listdir(d) == [".tmp.1"]  # what the kill left
        m.save({"w": torch.arange(3.0)}, step=1)
        m.wait_until_finished()
        assert m.valid_steps() == [1] and os.listdir(d) == ["1"]
        assert torch.equal(m.restore()["w"], torch.arange(3.0))


@pytest.mark.chaos
def test_checkpoint_save_fault_injectable(tmp_path):
    with CheckpointManager(str(tmp_path / "c")) as m:
        with FaultPlan().fail("checkpoint.save"):
            with pytest.raises(FaultInjected):
                m.save({"v": torch.tensor(1.0)}, step=1)
        assert m.all_steps() == []
        m.save({"v": torch.tensor(1.0)}, step=1)  # plan gone: save lands
        m.wait_until_finished()
        assert m.all_steps() == [1]


# --------------------------------------------------- resume, bit for bit


def lm_rows(n=24, seed=0):
    return np.random.default_rng(seed).integers(0, 64, (n, 17)).astype(
        np.int32)


def lm_base():
    cfg = dkt.TransformerConfig(**LM_CFG)
    return dkt.init_params(5, cfg, device="cpu")


def keras_run(cls, **kw):
    x, y = make_blobs(n=128)
    ds = dkt.Dataset.from_arrays(x, y)

    def run(**ck):
        t = cls(mlp(), num_epoch=2, **KERAS, **kw, **ck)
        return t, module_weights(t.train(ds))
    return run


def lm_run(cls=dkt.LMTrainer, dropout=0.0, batch_size=4, **kw):
    cfg = dkt.TransformerConfig(**LM_CFG, dropout=dropout)
    rows = lm_rows()

    def run(**ck):
        common = dict(optimizer="adamw", learning_rate=1e-2,
                      batch_size=batch_size, num_epoch=2, device="cpu",
                      seed=3)
        if cls is dkt.LoRATrainer:
            t = cls(cfg, lm_base(), lora_rank=2, **common, **kw, **ck)
        else:
            t = cls(cfg, **common, **kw, **ck)
        out = t.train(rows)
        ws = tree_weights(out)
        if kw.get("ema_decay"):
            ws += tree_weights(t.ema_params)
        return t, ws
    return run


RESUME = {
    "single": lambda: keras_run(dkt.SingleTrainer, worker_optimizer="adam",
                                learning_rate=0.01),
    "single_spc_device_data": lambda: keras_run(
        dkt.SingleTrainer, worker_optimizer="adam", learning_rate=0.01,
        steps_per_call=2, device_data=True, shuffle=True, seed=4),
    "adag": lambda: keras_run(dkt.ADAG, worker_optimizer="adam",
                              learning_rate=0.01, communication_window=2),
    "dynsgd_device_data": lambda: keras_run(
        dkt.DynSGD, worker_optimizer="rmsprop", communication_window=2,
        device_data=True),
    "aeasgd": lambda: keras_run(dkt.AEASGD, learning_rate=0.05, rho=1.0,
                                communication_window=2),
    "eamsgd": lambda: keras_run(dkt.EAMSGD, learning_rate=0.02, rho=1.0,
                                momentum=0.9, communication_window=2),
    "downpour": lambda: keras_run(dkt.DOWNPOUR, learning_rate=0.05,
                                  communication_window=2),
    "lm_dropout_ema_accum": lambda: lm_run(dropout=0.1, ema_decay=0.9,
                                           grad_accum=2, batch_size=2),
    "lm_device_data_shuffle": lambda: lm_run(dropout=0.1, device_data=True,
                                             shuffle=True),
    "lora": lambda: lm_run(dkt.LoRATrainer, dropout=0.1),
}


@pytest.mark.parametrize("name", list(RESUME))
def test_resume_matches_straight_run_bit_for_bit(tmp_path, name):
    """A run stopped by a fault at round 5 and resumed from its latest
    checkpoint (round 4) ends bit-identical to the straight run and
    records exactly the straight run's losses from round 5 on."""
    run = RESUME[name]()
    straight, ref = run()
    ck = dict(checkpoint_dir=str(tmp_path / "c"), checkpoint_every=2)
    with pytest.raises(FaultInjected):
        with FaultPlan().fail("train.round", at=5):
            run(**ck)
    assert max(int(e) for e in os.listdir(tmp_path / "c")
               if e.isdigit()) == 4
    resumed, got = run(resume=True, **ck)
    assert_bitwise(got, ref)
    per_round = getattr(straight, "steps_per_call", 1)  # losses per round
    assert resumed.history == straight.history[4 * per_round:]
    assert len(resumed.history) > 0


# ----------------------------------------------------- across the packages


def test_keras_resume_matches_jax_straight_run(tmp_path):
    """ADAG resumed at round 3 on the port == JAX's straight ADAG (the
    same Keras initial weights), at tests/test_torch_keras_trainers.py's
    tolerance."""
    import distkeras_tpu as dk
    from tests.helpers import make_mlp

    x, y = make_blobs(n=128)
    jm = make_mlp(seed=0)
    init = [np.asarray(v.value) for v in jm.trainable_variables]
    kw = dict(loss="sparse_categorical_crossentropy", worker_optimizer="adam",
              learning_rate=0.01, batch_size=16, communication_window=2,
              num_epoch=2)
    jt = dk.ADAG(jm, num_workers=1, **kw)
    jout = jt.train(dk.Dataset.from_arrays(x, y))

    def port(**ck):
        tm = dkt.zoo.MLP(16, (32,), 4)
        dkt.module_from_keras_numpy(tm, init)
        t = dkt.ADAG(tm, device="cpu", checkpoint_dir=str(tmp_path / "c"),
                     checkpoint_every=1, **kw, **ck)
        return t, t.train(dkt.Dataset.from_arrays(x, y))

    with pytest.raises(FaultInjected):
        with FaultPlan().fail("train.round", at=4):
            port()
    tt, tout = port(resume=True)
    np.testing.assert_allclose(tt.history, jt.history[3:], rtol=1e-4,
                               atol=1e-5)
    got = dkt.keras_numpy_from_module(tout)[0]
    for a, b in zip(got, [np.asarray(v.value)
                          for v in jout.trainable_variables]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_lm_resume_matches_jax_straight_run(tmp_path, devices):
    """LMTrainer resumed at round 2 on the port == JAX's straight
    LMTrainer on a one-device mesh (weights carried across), at
    tests/test_torch_train.py's 1e-4."""
    import jax
    import jax.numpy as jnp

    from distkeras_tpu.models import transformer as jtfm
    from distkeras_tpu.parallel.mesh import MeshSpec, make_mesh
    from distkeras_tpu.trainers import lm as jlm

    jcfg = jtfm.TransformerConfig(**LM_CFG, rope=True)
    tcfg = dkt.TransformerConfig(**LM_CFG, rope=True)
    np_params = jax.tree.map(np.asarray,
                             jtfm.init_params(jax.random.key(0), jcfg))
    rows = lm_rows(20)
    kw = dict(optimizer="adamw", learning_rate=3e-3, batch_size=4,
              shuffle=True, seed=3, num_epoch=1)
    jt = jlm.LMTrainer(jcfg, mesh=make_mesh(MeshSpec(data=1),
                                            devices=devices[:1]), **kw)
    jout = jt.train(rows, params=jax.tree.map(jnp.asarray, np_params))

    def port(**ck):
        t = dkt.LMTrainer(tcfg, device="cpu",
                          checkpoint_dir=str(tmp_path / "c"),
                          checkpoint_every=1, **kw, **ck)
        return t, t.train(rows, params=dkt.params_from_numpy(np_params,
                                                             "cpu"))

    with pytest.raises(FaultInjected):
        with FaultPlan().fail("train.round", at=3):
            port()
    tt, tout = port(resume=True)
    assert len(tt.history) == 3
    np.testing.assert_allclose(tt.history, jt.history[2:], atol=1e-4,
                               rtol=1e-4)
    ref = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path): np.asarray(v) for path, v in
           jax.tree_util.tree_flatten_with_path(jout)[0]}
    for name, t in named_leaves(tout):
        np.testing.assert_allclose(t.detach().numpy(), ref[name],
                                   atol=1e-4, rtol=1e-4, err_msg=name)


# ---------------------------------------------------------------- refusals


def test_setup_refusals(tmp_path):
    """_setup_checkpointing's ValueErrors, in the reference's cases and
    words, on both trainer families."""
    with pytest.raises(ValueError, match="needs a fixed seed"):
        dkt.SingleTrainer(mlp(), checkpoint_dir=str(tmp_path / "c"),
                          resume=True, shuffle=True, device="cpu")
    cfg = dkt.TransformerConfig(**LM_CFG)
    for make in (lambda **k: dkt.SingleTrainer(mlp(), device="cpu", **k),
                 lambda **k: dkt.ADAG(mlp(), device="cpu", **k),
                 lambda **k: dkt.LMTrainer(cfg, device="cpu", **k)):
        for knob in (dict(resume=True), dict(checkpoint_every=5)):
            with pytest.raises(ValueError,
                               match="need a checkpoint_dir"):
                make(**knob)


def test_retrain_into_populated_dir_fails_fast(tmp_path):
    x, y = make_blobs(n=64)
    ds = dkt.Dataset.from_arrays(x, y)
    d = str(tmp_path / "c")
    dkt.SingleTrainer(mlp(), checkpoint_dir=d, **KERAS).train(ds)
    with pytest.raises(ValueError, match="resume=True"):
        dkt.SingleTrainer(mlp(), checkpoint_dir=d, **KERAS).train(ds)
    with pytest.raises(ValueError, match="resume=True"):
        dkt.LMTrainer(dkt.TransformerConfig(**LM_CFG), batch_size=4,
                      device="cpu", checkpoint_dir=d).train(lm_rows())


def test_steps_per_call_mismatch_rejected(tmp_path):
    x, y = make_blobs(n=128)
    ds = dkt.Dataset.from_arrays(x, y)
    d = str(tmp_path / "c")
    dkt.SingleTrainer(mlp(), checkpoint_dir=d, checkpoint_every=2,
                      **KERAS).train(ds)
    with pytest.raises(ValueError, match="steps_per_call=2 implies"):
        dkt.SingleTrainer(mlp(), checkpoint_dir=d, resume=True,
                          steps_per_call=2, num_epoch=2, **KERAS).train(ds)


def test_resume_past_end_returns_trained_model(tmp_path):
    x, y = make_blobs(n=128)
    ds = dkt.Dataset.from_arrays(x, y)
    d = str(tmp_path / "c")
    for cls, kw in ((dkt.SingleTrainer, {}),
                    (dkt.AEASGD, dict(communication_window=2,
                                      learning_rate=0.05))):
        sub = os.path.join(d, cls.__name__)
        ref = cls(mlp(), checkpoint_dir=sub, **KERAS, **kw).train(ds)
        t2 = cls(mlp(), checkpoint_dir=sub, resume=True, **KERAS, **kw)
        out = t2.train(ds)  # nothing left to train; must not raise
        assert_bitwise(module_weights(out), module_weights(ref))
        assert t2.history == []
    cfg = dkt.TransformerConfig(**LM_CFG)
    sub = os.path.join(d, "lm")
    ref = dkt.LMTrainer(cfg, batch_size=4, device="cpu",
                        checkpoint_dir=sub).train(lm_rows())
    t2 = dkt.LMTrainer(cfg, batch_size=4, device="cpu", checkpoint_dir=sub,
                       resume=True)
    assert_bitwise(tree_weights(t2.train(lm_rows())), tree_weights(ref))
    assert t2.history == []


def test_final_round_collides_with_periodic(tmp_path):
    # checkpoint_every divides the round count: the final save must not
    # re-save the same step (a committed step is never overwritten).
    x, y = make_blobs(n=64)
    ds = dkt.Dataset.from_arrays(x, y)
    d = str(tmp_path / "c")
    dkt.SingleTrainer(mlp(), num_epoch=1, checkpoint_dir=d,
                      checkpoint_every=4, **KERAS).train(ds)  # 4 rounds
    assert CheckpointManager(d).all_steps() == [4]


def test_periodic_checkpoints_written(tmp_path):
    x, y = make_blobs(n=256)
    ds = dkt.Dataset.from_arrays(x, y)
    d = str(tmp_path / "ckpt")
    dkt.SingleTrainer(mlp(), num_epoch=1, checkpoint_dir=d,
                      checkpoint_every=5, max_checkpoints=100,
                      **KERAS).train(ds)
    # Every 5 rounds, and the final one (16 rounds).
    assert CheckpointManager(d).all_steps() == [5, 10, 15, 16]


# ----------------------------------------------------- world 2, over gloo

MP_BASE = dict(batch_size=8, num_epoch=2, communication_window=2,
               worker_optimizer="adam", learning_rate=0.01,
               checkpoint_backend="pickle")
MP_CASES = {
    "zero1": dict(kind="keras", trainer="ADAG", kw=dict(MP_BASE, zero=1)),
    "zero3": dict(kind="keras", trainer="ADAG", kw=dict(MP_BASE, zero=3)),
    "int8": dict(kind="keras", trainer="ADAG",
                 kw=dict(MP_BASE, compress="int8")),
    "aeasgd": dict(kind="keras", trainer="AEASGD",
                   kw=dict(batch_size=8, num_epoch=2, learning_rate=0.05,
                           rho=1.0, communication_window=2,
                           checkpoint_backend="pickle")),
    "lm_zero3_dropout": dict(kind="lm", dropout=0.1,
                             kw=dict(batch_size=4, num_epoch=2, zero=3,
                                     optimizer="adamw", learning_rate=1e-2,
                                     checkpoint_backend="pickle")),
    "lm_int8": dict(kind="lm", kw=dict(batch_size=4, num_epoch=2,
                                       compress="int8", optimizer="adamw",
                                       learning_rate=1e-2,
                                       checkpoint_backend="pickle")),
}
# The same runs under the sharded backend (each rank writes its pieces).
SHARDED = ("zero3", "lm_zero3_dropout", "lm_int8")
MP_CASES.update({f"{k}_orbax": dict(MP_CASES[k], kw=dict(
    MP_CASES[k]["kw"], checkpoint_backend="orbax")) for k in SHARDED})


# tests/test_zero1.py::test_lm_zero1_checkpoint_resume's configuration.
ZERO1_CFG = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                 max_len=32)
ZERO1_KW = dict(learning_rate=1e-2, batch_size=16)


def zero1_reference():
    """(config, the JAX package's initial params by key path, the token
    rows) of tests/test_zero1.py's LM checkpoint case."""
    import jax

    from distkeras_tpu.models import transformer as jtfm

    params = jtfm.init_params(jax.random.key(0),
                              jtfm.TransformerConfig(**ZERO1_CFG))
    flat = {jax.tree_util.keystr(p, simple=True, separator="/"):
            np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    rows = np.random.default_rng(0).integers(0, 64, (64, 17)).astype(
        np.int32)
    return ZERO1_CFG, flat, rows


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    from tests.torch_dp_ranks import spawn

    x, y = make_blobs(n=128)
    w = dkt.keras_numpy_from_module(mlp())[0]
    data = dict(x=x, y=y, n_w=np.asarray(len(w)),
                **{f"w{i}": a for i, a in enumerate(w)},
                tokens=lm_rows(24),
                **{"p/" + k: v.numpy() for k, v in named_leaves(lm_base())})
    cases = [dict(name=k, resume={"at": 3, "every": 2}, **c)
             for k, c in MP_CASES.items()]
    # tests/test_zero1.py's sharded resume, the JAX package's params.
    cfg, np_params, rows = zero1_reference()
    data.update(z_tokens=rows, **{"z/" + k: v for k, v in np_params.items()})
    cases.append(dict(name="lm_zero1_orbax_epoch", kind="lm",
                      params="z", tokens="z_tokens", cfg=cfg,
                      resume={"epochs": 1, "every": 1},
                      kw=dict(ZERO1_KW, zero=1, num_epoch=2,
                              checkpoint_backend="orbax")))
    tmp = tmp_path_factory.mktemp("resume2")
    res = spawn(tmp, 2, cases, data, cfg=LM_CFG)
    res["out_dir"] = str(tmp / "out")  # the ranks' checkpoints
    return res


@pytest.mark.multiprocess
@pytest.mark.time_limit(300)  # above SPAWN_TIMEOUT (240 s)
@pytest.mark.parametrize("name", list(MP_CASES))
def test_world2_resume_bit_for_bit(world2, name):
    """Two gloo ranks: the pickle checkpoint gathers ZeRO shards,
    exchange residuals, replicas and dropout generators to rank 0, which
    writes (the ``_orbax`` cases: each rank writes its own pieces); the
    resumed run re-scatters them and ends bit-identical to the straight
    run on both ranks."""
    ranks = world2[name]
    for r, res in enumerate(ranks):
        assert int(res["resumed_from"]) == 2
        straight = {k[9:]: v for k, v in res.items()
                    if k.startswith("straight/")}
        got = {k[8:]: v for k, v in res.items() if k.startswith("resumed/")}
        np.testing.assert_array_equal(got["history"],
                                      straight["history"][2:])
        weights = [k for k in straight if k not in ("history", "eval_loss",
                                                    "probe", "n_models")]
        assert weights
        for k in weights:
            np.testing.assert_array_equal(got[k], straight[k], err_msg=k)
        if r:
            for k in weights:
                np.testing.assert_array_equal(got[k], ranks[0][f"resumed/{k}"])


def _assert_trees_equal(got, want, path="") -> int:
    """Leaf for leaf, bit for bit (containers of the same kind, tensors
    of the same dtype); returns the number of tensor leaves."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        return sum(_assert_trees_equal(got[k], want[k], f"{path}/{k}")
                   for k in want)
    if isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        return sum(_assert_trees_equal(g, w, f"{path}/{i}")
                   for i, (g, w) in enumerate(zip(got, want)))
    if isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype \
            and torch.equal(got, want), path
        return 1
    assert got == want and type(got) is type(want), path
    return 0


@pytest.mark.multiprocess
@pytest.mark.time_limit(300)  # above SPAWN_TIMEOUT (240 s)
@pytest.mark.parametrize("name", SHARDED)
def test_world2_sharded_save_writes_own_pieces(world2, name):
    """Under ``checkpoint_backend="orbax"`` no rank gathers inside a save
    (the pickle twin does), each rank file holds that rank's own pieces
    — its ZeRO shards, its row of the exchange residuals and dropout
    generators — and every step, assembled (``restore()``, no template),
    equals the pickle twin's step leaf for leaf, bit for bit.  Resumed
    on the same layout, a rank reads its own pieces and assembles no
    split leaf."""
    from distkeras_tpu_torch.checkpoint import read_manifest

    for twin, sharded in zip(world2[name], world2[f"{name}_orbax"]):
        assert int(sharded["save_gathers"]) == 0
        assert int(twin["save_gathers"]) > 0
        # The same layout resumes: each rank read its own pieces alone.
        assert int(sharded["restore_assembled"]) == 0
    out = world2["out_dir"]
    pk = CheckpointManager(os.path.join(out, f"ckpt_{name}"),
                           backend="pickle")
    sh = CheckpointManager(os.path.join(out, f"ckpt_{name}_orbax"))
    steps = sh.all_steps()
    assert steps == pk.all_steps() and len(steps) >= 2
    assert sh.valid_steps() == steps
    for step in steps:
        manifest = read_manifest(os.path.join(sh.directory, str(step)))
        assert [f["name"] for f in manifest["files"]] == ["rank0.bin",
                                                          "rank1.bin"]
        split = [leaf for leaf in manifest["leaves"]
                 if {p["rank"] for p in leaf["pieces"]} == {0, 1}]
        # ZeRO shards are flat ranges; the residual and dropout rows index.
        kind = "index" if name == "lm_int8" else "flat"
        assert any(kind in leaf["pieces"][0] for leaf in split), name
        for leaf in manifest["leaves"]:
            size = int(np.prod(leaf["shape"]))
            covered = sum(int(np.prod([b - a for a, b in p["index"]]))
                          if "index" in p else p["flat"][1] - p["flat"][0]
                          for p in leaf["pieces"])
            assert covered == size  # every element written once
        assert _assert_trees_equal(sh.restore(step=step),
                                   pk.restore(step=step)) > 0


@pytest.mark.multiprocess
@pytest.mark.time_limit(300)  # above SPAWN_TIMEOUT (240 s)
def test_world2_zero1_sharded_resume_matches_jax_orbax(world2, tmp_path):
    """tests/test_zero1.py's LM case on both packages: LMTrainer over a
    data axis of 2 with zero=1 and ``checkpoint_backend="orbax"``, one
    epoch checkpointed every round, then resumed for the second.  The
    JAX package runs real orbax; the port two gloo ranks on its sharded
    backend, from the same initial weights (``params_from_numpy``).

    Each package's resume equals its own straight run exactly, and the
    resumed histories agree at rtol 2e-4.  The weights hold the rule of
    8 adamw steps at rate 1e-2 across the packages (the straight runs
    show the same): all but 0.1% of the elements within 1e-4, none off
    by more than 5e-3 — an Adam update moves an element by up to the
    rate, and a near-zero gradient's sign may differ with the summation
    order."""
    import jax

    import distkeras_tpu as dk
    from distkeras_tpu.models import transformer as jtfm
    from distkeras_tpu.parallel.mesh import MeshSpec, make_mesh

    cfg, _, rows = zero1_reference()
    jcfg = jtfm.TransformerConfig(**cfg)
    mesh = make_mesh(MeshSpec(data=2), devices=jax.devices()[:2])

    def jax_run(num_epoch, **ck):
        t = dk.LMTrainer(jcfg, num_epoch=num_epoch, mesh=mesh, zero1=True,
                         **ZERO1_KW, **ck)
        out = t.train(rows, params=jtfm.init_params(jax.random.key(0),
                                                    jcfg))
        return t.history, {
            jax.tree_util.keystr(p, simple=True, separator="/"):
            np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(out)[0]}

    straight_hist, straight = jax_run(2)
    ck = dict(checkpoint_backend="orbax", checkpoint_dir=str(tmp_path / "c"),
              checkpoint_every=1)
    first_hist, _ = jax_run(1, **ck)
    hist, want = jax_run(2, resume=True, **ck)
    assert len(first_hist) == len(hist) == 4
    np.testing.assert_array_equal(hist, straight_hist[4:])
    for k, v in want.items():
        np.testing.assert_array_equal(v, straight[k], err_msg=k)
    for got in world2["lm_zero1_orbax_epoch"]:
        assert int(got["resumed_from"]) == 4
        assert int(got["save_gathers"]) == 0
        np.testing.assert_array_equal(got["resumed/history"],
                                      got["straight/history"][4:])
        np.testing.assert_allclose(got["resumed/history"], hist, rtol=2e-4)
        mine = np.concatenate([got["resumed/p/" + k].ravel() for k in want])
        ref = np.concatenate([v.ravel() for v in want.values()])
        diff = np.abs(mine - ref)
        assert (diff > 1e-4 + 1e-4 * np.abs(ref)).mean() <= 1e-3
        assert diff.max() <= 5e-3

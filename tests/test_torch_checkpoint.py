"""The port's checkpoint / resume (``distkeras_tpu_torch/checkpoint.py``,
``trainers/base.py::CheckpointingBase``) against the reference's
contract (tests/test_checkpoint.py, tests/test_resilience.py), on the
CPU.

- The manager: roundtrip (bfloat16 and int leaves, nested containers,
  Python values, placement on the template's device and dtype), missing
  step, ``max_to_keep``, refusal to overwrite, ``"orbax"``'s error, the
  ``checkpoint.save`` chaos probe.
- Resume is *bit for bit*: a run stopped by a fault and resumed from its
  latest checkpoint ends with exactly the straight run's weights, and
  its history is exactly the straight run's tail — for SingleTrainer,
  ADAG, DynSGD, AEASGD, EAMSGD, DOWNPOUR, LMTrainer (dropout, EMA,
  ``grad_accum``, ``device_data``) and LoRATrainer; and at world 2 over
  gloo (``zero=1``, ``zero=3``, ``compress="int8"``, the replica family,
  the LM's per-rank dropout generators).
- Across packages: a port run resumed at round k equals the JAX
  package's straight run, weights carried across, at the tolerances of
  tests/test_torch_keras_trainers.py (1e-4 / 1e-5) and
  tests/test_torch_train.py (1e-4).
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
    with CheckpointManager(str(tmp_path / "ckpt")) as mngr:
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
        assert mngr.all_steps() == [2, 3]
        with pytest.raises(ValueError, match="already exists"):
            mngr.save({"v": torch.tensor(9.0)}, step=3, force=True)
        assert float(mngr.restore()["v"]) == 3.0


def test_manager_backends(tmp_path):
    with pytest.raises(ImportError, match="JAX library.*backend='pickle'"):
        CheckpointManager(str(tmp_path / "c"), backend="orbax")
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        CheckpointManager(str(tmp_path / "c"), backend="zarr")
    for b in ("auto", "pickle"):
        assert CheckpointManager(str(tmp_path / "c"),
                                 backend=b).backend == "pickle"


@pytest.mark.chaos
def test_checkpoint_save_fault_injectable(tmp_path):
    with CheckpointManager(str(tmp_path / "c")) as m:
        with FaultPlan().fail("checkpoint.save"):
            with pytest.raises(FaultInjected):
                m.save({"v": torch.tensor(1.0)}, step=1)
        assert m.all_steps() == []
        m.save({"v": torch.tensor(1.0)}, step=1)  # plan gone: save lands
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
               worker_optimizer="adam", learning_rate=0.01)
MP_CASES = {
    "zero1": dict(kind="keras", trainer="ADAG", kw=dict(MP_BASE, zero=1)),
    "zero3": dict(kind="keras", trainer="ADAG", kw=dict(MP_BASE, zero=3)),
    "int8": dict(kind="keras", trainer="ADAG",
                 kw=dict(MP_BASE, compress="int8")),
    "aeasgd": dict(kind="keras", trainer="AEASGD",
                   kw=dict(batch_size=8, num_epoch=2, learning_rate=0.05,
                           rho=1.0, communication_window=2)),
    "lm_zero3_dropout": dict(kind="lm", dropout=0.1,
                             kw=dict(batch_size=4, num_epoch=2, zero=3,
                                     optimizer="adamw",
                                     learning_rate=1e-2)),
    "lm_int8": dict(kind="lm", kw=dict(batch_size=4, num_epoch=2,
                                       compress="int8", optimizer="adamw",
                                       learning_rate=1e-2)),
}


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
    return spawn(tmp_path_factory.mktemp("resume2"), 2, cases, data,
                 cfg=LM_CFG)


@pytest.mark.multiprocess
@pytest.mark.parametrize("name", list(MP_CASES))
def test_world2_resume_bit_for_bit(world2, name):
    """Two gloo ranks: the checkpoint gathers ZeRO shards, exchange
    residuals, replicas and dropout generators to rank 0, which writes;
    the resumed run re-scatters them and ends bit-identical to the
    straight run on both ranks."""
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

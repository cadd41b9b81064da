"""The port's Keras trainer family against ``distkeras_tpu``'s, on the
same blobs and the same initial weights (CPU, float32, one worker; the
JAX trainers on a one-device mesh).

Each trainer's ``history``, ``eval_history`` (loss and accuracy) and
exported weights agree at ``rtol=1e-4, atol=1e-5``, the tolerance of
``tests/test_trainers.py``'s single-vs-ADAG check (different matmul
summation orders compounding over the steps).  Also: the synchronization
rules at n = 4 (``reduce`` summing a stacked leading axis) against the
JAX rules under ``shard_map`` on 4 of the 8 test devices at 1e-6, the
canonical drive (Dataset -> ADAG -> ModelPredictor ->
LabelIndexTransformer -> AccuracyEvaluator) in both packages, and the
error contracts.
"""

import warnings

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import distkeras_tpu as dk
import distkeras_tpu_torch as dkt
from distkeras_tpu.parallel.compat import shard_map
from distkeras_tpu.trainers import elastic as jel
from distkeras_tpu_torch.trainers import elastic as tel
from tests.conftest import make_blobs, make_mlp

TOL = dict(rtol=1e-4, atol=1e-5)


def pair(seed=0, dim=16, classes=4, hidden=32):
    """The reference's test MLP and the port's, holding equal weights."""
    jm = make_mlp(dim=dim, classes=classes, hidden=hidden, seed=seed)
    tm = dkt.zoo.MLP(dim, (hidden,), classes)
    dkt.module_from_keras_numpy(
        tm, [np.asarray(v.value) for v in jm.trainable_variables])
    return jm, tm


def keras_weights(model):
    return [np.asarray(v.value) for v in model.trainable_variables]


def run_both(jcls, tcls, n=256, eval_every=0, **kw):
    x, y = make_blobs(n=n)
    jm, tm = pair()
    kw = dict(loss="sparse_categorical_crossentropy", num_epoch=2,
              metrics=["accuracy"], **kw)
    if issubclass(jcls, dk.trainers.distributed.DistributedTrainer):
        kw["num_workers"] = 1
    jt = jcls(jm, eval_every=eval_every, **kw)
    tt = tcls(tm, device="cpu", eval_every=eval_every, **kw)
    ev = x[:50], y[:50]
    jout = jt.train(dk.Dataset.from_arrays(x, y),
                    eval_dataset=dk.Dataset.from_arrays(*ev))
    tout = tt.train(dkt.Dataset.from_arrays(x, y),
                    eval_dataset=dkt.Dataset.from_arrays(*ev))
    return jt, tt, jout, tout


def assert_same_run(jt, tt, jout, tout):
    assert len(tt.history) == len(jt.history) > 0
    np.testing.assert_allclose(tt.history, jt.history, **TOL)
    assert [r for r, _ in tt.eval_history] == [r for r, _ in jt.eval_history]
    for (_, a), (_, b) in zip(tt.eval_history, jt.eval_history):
        assert a.keys() == b.keys() == {"loss", "accuracy"}
        np.testing.assert_allclose(a["loss"], b["loss"], **TOL)
        np.testing.assert_allclose(a["accuracy"], b["accuracy"], **TOL)
    got = dkt.keras_numpy_from_module(tout)[0]
    for a, b in zip(got, keras_weights(jout)):
        np.testing.assert_allclose(a, b, **TOL)
    assert tt.training_time > 0 and tt.history[-1] < tt.history[0]


@pytest.mark.parametrize("spc,device_data", [(1, False), (1, True),
                                             (4, False), (4, True)])
def test_single_trainer_matches_jax(spc, device_data):
    runs = run_both(dk.SingleTrainer, dkt.SingleTrainer, eval_every=3,
                    worker_optimizer="adam", learning_rate=0.01,
                    batch_size=16, steps_per_call=spc,
                    device_data=device_data, shuffle=True, seed=5)
    assert_same_run(*runs)


def test_adag_window_and_probe_match_jax():
    jt, tt, jout, tout = run_both(
        dk.ADAG, dkt.ADAG, eval_every=2, worker_optimizer="sgd",
        learning_rate=0.1, batch_size=16, communication_window=4,
        probe_metrics=True)
    assert_same_run(jt, tt, jout, tout)
    assert len(tt.probe_history) == len(jt.probe_history) == 8
    np.testing.assert_allclose([p["grad_norm"] for p in tt.probe_history],
                               [p["grad_norm"] for p in jt.probe_history],
                               **TOL)
    assert set(tt.step_timer.phases) == {"h2d", "step"}


@pytest.mark.parametrize("jcls,tcls,kw", [
    (dk.DynSGD, dkt.DynSGD, dict(worker_optimizer="rmsprop",
                                 communication_window=2, device_data=True)),
    (dk.AEASGD, dkt.AEASGD, dict(learning_rate=0.05, rho=1.0,
                                 communication_window=4)),
    (dk.EAMSGD, dkt.EAMSGD, dict(learning_rate=0.02, rho=1.0, momentum=0.9,
                                 communication_window=4)),
    (dk.DOWNPOUR, dkt.DOWNPOUR, dict(learning_rate=0.05,
                                     communication_window=3)),
    (dk.DOWNPOUR, dkt.DOWNPOUR, dict(learning_rate=0.05, device_data=True,
                                     communication_window=3)),
    (dk.AveragingTrainer, dkt.AveragingTrainer, dict(learning_rate=0.1)),
], ids=["dynsgd", "aeasgd", "eamsgd", "downpour", "downpour_device_data",
        "averaging"])
def test_trainer_matches_jax(jcls, tcls, kw):
    runs = run_both(jcls, tcls, eval_every=2, batch_size=8, **kw)
    assert_same_run(*runs)


def test_ensemble_matches_jax():
    x, y = make_blobs(n=256)
    jm, tm = pair()
    kw = dict(loss="sparse_categorical_crossentropy", num_models=1, seed=3,
              learning_rate=0.1, batch_size=8, num_epoch=2)
    jt = dk.EnsembleTrainer(jm, **kw)
    tt = dkt.EnsembleTrainer(tm, device="cpu", **kw)
    jout = jt.train(dk.Dataset.from_arrays(x, y))
    tout = tt.train(dkt.Dataset.from_arrays(x, y))
    assert isinstance(tout, list) and len(tout) == len(jout) == 1
    np.testing.assert_allclose(tt.history, jt.history, **TOL)
    for a, b in zip(dkt.keras_numpy_from_module(tout[0])[0],
                    keras_weights(jout[0])):
        np.testing.assert_allclose(a, b, **TOL)
    # The member's start is the reference's reinit, bit for bit.
    start = jel._reinit_weights(keras_weights(make_mlp(seed=0)), 3)
    for a, b in zip(tel._reinit_weights(keras_weights(make_mlp(seed=0)), 3),
                    start):
        np.testing.assert_array_equal(a, b)
    # The trainer's input module keeps its own weights.
    for a, b in zip(dkt.keras_numpy_from_module(tm)[0],
                    keras_weights(make_mlp(seed=0))):
        assert not np.array_equal(a, b) or a.ndim == 1


@pytest.mark.parametrize("rule", ["easgd", "downpour", "averaging"])
def test_sync_rules_match_jax_at_four_replicas(devices, rule):
    rng = np.random.default_rng(6)
    n = 4
    tv = [rng.normal(size=(n, 3, 5)).astype(np.float32),
          rng.normal(size=(n, 5)).astype(np.float32)]
    center = [rng.normal(size=(3, 5)).astype(np.float32),
              rng.normal(size=(5,)).astype(np.float32)]
    jrule, trule = {"easgd": (jel._easgd_sync(0.15), tel.easgd_sync(0.15)),
                    "downpour": (jel._downpour_sync, tel.downpour_sync(n)),
                    "averaging": (jel._averaging_sync,
                                  tel.averaging_sync(n))}[rule]

    def body(tv, center):
        new_tv, new_c = jrule([a[0] for a in tv], center, "data")
        return [a[None] for a in new_tv], new_c

    mesh = Mesh(np.array(devices[:n]), ("data",))
    jtv, jc = shard_map(body, mesh=mesh, in_specs=(P("data"), P()),
                        out_specs=(P("data"), P()), check_vma=False)(
        tv, center)
    ttv, tc = trule([torch.from_numpy(a) for a in tv],
                    [torch.from_numpy(a) for a in center],
                    lambda t: t.sum(0))
    for got, want in zip(ttv + tc, list(jtv) + list(jc)):
        got = np.broadcast_to(got.numpy(), np.shape(want))
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    assert tel.no_sync(tv, center, None) == (tv, center)


def test_canonical_drive_same_accuracy():
    """The verify skill's drive: Dataset -> ADAG -> ModelPredictor ->
    LabelIndexTransformer -> AccuracyEvaluator, in both packages."""
    import keras

    rng = np.random.default_rng(42)
    n, dim = 4096, 28
    w = rng.normal(0, 1, (dim,))
    X = rng.normal(0, 1, (n, dim)).astype("float32")
    Y = (X @ w > 0).astype("int64")
    keras.utils.set_random_seed(0)
    jm = keras.Sequential([keras.Input((dim,)),
                           keras.layers.Dense(64, activation="relu"),
                           keras.layers.Dense(2)])
    tm = dkt.module_from_keras_numpy(dkt.zoo.higgs_mlp(hidden=(64,)),
                                     keras_weights(jm))
    accs = []
    for pkg, model, extra in ((dk, jm, {}), (dkt, tm, {"device": "cpu"})):
        ds = pkg.Dataset.from_arrays(X, Y)
        t = pkg.ADAG(model, loss="sparse_categorical_crossentropy",
                     worker_optimizer="adam", learning_rate=1e-3,
                     batch_size=64, communication_window=4, num_epoch=8,
                     num_workers=1, **extra)
        trained = t.train(ds)
        scored = pkg.LabelIndexTransformer(input_col="prediction").transform(
            pkg.ModelPredictor(trained, output_col="prediction",
                               **extra).predict(ds))
        accs.append(pkg.AccuracyEvaluator(
            prediction_col="prediction_index").evaluate(scored))
    assert accs[1] > 0.9
    # Equal up to a row or two whose logits tie within float rounding.
    assert abs(accs[0] - accs[1]) <= 2 / n, accs


def test_predictor_pads_the_tail_and_matches_jax():
    jm, tm = pair(seed=1)
    x = make_blobs(n=77)[0]
    want = dk.ModelPredictor(jm, batch_size=32).predict(
        dk.Dataset.from_arrays(x))["prediction"]
    pred = dkt.ModelPredictor(tm, batch_size=32, device="cpu")
    got = pred.predict(dkt.Dataset.from_arrays(x))["prediction"]
    assert got.shape == (77, 4)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    assert pred._predict_array(x[:0]).shape == (0, 4)
    assert [a.shape for a in pred.predict_stream([x[:3], x[3:40]])] == \
        [(3, 4), (37, 4)]


def test_error_contracts(monkeypatch):
    x, y = make_blobs(n=64)
    ds = dkt.Dataset.from_arrays(x, y)
    mlp = lambda: pair()[1]
    for cls in (dkt.ADAG, dkt.DOWNPOUR, dkt.AEASGD):
        with pytest.raises(ValueError, match="exceeds visible devices"):
            cls(mlp(), num_workers=2, device="cpu")
    # The data-parallel knobs (zero=, merge_rule=, sync_every=,
    # compress=), fsdp= / plan= and the checkpoint knobs are ported (with
    # the reference's refusals); a plan is a ShardingPlan.
    assert dkt.ADAG(mlp(), device="cpu", fsdp=True).plan.fsdp_axis == "data"
    with pytest.raises(TypeError, match="ShardingPlan"):
        dkt.ADAG(mlp(), device="cpu", plan=object())
    for knob, value in (("checkpoint_every", 2), ("resume", True)):
        with pytest.raises(ValueError, match="checkpoint_dir"):
            dkt.SingleTrainer(mlp(), device="cpu", **{knob: value})
    assert dkt.SingleTrainer(mlp(), device="cpu",
                             checkpoint_dir="/x").checkpoint_dir == "/x"
    with pytest.raises(TypeError, match="unexpected keyword"):
        dkt.SingleTrainer(mlp(), device="cpu", mesh=None)
    with pytest.raises(ValueError, match="known: .*sparse_categorical"):
        dkt.SingleTrainer(mlp(), loss="hinge", device="cpu")
    with pytest.raises(ValueError, match="known: .*adagrad"):
        dkt.ADAG(mlp(), worker_optimizer="lars", device="cpu")
    with pytest.raises(ValueError, match=r"known: \['accuracy'\]"):
        dkt.ModelAdapter(mlp(), metrics=["auc"], device="cpu")
    with pytest.raises(ValueError, match="must be built"):
        dkt.ModelAdapter(torch.nn.LazyLinear(3), device="cpu")
    with pytest.raises(ValueError, match="scalar learning_rate"):
        dkt.AEASGD(mlp(), learning_rate=lambda c: 0.1, device="cpu")
    with pytest.warns(UserWarning, match="clamping"):
        t = dkt.AEASGD(mlp(), learning_rate=0.5, rho=5.0, device="cpu")
    assert t.alpha == pytest.approx(0.9)
    with pytest.raises(ValueError, match="no single model"):
        dkt.EnsembleTrainer(mlp(), eval_every=1, device="cpu")
    with pytest.raises(ValueError, match="evaluate"):
        dkt.EnsembleTrainer(mlp(), device="cpu").train(ds, eval_dataset=ds)
    with pytest.raises(ValueError, match="device_data"):
        dkt.ADAG(mlp(), device_data=True, probe_metrics=True, device="cpu")
    with pytest.raises(ValueError, match="probe_metrics"):
        dkt.DOWNPOUR(mlp(), probe_metrics=True, device="cpu")
    with pytest.raises(ValueError, match="training step needs"):
        dkt.AEASGD(mlp(), batch_size=32, communication_window=32,
                   device="cpu").train(ds)
    with pytest.raises(ValueError, match="no eval_dataset"):
        dkt.SingleTrainer(mlp(), eval_every=1, device="cpu").train(ds)
    trainer = dkt.SingleTrainer(mlp(), "sparse_categorical_crossentropy",
                                preprocess=lambda v: v * 1.0,
                                device="cpu", batch_size=16)
    with pytest.warns(UserWarning, match="preprocess"):
        trainer.train(ds)
    # The device rule: the card by default, and no silent CPU fallback.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: dkt.SingleTrainer(mlp()),
                 lambda: dkt.ADAG(mlp()),
                 lambda: dkt.DOWNPOUR(mlp()),
                 lambda: dkt.ModelPredictor(mlp()),
                 lambda: dkt.ModelAdapter(mlp())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_perplexity_evaluator_matches_jax():
    from distkeras_tpu.models import transformer as jtfm

    base = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
                max_len=16)
    jcfg = jtfm.TransformerConfig(**base)
    tcfg = dkt.TransformerConfig(**base)
    params = jax.tree.map(np.asarray,
                          jtfm.init_params(jax.random.key(0), jcfg))
    tokens = np.random.default_rng(3).integers(0, 64, (10, 9))
    want = dk.PerplexityEvaluator(params, jcfg, batch_size=4).evaluate(
        tokens)
    got = dkt.PerplexityEvaluator(dkt.params_from_numpy(params, "cpu"),
                                  tcfg, batch_size=4).evaluate(
        dkt.Dataset({"tokens": tokens}))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    with pytest.raises(ValueError, match="one batch needs"):
        dkt.PerplexityEvaluator({}, tcfg, batch_size=16).evaluate(tokens)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert dkt.AccuracyEvaluator().evaluate(dkt.Dataset({
            "prediction_index": np.array([0, 1, 2]),
            "label": np.eye(3)[[0, 1, 0]]})) == pytest.approx(2 / 3)


def test_step_timer_copy_matches_reference():
    """The port's jax-free StepTimer keeps the reference's contract:
    rounds closed by ``finalize``, named phases, ``reset`` per run."""
    from distkeras_tpu.utils.profiling import StepTimer as JTimer
    from distkeras_tpu_torch.utils.profiling import StepTimer as TTimer

    for timer, ref in ((TTimer(), torch.ones(3)), (JTimer(), np.ones(3))):
        with timer.round(n_steps=4):
            with timer.phase("h2d"):
                pass
            with timer.phase("step"):
                pass
            timer.count(2)
        timer.finalize(ref)
        assert timer.total_steps == 6 and len(timer.rounds) == 1
        assert timer.mean_step_s == timer.total_s / 6 > 0
        stats = timer.phase_stats()
        assert set(stats) == {"h2d", "step"}
        assert stats["step"]["calls"] == 1 and timer.phase_s("none") == 0.0
        assert timer.samples_per_sec(8) == pytest.approx(
            48 / timer.total_s)
        timer.reset()
        assert timer.rounds == [] and timer.phases == {}

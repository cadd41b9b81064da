"""The port's Keras BatchNorm and ResNet-50 against Keras' (JAX backend,
CPU): ``keras.layers.BatchNormalization`` and
``keras.applications.ResNet50(weights=None, classifier_activation=None)``
(the reference's ``zoo.resnet50``), weights carried across.

- The BN layer in training and inference mode, its input gradient and
  its moving statistics, at 1e-5 (f32; summation order only).
- ResNet-50's variables: Keras' 214 trainable and 106 non-trainable
  paths, in Keras' order (topological, not the order of construction),
  equal to the port's parameter and buffer names mapped one to one.
- ResNet-50 at 64 x 64, batch 2: inference logits at 1e-4 of max
  |logit|; training-mode logits (batch statistics) at 5e-4 of it, since
  the statistics of batch 2's few values per channel in the last stages
  amplify summation-order noise: each f32 forward (port and JAX) is held
  within 2e-4 of max |logit| of the port's float64 forward of the same
  weights (1e-5 in inference); the moving statistics at rtol 1e-4 /
  atol 1e-5, the Keras trainers' tolerance.
- One ``SingleTrainer`` sgd step, held to the reference twice: in
  float64 (the reference's step in a process with x64 on and Keras'
  float64 promotion restored), every variable at rtol 1e-8 / atol
  1e-10 and the whole update within 1e-10 of its norm, the loss at
  1e-7 (the reference reports it rounded to f32); in f32, the loss and
  the moving statistics at rtol 1e-4 / atol 1e-5 against the reference's
  f32 step, each conv bias at atol 1e-5 (a BN follows every conv, so
  its exact gradient is 0), and each other variable's update no farther
  from the reference's float64 update than 3x the reference's own f32
  update: the f32 backward of this randomly initialized network is
  ill-conditioned, so an f32 update sits a few percent of its norm from
  the float64 one (in both packages).

One module-scoped Keras ResNet-50 serves every case (its build and
XLA compiles dominate the file's time).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import distkeras_tpu as dk
import keras
import distkeras_tpu_torch as dkt
from distkeras_tpu.models import zoo as jzoo
from distkeras_tpu_torch.models.batchnorm import KerasBatchNorm
from distkeras_tpu_torch.utils.serialization import weight_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-5)
SHAPE = (64, 64, 3)


@pytest.fixture(scope="module")
def keras_resnet():
    jm = jzoo.resnet50(num_classes=10, input_shape=SHAPE, seed=0)
    return jm, jm.get_weights()


def port_resnet(jm):
    tm = dkt.zoo.resnet50(num_classes=10, input_shape=SHAPE, seed=1)
    dkt.set_weights(tm, jm.get_weights())
    return tm


@pytest.mark.parametrize("shape", [(4, 5, 5, 6), (16, 6)])
def test_batchnorm_matches_keras(shape):
    rng = np.random.default_rng(0)
    c = shape[-1]
    x = rng.normal(1.5, 2.0, shape).astype(np.float32)
    ws = [rng.uniform(0.5, 1.5, c), rng.normal(0, 1, c),
          rng.normal(0, 1, c), rng.uniform(0.5, 2.0, c)]
    ws = [w.astype(np.float32) for w in ws]
    kbn = keras.layers.BatchNormalization(epsilon=1.001e-5)
    kbn.build(shape)
    kbn.set_weights(ws)
    tbn = KerasBatchNorm(c, epsilon=1.001e-5)
    dkt.set_weights(tbn, ws)
    assert [n for n, _ in tbn.named_parameters()] == ["gamma", "beta"]
    assert [n for n, _ in tbn.named_buffers()] == ["moving_mean",
                                                   "moving_variance"]
    tv = [v.value for v in kbn.trainable_variables]
    ntv = [v.value for v in kbn.non_trainable_variables]
    # Inference mode: the moving statistics.
    want, _ = kbn.stateless_call(tv, ntv, x, training=False)
    tbn.eval()
    with torch.no_grad():
        got = tbn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    # Training mode: batch statistics (biased variance), the moving
    # update at momentum 0.99, and the gradient through the statistics.
    cot = rng.normal(0, 1, shape).astype(np.float32)

    def f(tv, x):
        y, new_ntv = kbn.stateless_call(tv, ntv, x, training=True)
        return (y * cot).sum(), (y, new_ntv)

    (_, (want, want_ntv)), (g_tv, g_x) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(tv, x)
    tbn.train()
    xt = torch.from_numpy(x).requires_grad_()
    got = tbn(xt)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x),
                               rtol=1e-4, atol=1e-5)
    for p, g in zip(tbn.parameters(), g_tv):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g),
                                   rtol=1e-4, atol=1e-5)
    for b, w in zip(tbn.buffers(), want_ntv):
        np.testing.assert_allclose(b.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    # Torch's own running_var would take the unbiased variance.
    n = x.size // c
    biased = x.reshape(-1, c).var(0)
    np.testing.assert_allclose(
        tbn.moving_variance.numpy(), 0.99 * ws[3] + 0.01 * biased,
        rtol=1e-5)
    assert not np.allclose(0.99 * ws[3] + 0.01 * biased * n / (n - 1),
                           tbn.moving_variance.numpy(), rtol=1e-5)


def test_resnet50_paths_match_keras(keras_resnet):
    jm, _ = keras_resnet
    tm = port_resnet(jm)
    tv = [v.path for v in jm.trainable_variables]
    ntv = [v.path for v in jm.non_trainable_variables]
    assert (len(tv), len(ntv)) == (214, 106)
    # Keras' get_weights() order interleaves each BN's four variables
    # per layer: it is not tv + ntv.
    order = [w.path for w in jm.weights]
    assert order != tv + ntv and len(order) == 320
    paths = weight_paths(tm)
    assert paths == order
    moving = ("moving_mean", "moving_variance")
    assert [p for p in paths if not p.endswith(moving)] == tv
    assert [p for p in paths if p.endswith(moving)] == ntv
    got = dkt.get_weights(tm)
    for a, b in zip(got, jm.get_weights()):
        np.testing.assert_array_equal(a, b)
    tv_np, ntv_np = dkt.keras_numpy_from_module(tm)
    for a, v in zip(tv_np + ntv_np, jm.trainable_variables
                    + jm.non_trainable_variables):
        np.testing.assert_array_equal(a, np.asarray(v.value))
    # The builder's own init is Keras': BN gamma 1, beta 0, moving
    # statistics 0 / 1, zero biases.
    fresh = dkt.zoo.resnet50(num_classes=10, input_shape=SHAPE, seed=0)
    named = dict(fresh.named_parameters())
    assert torch.equal(named["conv1_bn.gamma"], torch.ones(64))
    assert not named["conv1_conv.bias"].any()
    assert torch.equal(fresh.conv5_block3_3_bn.moving_variance,
                       torch.ones(2048))


@pytest.mark.parametrize("training", [False, True])
def test_resnet50_logits_match_keras(keras_resnet, training):
    jm, w0 = keras_resnet
    jm.set_weights(w0)
    tm = port_resnet(jm)
    x = np.random.default_rng(1).uniform(0, 1, (2, *SHAPE)).astype(
        np.float32)
    want, new_ntv = jm.stateless_call(
        [v.value for v in jm.trainable_variables],
        [v.value for v in jm.non_trainable_variables], x, training=training)
    tm.train(training)
    exact = port_resnet(jm).double().train(training)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
        ref = exact(torch.from_numpy(x).double()).numpy()
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert got.shape == want.shape == (2, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=(
        5e-4 if training else 1e-4) * scale)
    # Each f32 forward against the float64 one: the training-mode bound
    # is their f32 rounding, amplified by the batch statistics.
    for f32 in (got, want):
        np.testing.assert_allclose(f32, ref, rtol=0, atol=(
            2e-4 if training else 1e-5) * scale)
    for b, w in zip(tm.buffers(), new_ntv):
        np.testing.assert_allclose(b.numpy(), np.asarray(w), **TOL)


# One SingleTrainer step of the reference in float64.  Keras computes a
# 64-bit input in 32 bits on the JAX backend (its dtype lattice maps
# float64 to float32, so BatchNorm's statistics are f32); the script maps
# float64 to itself, so the whole step runs in float64.  Its own process:
# x64 and the float64 floatx are global.
F64_STEP = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
import distkeras_tpu as dk
import keras
from keras.src.backend.common import dtypes
dtypes.BIT64_TO_BIT32_DTYPE["float64"] = "float64"
keras.config.set_floatx("float64")
from distkeras_tpu.models import zoo
d = np.load(sys.argv[1])
m = zoo.resnet50(num_classes=10, input_shape=tuple(d["shape"]), seed=0)
m.set_weights([d[f"w{i}"].astype(np.float64) for i in range(int(d["n"]))])
t = dk.SingleTrainer(m, **json.loads(sys.argv[3]))
ws = t.train(dk.Dataset.from_arrays(d["x"], d["y"])).get_weights()
assert all(w.dtype == np.float64 for w in ws)
np.savez(sys.argv[2], history=np.asarray(t.history, np.float64),
         **{f"w{i}": w for i, w in enumerate(ws)})
"""


def test_resnet50_single_trainer_step(keras_resnet, tmp_path):
    jm, w0 = keras_resnet
    jm.set_weights(w0)
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (2, *SHAPE))
    y = np.array([3, 7])
    kw = dict(loss="sparse_categorical_crossentropy", worker_optimizer="sgd",
              learning_rate=0.01, batch_size=2, num_epoch=1)
    np.savez(tmp_path / "in.npz", n=len(w0), shape=SHAPE, x=x, y=y,
             **{f"w{i}": w for i, w in enumerate(w0)})
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    f64 = subprocess.Popen(
        [sys.executable, "-c", F64_STEP, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz"), json.dumps(kw)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    x32 = x.astype(np.float32)
    jt = dk.SingleTrainer(jm, **kw)
    jout = jt.train(dk.Dataset.from_arrays(x32, y))
    jm.set_weights(w0)
    runs = []
    for dtype, xs in ((torch.float32, x32), (torch.float64, x)):
        t = dkt.SingleTrainer(port_resnet(jm).to(dtype), device="cpu",
                              **kw)
        out = t.train(dkt.Dataset.from_arrays(xs, y))
        runs.append((np.array(t.history), dkt.get_weights(out)))
    (h32, got), (h64, got64) = runs
    log = f64.communicate(timeout=300)[0]
    assert f64.returncode == 0, log[-3000:]
    ref = np.load(tmp_path / "out.npz")
    exact = [ref[f"w{i}"] for i in range(len(w0))]
    paths = [w.path for w in jout.weights]
    assert len(got) == len(got64) == len(exact) == len(w0) == 320
    # float64 against float64: the step itself, away from f32 rounding
    # (read: 2.4e-12 at most, 7e-13 of the update's norm).  The
    # reference reports its loss rounded to f32 (read: 8e-9 relative).
    assert len(h64) == len(ref["history"]) == 1
    np.testing.assert_allclose(h64, ref["history"], rtol=1e-7)
    for a, e, path in zip(got64, exact, paths):
        np.testing.assert_allclose(a, e, rtol=1e-8, atol=1e-10,
                                   err_msg=path)
    du = np.concatenate([(a - z).ravel() for a, z in zip(got64, w0)])
    de = np.concatenate([(e - z).ravel() for e, z in zip(exact, w0)])
    assert np.linalg.norm(du - de) <= 1e-10 * np.linalg.norm(de)
    # float32 against the reference's float32 run: the loss (the forward
    # from equal weights) and the moving statistics at the Keras
    # trainers' tolerance.
    assert len(h32) == len(jt.history) == 1
    np.testing.assert_allclose(h32, jt.history, **TOL)
    for a, b, e, a0, path in zip(got, jout.get_weights(), exact, w0, paths):
        if path.endswith(("moving_mean", "moving_variance")):
            np.testing.assert_allclose(a, b, **TOL, err_msg=path)
            continue
        if path.endswith("_conv/bias"):
            # Every conv feeds a BN, which removes its bias: the exact
            # gradient is 0, both updates are rounding noise.
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5,
                                       err_msg=path)
            continue
        # The f32 backward of this random-init net is ill-conditioned
        # (both packages' f32 updates sit 4-5% of the update from the
        # float64 one), so the port's f32 update is held to the
        # reference's exact one: no farther than 3x the reference's own
        # f32 update (read: 0.34 of that bound at most).
        du, dw, de = (np.float64(v) - a0 for v in (a, b, e))
        assert np.linalg.norm(du - de) <= 3 * np.linalg.norm(dw - de) \
            + 1e-6, (path, np.linalg.norm(du - de),
                     np.linalg.norm(dw - de))


def test_resnet50_adag_and_predictor():
    """The port's ResNet-50 under ADAG (window 1: SingleTrainer's
    operations, within 1e-6) and scored by ``ModelPredictor`` (inference
    mode: the trained moving statistics)."""
    x = np.random.default_rng(5).uniform(0, 1, (8, 32, 32, 3)).astype(
        np.float32)
    y = np.arange(8) % 10
    ds = dkt.Dataset.from_arrays(x, y)
    outs = []
    for cls, kw in ((dkt.SingleTrainer, {}),
                    (dkt.ADAG, dict(communication_window=1))):
        t = cls(dkt.zoo.resnet50(num_classes=10, input_shape=(32, 32, 3),
                                 seed=3),
                loss="sparse_categorical_crossentropy",
                worker_optimizer="sgd", learning_rate=0.01, batch_size=4,
                device="cpu", **kw)
        outs.append((t.train(ds), np.array(t.history)))
    (m1, h1), (m2, h2) = outs
    assert len(h1) == len(h2) == 2 and np.all(np.isfinite(h1))
    np.testing.assert_allclose(h2, h1, rtol=0, atol=1e-6)
    for a, b in zip(dkt.get_weights(m2), dkt.get_weights(m1)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    pred = dkt.ModelPredictor(m2, device="cpu").predict(ds)
    m2.eval()
    with torch.no_grad():
        want = m2(torch.from_numpy(x)).numpy()
    got = np.stack([np.asarray(p) for p in pred["prediction"]])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

"""Synchronized BatchNorm at ``num_workers > 1``: the port's gloo ranks
against the JAX package and against the port's own world 1 (CPU).

The model is ``tests/test_batchnorm_dp.py::bn_mlp`` (Dense 32, BN,
ReLU, Dense 4), carried across as ``tests/torch_dp_ranks.py::BNMLP``;
the run is that test's: 512 blobs, global batch 64, window 2, 2
epochs, sgd at 0.05.

- ADAG and DynSGD (the default synchronous exchange) at world 2 and 4:
  the batch statistics are the global batch's, so the losses, the
  weights and the moving statistics equal JAX's ``num_workers=n`` and
  the port's world 1 at the global batch, at rtol 1e-4 / atol 1e-5 (the
  data-parallel tolerance of ``tests/test_torch_dp.py``).
- The gradient-exchange options refuse a model with BN statistics,
  with the reference's error.
- The replica family (AEASGD): each replica keeps its own statistics,
  and the exported center carries replica 0's, equal to JAX's.
- ResNet-50 (NCHW statistics, 53 BNs) in float64 at world 2, batch 2 a
  rank, one ADAG step, equals the port's world 1 at batch 4: the update
  within 1e-9 of its norm (float64, so f32 rounding through its
  ill-conditioned backward does not hide a fault;
  ``tests/test_torch_resnet.py`` holds the float64 step to the
  reference's).
"""

import numpy as np
import pytest

import distkeras_tpu as dk
import distkeras_tpu_torch as dkt
from tests.conftest import make_blobs
from tests.test_batchnorm_dp import bn_mlp
from tests.torch_dp_ranks import BNMLP, spawn

# The limit sits above torch_dp_ranks.SPAWN_TIMEOUT (240 s).
pytestmark = [pytest.mark.multiprocess, pytest.mark.time_limit(300)]

TOL = dict(rtol=1e-4, atol=1e-5)
GLOBAL_BATCH = 64
SYNC = dict(worker_optimizer="sgd", learning_rate=0.05,
            communication_window=2, num_epoch=2)
REPLICA = dict(learning_rate=0.05, rho=1.0, communication_window=2,
               num_epoch=2, batch_size=16)
RESNET = dict(num_classes=10, input_shape=(32, 32, 3), seed=3)
RESNET_KW = dict(worker_optimizer="sgd", learning_rate=0.01,
                 communication_window=1, num_epoch=1)
CASES = {
    "adag": ("ADAG", SYNC),
    "dynsgd_zero1": ("DynSGD", dict(SYNC, zero=1)),
    "adag_device_data": ("ADAG", dict(SYNC, device_data=True)),
    "aeasgd": ("AEASGD", REPLICA),
}


def data():
    x, y = make_blobs(n=512)
    jm = bn_mlp()
    w = [np.asarray(v.value) for v in jm.trainable_variables]
    mean, var = [np.asarray(v.value) for v in jm.non_trainable_variables]
    rng = np.random.default_rng(4)
    return dict(x=x, y=y, bn_n_w=np.asarray(len(w)), bn_mean=mean,
                bn_var=var, **{f"bn_w{i}": a for i, a in enumerate(w)},
                img_x=rng.uniform(0, 1, (4, *RESNET["input_shape"])),
                img_y=rng.integers(0, 10, 4))


def kw_for(name, world):
    trainer, kw = CASES[name]
    if trainer != "AEASGD":
        kw = dict(kw, batch_size=GLOBAL_BATCH // world)
    return trainer, kw


def spawn_world(tmp_path_factory, world):
    cases = [dict(name=k, kind="keras", model="bn_mlp",
                  trainer=kw_for(k, world)[0], kw=kw_for(k, world)[1])
             for k in CASES]
    cases += [dict(name=f"refuse_{k}", kind="keras", model="bn_mlp",
                   trainer="ADAG", kw=dict(SYNC, batch_size=8, **opt),
                   expect_error=True)
              for k, opt in (("adasum", dict(merge_rule="adasum")),
                             ("local_sgd", dict(sync_every=2)),
                             ("int8", dict(compress="int8")))]
    if world == 2:
        cases.append(dict(name="resnet50", kind="keras", model="resnet50",
                          zoo=RESNET, data="img_", trainer="ADAG",
                          kw=dict(RESNET_KW, batch_size=2)))
    return spawn(tmp_path_factory.mktemp(f"bn{world}"), world, cases, data())


@pytest.fixture(scope="module")
def bn_w2(tmp_path_factory):
    return spawn_world(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def bn_w4(tmp_path_factory):
    return spawn_world(tmp_path_factory, 4)


def jax_run(trainer, kw, world):
    x, y = make_blobs(n=512)
    t = getattr(dk, trainer)(bn_mlp(), loss="sparse_categorical_crossentropy",
                             num_workers=world, **kw)
    model = t.train(dk.Dataset.from_arrays(x, y))
    return (np.asarray(t.history),
            [np.asarray(v.value) for v in model.trainable_variables],
            [np.asarray(v.value) for v in model.non_trainable_variables])


def port_world1(trainer, kw):
    x, y = make_blobs(n=512)
    d = data()
    model = dkt.module_from_keras_numpy(
        BNMLP(), [d[f"bn_w{i}"] for i in range(int(d["bn_n_w"]))],
        [d["bn_mean"], d["bn_var"]])
    t = getattr(dkt, trainer)(model, loss="sparse_categorical_crossentropy",
                              device="cpu", **kw)
    tv, ntv = dkt.keras_numpy_from_module(
        t.train(dkt.Dataset.from_arrays(x, y)))
    return np.asarray(t.history), tv, ntv


def assert_run(got, want, what):
    hist, tv, ntv = want
    assert len(got["history"]) == len(hist) > 0, what
    np.testing.assert_allclose(got["history"], hist, **TOL, err_msg=what)
    assert len(ntv) == 2
    for i, w in enumerate(tv):
        np.testing.assert_allclose(got[f"m0_w{i}"], w, **TOL,
                                   err_msg=f"{what} w{i}")
    for i, w in enumerate(ntv):
        np.testing.assert_allclose(got[f"m0_n{i}"], w, **TOL,
                                   err_msg=f"{what} moving statistic {i}")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["adag", "dynsgd_zero1",
                                  "adag_device_data"])
def test_sync_bn_matches_jax_and_world1(bn_w2, bn_w4, world, name):
    res = (bn_w2 if world == 2 else bn_w4)[name]
    keys = [k for k in res[0] if k.startswith(("history", "m0_"))]
    for other in res[1:]:
        for k in keys:
            np.testing.assert_array_equal(other[k], res[0][k], err_msg=k)
    trainer, kw = kw_for(name, world)
    assert_run(res[0], jax_run(trainer, kw, world), f"{name} vs JAX")
    one = dict(kw, batch_size=GLOBAL_BATCH)
    one.pop("zero", None)
    assert_run(res[0], port_world1(trainer, one), f"{name} vs world 1")


@pytest.mark.parametrize("world", [2, 4])
def test_replica_family_keeps_per_replica_statistics(bn_w2, bn_w4, world):
    res = (bn_w2 if world == 2 else bn_w4)["aeasgd"]
    trainer, kw = kw_for("aeasgd", world)
    assert_run(res[0], jax_run(trainer, kw, world), "aeasgd vs JAX")
    # Every rank exports replica 0's statistics with the center.
    for other in res[1:]:
        for k in ("m0_n0", "m0_n1", "m0_w0"):
            np.testing.assert_array_equal(other[k], res[0][k])


@pytest.mark.parametrize("opt", ["adasum", "local_sgd", "int8"])
def test_exchange_options_refuse_bn_statistics(bn_w2, opt):
    x = dict(merge_rule="adasum") if opt == "adasum" else (
        dict(sync_every=2) if opt == "local_sgd" else dict(compress="int8"))
    with pytest.raises(ValueError) as want:
        dk.ADAG(bn_mlp(), loss="sparse_categorical_crossentropy",
                num_workers=2, **dict(SYNC, batch_size=8, **x))
    assert "non-trainable training state" in str(want.value)
    for r in bn_w2[f"refuse_{opt}"]:
        assert str(r["error_text"]) == str(want.value)


def test_sync_bn_resnet50_matches_world1(bn_w2):
    res = bn_w2["resnet50"]
    for k in res[0]:
        if k.startswith(("history", "m0_")):
            np.testing.assert_array_equal(res[1][k], res[0][k], err_msg=k)
    d = data()
    model = dkt.zoo.resnet50(**RESNET).double()
    t = dkt.ADAG(model, loss="sparse_categorical_crossentropy",
                 device="cpu", batch_size=4, **RESNET_KW)
    tv, ntv = dkt.keras_numpy_from_module(
        t.train(dkt.Dataset.from_arrays(d["img_x"], d["img_y"])))
    assert (len(tv), len(ntv)) == (214, 106) and len(t.history) == 1
    # A random-init ResNet-50 on 4 images a step takes an update of norm
    # ~1.5e3 (BN over 4 values a channel in conv5): the update is held
    # to its norm (read: 2.4e-11 of it), each weight at 1e-7 (read:
    # 1.4e-9 at most), the moving statistics at 1e-8 (read: 8e-14).
    np.testing.assert_allclose(res[0]["history"], t.history, rtol=1e-10)
    w0 = dkt.keras_numpy_from_module(dkt.zoo.resnet50(**RESNET))[0]
    du = np.concatenate([(res[0][f"m0_w{i}"] - z).ravel()
                         for i, z in enumerate(w0)])
    dv = np.concatenate([(w - z).ravel() for w, z in zip(tv, w0)])
    assert np.linalg.norm(du - dv) <= 1e-9 * np.linalg.norm(dv)
    for i, w in enumerate(tv):
        np.testing.assert_allclose(res[0][f"m0_w{i}"], w, rtol=1e-7,
                                   atol=1e-7, err_msg=f"w{i}")
    for i, w in enumerate(ntv):
        np.testing.assert_allclose(res[0][f"m0_n{i}"], w, rtol=1e-8,
                                   atol=1e-10, err_msg=f"moving {i}")

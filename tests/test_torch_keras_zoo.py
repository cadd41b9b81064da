"""The port's model zoo against the Keras zoo of ``distkeras_tpu``: each
Keras model (JAX backend) is built from a seed, its variables carry
across with ``module_from_keras_numpy``, and both run the same numpy
inputs (CPU).

- float32 logits of ``mnist_mlp``, ``cifar_cnn`` and ``higgs_mlp`` at
  1e-5 (summation order only); for ``cifar_cnn``, a C, H, W flatten is
  shown to miss by far more than that, so the Flatten order is checked;
- ``mixed_bfloat16`` logits within 2e-2 of max |logit| (bf16 products and
  roundings in both), and the loss on them computed in bf16 by both;
- the weight round trip is exact.
"""

import numpy as np
import pytest
import torch

import distkeras_tpu  # noqa: F401  (selects the JAX backend for keras)
import keras
from distkeras_tpu.models import adapter as jadapter
from distkeras_tpu.models import zoo as jzoo
from distkeras_tpu.ops import losses as jlosses
from distkeras_tpu_torch.models import zoo as tzoo
from distkeras_tpu_torch.ops import losses as tlosses
from distkeras_tpu_torch.utils.serialization import (keras_numpy_from_module,
                                                     module_from_keras_numpy)


def keras_numpy(model):
    return ([np.asarray(v.value) for v in model.trainable_variables],
            [np.asarray(v.value) for v in model.non_trainable_variables])


def carried(jmodel, tmodule):
    tv, ntv = keras_numpy(jmodel)
    return module_from_keras_numpy(tmodule, tv, ntv)


CASES = [
    ("mnist_mlp", dict(), (8, 784)),
    ("cifar_cnn", dict(), (4, 32, 32, 3)),
    ("higgs_mlp", dict(), (8, 28)),
    ("cifar_cnn", dict(num_classes=7, input_shape=(16, 24, 3)),
     (3, 16, 24, 3)),
]


@pytest.mark.parametrize("name,kw,shape", CASES)
def test_zoo_logits_match_keras_f32(name, kw, shape):
    jm = jzoo.ZOO[name](seed=0, **kw)
    tm = carried(jm, tzoo.ZOO[name](**kw))
    x = np.random.default_rng(1).uniform(0, 1, shape).astype(np.float32)
    want = np.asarray(jm(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if name == "cifar_cnn":
        # The same weights under a C, H, W flatten: far outside 1e-5.
        class ChwFlatten(tzoo.CifarCNN):
            def forward(self, x):
                x = x.permute(0, 3, 1, 2)
                for i, conv in enumerate(self.conv):
                    x = torch.relu(conv(x))
                    if i % 2:
                        x = torch.nn.functional.max_pool2d(x, 2)
                x = torch.relu(self.dense[0](x.flatten(1)))
                return self.dense[1](x)

        wrong = carried(jm, ChwFlatten(**kw))
        with torch.no_grad():
            bad = wrong(torch.from_numpy(x)).numpy()
        assert np.abs(bad - want).max() > 100 * 1e-5


def test_zoo_mixed_bfloat16_logits_and_bf16_loss():
    x = np.random.default_rng(2).uniform(0, 1, (6, 32, 32, 3)).astype(
        np.float32)
    y = np.arange(6) % 10
    keras.mixed_precision.set_global_policy("mixed_bfloat16")
    try:
        jm = jzoo.cifar_cnn(seed=0)
        want = jm(x)
        jloss = jlosses.resolve_loss("sparse_categorical_crossentropy")(
            y, want)
    finally:
        keras.mixed_precision.set_global_policy("float32")
    tm = carried(jm, tzoo.cifar_cnn(policy="mixed_bfloat16"))
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
        tloss = tlosses.resolve_loss("sparse_categorical_crossentropy")(
            torch.from_numpy(y), got)
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    assert tloss.dtype == torch.bfloat16 and str(jloss.dtype) == "bfloat16"
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2e-2 * scale)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-2)


@pytest.mark.parametrize("name", ["mnist_mlp", "cifar_cnn", "higgs_mlp"])
def test_weight_round_trip_exact(name):
    jm = jzoo.ZOO[name](seed=3)
    tv, ntv = keras_numpy(jm)
    tm = module_from_keras_numpy(tzoo.ZOO[name](seed=5), tv, ntv)
    tv2, ntv2 = keras_numpy_from_module(tm)
    assert len(tv2) == len(tv) and ntv2 == [] == ntv
    for a, b in zip(tv, tv2):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # The port's parameters are the adapter's tv, in Keras' order.
    assert [p.numel() for p in tm.parameters()] == [a.size for a in tv]
    jad = jadapter.ModelAdapter(jm)
    assert len(jad.tv_paths) == len(list(tm.parameters()))


def test_zoo_contracts():
    for name in jzoo.ZOO:
        assert name in tzoo.ZOO
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        tzoo.imdb_lstm()
    with pytest.raises(NotImplementedError, match="ROADMAP A6") as err:
        tzoo.resnet50()
    # The BatchNorm it names is the one keras.applications.ResNet50
    # builds: every BatchNormalization there passes epsilon=1.001e-5 and
    # keeps the layer's default momentum.
    import inspect

    import keras
    from keras.src.applications import resnet

    src = inspect.getsource(resnet)
    assert "epsilon=1.001e-5" in src and "momentum" not in src
    assert keras.layers.BatchNormalization().momentum == 0.99
    assert "epsilon=1.001e-5" in str(err.value)
    assert "momentum 0.99" in str(err.value)
    with pytest.raises(ValueError, match="known"):
        tzoo.cifar_cnn(policy="float16")
    with pytest.raises(ValueError, match="does not fit"):
        module_from_keras_numpy(tzoo.mnist_mlp(), keras_numpy_from_module(
            tzoo.mnist_mlp(hidden=(400, 300)))[0])
    with pytest.raises(ValueError, match="holds"):
        module_from_keras_numpy(tzoo.mnist_mlp(), [])
    # The zoo's own init: Keras' (glorot-uniform kernels, zero biases),
    # reproducible from its seed.
    a = keras_numpy_from_module(tzoo.cifar_cnn(seed=4))[0]
    b = keras_numpy_from_module(tzoo.cifar_cnn(seed=4))[0]
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
    assert not a[-1].any() and np.abs(a[0]).max() <= np.sqrt(6 / (27 + 288))

"""The port's utility surface and API repairs against the reference
(CPU), mirroring ``tests/test_serialization.py:9-38``:

- ``serialize_keras_model`` / ``deserialize_keras_model``: the
  ``{"model": json, "weights": [np.ndarray]}`` dict, picklable, exact
  round trip; ``"weights"`` is Keras' ``get_weights()`` list (order and
  layout) of the same model, exactly, on the BN model (per layer: each
  BN's gamma, beta, moving_mean, moving_variance together — not
  ``tv + ntv``);
- weights follow the layer kind: an ``Embedding`` table at V == E is
  carried as it is (the rank of an array would transpose it silently);
- ``to_dense_vector``, ``uniform_weights`` (the reference's draws for
  the same seed, exactly);
- ``trace`` writes a chrome trace on the CPU, ``annotate`` names a
  region in it;
- C5: the top-level ``__all__`` holds the reference's (every name is
  ported), and ``utils.__all__`` the reference's;
  C6: ``ModelAdapter(keras_model=...)``; C7:
  ``CheckpointManager(..., async_save=...)``;
- C8 / C9: each reference sub-package's and module's public names —
  its ``__all__`` and its public top-level functions and classes (data,
  models, ops, trainers, parallel and its modules, native, utils.misc,
  analysis and its modules) — are the port's, less the XLA-only helpers
  listed with their reasons; every reference module has a port module
  but the ones listed with theirs.
"""

import importlib
import inspect
import json
import pickle

import numpy as np
import pytest
import torch

import distkeras_tpu as dk
import distkeras_tpu.utils as dk_utils
import distkeras_tpu_torch as dkt
import distkeras_tpu_torch.utils as dkt_utils
from distkeras_tpu.models import zoo as jzoo
from distkeras_tpu.utils.misc import to_dense_vector as j_dense
from distkeras_tpu.utils.misc import uniform_weights as j_uniform
from tests.conftest import make_mlp
from tests.test_batchnorm_dp import bn_mlp
from tests.torch_dp_ranks import BNMLP

# ROADMAP items whose names the port does not export yet (none left).
NOT_PORTED = {}

# Reference names with no port, each with its reason: XLA sharding trees
# and compiled spellings whose job the port's own placement does.
_XLA_STATE = ("an XLA sharding tree for the ZeRO state; the port's "
              "ZeroState holds each rank's shards and Zero1Layout places "
              "them")
_HLO = ("it reads XLA's compiled HLO; the port's step census records the "
        "dispatched collectives instead")
NOT_PORTED_SUB = {
    "analysis.ir_lint": {
        "declared_zero1_exchange": "it reads the zero scopes off the "
                                   "jaxpr; the port's census reads the "
                                   "recorded step (declared_zero_exchange)",
    },
    "analysis.shard_lint": {
        "DECLARED_SCOPES": _HLO, "attributed": _HLO,
        "resharding_census": _HLO, "reshard_findings": _HLO},
    "ops.optimizers": {
        "zero1_offender": "it names the non-elementwise optax transform "
                          "in a chain; the port's zero_validate "
                          "(parallel/collectives.py) has no optax chain "
                          "to name"},
    "parallel.async_tier": {
        "make_wire_merge": "the shard_map spelling of one aggregation "
                           "wave for the XLA IR census; the port's "
                           "AsyncPlane merges on the host"},
    "parallel.collectives": {"zero1_state_shardings": _XLA_STATE},
    "parallel.exchange": {"exchange_state_shardings": _XLA_STATE},
    "parallel.mesh": {
        "enable_cpu_collectives": "an XLA CPU-backend flag; the port's "
                                  "CPU ranks join over gloo"},
    "parallel.rules": {"shard_view_rule": _XLA_STATE,
                       "zero3_param_shardings": _XLA_STATE,
                       "zero_state_rules": _XLA_STATE,
                       "zero_state_shardings": _XLA_STATE},
    "utils.misc": {
        "probe_devices": "a JAX device-discovery probe; the port's "
                         "process sees its one device",
        "probe_device_count_subprocess": "a JAX device-discovery probe "
                                         "in a child process; as "
                                         "probe_devices"},
}
# Reference modules with no port module, each with its reason.
NOT_PORTED_MODULES = {
    "parallel.compat": "a shim over jax versions' moved APIs; the port "
                       "has no jax",
}
SUBPACKAGES = ["data", "models", "ops", "ops.optimizers", "trainers",
               "parallel", "native", "utils.misc", "analysis"] + [
    f"parallel.{m}" for m in ("async_tier", "collectives", "exchange",
                              "mesh", "pipeline", "ring", "rules",
                              "sharding")] + [
    f"analysis.{m}" for m in ("contract_lint", "findings", "ir_lint",
                              "shard_lint", "source_lint", "targets",
                              "thread_lint")]


def test_round_trip():
    m = dkt.zoo.mnist_mlp(hidden=(32,), seed=0)
    blob = dkt.serialize_keras_model(m)
    assert isinstance(blob["model"], str)
    assert json.loads(blob["model"])["builder"] == "mnist_mlp"
    m2 = dkt.deserialize_keras_model(blob)
    assert type(m2) is type(m)
    for a, b in zip(dkt.get_weights(m), dkt.get_weights(m2)):
        np.testing.assert_array_equal(a, b)
    x = torch.rand(3, 784)
    with torch.no_grad():
        torch.testing.assert_close(m(x), m2(x), rtol=0, atol=0)
    with pytest.raises(ValueError, match="zoo"):
        dkt.serialize_keras_model(BNMLP())


def test_blob_is_picklable():
    m = dkt.zoo.cifar_cnn(num_classes=3, input_shape=(8, 8, 3), seed=1,
                          policy="mixed_bfloat16")
    m2 = dkt.deserialize_keras_model(pickle.loads(pickle.dumps(
        dkt.serialize_keras_model(m))))
    assert m2.policy == "mixed_bfloat16"
    for a, b in zip(dkt.get_weights(m), dkt.get_weights(m2)):
        np.testing.assert_array_equal(a, b)


def test_get_weights_is_keras_order_on_the_bn_model():
    jm = bn_mlp()
    # Make every variable distinct (the moving statistics too).
    j_uniform(jm, seed=4)
    tm = BNMLP()
    dkt.set_weights(tm, jm.get_weights())
    got, want = dkt.get_weights(tm), jm.get_weights()
    assert [w.path.split("/")[-1] for w in jm.weights] == [
        "kernel", "bias", "gamma", "beta", "moving_mean",
        "moving_variance", "kernel", "bias"]
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # Not tv + ntv: the adapter's lists are Keras' variable lists.
    tv, ntv = dkt.keras_numpy_from_module(tm)
    for a, v in zip(tv + ntv, jm.trainable_variables
                    + jm.non_trainable_variables):
        np.testing.assert_array_equal(a, np.asarray(v.value))
    assert not all(np.array_equal(a, b) for a, b in zip(tv + ntv, got))


def test_embedding_layout_follows_the_layer_at_v_equals_e():
    jm = jzoo.imdb_lstm(vocab_size=8, embed_dim=8, lstm_units=4, maxlen=6,
                        seed=0)
    tm = dkt.zoo.imdb_lstm(vocab_size=8, embed_dim=8, lstm_units=4,
                           maxlen=6, seed=1)
    tv = [np.asarray(v.value) for v in jm.trainable_variables]
    dkt.module_from_keras_numpy(tm, tv)
    table = tv[0]
    assert table.shape == (8, 8) and not np.allclose(table, table.T)
    np.testing.assert_array_equal(tm.embedding.weight.detach().numpy(),
                                  table)
    np.testing.assert_array_equal(tm.dense.weight.detach().numpy(),
                                  tv[-2].T)   # a Dense kernel transposes
    x = np.random.default_rng(0).integers(0, 8, (3, 6)).astype(np.int32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm(x)), rtol=1e-5, atol=1e-5)
    back = dkt.keras_numpy_from_module(tm)[0]
    for a, b in zip(back, tv):
        np.testing.assert_array_equal(a, b)
    # The adapter's ZeRO layout perms follow the layer too.
    ad = dkt.ModelAdapter(tm, device="cpu")
    assert ad.ref_perms() == [None, None, None, None, (1, 0), None]


def test_to_dense_vector():
    out = dkt.to_dense_vector(2, 4)
    np.testing.assert_array_equal(out, [0, 0, 1, 0])
    out = dkt.to_dense_vector([0, 3], 4)
    assert out.shape == (2, 4) and out[1, 3] == 1.0
    np.testing.assert_array_equal(dkt.to_dense_vector([1, 2, 0], 3),
                                  j_dense([1, 2, 0], 3))
    assert out.dtype == j_dense([0, 3], 4).dtype == np.float32


def test_uniform_weights():
    jm = make_mlp(seed=0)
    tm = dkt.zoo.MLP(16, (32,), 4)
    assert dkt.uniform_weights(tm, bounds=(-0.1, 0.1), seed=0) is tm
    for w in dkt.get_weights(tm):
        assert w.min() >= -0.1 and w.max() <= 0.1
    # The same draws as the reference's, in Keras' order and layout.
    j_uniform(jm, bounds=(-0.1, 0.1), seed=0)
    for a, b in zip(dkt.get_weights(tm), jm.get_weights()):
        np.testing.assert_array_equal(a, b)


def test_trace_and_annotate_write_a_file(tmp_path):
    with dkt_utils.trace(str(tmp_path / "prof")) as prof:
        with dkt_utils.annotate("dkt_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)

    @dkt_utils.annotate("dkt_decorated")
    def f():
        return torch.zeros(3) + 1

    with dkt_utils.trace(str(tmp_path / "prof")):
        f()
    files = sorted((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(files) == 2 and prof.last_path in map(str, files)
    text = "".join(p.read_text() for p in files)
    assert "dkt_region" in text and "dkt_decorated" in text


def test_top_level_all_holds_the_reference_minus_unported():
    unported = set().union(*NOT_PORTED.values())
    assert unported <= set(dk.__all__)
    for name in dk.__all__:
        if name in unported:
            assert name not in dkt.__all__, f"{name} is ported: drop it " \
                "from NOT_PORTED"
        else:
            assert name in dkt.__all__ and hasattr(dkt, name), name
    assert dkt.__version__ == dk.__version__
    assert set(dkt_utils.__all__) == set(dk_utils.__all__)
    for name in dkt_utils.__all__:
        assert hasattr(dkt_utils, name), name
    cfg = dkt.ExchangeConfig(merge_rule="adasum")
    assert cfg.label() == dk.ExchangeConfig(merge_rule="adasum").label()


def _public(module):
    """A module's ``__all__`` and its public top-level functions and
    classes."""
    return set(getattr(module, "__all__", ())) | {
        n for n, v in vars(module).items() if not n.startswith("_")
        and (inspect.isfunction(v) or inspect.isclass(v))
        and v.__module__ == module.__name__}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_surface_holds_the_reference(sub):
    ref = importlib.import_module(f"distkeras_tpu.{sub}")
    port = importlib.import_module(f"distkeras_tpu_torch.{sub}")
    skip = NOT_PORTED_SUB.get(sub, {})
    assert set(skip) <= _public(ref)
    for name in sorted(_public(ref)):
        if name in skip:
            assert not hasattr(port, name), f"{name} is ported: drop it"
            continue
        assert hasattr(port, name), f"{sub}.{name}"
        if hasattr(port, "__all__"):
            assert name in port.__all__, f"{sub}.{name} not in __all__"


def _modules(pkg):
    import os

    root = os.path.dirname(importlib.import_module(pkg).__file__)
    out = set()
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py") and "__pycache__" not in d:
                rel = os.path.relpath(os.path.join(d, f), root)[:-3]
                out.add(rel.replace(os.sep, ".").removesuffix(".__init__")
                        .removesuffix("__init__"))
    return out - {""}


def test_every_reference_module_has_a_port_module():
    ref, port = _modules("distkeras_tpu"), _modules("distkeras_tpu_torch")
    assert set(NOT_PORTED_MODULES) <= ref
    assert not set(NOT_PORTED_MODULES) & port
    assert ref - port == set(NOT_PORTED_MODULES)


def test_model_adapter_takes_keras_model():
    first = list(inspect.signature(dkt.ModelAdapter).parameters)[0]
    assert first == list(inspect.signature(dk.ModelAdapter).parameters)[0] \
        == "keras_model"
    m = dkt.zoo.MLP(16, (32,), 4)
    by_name = dkt.ModelAdapter(keras_model=m, device="cpu")
    positional = dkt.ModelAdapter(m, device="cpu")
    assert by_name.model is positional.model is m


def test_checkpoint_manager_takes_async_save(tmp_path):
    sig = inspect.signature(dkt.CheckpointManager)
    ref = inspect.signature(dk.CheckpointManager)
    assert list(sig.parameters) == list(ref.parameters)
    assert sig.parameters["async_save"].default is True
    for flag in (True, False):
        with dkt.CheckpointManager(str(tmp_path / str(flag)),
                                   async_save=flag) as m:
            assert m.async_save is flag
            m.save({"w": torch.arange(3.0)}, 1)
            if flag:  # the write finishes on the writer thread
                m.wait_until_finished()
            # (async_save=False: the step is committed on return.)
            assert m.latest_step() == 1
            torch.testing.assert_close(m.restore()["w"], torch.arange(3.0))

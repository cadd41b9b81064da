"""The port's data parallelism against the JAX package's, on the CPU.

The port's ranks are separate processes joined over gloo, started as a
user starts them: ``deploy.Job(...).run_local()`` on
``tests/torch_dp_ranks.py`` with a ``file://`` rendezvous under the
test's temporary directory (no TCP port, so parallel test workers never
collide).  Each spawn runs many cases; the ranks import neither jax nor
``distkeras_tpu``.  The JAX side runs here, on conftest's 8 CPU devices
(``num_workers=2/4``, a data mesh of 2), on the same numpy inputs and
the same initial weights.

Tolerances: histories, eval losses and weights at ``rtol=1e-4,
atol=1e-5`` (the Keras tolerance of tests/test_torch_keras_trainers.py:
the reference averages over the global batch in one reduction, the
port per rank and then over the group, so summation orders differ);
the LM's losses at 1e-5 and its gradients (recovered from one sgd step
at rate 1) at 1e-4.  ZeRO stages hold the port's own ``zero=None`` run
at the same tolerance, and every rank must hold the same result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import distkeras_tpu as dk
from distkeras_tpu.models import transformer as jtfm
from distkeras_tpu.parallel.mesh import MeshSpec, make_mesh
from tests.conftest import make_blobs, make_mlp
from tests.torch_dp_ranks import spawn

pytestmark = pytest.mark.multiprocess

TOL = dict(rtol=1e-4, atol=1e-5)


def keras_weights(model):
    return [np.asarray(v.value) for v in model.trainable_variables]


def keras_data():
    x, y = make_blobs(n=256)
    w = keras_weights(make_mlp(seed=0))
    return dict(x=x, y=y, n_w=np.asarray(len(w)),
                **{f"w{i}": a for i, a in enumerate(w)})


BASE = dict(batch_size=8, num_epoch=1, communication_window=2,
            worker_optimizer="adam", learning_rate=0.01)

# name -> (trainer, kw, eval): every one of these runs at world 2 and at
# JAX num_workers=2.
W2 = {
    "adag": ("ADAG", dict(BASE, probe_metrics=True, eval_every=2), True),
    "dynsgd_device_data": ("DynSGD", dict(BASE, worker_optimizer="sgd",
                                          learning_rate=0.1,
                                          device_data=True), False),
    "zero1": ("ADAG", dict(BASE, zero=1), False),
    "zero2": ("ADAG", dict(BASE, zero=2, probe_metrics=True), False),
    "zero3": ("ADAG", dict(BASE, zero=3, eval_every=2), True),
    "zero3_device_data": ("ADAG", dict(BASE, zero=3, device_data=True),
                          False),
    "adasum": ("ADAG", dict(BASE, merge_rule="adasum"), False),
    "local_sgd": ("ADAG", dict(BASE, sync_every=2), False),
    "int8": ("ADAG", dict(BASE, compress="int8", probe_metrics=True),
             False),
    "topk": ("ADAG", dict(BASE, compress="topk", topk_frac=0.25), False),
    "zero1_int8": ("ADAG", dict(BASE, zero=1, compress="int8"), False),
}

# World 4: the synchronous pair and the replica family.
REPLICA = dict(batch_size=8, num_epoch=2)
W4 = {
    "adag4": ("ADAG", dict(BASE, eval_every=2), True),
    "dynsgd4_zero3": ("DynSGD", dict(BASE, zero=3), False),
    "aeasgd4": ("AEASGD", dict(REPLICA, learning_rate=0.05, rho=1.0,
                               communication_window=2, eval_every=2), True),
    "eamsgd4": ("EAMSGD", dict(REPLICA, learning_rate=0.02, rho=1.0,
                               momentum=0.9, communication_window=2), False),
    "downpour4_device_data": ("DOWNPOUR", dict(REPLICA, learning_rate=0.05,
                                               communication_window=2,
                                               device_data=True), False),
    "averaging4": ("AveragingTrainer", dict(REPLICA, learning_rate=0.1),
                   False),
    "ensemble4": ("EnsembleTrainer", dict(REPLICA, learning_rate=0.1,
                                          seed=3), False),
}


def jax_keras(trainer, kw, world, with_eval):
    x, y = make_blobs(n=256)
    kw = dict(kw)
    if trainer == "EnsembleTrainer":
        kw["num_models"] = world
    else:
        kw["num_workers"] = world
    t = getattr(dk, trainer)(make_mlp(seed=0),
                             loss="sparse_categorical_crossentropy", **kw)
    ev = dk.Dataset.from_arrays(x[:50], y[:50]) if with_eval else None
    out = t.train(dk.Dataset.from_arrays(x, y), eval_dataset=ev)
    models = out if isinstance(out, list) else [out]
    return t, [keras_weights(m) for m in models]


@pytest.fixture(scope="module")
def keras_w2(tmp_path_factory):
    cases = [dict(name=k, kind="keras", trainer=t, kw=kw, eval=ev)
             for k, (t, kw, ev) in W2.items()]
    cases.append(dict(name="prims", kind="prims"))
    return spawn(tmp_path_factory.mktemp("w2"), 2, cases, keras_data())


@pytest.fixture(scope="module")
def keras_w4(tmp_path_factory):
    cases = [dict(name=k, kind="keras", trainer=t, kw=kw, eval=ev)
             for k, (t, kw, ev) in W4.items()]
    cases.append(dict(name="prims", kind="prims"))
    return spawn(tmp_path_factory.mktemp("w4"), 4, cases, keras_data())


def assert_same_ranks(per_rank, keys):
    for got in per_rank[1:]:
        for k in keys:
            np.testing.assert_array_equal(got[k], per_rank[0][k], err_msg=k)


def assert_matches_jax(name, table, results, world):
    trainer, kw, with_eval = table[name]
    jt, jmodels = jax_keras(trainer, kw, world, with_eval)
    got = results[name][0]
    w_keys = [k for k in got if k.startswith("m")]
    assert_same_ranks(results[name], ["history"] + w_keys)
    assert len(got["history"]) == len(jt.history) > 0
    np.testing.assert_allclose(got["history"], jt.history, **TOL)
    if with_eval:
        np.testing.assert_allclose(
            got["eval_loss"], [e["loss"] for _, e in jt.eval_history], **TOL)
    assert int(got["n_models"]) == len(jmodels)
    for m, weights in enumerate(jmodels):
        for i, w in enumerate(weights):
            np.testing.assert_allclose(got[f"m{m}_w{i}"], w, **TOL,
                                       err_msg=f"{name} model {m} w{i}")
    if kw.get("probe_metrics"):
        np.testing.assert_allclose(
            got["probe"], [p["grad_norm"] for p in jt.probe_history], **TOL)
    return got


@pytest.mark.parametrize("name", list(W2))
def test_world2_matches_jax(keras_w2, name):
    got = assert_matches_jax(name, W2, keras_w2, 2)
    if name.startswith("zero") and "int8" not in name:
        # Every stage is the zero=None math.
        ref = keras_w2["adag"][0]
        np.testing.assert_allclose(got["history"], ref["history"], **TOL)


@pytest.mark.parametrize("name", list(W4))
def test_world4_matches_jax(keras_w4, name):
    assert_matches_jax(name, W4, keras_w4, 4)


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_over_gloo(keras_w2, keras_w4, world):
    per_rank = (keras_w2 if world == 2 else keras_w4)["prims"]
    n = world
    base = np.arange(4 * n, dtype=np.float32)
    total = base * sum(r + 1 for r in range(n))
    weights = np.arange(4 * n, dtype=np.float32).reshape(n, 4) + 1.0
    for r, got in enumerate(per_rank):
        np.testing.assert_array_equal(got["rs"], total.reshape(n, 4)[r])
        np.testing.assert_array_equal(
            got["ag"], np.repeat(np.arange(n, dtype=np.float32)[:, None],
                                 3, 1))
        rows = np.stack([base.reshape(n, 4)[k] + 10 * k for k in range(n)])
        np.testing.assert_array_equal(got["gb_fwd"], rows)
        # The backward: the owned row of the gradient, summed over ranks.
        np.testing.assert_array_equal(got["gb_grad"], n * weights[r])
        # Adasum: parallel contributions -> their mean-like combination
        # (identical directions), orthogonal ones -> their sum.
        np.testing.assert_allclose(got["ada_orth"], np.ones(n), rtol=1e-6)
        assert "unequal counts across processes: 0.." in str(got["unequal"])
        assert int(got["equal"]) == 7 and int(got["rows"]) == 8
        assert list(got["foreign"]) == [""]        # no JAX in a rank
        np.testing.assert_array_equal(got["gbatch"],
                                      np.arange(4 * n)[4 * r:4 * r + 4])
    ada = [np.asarray(g["ada"]) for g in per_rank]
    for a in ada[1:]:
        np.testing.assert_array_equal(a, ada[0])
    from distkeras_tpu.parallel.exchange import adasum_combine

    want = adasum_combine(jnp.asarray(
        [[1.0, 2.0]] * 1) * jnp.arange(1, n + 1, dtype=jnp.float32)[:, None])
    np.testing.assert_allclose(ada[0], np.asarray(want), rtol=1e-6)


# ---------------------------------------------------------------- the LM

LM_BASE = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
               max_len=32)
LM = dict(batch_size=4, optimizer="sgd", learning_rate=0.5)
# name -> (kw, segments); 4 steps of 4 rows (2 per rank).  sgd, so a
# weight's difference is the rate times its gradients' (adam's
# normalization turns last-bit noise of a near-zero gradient into a
# rate-sized step); "lm" covers adam.
LM_CASES = {
    "lm": (dict(LM, optimizer="adam", learning_rate=1e-2,
                probe_metrics=True), False),
    "lm_zero1": (dict(LM, zero=1), False),
    "lm_zero2": (dict(LM, zero=2, grad_accum=2), False),
    "lm_zero3": (dict(LM, zero=3), False),
    "lm_int8": (dict(LM, compress="int8"), False),
    "lm_zero1_int8": (dict(LM, zero=1, compress="int8"), False),
    "lm_adasum": (dict(LM, merge_rule="adasum"), False),
    "lm_local_sgd": (dict(LM, sync_every=2), False),
    "lm_segments": (dict(LM, grad_clip_norm=0.5), True),
}
# One sgd step at rate 1: the gradient is ``p0 - p1``.
GRAD_CASES = {f"grad_{k}": dict(batch_size=4, optimizer="sgd",
                                learning_rate=1.0, **kw)
              for k, kw in (("dp", {}), ("zero1", dict(zero=1)),
                            ("zero3", dict(zero=3)),
                            ("int8", dict(compress="int8")))}


def lm_data():
    cfg = jtfm.TransformerConfig(**LM_BASE)
    params = jax.tree.map(np.asarray,
                          jtfm.init_params(jax.random.key(0), cfg))
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 64, (16, 17)).astype(np.int32)
    docs = [rng.integers(1, 64, size=int(n))
            for n in rng.integers(2, 14, size=64)]
    from distkeras_tpu_torch.data.packing import pack_documents

    rows, seg = pack_documents(docs, 16)
    flat = {"p/" + jax.tree_util.keystr(p, simple=True, separator="/"): v
            for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    return cfg, params, dict(tokens=tokens, segments=seg[:16],
                             seg_tokens=rows[:16], **flat)


@pytest.fixture(scope="module")
def lm_w2(tmp_path_factory):
    _, _, data = lm_data()
    cases = [dict(name=k, kind="lm", kw=kw, segments=seg)
             for k, (kw, seg) in LM_CASES.items()]
    cases += [dict(name=k, kind="lm", kw=kw, rows=4)
              for k, kw in GRAD_CASES.items()]
    return spawn(tmp_path_factory.mktemp("lm"), 2, cases, data,
                 cfg=LM_BASE)


def jax_lm(kw, segments=False, rows=None):
    cfg, params, data = lm_data()
    mesh = make_mesh(MeshSpec(data=2), devices=jax.devices()[:2])
    t = dk.LMTrainer(cfg, mesh=mesh, **kw)
    tokens = data["seg_tokens"] if segments else data["tokens"]
    out = t.train(tokens[:rows] if rows else tokens,
                  params=jax.tree.map(jnp.asarray, params),
                  segments=data["segments"] if segments else None)
    return t, params, jax.tree.map(np.asarray, out)


def flat_params(tree):
    return {jax.tree_util.keystr(p, simple=True, separator="/"): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_int8_close(got, want, bound, frac, what):
    """The int8 rule: an int8 code whose f32 pre-image sits within float
    rounding of a .5 boundary may round apart between XLA and torch (the
    codec itself is bit-identical on the same input,
    tests/test_torch_dp_exchange.py).  Such a flip moves one gradient
    element by one quantization step (<= the row's amax / 127); sgd
    carries it into the weights and the next steps.  So: at most
    ``frac`` of the elements outside 1e-4, none by more than ``bound``."""
    diff = np.abs(got - want)
    off = diff > 1e-4 + 1e-4 * np.abs(want)
    assert off.mean() <= frac, (what, off.mean())
    assert diff.max() <= bound, (what, diff.max(), bound)


@pytest.mark.parametrize("name", list(LM_CASES))
def test_lm_world2_matches_jax(lm_w2, name):
    kw, seg = LM_CASES[name]
    jt, _, jout = jax_lm(kw, segments=seg)
    got = lm_w2[name][0]
    p_keys = [k for k in got if k.startswith("p/")]
    assert_same_ranks(lm_w2[name], ["history"] + p_keys)
    assert len(got["history"]) == len(jt.history) > 0
    np.testing.assert_allclose(got["history"], jt.history, rtol=1e-5,
                               atol=1e-5)
    want = flat_params(jout)
    if kw.get("compress") == "int8":
        # 4 sgd steps at rate 0.5 (see assert_int8_close), over the tree.
        assert_int8_close(np.concatenate([got["p/" + k].ravel()
                                          for k in want]),
                          np.concatenate([v.ravel() for v in want.values()]),
                          4e-3, 0.05, name)
    for k, v in want.items():
        if kw.get("compress") != "int8":
            np.testing.assert_allclose(got["p/" + k], v, rtol=1e-4,
                                       atol=1e-4, err_msg=f"{name} {k}")
    if kw.get("probe_metrics"):
        np.testing.assert_allclose(
            got["probe"], [p["grad_norm"] for p in jt.probe_history],
            rtol=1e-5)


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_lm_world2_gradients_match_jax(lm_w2, name):
    _, p0, jout = jax_lm(GRAD_CASES[name], rows=4)
    got = lm_w2[name][0]
    start = flat_params(p0)
    want = {k: start[k] - v for k, v in flat_params(jout).items()}
    if name == "grad_int8":
        # One step: a flip is one quantization step of a rank's
        # contribution (<= its row amax / 127, the rows up to n x the
        # mean gradient) and of the re-quantized chunk.
        g = np.concatenate([v.ravel() for v in want.values()])
        assert_int8_close(np.concatenate([(start[k] - got["p/" + k]).ravel()
                                          for k in want]), g,
                          4 * float(np.abs(g).max()) / 127, 1e-3, name)
        return
    for k, g in want.items():
        np.testing.assert_allclose(start[k] - got["p/" + k], g, rtol=1e-4,
                                   atol=1e-4, err_msg=f"{name} {k}")

"""The data-parallel layer's pieces against the JAX package's, with no
process group (CPU, one process).

Exact (bit for bit / equal): ``int8_encode`` on the same f32 input;
the int8 and top-k bucket merges of one replica (ties in the top-k
magnitudes pick the reference's indices); ``Zero1Layout``'s slots,
bucket widths, dtypes and codec groups on the flagship's small-config
tree and on the CIFAR CNN's and the MLP's Keras trees (the port's
kernels through their permutation into Keras' layout); ``wire_bytes``
and ``topk_k``; the rule engine's matches and messages;
``normalize_zero_args``, ``ExchangeConfig`` and the trainers' refusals
(the reference's messages).  ``adasum_combine`` at 1e-6 (summation
order).  Also the port's own contracts: the mesh, the plans, the
``deploy.Job`` environment and the device rule.
"""

import re

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, PartitionSpec as P

import distkeras_tpu as dk
import distkeras_tpu_torch as dkt
from distkeras_tpu.models import transformer as jtfm
from distkeras_tpu.parallel import collectives as jcoll
from distkeras_tpu.parallel import exchange as jex
from distkeras_tpu.parallel import rules as jrules
from distkeras_tpu.parallel.compat import shard_map
from distkeras_tpu.trainers.base import normalize_zero_args as j_norm
from distkeras_tpu_torch.deploy import Job, init_from_env
from distkeras_tpu_torch.parallel import collectives as tcoll
from distkeras_tpu_torch.parallel import exchange as tex
from distkeras_tpu_torch.parallel import mesh as tmesh
from distkeras_tpu_torch.parallel import rules as trules
from distkeras_tpu_torch.parallel import sharding as tshard
from distkeras_tpu_torch.trainers.base import normalize_zero_args as t_norm
from tests.conftest import make_blobs, make_mlp

SMALL = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
             max_len=32)


def one_mesh():
    return tmesh.make_mesh()


def jax_one(devices, fn, *args):
    """``fn`` inside a shard_map over one device (the reference's merges
    run per replica there)."""
    mesh = JMesh(np.array(devices[:1]), ("data",))
    return shard_map(fn, mesh=mesh, in_specs=tuple(P() for _ in args),
                     out_specs=P(), check_vma=False)(*args)


# ------------------------------------------------------------- codecs


@pytest.mark.parametrize("seed,shape", [(0, (4, 33)), (1, (2, 1000)),
                                        (2, (8, 7))])
def test_int8_encode_bit_identical(seed, shape):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 10.0 ** rng.integers(-6, 3, (shape[0], 1))
         ).astype(np.float32)
    x[0] = 0.0                                     # an all-zero row
    x[-1, :3] = [0.5, -0.5, 1.5]                   # half-way values
    jq, js = jex.int8_encode(x)
    tq, ts = tex.int8_encode(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tex.int8_decode(tq, ts).numpy(),
                                  np.asarray(jex.int8_decode(jq, js)))


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5])
def test_adasum_combine_matches_jax(m):
    rng = np.random.default_rng(m)
    stack = rng.normal(size=(m, 40)).astype(np.float32)
    if m > 2:
        stack[1] = 0.0                             # the zero-norm guard
    np.testing.assert_allclose(
        tex.adasum_combine(torch.from_numpy(stack)).numpy(),
        np.asarray(jex.adasum_combine(stack)), rtol=1e-6, atol=1e-7)
    same = np.tile(stack[:1], (m, 1))
    np.testing.assert_allclose(tex.adasum_combine(torch.from_numpy(same)),
                               stack[0], rtol=1e-6)


def test_topk_merge_matches_jax_with_ties(devices):
    rng = np.random.default_rng(3)
    bucket = rng.integers(-3, 4, size=(1, 64)).astype(np.float32)  # ties
    e1 = np.zeros_like(bucket)
    e1[0, :5] = 0.25
    for k in (1, 7, 20):
        jm, je = jax_one(devices, lambda b, e: jex._merge_bucket_topk(
            b, e, "data", 1, k), bucket, e1)
        tm, te = tex._merge_bucket_topk(torch.from_numpy(bucket),
                                        torch.from_numpy(e1), one_mesh(), k)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))


@pytest.mark.parametrize("zero1", [False, True])
def test_int8_merge_matches_jax(devices, zero1):
    rng = np.random.default_rng(4)
    bucket = rng.normal(size=(1, 96)).astype(np.float32)
    e1 = (rng.normal(size=(1, 96)) * 1e-3).astype(np.float32)
    e2 = (rng.normal(size=(96,)) * 1e-3).astype(np.float32)
    jout = jax_one(devices, lambda b, a, c: jex._merge_bucket_int8(
        b, a, c, "data", 1, zero1), bucket, e1, e2)
    tout = tex._merge_bucket_int8(torch.from_numpy(bucket),
                                  torch.from_numpy(e1), torch.from_numpy(e2),
                                  one_mesh(), zero1)
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------- layouts


def flagship_trees():
    jcfg = jtfm.TransformerConfig(**SMALL)
    jp = jtfm.init_params(jax.random.key(0), jcfg)
    tp = dkt.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jp, tp


def keras_pair(jm, tm):
    """The Keras model's trainable tree, the port's module holding the
    same weights, and its permutations into Keras' layout."""
    jw = [v.value for v in jm.trainable_variables]
    dkt.module_from_keras_numpy(tm, [np.asarray(w) for w in jw])
    ad = dkt.ModelAdapter(tm, device="cpu")
    return jw, list(tm.parameters()), ad.ref_perms()


def cnn_trees():
    from distkeras_tpu.models import zoo as jzoo

    return keras_pair(jzoo.cifar_cnn(), dkt.zoo.cifar_cnn())


def mlp_trees():
    return keras_pair(make_mlp(), dkt.zoo.MLP(16, (32,), 4))


def assert_same_layout(t, j):
    assert t.n == j.n
    assert t.bucket_cols == j.bucket_cols
    assert [str(d).replace("torch.", "") for d in t.bucket_dtypes] == \
        [str(np.dtype(d)) for d in j.bucket_dtypes]
    assert t.bucket_groups == j.bucket_groups
    assert len(t.slots) == len(j.slots)
    for a, b in zip(t.slots, j.slots):
        assert (a.shape, a.size, a.cols, a.bucket, a.offset) == \
            (tuple(b.shape), b.size, b.cols, b.bucket, b.offset)


@pytest.mark.parametrize("tree", ["flagship", "cifar_cnn", "mlp"])
@pytest.mark.parametrize("n,mb", [(2, 4.0), (4, 0.01), (8, 0.002)])
def test_zero1_layout_matches_jax(tree, n, mb):
    if tree == "flagship":
        jp, tp = flagship_trees()
        perms = None
    else:
        jp, tp, perms = cnn_trees() if tree == "cifar_cnn" else mlp_trees()
    j = jcoll.Zero1Layout.for_tree(jp, n, mb)
    t = tcoll.Zero1Layout.for_tree(tp, n, mb, perms=perms)
    assert_same_layout(t, j)
    # The chunk-major views hold the same elements.
    for jv, tv in zip(jax.tree.leaves(j.shard_views(jp)), t.shard_views(tp)):
        np.testing.assert_array_equal(tv.detach().numpy(), np.asarray(jv))
    # pack / unpack and the per-rank rows round-trip.
    back = t.unpack(t.pack(tp))
    for a, b in zip(back, tcoll.tree_leaves(tp)):
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())
    rows = [b[n - 1] for b in t.pack(tp)]
    for s, v in zip(t.rows_to_shards(rows), t.shard_views(tp)):
        np.testing.assert_array_equal(s.detach().numpy(),
                                      v[n - 1].detach().numpy())


@pytest.mark.parametrize("n", [2, 4])
def test_codec_rule_layout_and_wire_bytes_match_jax(n):
    jp, tp = flagship_trees()
    rules = [("emb", "topk"), (".*", "int8")]
    for compress, zero1 in ((rules, False), ("int8", False), ("int8", True),
                            ("topk", False), (None, False)):
        for merge in (("mean", "adasum") if compress is None else ("mean",)):
            jc = jex.ExchangeConfig(merge_rule=merge, compress=compress,
                                    topk_frac=0.05, bucket_mb=0.01)
            tc = tex.ExchangeConfig(merge_rule=merge, compress=compress,
                                    topk_frac=0.05, bucket_mb=0.01)
            jl, tl = jex.exchange_layout(jp, n, jc), tex.exchange_layout(
                tp, n, tc)
            assert_same_layout(tl, jl)
            assert tex.wire_bytes(tl, tc, zero1) == jex.wire_bytes(
                jl, jc, zero1)
            assert tex._residual_shapes(tl, tc, zero1) == \
                jex._residual_shapes(jl, jc, zero1)
            for cols in tl.bucket_cols:
                assert tex.topk_k(tc, cols, n) == jex.topk_k(jc, cols, n)


# -------------------------------------------------------- configs, rules


@pytest.mark.parametrize("args", [
    (None, False, None, None), (None, True, None, None), (2, False, 1.0, None),
    (3, True, None, None), (5, False, None, None), (1, False, 1.0, 2.0),
    (0, False, None, 0.5)])
def test_normalize_zero_args_matches_jax(args):
    try:
        want = j_norm(*args)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            t_norm(*args)
        return
    assert t_norm(*args) == want


@pytest.mark.parametrize("kw", [
    dict(merge_rule="median"), dict(compress="fp8"), dict(sync_every=0),
    dict(topk_frac=0.0), dict(compress="int8", merge_rule="adasum"),
    dict(compress="topk", sync_every=2), dict(compress=[]),
    dict(compress=[("x", "fp8")]), dict(compress=["bad"]),
    dict(merge_rule="adasum", sync_every=3, bucket_mb=1.0)])
def test_exchange_config_matches_jax(kw):
    try:
        jc = jex.ExchangeConfig(**kw)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            tex.ExchangeConfig(**kw)
        return
    tc = tex.ExchangeConfig(**kw)
    assert (tc.label(), tc.is_default, tc.needs_grad_exchange) == \
        (jc.label(), jc.is_default, jc.needs_grad_exchange)


@pytest.mark.parametrize("kw", [
    dict(compress="int8", device_data=True),
    dict(zero=2, compress="int8"), dict(zero=1, merge_rule="adasum"),
    dict(sync_every=2, probe_metrics=True),
    dict(probe_metrics=True, device_data=True), dict(zero_bucket_mb=1.0),
    dict(zero=2, zero1=True)])
def test_trainer_refusals_match_jax(kw):
    with pytest.raises(ValueError) as want:
        dk.ADAG(make_mlp(), num_workers=1, **kw)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        dkt.ADAG(dkt.zoo.MLP(16, (32,), 4), device="cpu", **kw)


def test_replica_family_refusals_match_jax():
    for cls in ("AEASGD", "DOWNPOUR", "EnsembleTrainer"):
        for kw in (dict(zero=1), dict(merge_rule="adasum")):
            with pytest.raises(ValueError) as want:
                getattr(dk, cls)(make_mlp(), num_workers=1, **kw)
            with pytest.raises(ValueError,
                               match=re.escape(str(want.value))):
                getattr(dkt, cls)(dkt.zoo.MLP(16, (32,), 4), device="cpu",
                                  **kw)


def test_rules_match_jax():
    jp, tp = flagship_trees()
    rules = [("attn/w[qk]", "a"), ("ffn", "f"), ("_scale$", "s"),
             (".*", lambda name, leaf: "big" if leaf.ndim > 2 else None),
             ("emb", "e")]
    assert dkt.parallel.rules.match_rules(rules, tp) == \
        jrules.match_rules(rules, jp)
    with pytest.raises(jrules.UnmatchedLeafError) as want:
        jrules.match_rules([("atn/wq", 1)], jp, what="codec")
    with pytest.raises(trules.UnmatchedLeafError) as got:
        trules.match_rules([("atn/wq", 1)], tp, what="codec")
    assert str(got.value) == str(want.value)
    for name in ("layers/attn/wq", "tok_emb", "x"):
        pats = ["layers/atn", "tok_emb$", "ffn/w1", "zzz"]
        assert trules.nearest_patterns(name, pats) == \
            jrules.nearest_patterns(name, pats)
    with pytest.raises(ValueError, match="duplicate pattern"):
        trules.compile_rules([("a", 1), ("a", 2)])
    trules.compile_rules([("a", lambda n, x: None), ("a", 2)])
    codecs = tex.resolve_codecs([("emb", "topk"), (".*", "int8")], tp)
    assert codecs == jex.resolve_codecs([("emb", "topk"), (".*", "int8")],
                                        jp)
    assert trules.leaf_name(("layers", 0, "wq")) == "layers/0/wq"


# -------------------------------------------------- mesh, plans, deploy


def test_mesh_and_plans():
    for spec, n in ((tmesh.MeshSpec(), 4), (tmesh.MeshSpec(data=2), 2),
                    (tmesh.MeshSpec(model=2), 4)):
        from distkeras_tpu.parallel.mesh import MeshSpec as JSpec

        assert spec.resolve(n) == JSpec(**vars(spec)).resolve(n)
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.MeshSpec(model=3).resolve(4)
    m = tmesh.make_mesh()
    assert (m.size, m.rank, m.group, m.backend) == (1, 0, None, None)
    assert m.shape == dict(data=1, model=1, pipeline=1, seq=1, expert=1)
    # Every axis may exceed 1: a seq / pipeline / expert mesh resolves as
    # the reference's does, and its one-axis views carry the coordinate.
    for kw in (dict(seq=2), dict(pipeline=2, data=2), dict(expert=2,
                                                           seq=2)):
        from distkeras_tpu.parallel.mesh import MeshSpec as JSpec

        assert tmesh.MeshSpec(**kw).resolve(4) == JSpec(**kw).resolve(4)
    grid = tmesh.Mesh(shape=dict(data=1, model=1, pipeline=2, seq=2,
                                 expert=1),
                      coords=dict(data=0, model=0, pipeline=1, seq=0,
                                  expert=0))
    assert (grid.sub("pipeline").size, grid.sub("pipeline").rank) == (2, 1)
    assert not hasattr(tmesh, "check_axes")
    assert tmesh.local_device_count() == 1
    assert tmesh.per_host_rows(8) == 8
    assert tmesh.equal_across_hosts(3, "x") == 3
    arr = np.arange(6)
    assert tmesh.global_batch(arr, m) is arr
    # The rule-driven plans are ported (tests/test_torch_tp.py holds
    # their specs to the reference's).
    assert tshard.fsdp_plan().fsdp_axis == "data"
    assert tshard.serving_plan().batch_spec == ()
    assert len(tshard.tp_plan().rules) == 3
    assert tshard.ShardingPlan(rules=[("x", None)]).rules[0][0].pattern \
        == "x"
    assert (tshard.zero1_plan(2.0).zero, tshard.zero1_plan().zero1,
            tshard.zero1_plan().bucket_mb, tshard.zero3_plan().zero,
            tshard.dp_plan().zero) == (1, True, 4.0, 3, 0)


def test_deploy_job_environment(monkeypatch, tmp_path):
    job = Job("train.py", world=4, coordinator="10.0.0.1:29400",
              procs_per_host=2, env={"A": 1}, args=("--x", 3))
    env = job.env_for(3)
    assert env == {"A": "1", "RANK": "3", "WORLD_SIZE": "4",
                   "LOCAL_RANK": "1", "MASTER_ADDR": "10.0.0.1",
                   "MASTER_PORT": "29400"}
    assert job.command_for(0) == (
        "env A=1 LOCAL_RANK=0 MASTER_ADDR=10.0.0.1 MASTER_PORT=29400 "
        "RANK=0 WORLD_SIZE=4 python3 train.py --x 3")
    assert len(job.command_lines()) == 4
    with pytest.raises(ValueError, match="outside"):
        job.env_for(4)
    assert Job("t.py", init_method="file:///r").env_for(0)[
        "DKT_INIT_METHOD"] == "file:///r"
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert init_from_env(device="cpu") is None       # a lone script
    # A rank that fails stops the job, named; a hang hits the deadline.
    bad = tmp_path / "bad.py"
    bad.write_text("import sys; sys.exit(3)\n")
    with pytest.raises(RuntimeError, match="rank 0 exited with returncode"):
        Job(str(bad), world=2).run_local(timeout=60)
    out = Job(str(bad), world=1).run_local(check=False, timeout=60)
    assert out[0].returncode == 3
    slow = tmp_path / "slow.py"
    slow.write_text("import time; time.sleep(30)\n")
    with pytest.raises(TimeoutError, match="ranks killed"):
        Job(str(slow), world=2).run_local(timeout=1)


def test_device_rule_for_ranks(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmesh.initialize_multihost(world_size=1, rank=0)
    with pytest.raises(ValueError, match="nccl"):
        tmesh.initialize_multihost(world_size=1, rank=0, device="cpu",
                                   backend="nccl")


def test_world1_zero_and_exchange_are_plain_adag():
    """With no process group every stage and codec-free policy is the
    one-replica math: zero=1/2/3 and adasum equal plain ADAG."""
    x, y = make_blobs(n=128)
    ds = dkt.Dataset.from_arrays(x, y)
    runs = {}
    for name, kw in (("plain", {}), ("zero1", dict(zero=1)),
                     ("zero2", dict(zero=2)), ("zero3", dict(zero=3)),
                     ("adasum", dict(merge_rule="adasum"))):
        model = dkt.zoo.MLP(16, (32,), 4)
        dkt.module_from_keras_numpy(
            model, [np.asarray(v.value)
                    for v in make_mlp().trainable_variables])
        t = dkt.ADAG(model, loss="sparse_categorical_crossentropy",
                     worker_optimizer="adam", learning_rate=0.01,
                     batch_size=8, communication_window=2, device="cpu", **kw)
        out = t.train(ds)
        runs[name] = (np.array(t.history),
                      dkt.keras_numpy_from_module(out)[0])
    h0, w0 = runs.pop("plain")
    for name, (h, w) in runs.items():
        np.testing.assert_allclose(h, h0, rtol=1e-6, atol=1e-7, err_msg=name)
        for a, b in zip(w, w0):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7,
                                       err_msg=name)

"""The port's model axis and FSDP against the JAX package, on the CPU.

The port runs one process per device: ranks of a ``MeshSpec(data=d,
model=m)`` grid joined over gloo (``tests/torch_dp_ranks.py::spawn``,
one spawn per world size running every case: ``(data=1, model=2)``
and ``(data=2)`` with ``fsdp=True`` on two ranks, ``(data=2,
model=2)`` on four).  Weights come from the reference's numpy tree, placed
by ``sharded_params_from_numpy``; the ranks import neither jax nor
``distkeras_tpu``.  The JAX side runs the same math unsharded, on one
device.

Bounds: f32 greedy tokens and block ids equal; logits within 1e-5 x
max |logit| (an all-reduce changes only the summation order); LM loss
histories at rtol 2e-4 (``tests/test_fsdp.py``'s bound); gradients
(one sgd step at rate 1) within 1e-4; per-rank parameter and KV bytes
about 1/m of one process's; a TP checkpoint resumes bit for bit.  The
placement itself (every leaf's spec, and each rank's slice of it)
equals the reference's exactly, and so do the validation messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import distkeras_tpu as dk
import distkeras_tpu_torch as dkt
from distkeras_tpu.models import generate as jgen
from distkeras_tpu.models import transformer as jtfm
from distkeras_tpu.parallel import rules as jrules
from distkeras_tpu.parallel import sharding as jshard
from distkeras_tpu.parallel.mesh import MeshSpec, make_mesh
from distkeras_tpu_torch.models import transformer as ttfm
from distkeras_tpu_torch.parallel import mesh as tmesh
from distkeras_tpu_torch.parallel import rules as trules
from distkeras_tpu_torch.parallel import sharding as tshard
from tests.conftest import make_blobs, make_mlp
from tests.torch_dp_ranks import spawn

pytestmark = pytest.mark.multiprocess

CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_len=32, rope=True, n_kv_heads=2)
# 4 sgd steps of 4 rows; "grad": one step at rate 1 (the gradient is
# p0 - p1).  sgd, so a weight's difference is the rate times its
# gradients'.
LM = dict(batch_size=4, optimizer="sgd", learning_rate=0.5,
          probe_metrics=True)
GRAD = dict(batch_size=4, optimizer="sgd", learning_rate=1.0)
NEW = 6


def jcfg():
    return jtfm.TransformerConfig(**CFG)


def ref_params():
    return jax.tree.map(np.asarray,
                        jtfm.init_params(jax.random.key(0), jcfg()))


def named(tree):
    return {jax.tree_util.keystr(p, simple=True, separator="/"): v
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def flat(tree):
    return {k: np.asarray(v) for k, v in named(tree).items()}


def data():
    rng = np.random.default_rng(11)
    # The prompts share a 5-token prefix: prompt_cache and the prefix
    # pool decode their 7-token tails past it.
    prompts = rng.integers(0, 64, (2, 12)).astype(np.int32)
    prompts[1, :5] = prompts[0, :5]
    return dict(tokens=rng.integers(0, 64, (16, 17)).astype(np.int32),
                prompts=prompts, prefix=prompts[0, :5].copy(),
                **{"p/" + k: v for k, v in flat(ref_params()).items()})


def fake_mesh(**axes):
    """A port mesh of this shape with no process group (placement and
    validation only)."""
    shape = dict({a: 1 for a in tmesh.AXES}, **axes)
    return tmesh.Mesh(shape=shape,
                      coords={a: 0 for a in tmesh.AXES})


# ------------------------------------------------------------ spawns


def lm_cases(mesh, prefix, **extra):
    return [dict(name=f"{prefix}_lm", kind="lm", kw=dict(LM), mesh=mesh,
                 **extra),
            dict(name=f"{prefix}_grad", kind="lm", kw=dict(GRAD), rows=4,
                 mesh=mesh, **extra)]


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    """World 2: the model-axis cases (data=1 x model=2), then the fsdp
    cases (data=2), each case on its own mesh of the same two ranks."""
    mesh = dict(data=1, model=2)
    cases = lm_cases(mesh, "tp")
    cases += [dict(name=f"tp_resume{tag}", kind="lm", mesh=mesh,
                   dropout=0.1, resume=dict(at=2),
                   kw=dict(LM, probe_metrics=False, checkpoint_backend=b))
              for tag, b in (("", "pickle"), ("_orbax", "orbax"))]
    cases += [
              dict(name="decode", kind="tp", fn="decode_case", mesh=mesh,
                   plan="serving", new=NEW),
              dict(name="fsdp_lm", kind="lm", kw=dict(LM, fsdp=True),
                   mesh=dict(data=2)),
              dict(name="fsdp_grad", kind="lm", kw=dict(GRAD, fsdp=True),
                   rows=4, mesh=dict(data=2)),
              dict(name="adag_fsdp", kind="keras", trainer="ADAG",
                   kw=dict(ADAG_KW, fsdp=True)),
              dict(name="fsdp_decode", kind="tp", fn="decode_case",
                   mesh=dict(data=2), plan="fsdp", new=NEW, engines=False),
              dict(name="predict", kind="tp", fn="predictor_case",
                   mesh=dict(data=2))]
    x, y = make_blobs(n=256)
    w = [np.asarray(v.value) for v in make_mlp(seed=0).trainable_variables]
    return spawn(tmp_path_factory.mktemp("tp2"), 2, cases,
                 dict(data(), x=x, y=y, n_w=np.asarray(len(w)),
                      **{f"w{i}": a for i, a in enumerate(w)}), cfg=CFG)


@pytest.fixture(scope="module")
def dp2tp2(tmp_path_factory):
    mesh = dict(data=2, model=2)
    cases = lm_cases(mesh, "dptp", rules="serving_fsdp")
    cases += [dict(name="dptp_fsdp_lm", kind="lm", kw=dict(LM, fsdp=True),
                   mesh=mesh),
              dict(name="place", kind="tp", fn="placement_case", mesh=mesh,
                   plan="serving_fsdp"),
              dict(name="decode", kind="tp", fn="decode_case", mesh=mesh,
                   plan="serving_fsdp", new=NEW, engines=False)]
    return spawn(tmp_path_factory.mktemp("dp2tp2"), 4, cases, data(),
                 cfg=CFG)


ADAG_KW = dict(batch_size=8, num_epoch=2, communication_window=4,
               worker_optimizer="sgd", learning_rate=0.05)


# ----------------------------------------------------------- the JAX side


@pytest.fixture(scope="module")
def jax_ref():
    """The unsharded reference on one device: the LM's sgd steps (what
    ``LMTrainer`` runs: the loss before each update, the gradient's
    global norm, ``p - lr g``), the decodes and the logits."""
    cfg, d = jcfg(), data()
    p0 = jax.tree.map(jnp.asarray, ref_params())
    vg = jax.jit(jax.value_and_grad(lambda p, t: jtfm.lm_loss(p, t, cfg)))
    p, hist, norms = p0, [], []
    for j in range(0, len(d["tokens"]), LM["batch_size"]):
        loss, g = vg(p, d["tokens"][j:j + LM["batch_size"]])
        if j == 0:
            first = flat(g)
        hist.append(float(loss))
        norms.append(float(jnp.sqrt(sum(jnp.sum(x * x)
                                        for x in jax.tree.leaves(g)))))
        p = jax.tree.map(lambda a, b: a - LM["learning_rate"] * b, p, g)
    out = {"lm": (np.asarray(hist), np.asarray(norms), flat(p)),
           "grad": first}
    out["logits"] = np.asarray(jtfm.apply(p0, d["tokens"][:, :-1], cfg)[0])
    out["generate"] = np.asarray(jgen.generate(p0, d["prompts"], cfg, NEW))
    seqs, scores = jgen.beam_search(p0, d["prompts"][:1], cfg, 4,
                                    beam_width=3)
    out["beam"] = (np.asarray(seqs), np.asarray(scores))
    return out


def assert_lm(got, ref, name):
    hist, norms, want = ref
    np.testing.assert_allclose(got["history"], hist, rtol=2e-4)
    np.testing.assert_allclose(got["probe"], norms, rtol=2e-4)
    for k, v in want.items():
        np.testing.assert_allclose(got["p/" + k], v, rtol=1e-4, atol=1e-4,
                                   err_msg=f"{name} {k}")


def assert_grads(got, want, name):
    start = flat(ref_params())
    for k, g in want.items():
        np.testing.assert_allclose(start[k] - got["p/" + k], g, atol=1e-4,
                                   err_msg=f"{name} {k}")


def assert_ranks_equal(per_rank, keys):
    for r in per_rank[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], per_rank[0][k], err_msg=k)


# ------------------------------------------------------- training parity


@pytest.mark.parametrize("spawn_name,case", [
    ("tp2", "tp"), ("dp2tp2", "dptp"), ("dp2tp2", "dptp_fsdp"),
    ("tp2", "fsdp")])
def test_lm_matches_jax(request, jax_ref, spawn_name, case):
    res = request.getfixturevalue(spawn_name)
    per_rank = res[f"{case}_lm"]
    assert_ranks_equal(per_rank, ["history"] + [k for k in per_rank[0]
                                                if k.startswith("p/")])
    assert_lm(per_rank[0], jax_ref["lm"], case)


@pytest.mark.parametrize("spawn_name,case", [
    ("tp2", "tp"), ("dp2tp2", "dptp"), ("tp2", "fsdp")])
def test_gradients_match_jax(request, jax_ref, spawn_name, case):
    res = request.getfixturevalue(spawn_name)
    assert_grads(res[f"{case}_grad"][0], jax_ref["grad"], case)


def _assert_tp_resume(per_rank):
    # Dropout masks alike on the model ranks: their losses agree.
    assert_ranks_equal(per_rank, ["straight/history", "resumed/history"])
    for got in per_rank:
        keys = [k for k in got if k.startswith("straight/p/")]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(
                got[k], got["resumed/" + k[len("straight/"):]], err_msg=k)
        n = len(got["resumed/history"])
        assert 0 < n < len(got["straight/history"])
        np.testing.assert_array_equal(got["resumed/history"],
                                      got["straight/history"][-n:])


def test_tp_checkpoint_resumes_bit_for_bit(tp2):
    _assert_tp_resume(tp2["tp_resume"])


def test_tp_checkpoint_sharded_resumes_bit_for_bit(tp2):
    """The same run under ``checkpoint_backend="orbax"``: each model rank
    writes its own slices (no gather inside a save) and the resumed run
    reads only its own pieces back (assembles no split leaf)."""
    _assert_tp_resume(tp2["tp_resume_orbax"])
    for r in tp2["tp_resume_orbax"]:
        assert int(r["save_gathers"]) == int(r["restore_assembled"]) == 0
    assert all(int(r["save_gathers"]) > 0 for r in tp2["tp_resume"])


def test_adag_fsdp_matches_jax(tp2):
    x, y = make_blobs(n=256)
    ds = dk.Dataset({"features": x, "label": y})
    t = dk.ADAG(make_mlp(seed=0), loss="sparse_categorical_crossentropy",
                num_workers=2, fsdp=True, **ADAG_KW)
    out = t.train(ds)
    per_rank = tp2["adag_fsdp"]
    assert_ranks_equal(per_rank, ["history", "m0_w0"])
    np.testing.assert_allclose(per_rank[0]["history"], t.history,
                               rtol=2e-4)
    for i, v in enumerate(out.trainable_variables):
        np.testing.assert_allclose(per_rank[0][f"m0_w{i}"],
                                   np.asarray(v.value), rtol=1e-4,
                                   atol=1e-5)


# ------------------------------------------------------- serving parity


@pytest.mark.parametrize("spawn_name,case", [
    ("tp2", "decode"), ("dp2tp2", "decode"), ("tp2", "fsdp_decode")])
def test_decode_matches_jax(request, jax_ref, spawn_name, case):
    per_rank = request.getfixturevalue(spawn_name)[case]
    got = per_rank[0]
    want = jax_ref["logits"]
    np.testing.assert_allclose(got["logits"], want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    for r in per_rank:
        # Every rank picked the same tokens (one all-gather compared).
        assert bool(r["picks_agree"]) and bool(r["beam_agree"])
        np.testing.assert_array_equal(r["generate"], jax_ref["generate"])
    seqs, scores = jax_ref["beam"]
    np.testing.assert_array_equal(got["beam_seqs"], seqs)
    np.testing.assert_allclose(got["beam_scores"], scores, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got["prompt_cache"],
                                  jax_ref["generate"][:, 5:])


def test_engines_match_jax(tp2, jax_ref):
    per_rank = tp2["decode"]
    want = jax_ref["generate"]
    for got in per_rank:
        for eng in ("cb", "paged", "paged_solo", "spec"):
            np.testing.assert_array_equal(got[eng], want, err_msg=eng)
        np.testing.assert_array_equal(got["pool"],
                                      jax_ref["generate"][:, 5:])
        # A sharded hot-swap engine serves the pushed tree as a fresh
        # one-process engine on it does.
        np.testing.assert_array_equal(got["swapped"], got["fresh_on_new"])
        assert not np.array_equal(got["swapped"], got["cb"])
        # The sharded paged engine's host decisions are the solo one's.
        np.testing.assert_array_equal(got["paged_tables"],
                                      got["paged_solo_tables"])
        assert "different calls" in str(got["guard"])


def test_per_rank_bytes_drop_with_the_model_axis(tp2, dp2tp2):
    got = tp2["decode"][0]
    mem = {k[4:]: v for k, v in got.items() if k.startswith("mem/")}
    assert mem["param_bytes"][0] == mem["param_bytes"][1]
    assert mem["kv_bytes"][0] == mem["kv_bytes"][1]
    assert mem["kv_bytes_per_device"][0] * 2 == mem["kv_bytes_per_device"][1]
    assert mem["param_bytes_per_device"][0] < 0.6 * mem["param_bytes"][1]
    assert mem["param_bytes_per_device"][1] == mem["param_bytes"][1]
    assert int(got["model_shards"]) == 2 and int(got["cache_heads"]) == 1
    # data=2 x model=2 under fsdp over data: parameters ~1/4 a rank.
    for got in dp2tp2["place"]:
        local, full = got["bytes"]
        assert local < 0.3 * full


def test_rank_slices_are_the_reference_placement(dp2tp2):
    """Each rank's slice of each leaf is what the reference's
    ``device_put`` puts on the device at its coordinates, and gathering
    the slices gives the tree back."""
    params = ref_params()
    mesh = make_mesh(MeshSpec(data=2, model=2), devices=jax.devices()[:4])
    sh = jshard.serving_plan(fsdp_axis="data").tree_shardings(mesh, params)
    placed = jax.device_put(jax.tree.map(jnp.asarray, params), sh)
    for got in dp2tp2["place"]:
        d, m = int(got["coords"][0]), int(got["coords"][1])
        dev = mesh.devices[d, m, 0, 0, 0]
        for k, leaf in named(placed).items():
            arr = np.asarray(leaf)
            shard = [s.data for s in leaf.addressable_shards
                     if s.device == dev][0]
            np.testing.assert_array_equal(got["local/" + k],
                                          np.asarray(shard), err_msg=k)
            np.testing.assert_array_equal(got["gathered/" + k], arr)


# ------------------------------------------- placement, without processes


def plans():
    return {
        "tp_plan": (jshard.tp_plan(), tshard.tp_plan()),
        "serving_plan": (jshard.serving_plan(), tshard.serving_plan()),
        "fsdp_plan": (jshard.fsdp_plan(), tshard.fsdp_plan()),
        "serving_plan_fsdp": (jshard.serving_plan(fsdp_axis="data"),
                              tshard.serving_plan(fsdp_axis="data")),
        "lm_default": (jshard.ShardingPlan(rules=jtfm.tp_rules()),
                       tshard.ShardingPlan(rules=ttfm.tp_rules())),
    }


@pytest.mark.parametrize("name", list(plans()))
def test_specs_equal_the_reference(name):
    """Over the flagship serving tree (shapes only), every leaf's spec
    under each plan equals the reference's, on a data=2 x model=2
    mesh."""
    jplan, tplan = plans()[name]
    cfg = jtfm.TransformerConfig(vocab_size=32768, d_model=1024, n_heads=8,
                                 n_layers=8, d_ff=4096, max_len=1024,
                                 rope=True)
    shapes = jax.eval_shape(lambda: jtfm.init_params(jax.random.key(0),
                                                     cfg))
    jmesh = make_mesh(MeshSpec(data=2, model=2), devices=jax.devices()[:4])
    want = {k: tuple(sh.spec) for k, sh in
            named(jplan.tree_shardings(jmesh, shapes)).items()}
    port = tplan.tree_shardings(fake_mesh(data=2, model=2), named(shapes))
    assert set(port) == set(want)
    for k in want:
        assert tuple(port[k].spec) == tuple(want[k]), k


def test_match_partition_rules_equal_the_reference():
    params = ref_params()
    params["scalar"] = np.zeros(())
    from distkeras_tpu_torch.parallel.tree import tree_flatten_with_names

    from jax.sharding import PartitionSpec as JP

    want = named(jrules.match_partition_rules(
        jtfm.tp_rules() + [(r"ln", JP(None))], params))
    got = dict(tree_flatten_with_names(trules.match_partition_rules(
        ttfm.tp_rules() + [(r"ln", trules.P(None))], params))[0])
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}
    for fn, rules in ((jrules.match_partition_rules, [("tok", None)]),
                      (trules.match_partition_rules, [("tok", None)])):
        with pytest.raises(ValueError, match="no partition rule matched"):
            fn(rules, params)
    kv = {"k": np.zeros((2, 1, 8, 4, 16)), "k_scale": np.zeros((2, 1, 8, 4))}
    assert {k: tuple(v) for k, v in
            named(jrules.kv_slab_specs(kv, "model")).items()} == {
        k: tuple(v) for k, v in tree_flatten_with_names(
            trules.kv_slab_specs(kv, "model"))[0]}


def _kv_axis_error(rules_mod, plan, mesh, cfg):
    try:
        return repr(rules_mod.serving_kv_axis(plan, mesh, cfg))
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("case", ["heads", "two_axes", "callable", "ok"])
def test_serving_kv_axis_errors_verbatim(case):
    jm = make_mesh(MeshSpec(data=2, model=4), devices=jax.devices())
    tm = fake_mesh(data=2, model=4)
    cfg = jcfg() if case != "heads" else jtfm.TransformerConfig(
        **dict(CFG, n_heads=6, n_kv_heads=6, d_model=48))
    from jax.sharding import PartitionSpec as JP

    extra = {"heads": [], "ok": [],
             "two_axes": [(r"attn/wk$", (None, None, "data", None))],
             "callable": [(r"attn/wq$", lambda n, x: None)]}[case]
    jplan = jshard.serving_plan([(p, JP(*s) if isinstance(s, tuple) else s)
                                 for p, s in extra])
    tplan = tshard.serving_plan([(p, trules.P(*s) if isinstance(s, tuple)
                                  else s) for p, s in extra])
    assert _kv_axis_error(trules, tplan, tm, cfg) == \
        _kv_axis_error(jrules, jplan, jm, cfg)


def test_validation_errors_equal_the_reference():
    tcfg = ttfm.TransformerConfig(**dict(CFG, n_kv_heads=1))
    jc = jtfm.TransformerConfig(**dict(CFG, n_kv_heads=1))
    jm = make_mesh(MeshSpec(data=4, model=2), devices=jax.devices())

    def msg(fn):
        try:
            fn()
        except (ValueError, TypeError, NotImplementedError) as e:
            return str(e)
        return "no error"

    pairs = [
        (lambda: dk.LMTrainer(jc, mesh=jm),
         lambda: dkt.LMTrainer(tcfg, mesh=fake_mesh(data=4, model=2),
                               device="cpu")),
        (lambda: dk.LMTrainer(jcfg(), fsdp=True, zero=1),
         lambda: dkt.LMTrainer(ttfm.TransformerConfig(**CFG), fsdp=True,
                               zero=1, device="cpu")),
        (lambda: dk.LMTrainer(jcfg(), mesh=jm, compress="int8"),
         lambda: dkt.LMTrainer(ttfm.TransformerConfig(**CFG),
                               mesh=fake_mesh(data=4, model=2),
                               compress="int8", device="cpu")),
        (lambda: dk.ADAG(make_mlp(), plan=dk.dp_plan(), fsdp=True),
         lambda: dkt.ADAG(dkt.zoo.MLP(16, (32,), 4), plan=dkt.dp_plan(),
                          fsdp=True, device="cpu")),
        (lambda: dk.ADAG(make_mlp(), fsdp=True, compress="int8"),
         lambda: dkt.ADAG(dkt.zoo.MLP(16, (32,), 4), fsdp=True,
                          compress="int8", device="cpu")),
    ]
    for cls in ("AEASGD", "DOWNPOUR"):
        for kw in (dict(fsdp=True), dict(plan="fsdp")):
            pairs.append((
                lambda c=cls, k=kw: getattr(dk, c)(make_mlp(), **(
                    dict(plan=dk.fsdp_plan()) if k.get("plan") else k)),
                lambda c=cls, k=kw: getattr(dkt, c)(
                    dkt.zoo.MLP(16, (32,), 4), device="cpu", **(
                        dict(plan=dkt.fsdp_plan()) if k.get("plan")
                        else k))))
    for jfn, tfn in pairs:
        want = msg(jfn)
        assert want != "no error"
        assert msg(tfn) == want
    # The engines: plan= needs mesh= (and vice versa), a full cache.
    p = dkt.params_from_numpy(ref_params(), "cpu")
    tc = ttfm.TransformerConfig(**CFG)
    jp = jax.tree.map(jnp.asarray, ref_params())
    for j, t in (
            (lambda: dk.ContinuousBatcher(jp, jcfg(),
                                          plan=dk.serving_plan()),
             lambda: dkt.ContinuousBatcher(p, tc, plan=dkt.serving_plan(),
                                           device="cpu")),
            (lambda: dk.PrefixPool(jcfg(), 2, draft_cfg=jcfg(),
                                   mesh=jm),
             lambda: dkt.PrefixPool(tc, 2, draft_cfg=tc, device="cpu",
                                    mesh=fake_mesh(data=4, model=2)))):
        assert msg(t) == msg(j) != "no error"
    # The seq, pipeline and expert axes are ported: such a mesh's
    # LMTrainer builds (no check_axes is left), and the pipeline guards
    # raise the reference's words.
    assert not hasattr(tmesh, "check_axes")
    jpp = make_mesh(MeshSpec(data=2, pipeline=2, seq=2),
                    devices=jax.devices())
    want = msg(lambda: dk.LMTrainer(jcfg(), mesh=jpp, fsdp=True))
    got = msg(lambda: dkt.LMTrainer(
        ttfm.TransformerConfig(**CFG), device="cpu", fsdp=True,
        mesh=fake_mesh(data=2, pipeline=2, seq=2)))
    assert want != "no error" and got == want
    assert dkt.LMTrainer(ttfm.TransformerConfig(**CFG), device="cpu",
                         mesh=fake_mesh(data=2, pipeline=2,
                                        seq=2)).microbatches == 4


def test_predictor_splits_the_batch_over_the_data_axis(tp2):
    x, y = make_blobs(n=256)
    model = dkt.zoo.MLP(16, (32,), 4)
    dkt.module_from_keras_numpy(model, [np.asarray(v.value) for v in
                                        make_mlp(seed=0).trainable_variables])
    want = dkt.ModelPredictor(model, batch_size=4, device="cpu").predict(
        dkt.Dataset.from_arrays(x[:10], y[:10]))["prediction"]
    for got in tp2["predict"]:
        np.testing.assert_allclose(got["prediction"], np.asarray(want),
                                   rtol=1e-5, atol=1e-6)

"""The port's seq, pipeline and expert axes against the JAX package, on
the CPU.

The port runs one process per device: ranks of a ``MeshSpec`` grid
joined over gloo (``tests/torch_dp_ranks.py::spawn``, one world-2 spawn
and one world-4 spawn, each running all its cases on meshes of its
ranks; the rank side is ``tests/torch_axes_cases.py``).  Weights come
from the reference's numpy trees, placed by
``sharded_params_from_numpy``; the ranks import neither jax nor
``distkeras_tpu``.  The JAX side runs the same mesh sizes on its forced
CPU devices (ring, pipeline, ``apply_pipelined``, ``LMTrainer``) or one
device where the reference's math is the global one (MoE under
data / expert / model, serving).  The spawns run in threads while the
parent computes the JAX side.

Bounds (f32): ring outputs and gradients 1e-5 (the reference's ring
bound); logits 1e-5 x max |logit|; losses and loss histories rtol 2e-4;
parameters after training 1e-4 (the gradients, at sgd rate 0.5); MoE
drop counts exactly the one-process port's (whose dispatch
``tests/test_torch_moe.py`` holds to JAX's); greedy tokens equal.  The
validation errors are the reference's, word for word.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import distkeras_tpu as dk
import distkeras_tpu_torch as dkt
from distkeras_tpu.models import generate as jgen
from distkeras_tpu.models import transformer as jtfm
from distkeras_tpu.parallel import pipeline as jpipe
from distkeras_tpu.parallel import ring as jring
from distkeras_tpu.parallel.mesh import MeshSpec, make_mesh
from distkeras_tpu_torch.models import transformer as ttfm
from distkeras_tpu_torch.parallel import mesh as tmesh
from distkeras_tpu_torch.parallel import pipeline as tpipe
from distkeras_tpu_torch.parallel.rules import P as TP
from tests.torch_axes_cases import RING
from tests.torch_dp_ranks import spawn

pytestmark = pytest.mark.multiprocess

CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=4, d_ff=64,
           max_len=32, rope=True)
MCFG = dict(CFG, d_ff=32, num_experts=4, moe_top_k=2, capacity_factor=1.0)
LM = dict(batch_size=4, optimizer="sgd", learning_rate=0.5)
NEW = 4
# apply_pipelined variants: (name, config overrides, options).
PP = [("window_segments", dict(attention_window=6), dict(segments=True)),
      ("chunked", dict(ce_chunks=2, remat=True), dict(loss=True))]
PP_SP = [("segments", {}, dict(segments=True))]


def named(tree):
    return {jax.tree_util.keystr(p, simple=True, separator="/"): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def ref_params(cfg, seed):
    return jax.tree.map(np.asarray, jtfm.init_params(jax.random.key(seed),
                                                     cfg))


def data():
    rng = np.random.default_rng(5)
    segs = (np.cumsum(rng.random((8, 17)) < 0.2, axis=1) + 1).astype(
        np.int32)
    out = dict(tokens=rng.integers(0, 64, (8, 17)).astype(np.int32),
               eval_tokens=rng.integers(0, 64, (4, 17)).astype(np.int32),
               segments=segs,
               prompts=rng.integers(0, 64, (2, 6)).astype(np.int32),
               ring_seg=np.repeat(np.arange(4), 4)[None].repeat(
                   2, 0).astype(np.int32),
               toy_w=(rng.normal(size=(2, 4, 4)) * 0.5).astype(np.float32),
               toy_a=rng.normal(size=(2,)).astype(np.float32),
               toy_x=rng.normal(size=(8, 4)).astype(np.float32),
               toy_c=rng.normal(size=(8, 4)).astype(np.float32))
    for c in "qkvc":
        out["ring_" + c] = rng.normal(size=(2, 16, 2, 8)).astype(np.float32)
    out.update({"p/" + k: v for k, v in named(ref_params(
        jtfm.TransformerConfig(**CFG), 0)).items()})
    out.update({"pm/" + k: v for k, v in named(ref_params(
        jtfm.TransformerConfig(**MCFG), 1)).items()})
    return out


def lm(name, mesh, **kw):
    extra = {k: kw.pop(k) for k in ("params", "cfg", "eval", "resume",
                                    "rows") if k in kw}
    return dict(name=name, kind="lm", mesh=mesh, kw=dict(LM, **kw), **extra)


def axes(name, fn, mesh, **kw):
    return dict(name=name, kind="axes", fn=fn, mesh=mesh, **kw)


WORLD2 = [
    axes("ring", "ring_case", dict(data=1, seq=2)),
    axes("toy", "pipe_toy_case", dict(data=1, pipeline=2)),
    axes("pp", "pp_case", dict(data=1, pipeline=2), variants=PP),
    axes("moe_data", "moe_case", dict(data=2), cfg=MCFG),
    axes("moe_expert", "moe_case", dict(data=1, expert=2), cfg=MCFG,
         new=NEW),
    axes("moe_model", "moe_case", dict(data=1, model=2), cfg=MCFG),
    axes("moe_pp", "moe_case", dict(data=1, pipeline=2), cfg=MCFG,
         pipelined=True),
    axes("moe_serve", "moe_serve_case", dict(data=1, model=2), cfg=MCFG,
         new=NEW),
    lm("lm_seq", dict(data=1, seq=2)),
    lm("lm_pp", dict(data=1, pipeline=2)),
    lm("lm_pp_mb", dict(data=1, pipeline=2), microbatches=2),
    lm("pp_resume", dict(data=1, pipeline=2), batch_size=2, microbatches=2,
       resume=dict(at=2)),
    lm("ep_resume", dict(data=1, expert=2), batch_size=2, params="pm",
       cfg=MCFG, resume=dict(at=2)),
]
WORLD4 = [
    axes("pp_sp", "pp_case", dict(data=1, pipeline=2, seq=2),
         variants=PP_SP),
    axes("moe_pp_ep", "moe_case", dict(data=1, pipeline=2, expert=2),
         cfg=MCFG, pipelined=True),
    lm("lm_pp_sp", dict(data=1, pipeline=2, seq=2)),
    lm("lm_dp_ep", dict(data=2, expert=2), params="pm", cfg=MCFG,
       eval=True, eval_every=1),
]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both spawns, running in threads (their ranks are processes)."""
    pool = concurrent.futures.ThreadPoolExecutor(3)
    d = data()
    futs = {w: pool.submit(spawn, tmp_path_factory.mktemp(f"axes{w}"), w,
                           cases, d, cfg=CFG)
            for w, cases in ((2, WORLD2), (4, WORLD4))}
    yield futs
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def w2(ranks):
    return ranks[2].result()


@pytest.fixture(scope="module")
def w4(ranks):
    return ranks[4].result()


def jmesh(**axes_):
    n = int(np.prod(list(axes_.values())))
    return make_mesh(MeshSpec(**axes_), devices=jax.devices()[:n])


def assemble(per_rank, key, coord, dim, n):
    """The global array from the ranks' blocks along ``dim`` (rank
    ``r``'s block index ``coord(r)``)."""
    blocks = [None] * n
    for r, got in enumerate(per_rank):
        blocks[coord(r)] = got[key]
    return np.concatenate(blocks, axis=dim)


def close_logits(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# ------------------------------------------------------- the JAX side


def _jax_pp(cfg, mesh, seq_axis=None):
    return jax.jit(lambda p, t, s: jtfm.apply_pipelined(
        p, t, cfg, mesh, 2, seq_axis=seq_axis, segment_ids=s))


def _jax_trainer(axes_, moe=False, **kw):
    d = data()
    cfg = jtfm.TransformerConfig(**(MCFG if moe else CFG))
    t = dk.LMTrainer(cfg, mesh=jmesh(**axes_), **dict(LM, **kw))
    params = jax.tree.map(jnp.asarray, ref_params(cfg, 1 if moe else 0))
    ev = d["eval_tokens"] if kw.get("eval_every") else None
    out = t.train(d["tokens"], params=params, eval_tokens=ev)
    return (t.history, [e["loss"] for _, e in t.eval_history], named(out))


def _jax_moe():
    """The MoE side: one device's apply, loss and generate, and the
    pipelined forward on the pipeline meshes."""
    d = data()
    inputs = d["tokens"][:, :-1]
    pp_mesh = jmesh(data=1, pipeline=2)
    out = {}
    mcfg = jtfm.TransformerConfig(**MCFG)
    moe = jax.tree.map(jnp.asarray, ref_params(mcfg, 1))
    out["moe"] = jax.jit(lambda p, t: jtfm.apply(p, t, mcfg))(moe, inputs)
    out["moe_loss"] = jax.jit(lambda p, t: jtfm.lm_loss(p, t, mcfg))(
        moe, d["tokens"])
    out["moe_bytes"] = sum(v.nbytes for k, v in named(moe).items()
                           if k.endswith(("moe/w1", "moe/w2")))
    out["moe_pp"] = _jax_pp(mcfg, pp_mesh)(moe, inputs, None)
    out["moe_pp_ep"] = _jax_pp(mcfg, jmesh(data=1, pipeline=2, expert=2))(
        moe, inputs, None)
    out["generate"] = np.asarray(jgen.generate(moe, d["prompts"], mcfg,
                                               NEW))
    return out


@pytest.fixture(scope="module")
def jax_ref(ranks):
    """Every JAX result, computed while the spawns run (the trainers and
    the MoE side in threads of their own: XLA compiles outside the
    GIL)."""
    d = data()
    out = {}
    pool = concurrent.futures.ThreadPoolExecutor(3)
    # The dense trainers' math is one (the ring and the pipeline are
    # exact reorderings): JAX's LMTrainer on the pipeline x seq mesh is
    # the oracle of every dense run; MoE runs on its own mesh.
    trainers = {"lm_dense": pool.submit(_jax_trainer, dict(
        data=1, pipeline=2, seq=2)), "lm_moe": pool.submit(
        _jax_trainer, dict(data=2, expert=2), moe=True, eval_every=1),
        "moe": pool.submit(_jax_moe)}
    ring_mesh = jmesh(data=1, seq=2)
    q, k, v, ct = (jnp.asarray(d["ring_" + c]) for c in "qkvc")
    for name, (causal, window, segmented) in RING.items():
        fn = jring.make_ring_attention(ring_mesh, causal=causal,
                                       window=window)
        seg = jnp.asarray(d["ring_seg"]) if segmented else None

        def fwd_bwd(q, k, v, fn=fn, seg=seg):
            o, vjp = jax.vjp(lambda *a: fn(*a, segment_ids=seg), q, k, v)
            return (o,) + vjp(ct)

        out["ring/" + name] = jax.jit(fwd_bwd)(q, k, v)

    pp_mesh = jmesh(data=1, pipeline=2)

    def stage(p, u):
        return jnp.tanh(u @ p["w"]), p["a"] * jnp.mean(u * u)

    pipe = jpipe.make_pipeline(stage, pp_mesh, microbatches=4)

    def toy_loss(p, x):
        y, aux = pipe(p, x)
        return (y * d["toy_c"]).sum() + aux, (y, aux)

    p = {"w": jnp.asarray(d["toy_w"]), "a": jnp.asarray(d["toy_a"])}
    out["toy"] = jax.jit(jax.value_and_grad(toy_loss, argnums=(0, 1),
                                            has_aux=True))(
        p, jnp.asarray(d["toy_x"]))

    dense = jax.tree.map(jnp.asarray, ref_params(
        jtfm.TransformerConfig(**CFG), 0))
    inputs = d["tokens"][:, :-1]
    for name, over, kw in PP:
        cfg = jtfm.TransformerConfig(**dict(CFG, **over))
        if kw.get("loss"):
            fwd = lambda p, t, cfg=cfg: jtfm.apply_pipelined(
                p, t, cfg, pp_mesh, 2, return_hidden=True)
            out["pp/" + name] = jax.jit(lambda p, t, cfg=cfg, fwd=fwd:
                                        jtfm.lm_loss(p, t, cfg,
                                                     hidden_fn=fwd))(
                dense, d["tokens"])
            continue
        seg = d["segments"][:, :-1] if kw.get("segments") else None
        out["pp/" + name] = _jax_pp(cfg, pp_mesh)(dense, inputs, seg)
    pp_sp = jmesh(data=1, pipeline=2, seq=2)
    for name, over, kw in PP_SP:
        cfg = jtfm.TransformerConfig(**dict(CFG, **over))
        seg = d["segments"][:, :-1] if kw.get("segments") else None
        out["pp_sp/" + name] = _jax_pp(cfg, pp_sp, "seq")(dense, inputs,
                                                          seg)

    out.update({k: f.result() for k, f in trainers.items() if k != "moe"})
    out.update(trainers["moe"].result())
    pool.shutdown()
    return out


# ------------------------------------------------------------- the ring


@pytest.mark.parametrize("variant", list(RING))
def test_ring_attention_matches_jax(w2, jax_ref, variant):
    want = jax_ref["ring/" + variant]
    for key, w in zip(("out", "dq", "dk", "dv"), want):
        got = assemble(w2["ring"], f"{variant}/{key}", lambda r: r, 1, 2)
        np.testing.assert_allclose(got, np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=key)


# ---------------------------------------------------------- the pipeline


def test_make_pipeline_matches_jax(w2, jax_ref):
    (_, (y, aux)), (gp, gx) = jax_ref["toy"]
    per_rank = w2["toy"]
    for got in per_rank:
        np.testing.assert_allclose(got["y"], y, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["aux"], aux, rtol=1e-5)
    np.testing.assert_allclose(np.concatenate([g["dw"] for g in per_rank]),
                               gp["w"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.concatenate([g["da"] for g in per_rank]),
                               gp["a"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(sum(g["dx"] for g in per_rank), gx,
                               rtol=1e-4, atol=1e-5)


def _fake(**axes_):
    shape = dict({a: 1 for a in tmesh.AXES}, **axes_)
    return tmesh.Mesh(shape=shape, coords={a: 0 for a in tmesh.AXES})


def _msg(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return "no error"


def test_make_pipeline_errors_equal_the_reference():
    import torch
    from jax.sharding import PartitionSpec as JP

    jm = jmesh(data=2, pipeline=2, seq=2)
    tm = _fake(data=2, pipeline=2, seq=2)
    stage = lambda p, u: (u, jnp.zeros(()))
    tstage = lambda p, u: (u, torch.zeros(()))
    x = np.zeros((6, 4), np.float32)
    pairs = [
        # Misstacked: a shard of 2 on each of the 2 stages.
        (lambda: jax.jit(jpipe.make_pipeline(stage, jm, 2))(
            jnp.zeros((4, 4)), jnp.zeros((8, 4))),
         lambda: tpipe.make_pipeline(tstage, tm, 2)(
             torch.zeros(2, 4), torch.zeros(8, 4))),
        (lambda: jax.jit(jpipe.make_pipeline(stage, jm, 4))(
            jnp.zeros((2, 4)), jnp.asarray(x)),
         lambda: tpipe.make_pipeline(tstage, tm, 4)(
             torch.zeros(1, 4), torch.tensor(x))),
        (lambda: jpipe.make_pipeline(stage, jm, 2,
                                     x_spec=JP(None, "pipeline")),
         lambda: tpipe.make_pipeline(tstage, tm, 2,
                                     x_spec=TP(None, "pipeline"))),
        (lambda: jpipe.make_pipeline(stage, jm, 2,
                                     extras_spec=JP("pipeline")),
         lambda: tpipe.make_pipeline(tstage, tm, 2,
                                     extras_spec=TP("pipeline"))),
        (lambda: jpipe.make_pipeline(stage, jm, 2,
                                     extras_spec=JP(None, None, "seq")),
         lambda: tpipe.make_pipeline(tstage, tm, 2,
                                     extras_spec=TP(None, None, "seq"))),
        (lambda: jpipe.make_pipeline(stage, jm, 2)(
            jnp.zeros((2, 4)), jnp.zeros((8, 4)), jnp.zeros((2, 4))),
         lambda: tpipe.make_pipeline(tstage, tm, 2)(
             torch.zeros(1, 4), torch.zeros(8, 4), torch.zeros(2, 4))),
    ]
    for jfn, tfn in pairs:
        want = _msg(jfn)
        assert want != "no error"
        assert _msg(tfn) == want


@pytest.mark.parametrize("name", [n for n, _, _ in PP])
def test_apply_pipelined_matches_jax(w2, jax_ref, name):
    want = jax_ref["pp/" + name]
    for got in w2["pp"]:
        if f"{name}/loss" in got:  # the chunked head's loss
            np.testing.assert_allclose(got[f"{name}/loss"], want, rtol=2e-4)
            continue
        close_logits(got[f"{name}/logits"], np.asarray(want[0]))
        np.testing.assert_allclose(got[f"{name}/aux"], want[1], atol=1e-7)


@pytest.mark.parametrize("name", [n for n, _, _ in PP_SP])
def test_apply_pipelined_with_seq_matches_jax(w4, jax_ref, name):
    logits, _ = jax_ref["pp_sp/" + name]
    # Rank r sits at (pipeline, seq) = divmod(r, 2): assemble over seq.
    per_rank = w4["pp_sp"]
    for p in range(2):
        got = assemble(per_rank[2 * p:2 * p + 2], f"{name}/logits",
                       lambda r: r, 1, 2)
        close_logits(got, np.asarray(logits))


# ---------------------------------------------------------------- MoE


def _port_stats(tokens):
    """The one-process port's drop counts on the same rows."""
    import torch

    c = ttfm.TransformerConfig(**MCFG)
    p = dkt.params_from_numpy(ref_params(jtfm.TransformerConfig(**MCFG), 1),
                              "cpu")
    real, stats = ttfm._moe_block, {}
    ttfm._moe_block = lambda lp, x, c_, **kw: real(lp, x, c_, stats=stats,
                                                   **kw)
    try:
        with torch.no_grad():
            dkt.apply(p, tokens, c, device="cpu")
    finally:
        ttfm._moe_block = real
    return int(stats["dropped"]), int(stats["assigned"])


@pytest.mark.parametrize("case", ["moe_data", "moe_expert", "moe_model"])
def test_moe_under_a_mesh_matches_jax(w2, jax_ref, case):
    """Capacity, slots and aux over the global batch: one device's."""
    logits, aux = jax_ref["moe"]
    per_rank = w2[case]
    split = case == "moe_data"
    got = (np.concatenate([g["logits"] for g in per_rank]) if split
           else per_rank[0]["logits"])
    close_logits(got, np.asarray(logits))
    dropped, assigned = _port_stats(data()["tokens"][:, :-1])
    assert 0 < dropped < assigned
    for g in per_rank:
        np.testing.assert_allclose(g["aux"], aux, rtol=1e-5)
        assert (int(g["dropped"]), int(g["assigned"])) == (dropped,
                                                           assigned)
        if not split:
            close_logits(g["logits"], np.asarray(logits))
    mean = np.mean([g["loss"] for g in per_rank])
    np.testing.assert_allclose(mean, jax_ref["moe_loss"], rtol=2e-4)
    if case == "moe_expert":  # each rank holds half the experts
        assert int(per_rank[0]["expert_bytes"]) * 2 == jax_ref["moe_bytes"]


@pytest.mark.parametrize("spawn_name,case", [("w2", "moe_pp"),
                                             ("w4", "moe_pp_ep")])
def test_pipelined_moe_matches_jax(request, jax_ref, spawn_name, case):
    """Capacity and aux per microbatch, as the reference's pipeline."""
    logits, aux = jax_ref[case]
    for got in request.getfixturevalue(spawn_name)[case]:
        close_logits(got["logits"], np.asarray(logits))
        np.testing.assert_allclose(got["aux"], aux, rtol=1e-5)


def test_moe_serving_under_the_model_axis_matches_jax(w2, jax_ref):
    for got in w2["moe_serve"]:
        np.testing.assert_array_equal(got["generate"], jax_ref["generate"])
        np.testing.assert_array_equal(got["cb"], jax_ref["generate"])


def test_generate_on_an_expert_split_tree_matches_jax(w2, jax_ref):
    """generate takes the serving engines' placement of a tree whose
    experts are split over the expert axis: gathered whole once."""
    for got in w2["moe_expert"]:
        np.testing.assert_array_equal(got["generate"], jax_ref["generate"])


# ------------------------------------------------------------ LMTrainer


@pytest.mark.parametrize("spawn_name,case,ref", [
    ("w2", "lm_seq", "lm_dense"), ("w2", "lm_pp", "lm_dense"),
    ("w2", "lm_pp_mb", "lm_dense"), ("w4", "lm_pp_sp", "lm_dense"),
    ("w4", "lm_dp_ep", "lm_moe")])
def test_lm_trainer_matches_jax(request, jax_ref, spawn_name, case, ref):
    history, evals, want = jax_ref[ref]
    per_rank = request.getfixturevalue(spawn_name)[case]
    for got in per_rank:
        np.testing.assert_allclose(got["history"], history, rtol=2e-4)
        for k, v in want.items():
            np.testing.assert_allclose(got["p/" + k], v, rtol=1e-4,
                                       atol=1e-4, err_msg=k)
        # eval excludes the MoE aux, as JAX's
        np.testing.assert_allclose(got["eval"], evals, rtol=2e-4)


@pytest.mark.parametrize("case", ["pp_resume", "ep_resume"])
def test_resume_is_bit_for_bit(w2, case):
    for got in w2[case]:
        keys = [k for k in got if k.startswith("straight/p/")]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(
                got[k], got["resumed/" + k[len("straight/"):]], err_msg=k)
        n = len(got["resumed/history"])
        assert 0 < n < len(got["straight/history"])
        np.testing.assert_array_equal(got["resumed/history"],
                                      got["straight/history"][-n:])


# -------------------------------------------------- validation, verbatim


def test_lm_trainer_errors_equal_the_reference():
    def both(jcfg_kw, axes_, kw, train=None):
        jm, tm = jmesh(**axes_), _fake(**axes_)
        jc = jtfm.TransformerConfig(**dict(CFG, **jcfg_kw))
        tc = ttfm.TransformerConfig(**dict(CFG, **jcfg_kw))

        def jfn():
            t = dk.LMTrainer(jc, mesh=jm, **kw)
            if train is not None:
                t.train(train)

        def tfn():
            t = dkt.LMTrainer(tc, mesh=tm, device="cpu", **kw)
            if train is not None:
                t.train(train)
        return _msg(jfn), _msg(tfn)

    rows = data()["tokens"]
    cases = [
        (dict(dropout=0.1), dict(data=1, pipeline=2), {}, None),
        ({}, dict(data=1, pipeline=2), dict(fsdp=True), None),
        ({}, dict(data=2), dict(microbatches=2), None),
        ({}, dict(data=1, seq=2), {}, rows[:, :16]),     # seq 15 over 2
        ({}, dict(data=1, pipeline=2), dict(microbatches=3), rows),
        ({}, dict(data=1, seq=2), dict(compress="int8"), None),
        (dict(num_experts=2), dict(data=2), dict(merge_rule="adasum"),
         None),
    ]
    for jkw, axes_, kw, train in cases:
        want, got = both(jkw, axes_, kw, train)
        assert want != "no error", (jkw, axes_, kw)
        assert got == want
    # n_layers not divisible into the stages; attention_fn with seq_axis.
    for cfg_kw, kw in ((dict(n_layers=3), {}),
                       ({}, dict(seq_axis="seq", attention_fn="ring"))):
        jm, tm = jmesh(data=1, pipeline=2, seq=2), _fake(
            data=1, pipeline=2, seq=2)
        jc = jtfm.TransformerConfig(**dict(CFG, **cfg_kw))
        tc = ttfm.TransformerConfig(**dict(CFG, **cfg_kw))
        jkw = dict(kw, attention_fn=jring.make_ring_attention(jm)) \
            if kw.get("attention_fn") else kw
        tkw = dict(kw, attention_fn=lambda q, k, v: q) \
            if kw.get("attention_fn") else kw
        p = ref_params(jtfm.TransformerConfig(**CFG), 0)
        want = _msg(lambda: jtfm.apply_pipelined(
            p, rows[:, :16], jc, jm, 2, **jkw))
        got = _msg(lambda: ttfm.apply_pipelined(
            dkt.params_from_numpy(p, "cpu"), rows[:, :8], tc, tm, 2, **tkw))
        assert want != "no error" and got == want


def test_placement_splits_stages_and_experts():
    """Under a pipeline axis each rank holds its stage's layers; over the
    expert axis its experts' slabs, and a gather gives the tree back."""
    from distkeras_tpu_torch.parallel.layout import Layout
    from distkeras_tpu_torch.parallel.sharding import ShardingPlan

    tree = ref_params(jtfm.TransformerConfig(**MCFG), 1)
    for coords in ((0, 0), (1, 1)):
        mesh = tmesh.Mesh(
            shape=dict(data=1, model=1, pipeline=2, seq=1, expert=2),
            coords=dict(data=0, model=0, pipeline=coords[0], seq=0,
                        expert=coords[1]))
        lay = Layout(ShardingPlan(rules=ttfm.tp_rules()), mesh, tree)
        local = lay.shard(tree)
        w1 = local["layers"]["moe"]["w1"]
        full = tree["layers"]["moe"]["w1"]
        p, e = coords
        np.testing.assert_array_equal(w1, full[2 * p:2 * p + 2,
                                               2 * e:2 * e + 2])
        np.testing.assert_array_equal(local["tok_emb"], tree["tok_emb"])
        assert local["layers"]["ln1_scale"].shape[0] == 2

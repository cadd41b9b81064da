"""The model-axis cases of one rank (tests/test_torch_tp.py), run by
``tests/torch_dp_ranks.py`` for a case of kind ``"tp"``.

Every rank of the spawn builds ``make_mesh(MeshSpec(**case["mesh"]))``,
places the reference's numpy weights under the case's plan
(``sharded_params_from_numpy``) and drives the port's entry points with
the same calls in the same order; it returns numpy results for the
parent to hold against the JAX package.  No jax, no ``distkeras_tpu``.
"""

import numpy as np
import torch

import distkeras_tpu_torch as dkt
from distkeras_tpu_torch import serving as S
from distkeras_tpu_torch.models import generate as G
from distkeras_tpu_torch.parallel import collectives as C
from distkeras_tpu_torch.parallel import mesh as M
from distkeras_tpu_torch.parallel.sharding import fsdp_plan, serving_plan

PLANS = {"serving": lambda: serving_plan(),
         "serving_fsdp": lambda: serving_plan(fsdp_axis="data"),
         "fsdp": lambda: fsdp_plan()}


def _agree(x, mesh):
    """Does every rank of the whole mesh hold the same ``x``?  (One
    all-gather of the values: the check that every model rank picked the
    same tokens after the final all-reduce.)"""
    t = torch.as_tensor(np.asarray(x, np.float64)).reshape(-1)
    rows = C.all_gather(t, mesh.whole())
    return bool((rows == rows[0]).all())


def _drive(eng, reqs):
    lanes = [eng.submit(p, n, **kw) for p, n, kw in reqs]
    while eng.running():
        eng.step()
    return [eng.drain(lane) for lane in lanes]


def decode_case(case, data, cfg, device):
    mesh = M.make_mesh(M.MeshSpec(**case["mesh"]))
    plan = PLANS[case["plan"]]()
    full = {k[2:]: data[k] for k in data.files if k.startswith("p/")}
    from torch_dp_ranks import nest

    tree = nest(full)
    sp = dkt.sharded_params_from_numpy(tree, plan, mesh, device)
    solo = dkt.params_from_numpy(tree, device)
    prompts = data["prompts"]                          # [B, P]
    n_new = int(case["new"])
    res = {}
    logits, _ = dkt.apply(sp, data["tokens"][:, :-1], cfg, device=device)
    res["logits"] = logits.numpy()
    out = G.generate(sp, prompts, cfg, n_new, device=device)
    res["generate"] = out.numpy()
    res["picks_agree"] = np.asarray(_agree(out.numpy(), mesh))
    seqs, scores = G.beam_search(sp, prompts[:1], cfg, 4, beam_width=3,
                                 device=device)
    res["beam_seqs"], res["beam_scores"] = seqs.numpy(), scores.numpy()
    pre = data["prefix"][None]
    cache, _ = G.prefill(sp, pre, cfg, last_logits=False, device=device)
    tails = prompts[:, pre.shape[1]:]                  # past the prefix
    pc = G.generate(sp, tails, cfg, n_new,
                    prompt_cache=(cache, pre.shape[1]), device=device)
    res["prompt_cache"] = pc.numpy()
    res["cache_heads"] = np.asarray(cache["k"].shape[3])
    res["beam_agree"] = np.asarray(_agree(seqs.numpy(), mesh))
    if not case.get("engines", True):
        return res

    # The engines, each against its one-process twin on this rank.
    reqs = [(p, n_new, {}) for p in prompts]
    kw = dict(lanes=2, prompt_buckets=(8,), device=device)
    eng = S.ContinuousBatcher(solo, cfg, plan=plan, mesh=mesh, **kw)
    res["cb"] = np.stack(_drive(eng, reqs))
    mf = eng.memory_footprint()
    one = S.ContinuousBatcher(solo, cfg, **kw).memory_footprint()
    for k in mf:
        res[f"mem/{k}"] = np.asarray([mf[k], one[k]])
    res["model_shards"] = np.asarray(eng.residency()["model_shards"])
    # Hot swap: every rank pushes the same full tree into its view.
    hs = S.ContinuousBatcher(solo, cfg, plan=plan, mesh=mesh,
                             hot_swap=True, **kw)
    new = {k: v * 1.5 if k == "tok_emb" else v for k, v in solo.items()}
    hs.swap_params(dkt.params_to_numpy(new), 1)
    res["swapped"] = np.stack(_drive(hs, reqs))
    res["fresh_on_new"] = np.stack(_drive(S.ContinuousBatcher(new, cfg, **kw),
                                          reqs))
    kv_axis = eng._kv_axis
    pool = S.PrefixPool(cfg, 2, mesh=mesh, kv_axis=kv_axis, device=device)
    pid = pool.put(cache, pre.shape[1])
    peng = S.ContinuousBatcher(solo, cfg, prefix_pool=pool, plan=plan,
                               mesh=mesh, **kw)
    res["pool"] = np.stack(_drive(peng, [(p, n_new, dict(prefix_id=pid))
                                         for p in tails]))
    pkw = dict(lanes=2, block=8, prompt_buckets=(8,), device=device)
    pb = S.PagedBatcher(solo, cfg, plan=plan, mesh=mesh, **pkw)
    pb_solo = S.PagedBatcher(solo, cfg, **pkw)
    for name, e in (("paged", pb), ("paged_solo", pb_solo)):
        lanes = [e.submit(p, n_new) for p in prompts]
        res[f"{name}_tables"] = e._tables_np.copy()
        while e.running():
            e.step()
        res[name] = np.stack([e.drain(lane) for lane in lanes])
    spec = S.SpeculativeBatcher(solo, solo, cfg, cfg, lanes=2, n_draft=2,
                                prompt_buckets=(8,), plan=plan, mesh=mesh,
                                device=device)
    res["spec"] = np.stack(_drive(spec, reqs))
    # The SPMD guard: a rank that submits another request raises.
    try:
        eng.submit(prompts[0][:2 + mesh.whole().rank], 2)
        res["guard"] = np.asarray("no error")
    except ValueError as e:
        res["guard"] = np.asarray(str(e))
    return res


def placement_case(case, data, cfg, device):
    """Each rank's slices and per-rank parameter bytes under a plan."""
    mesh = M.make_mesh(M.MeshSpec(**case["mesh"]))
    plan = PLANS[case["plan"]]()
    from torch_dp_ranks import flatten, nest

    tree = nest({k[2:]: data[k] for k in data.files if k.startswith("p/")})
    sp = dkt.sharded_params_from_numpy(tree, plan, mesh, device)
    res = {f"local/{k}": v for k, v in flatten(
        {n: t.numpy() for n, t in dkt.models.transformer.named_leaves(sp)}
    ).items()}
    res["coords"] = np.asarray([mesh.coords[a] for a in M.AXES])
    res["bytes"] = np.asarray([
        sum(t.numel() * t.element_size() for _, t in
            dkt.models.transformer.named_leaves(sp)),
        sum(v.nbytes for v in flatten(tree).values())])
    back = dkt.params_to_numpy(sp)
    res.update({f"gathered/{k}": v for k, v in flatten(back).items()})
    return res


def generate_case(case, data, cfg, device):
    """f32 ``generate`` and ``apply`` under the serving plan, with this
    rank's kernel launches (tests/test_torch_cuda.py, on the card)."""
    from distkeras_tpu_torch.ops import attention as attn
    from torch_dp_ranks import nest

    mesh = M.make_mesh(M.MeshSpec(**case["mesh"]))
    tree = nest({k[2:]: data[k] for k in data.files if k.startswith("p/")})
    sp = dkt.sharded_params_from_numpy(tree, PLANS[case["plan"]](), mesh,
                                       device)
    for k in attn.LAUNCHES:
        attn.LAUNCHES[k] = 0
    out = G.generate(sp, data["prompts"], cfg, int(case["new"]),
                     device=device)
    logits, _ = dkt.apply(sp, data["prompts"], cfg, device=device)
    return {"generate": out.cpu().numpy(), "logits": logits.cpu().numpy(),
            "fwd_launches": np.asarray(attn.LAUNCHES["flash_fwd"]),
            "picks_agree": np.asarray(_agree(out.cpu().numpy(), mesh))}


def predictor_case(case, data, cfg, device):
    """``ModelPredictor(mesh=)``: each rank predicts its rows of every
    batch; every rank gets the whole column."""
    mesh = M.make_mesh(M.MeshSpec(**case["mesh"]))
    model = dkt.zoo.MLP(16, (32,), 4)
    dkt.module_from_keras_numpy(
        model, [data[f"w{i}"] for i in range(int(data["n_w"]))])
    ds = dkt.Dataset.from_arrays(data["x"][:10], data["y"][:10])
    out = dkt.ModelPredictor(model, batch_size=3, mesh=mesh,
                             device=device).predict(ds)
    return {"prediction": np.asarray(out["prediction"])}

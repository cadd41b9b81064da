"""The seq, pipeline and expert cases of one rank
(tests/test_torch_axes.py), run by ``tests/torch_dp_ranks.py`` for a
case of kind ``"axes"``.

Every rank of the spawn builds ``make_mesh(MeshSpec(**case["mesh"]))``,
takes its block of the spawn's global inputs (its rows over ``data``,
its sequence block over ``seq``), places the reference's numpy weights
with ``sharded_params_from_numpy`` and drives the port with the same
calls in the same order; it returns numpy results for the parent to
assemble and hold against the JAX package.  No jax, no
``distkeras_tpu``.
"""

import dataclasses

import numpy as np
import torch

import distkeras_tpu_torch as dkt
from distkeras_tpu_torch import serving as S
from distkeras_tpu_torch.models import generate as G
from distkeras_tpu_torch.models import transformer as T
from distkeras_tpu_torch.parallel import mesh as M
from distkeras_tpu_torch.parallel.pipeline import make_pipeline
from distkeras_tpu_torch.parallel.ring import make_ring_attention
from distkeras_tpu_torch.parallel.rules import NamedSharding, P
from distkeras_tpu_torch.parallel.sharding import ShardingPlan, serving_plan

# The ring variants: (causal, window, segmented).
RING = {"full": (False, None, False), "causal": (True, None, False),
        "window": (True, 6, False), "segments": (True, None, True)}


def _mesh(case):
    return M.make_mesh(M.MeshSpec(**case["mesh"]))


def _tree(data, prefix):
    from torch_dp_ranks import nest

    return nest({k[len(prefix) + 1:]: data[k] for k in data.files
                 if k.startswith(prefix + "/")})


def _block(mesh, x, *axes):
    """This rank's block of ``x`` with dims split over ``axes``."""
    return NamedSharding(mesh, P(*axes)).local(x)


def ring_case(case, data, cfg, device):
    mesh = _mesh(case)
    res = {}
    for name, (causal, window, segmented) in RING.items():
        q, k, v, ct = (torch.tensor(_block(mesh, data["ring_" + c], None,
                                           "seq")) for c in "qkvc")
        q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
        seg = (torch.tensor(_block(mesh, data["ring_seg"], None, "seq"))
               if segmented else None)
        fn = make_ring_attention(mesh, causal=causal, window=window)
        out = fn(q, k, v, segment_ids=seg)
        (out * ct).sum().backward()
        res[f"{name}/out"] = out.detach().numpy()
        for c, t in zip("qkv", (q, k, v)):
            res[f"{name}/d{c}"] = t.grad.numpy()
    return res


def toy_stage(p, u):
    return torch.tanh(u @ p["w"]), p["a"] * (u * u).mean()


def pipe_toy_case(case, data, cfg, device):
    mesh = _mesh(case)
    idx = mesh.sub("pipeline").rank
    params = {k: torch.tensor(data["toy_" + k][idx:idx + 1])
              .requires_grad_() for k in ("w", "a")}
    x = torch.tensor(data["toy_x"]).requires_grad_()
    pipe = make_pipeline(toy_stage, mesh, microbatches=4)
    y, aux = pipe(params, x)
    ((y * torch.tensor(data["toy_c"])).sum() + aux).backward()
    return {"y": y.detach().numpy(), "aux": aux.detach().numpy(),
            "dw": params["w"].grad.numpy(), "da": params["a"].grad.numpy(),
            # Only stage 0 reads x.
            "dx": (torch.zeros_like(x) if x.grad is None else x.grad).numpy()}


def _pp_inputs(mesh, data, seq: bool):
    tok = data["tokens"][:, :-1]
    seg = data["segments"][:, :-1]
    if seq:
        tok, seg = (_block(mesh, a, None, "seq") for a in (tok, seg))
    return tok, seg


def pp_case(case, data, cfg, device):
    """apply_pipelined on this rank's block: the case's variants."""
    mesh = _mesh(case)
    seq = int(mesh.shape["seq"]) > 1
    tree = _tree(data, "p")
    res = {}
    for name, over, kw in case["variants"]:
        c = dataclasses.replace(cfg, **over)
        sp = dkt.sharded_params_from_numpy(tree, ShardingPlan(
            rules=T.tp_rules()), mesh, device)
        tok, seg = _pp_inputs(mesh, data, seq)
        extra = dict(seq_axis="seq" if seq else None)
        if kw.get("segments"):
            extra["segment_ids"] = seg
        if kw.get("loss"):  # the chunked head on the hidden states
            rows = data["tokens"]
            if seq:
                w = (rows.shape[1] - 1) // mesh.sub("seq").size
                r = mesh.sub("seq").rank
                rows = rows[:, r * w:(r + 1) * w + 1]
            fwd = lambda p, t: T.apply_pipelined(
                p, t, c, mesh, 2, return_hidden=True, **extra)
            with torch.no_grad():
                loss = T.lm_loss(sp, torch.tensor(rows), c, hidden_fn=fwd)
            res[f"{name}/loss"] = loss.numpy()
            continue
        with torch.no_grad():
            logits, aux = T.apply_pipelined(sp, tok, c, mesh, 2, **extra)
        res[f"{name}/logits"] = logits.numpy()
        res[f"{name}/aux"] = aux.numpy()
    return res


def _count_moe():
    """Wrap ``_moe_block`` to count the group's dropped / assigned."""
    real, stats = T._moe_block, {}
    T._moe_block = lambda lp, x, c, **kw: real(lp, x, c, stats=stats, **kw)
    return real, stats


def moe_case(case, data, cfg, device):
    """MoE apply (capacity routing), lm_loss and the drop counts on this
    rank's rows; ``pipelined`` runs apply_pipelined instead."""
    mesh = _mesh(case)
    c = T.TransformerConfig(**case["cfg"])
    sp = dkt.sharded_params_from_numpy(_tree(data, "pm"), ShardingPlan(
        rules=T.tp_rules()), mesh, device)
    rows = _block(mesh, data["tokens"], "data")
    real, stats = _count_moe()
    try:
        if case.get("pipelined"):
            with torch.no_grad():
                logits, aux = T.apply_pipelined(sp, rows[:, :-1], c, mesh, 2)
        else:
            logits, aux = dkt.apply(sp, rows[:, :-1], c, device=device)
    finally:
        T._moe_block = real
    res = {"logits": logits.numpy(), "aux": aux.numpy(),
           "dropped": np.asarray(int(stats["dropped"])),
           "assigned": np.asarray(int(stats["assigned"]))}
    if not case.get("pipelined"):
        with torch.no_grad():
            res["loss"] = T.lm_loss(sp, torch.tensor(rows), c).numpy()
        # Per-rank expert bytes (the experts' slabs this rank holds).
        res["expert_bytes"] = np.asarray(sum(
            t.numel() * t.element_size() for k, t in
            sp["layers"]["moe"].items() if k in ("w1", "w2")))
    if "new" in case:  # an expert-split tree, decoded with experts whole
        res["generate"] = G.generate(sp, data["prompts"], c,
                                     int(case["new"]), device=device).numpy()
    return res


def moe_serve_case(case, data, cfg, device):
    """An MoE model under ``serving_plan()``: generate on the placed tree
    and a ContinuousBatcher built with plan= / mesh=."""
    mesh = _mesh(case)
    c = T.TransformerConfig(**case["cfg"])
    tree = _tree(data, "pm")
    plan = serving_plan()
    sp = dkt.sharded_params_from_numpy(tree, plan, mesh, device)
    prompts, n_new = data["prompts"], int(case["new"])
    res = {"generate": G.generate(sp, prompts, c, n_new,
                                  device=device).numpy()}
    eng = S.ContinuousBatcher(dkt.params_from_numpy(tree, device), c,
                              plan=plan, mesh=mesh, lanes=2,
                              prompt_buckets=(8,), device=device)
    lanes = [eng.submit(p, n_new) for p in prompts]
    while eng.running():
        eng.step()
    res["cb"] = np.stack([eng.drain(lane) for lane in lanes])
    return res


def train_case(case, data, cfg, device):
    """``LMTrainer`` on the case's mesh, with this rank's kernel launches
    (tests/test_torch_cuda.py, on the card)."""
    from distkeras_tpu_torch.ops import attention as attn
    from torch_dp_ranks import flatten

    mesh = _mesh(case)
    for k in attn.LAUNCHES:
        attn.LAUNCHES[k] = 0
    t = dkt.LMTrainer(cfg, device=device, mesh=mesh, **case["kw"])
    out = t.train(data["tokens"], params=dkt.params_from_numpy(
        _tree(data, "p"), device))
    res = {"history": np.asarray(t.history),
           "launches": np.asarray([attn.LAUNCHES[k] for k in (
               "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")])}
    for k, v in flatten(dkt.params_to_numpy(out)).items():
        res["p/" + k] = v
    return res

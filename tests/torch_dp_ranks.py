"""One rank of the data-parallel parity tests (tests/test_torch_dp.py).

Started by ``distkeras_tpu_torch.deploy.Job(...).run_local()``: every
rank joins the gloo group from its environment, runs the cases of the
spec file given as the first argument (on the CPU, or on the device the
spec names), and writes ``<out>/<case>_r<rank>.npz``.  It imports
neither jax nor ``distkeras_tpu``; the parent test runs the JAX side
and compares.  A case with a ``resume`` entry (``{"at": k}``,
tests/test_torch_checkpoint.py) trains three times: a straight run, a
checkpointed run that a ``train.round`` fault stops at round ``k``,
and its resumed run (checkpoints in ``<out>/ckpt_<case>``, shared by
the ranks); the results carry ``straight/`` and ``resumed/`` prefixes.

Run alone: ``python tests/torch_dp_ranks.py spec.json`` (world 1).
:func:`spawn` is the tests' launcher.
"""

import dataclasses
import json
import os
import sys
import traceback

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import distkeras_tpu_torch as dkt  # noqa: E402
from distkeras_tpu_torch import deploy  # noqa: E402
from distkeras_tpu_torch.parallel import collectives as C  # noqa: E402
from distkeras_tpu_torch.parallel import mesh as M  # noqa: E402


RANKS = os.path.abspath(__file__)
# Generous: a spawn runs all its cases; the ranks start in ~3 s.
SPAWN_TIMEOUT = 240


def spawn(tmp, world, cases, data, cfg=None, **where):
    """Run ``cases`` in ``world`` gloo ranks (on the CPU unless
    ``where`` names a ``device``); returns ``{case: [rank 0 result,
    rank 1 result, ...]}``."""
    out = tmp / "out"
    out.mkdir()
    np.savez(tmp / "data.npz", **data)
    spec = tmp / "spec.json"
    spec.write_text(json.dumps({"data": str(tmp / "data.npz"),
                                "out": str(out), "cases": cases,
                                "cfg": cfg, **where}))
    deploy.Job(RANKS, world=world, init_method=f"file://{tmp}/rdv",
               args=(str(spec),), env={"OMP_NUM_THREADS": "1"}).run_local(
        timeout=SPAWN_TIMEOUT, capture=True)
    res = {}
    for c in cases:
        per_rank = [dict(np.load(out / f"{c['name']}_r{r}.npz"))
                    for r in range(world)]
        for r, got in enumerate(per_rank):
            assert "error" not in got, f"{c['name']} rank {r}: " + str(
                got["error"])
        res[c["name"]] = per_rank
    return res


def nest(flat: dict):
    """``{"a/b": x}`` -> ``{"a": {"b": x}}``."""
    out = {}
    for key, val in flat.items():
        node = out
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = val
    return out


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def resumed_case(case, data, device, run):
    """``run(data, device, kw)`` three times: straight, stopped by a
    fault at round ``case["resume"]["at"]``, resumed from its latest
    checkpoint."""
    from distkeras_tpu_torch.resilience.chaos import FaultInjected, FaultPlan

    spec = case["resume"]
    ckpt = os.path.join(SPEC_OUT, f"ckpt_{case['name']}")
    ck = dict(checkpoint_dir=ckpt, checkpoint_every=spec.get("every", 1),
              max_checkpoints=100)
    out = {f"straight/{k}": v for k, v in run(case, data, device, {}).items()}
    try:
        with FaultPlan().fail("train.round", at=spec["at"]):
            run(case, data, device, ck)
        raise AssertionError("the fault did not fire")
    except FaultInjected:
        pass
    steps = sorted(int(e) for e in os.listdir(ckpt) if e.isdigit())
    res = run(case, data, device, dict(ck, resume=True))
    out.update({f"resumed/{k}": v for k, v in res.items()})
    out["resumed_from"] = np.asarray(steps[-1])
    return out


def keras_case(case, data, device, extra=None):
    model = dkt.zoo.MLP(16, (32,), 4)
    dkt.module_from_keras_numpy(
        model, [data[f"w{i}"] for i in range(int(data["n_w"]))])
    cls = getattr(dkt, case["trainer"])
    kw = dict(case["kw"], **(extra or {}))
    t = cls(model, loss="sparse_categorical_crossentropy", device=device,
            **kw)
    ds = dkt.Dataset.from_arrays(data["x"], data["y"])
    ev = None
    if case.get("eval"):
        ev = dkt.Dataset.from_arrays(data["x"][:50], data["y"][:50])
    out = t.train(ds, eval_dataset=ev) if ev is not None else t.train(ds)
    res = {"history": np.asarray(t.history),
           "eval_loss": np.asarray([e["loss"] for _, e in t.eval_history]),
           "probe": np.asarray([p["grad_norm"] for p in
                                getattr(t, "probe_history", [])])}
    models = out if isinstance(out, list) else [out]
    for m, module in enumerate(models):
        for i, w in enumerate(dkt.keras_numpy_from_module(module)[0]):
            res[f"m{m}_w{i}"] = w
    res["n_models"] = np.asarray(len(models))
    if getattr(t, "residual_norm", None) is not None:
        res["residual_norm"] = np.asarray(t.residual_norm)
    return res


def lm_case(case, data, cfg, device, extra=None):
    params = dkt.params_from_numpy(nest({k[2:]: data[k] for k in data.files
                                         if k.startswith("p/")}), device)
    seg = data["segments"] if case.get("segments") else None
    tokens = data["seg_tokens"] if seg is not None else data["tokens"]
    if case.get("dropout"):
        cfg = dataclasses.replace(cfg, dropout=case["dropout"])
    t = dkt.LMTrainer(cfg, device=device, **case["kw"], **(extra or {}))
    out = t.train(tokens[:case.get("rows")], params=params, segments=seg)
    res = {"history": np.asarray(t.history),
           "probe": np.asarray([p["grad_norm"] for p in t.probe_history])}
    for k, v in flatten(dkt.params_to_numpy(out)).items():
        res["p/" + k] = v
    return res


def prims_case(mesh):
    """The collectives on this rank's tensors, for the parent to hold
    against numpy."""
    r, n = mesh.rank, mesh.size
    base = torch.arange(4 * n, dtype=torch.float32)
    x = base * (r + 1)                                   # this rank's addend
    rs = C.reduce_scatter(x, mesh)
    ag = C.all_gather(torch.full((3,), float(r)), mesh)
    bucket = (base.reshape(n, 4) + 10 * r).requires_grad_()
    row = bucket[r].detach().clone().requires_grad_()
    full = C.gather_bucket(row, mesh)
    (full * (torch.arange(4 * n).reshape(n, 4) + 1.0)).sum().backward()
    ada = C.adasum_reduce(torch.tensor([1.0, 2.0]) * (r + 1), mesh)
    orth = torch.zeros(n)
    orth[r] = 1.0
    ada_orth = C.adasum_reduce(orth, mesh)
    try:
        M.equal_across_hosts(r, "counts")
        unequal = "no error"
    except ValueError as e:
        unequal = str(e)
    return {"rs": rs.numpy(), "ag": ag.numpy(), "gb_fwd": full.detach().numpy(),
            "gb_grad": row.grad.numpy(), "ada": ada.numpy(),
            "ada_orth": ada_orth.numpy(),
            "unequal": np.asarray(unequal),
            "equal": np.asarray(M.equal_across_hosts(7, "counts")),
            "rows": np.asarray(M.per_host_rows(8 * n)),
            "gbatch": M.global_batch(np.arange(4 * n), mesh),
            # A rank imports neither JAX nor the reference package.
            "foreign": np.asarray(sorted(
                m for m in sys.modules if m.split(".")[0] in (
                    "jax", "jaxlib", "distkeras_tpu", "keras")) or [""])}


SPEC_OUT = None


def main(spec_path):
    global SPEC_OUT
    torch.set_num_threads(1)
    spec = json.load(open(spec_path))
    SPEC_OUT = spec["out"]
    # The CPU by default; a spec may name the card and the backend (two
    # ranks sharing one card take gloo over CUDA tensors).
    device = spec.get("device", "cpu")
    deploy.init_from_env(device=device, backend=spec.get("backend"),
                         timeout=60)
    mesh = M.make_mesh()
    rank = mesh.rank
    data = np.load(spec["data"]) if spec.get("data") else None
    cfg = dkt.TransformerConfig(**spec["cfg"]) if spec.get("cfg") else None
    for case in spec["cases"]:
        try:
            if case["kind"] == "keras":
                run = lambda c, d, dev, kw: keras_case(c, d, dev, kw)
            elif case["kind"] == "lm":
                run = lambda c, d, dev, kw: lm_case(c, d, cfg, dev, kw)
            else:
                run = None
            if run is None:
                res = prims_case(mesh)
            elif case.get("resume"):
                res = resumed_case(case, data, device, run)
            else:
                res = run(case, data, device, {})
        except Exception as e:  # recorded for the parent to report
            res = {"error": np.asarray(
                f"{type(e).__name__}: {e}\n{traceback.format_exc()}")}
        np.savez(os.path.join(spec["out"], f"{case['name']}_r{rank}.npz"),
                 **res)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])

"""The port's standard census targets.

One definition shared by ``python -m distkeras_tpu_torch.analysis`` and
the tests: a fixed tiny model per trainer family and serving engine,
reached through each subsystem's ``traced_for_analysis()`` hook, so the
census records the REAL steps.  The names are those of the reference's
targets (``distkeras_tpu/analysis/targets.py``, ``scripts/
comm_budget.json``), so the two budgets read side by side; the shapes
are the reference's, every parameter-leaf size divisible by the 8-wide
data axis, so the ZeRO bucket layout is pad-free and the parity check
is exact.

Mesh targets are built and run inside :func:`~distkeras_tpu_torch.
analysis.ir_lint.fake_world` (world 8, one process): the target
functions read the world from the process group, so call them inside
it.  They import the trainers and engines lazily: importing this module
touches no device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

WORLD = 8

# (zero target, its replicated-DP partner, stage) — the triples the
# parity proof runs on (ir_lint.check_zero1_parity).
ZERO_PARITY_TARGETS = (
    ("adag_zero1/accum_step", "adag_dp/accum_step", 1),
    ("adag_zero2/accum_step", "adag_dp/accum_step", 2),
    ("adag_zero3/accum_step", "adag_dp/accum_step", 3),
    ("lmtrainer_zero1/train_step", "lmtrainer_dp/train_step", 1),
    ("lmtrainer_zero2/train_step", "lmtrainer_dp/train_step", 2),
    ("lmtrainer_zero3/train_step", "lmtrainer_dp/train_step", 3),
)

# Stage-1 pairs (the reference's name for them).
ZERO1_PARITY_PAIRS = tuple(
    (z, dp) for z, dp, stage in ZERO_PARITY_TARGETS if stage == 1)

#: Reference targets with no port counterpart, each with its reason.
NOT_PORTED_TARGETS = {
    "asyncdp_wire/adasum_int8": "the port's AsyncPlane merges the hosts' "
                                "deltas on the host (one process "
                                "simulates the fleet): there is no "
                                "compiled aggregation wave to census",
    "asyncdp_wire/sum": "as asyncdp_wire/adasum_int8",
    "pagedbatcher_greedy/disagg_extract": "the port's block export is a "
                                          "host copy of the slab's "
                                          "blocks, not a device program",
    "pagedbatcher_greedy/disagg_adopt": "as pagedbatcher_greedy/"
                                        "disagg_extract",
}


def _lm_cfg(**kw):
    from distkeras_tpu_torch.models import transformer as tfm

    # All leaf sizes divide by 8: embedding 64x32, pos 16x32, attn
    # 32x32, mlp 32x64/64x32, norms 32.
    return tfm.TransformerConfig(vocab_size=64, d_model=32, n_heads=2,
                                 n_layers=2, d_ff=64, max_len=16, **kw)


def _mlp_trainer(device, cls=None, mesh=None, **kw):
    import distkeras_tpu_torch as dkt

    # 8 -> 16 -> 8: kernels 8x16 / 16x8, biases 16 / 8 — every leaf
    # size a multiple of the 8-wide data axis.
    model = dkt.zoo.MLP(8, (16,), 8, seed=0)
    cls = cls or dkt.ADAG
    return cls(model, loss="sparse_categorical_crossentropy",
               worker_optimizer="adam", learning_rate=0.05, batch_size=4,
               communication_window=2, device=device, mesh=mesh, **kw)


def _mlp_dataset(rows: int = 256):
    import distkeras_tpu_torch as dkt

    rng = np.random.default_rng(0)
    return dkt.Dataset({
        "features": rng.normal(size=(rows, 8)).astype(np.float32),
        "label": rng.integers(0, 8, rows).astype(np.int64)})


def adag_targets(device="cpu") -> list:
    ds = _mlp_dataset()
    specs = []
    for kw in ({}, {"zero": 1}, {"zero": 2}, {"zero": 3},
               {"merge_rule": "adasum"}, {"sync_every": 4}):
        specs += _mlp_trainer(device, **kw).traced_for_analysis(ds)
    return _pair(specs)


def async_targets(device="cpu") -> list:
    """AsyncDP's intra-host accumulation step: each simulated host is a
    world-1 ADAG, so the step carries no collective."""
    import distkeras_tpu_torch as dkt
    from distkeras_tpu_torch.parallel.mesh import AXES, Mesh

    one = Mesh(shape=dict.fromkeys(AXES, 1))
    t = _mlp_trainer(device, cls=dkt.AsyncDP, mesh=one, hosts=2, tau=2,
                     async_merge="adasum", async_compress="int8")
    return t.traced_for_analysis(_mlp_dataset())


def lm_targets(device="cpu") -> list:
    import distkeras_tpu_torch as dkt

    cfg = _lm_cfg()
    specs = []
    for kw in ({}, {"zero": 1}, {"zero": 2}, {"zero": 3}, {"fsdp": True},
               {"compress": "int8"},
               {"compress": (("emb", "topk"), (".*", "int8"))},
               {"zero": 1, "compress": "int8"}):
        t = dkt.LMTrainer(cfg, learning_rate=1e-2, batch_size=8,
                          device=device, **kw)
        specs += t.traced_for_analysis()
    return _pair(specs)


def serving_targets(device="cpu") -> list:
    """The engines' decode windows and admission chunks: a per-request
    sampling engine, a greedy engine with a prefix pool and chunked
    prefill, the paged engine, the speculative engine (sampled) and the
    tensor-parallel engine over a data=4 x model=2 mesh."""
    import distkeras_tpu_torch as dkt
    from distkeras_tpu_torch.models import transformer as tfm
    from distkeras_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from distkeras_tpu_torch.parallel.sharding import serving_plan

    cfg = _lm_cfg()
    params = tfm.init_params(0, cfg, device=device)
    prompt = np.arange(1, 8, dtype=np.int32)
    cb = dkt.ContinuousBatcher(params, cfg, lanes=2,
                               per_request_sampling=True,
                               prompt_buckets=(8,), device=device)
    cb.submit(prompt, 4, seed=3, temperature=0.7)
    pool = dkt.PrefixPool(cfg, slots=2, device=device)
    cbp = dkt.ContinuousBatcher(params, cfg, lanes=2, prompt_buckets=(8,),
                                prefill_chunk=8, prefix_pool=pool,
                                device=device)
    cbp.submit(prompt, 4)
    pgd = dkt.PagedBatcher(params, cfg, lanes=2, block=4, n_blocks=9,
                           prompt_buckets=(8,), device=device)
    pgd.submit(prompt, 4)
    draft = tfm.TransformerConfig(vocab_size=64, d_model=16, n_heads=2,
                                  n_layers=1, d_ff=32, max_len=16)
    dparams = tfm.init_params(1, draft, device=device)
    sb = dkt.SpeculativeBatcher(params, dparams, cfg, draft, lanes=2,
                                n_draft=2, temperature=0.7,
                                prompt_buckets=(8,), device=device)
    sb.submit(prompt, 4, seed=5)
    mesh = make_mesh(MeshSpec(data=4, model=2))
    cbs = dkt.ContinuousBatcher(params, cfg, lanes=2, prompt_buckets=(8,),
                                plan=serving_plan(), mesh=mesh,
                                device=device)
    cbs.submit(prompt, 4)
    return (cb.traced_for_analysis() + cbp.traced_for_analysis()
            + pgd.traced_for_analysis() + sb.traced_for_analysis()
            + cbs.traced_for_analysis())


def _pair(specs: list) -> list:
    """Attach the declared parity partners (and stage) to the zero
    specs."""
    names = {s.name for s in specs}
    out = []
    for s in specs:
        for z, dp, stage in ZERO_PARITY_TARGETS:
            if s.name == z and dp in names:
                s = dataclasses.replace(s, zero1_parity_with=dp,
                                        zero_stage=stage)
        out.append(s)
    return out


def default_targets(device="cpu") -> list:
    """Every standard target (call inside ``fake_world(WORLD)``): both
    trainer families (DP / the ZeRO stages / fsdp / the exchange
    variants), the async tier's host step, and the serving engines."""
    return (adag_targets(device) + lm_targets(device)
            + serving_targets(device) + async_targets(device))


__all__ = ["WORLD", "ZERO_PARITY_TARGETS", "ZERO1_PARITY_PAIRS",
           "NOT_PORTED_TARGETS", "adag_targets", "lm_targets",
           "serving_targets", "async_targets", "default_targets"]

"""The flagship LM's training on one card, through ``LMTrainer``.

Set-up builds one trainer and the train step it trains with (the one
``LMTrainer.train`` builds for this configuration: ``_carry_and_step``),
on weights the benchmark makes on the card from the seed, and runs its
first three steps through the window's own call and feed: the trainer's
host stream (``_host_block``: each step's rows copied from the host
rows to the card), on rows that all differ.  The window then goes on
with that same step and state for ``--seconds``.

``correct``: the plain reference (``reference/lm.py``) follows the same
three steps from the same weights and rows, and the run compares each
step's loss, the first gradient by leaf (the program's worked out from
AdamW's first moment after one step, m = (1 - b1) g), by the worst
leaf's gap of norms and by the median leaf's norm of the difference,
and each leaf's change over the three steps (the worst leaf's gap of
norms).
"""

from __future__ import annotations

import time

import numpy as np

from harness import compare, device, reckon
from harness.loop import run_steps
from reference import lm as ref

B1 = 0.9


def model_cfg(run) -> dict:
    cfg = {k: run.config[k] for k in ("vocab_size", "d_model", "n_heads",
                                      "n_layers", "d_ff", "rope",
                                      "rope_theta")}
    return dict(cfg, **{k: run.params[k] for k in ("dtype", "remat",
                                                   "max_len")})


def token_rows(cfg: dict, seed: int, n: int, width: int, dev: str):
    """``[n, width]`` int32 token rows, uniform over the vocabulary,
    drawn on the card from the seed and copied to the host (the
    trainer's stream reads host rows)."""
    import torch

    gen = torch.Generator(dev).manual_seed(seed ^ 0x7A11)
    rows = torch.randint(0, cfg["vocab_size"], (n, width), generator=gen,
                         device=dev, dtype=torch.int32)
    return rows.cpu().numpy()


def run(run):
    import torch

    from distkeras_tpu_torch.models.transformer import TransformerConfig
    from distkeras_tpu_torch.trainers.lm import LMTrainer

    p, dev = run.params, run.device
    cfg = model_cfg(run)
    b, s = p["batch"], p["seq"]
    tcfg = TransformerConfig(**cfg)
    run.mark("imports")
    rows = token_rows(cfg, run.seed, b * p["row_blocks"], s + 1, dev)
    run.mark("rows")

    def block(j):
        j %= p["row_blocks"]
        return np.arange(j * b, (j + 1) * b)

    trainer = LMTrainer(tcfg, optimizer=p["optimizer"],
                        learning_rate=p["learning_rate"], batch_size=b,
                        seed=run.seed, device=dev)
    weights = ref.init_params(cfg, run.seed, dev)
    # Attention runs in the promotion of the configuration's type and
    # the weights' (f32 weights under a bf16 configuration: f32).
    attention_dtype = str(torch.promote_types(
        getattr(torch, cfg["dtype"]), weights["tok_emb"].dtype)).split(".")[1]
    params, opt_state, step, drop = trainer._carry_and_step(weights)
    del weights          # the trainer holds its own copy
    carry = [(params, opt_state)]
    losses = []
    run.mark("trainer")

    def one(j):
        tokens, _ = trainer._host_block(rows, None, block(j), 1, b)
        carry[0], loss = step(carry[0], tokens, drop, None)
        losses.append(loss)

    # The first three steps, read as the reference reads them.
    one(0)
    device.sync(dev)
    run.mark("step1")
    moments = opt_state.torch_opt.state
    g1 = {k: float(moments[v]["exp_avg"].norm()) / (1 - B1)
          for k, v in ref.flatten(params).items()}
    # Kept on the host through the window, for the elementwise number.
    first_grad = {k: moments[v]["exp_avg"].cpu() / (1 - B1)
                  for k, v in ref.flatten(params).items()}
    one(1)
    one(2)
    start = ref.flatten(ref.init_params(cfg, run.seed, dev))
    change = {k: float((v.detach() - start[k]).norm())
              for k, v in ref.flatten(params).items()}
    del start
    first = [float(x) for x in losses]
    device.reset_peak(dev)

    steps, window_s = run_steps(run, lambda i: one(3 + i), run.seconds)
    run.memory_peak_bytes = device.peak(dev)
    tail = torch.stack(losses[3:]).float().cpu().numpy()
    run.attempted, run.failed = steps, int((~np.isfinite(tail)).sum())
    tokens = steps * b * s
    run.e2e["train_tokens_per_s"] = (tokens / window_s, "tokens/s")
    run.counters.update({
        "kind": "lm_train", "window_s": window_s, "lm_train.steps": steps,
        "lm_train.model_flops": steps * reckon.lm_train_flops(cfg, b, s),
        "lm_train.attention": {"b": b, "l": s, "h": cfg["n_heads"],
                               "d": cfg["d_model"] // cfg["n_heads"],
                               "causal": True,
                               "dtype": attention_dtype}})

    # The program's state goes before the reference runs.
    del carry, params, opt_state, step, trainer, losses
    device.free(dev)
    t = time.perf_counter()
    readings = reference_readings(run, cfg, rows, block)
    run.counters["reference_s"] = time.perf_counter() - t
    for name, value in compare.training_numbers(
            readings, (first, g1, change, first_grad)).items():
        run.check(name, value)


def reference_readings(run, cfg, rows, block, tf32: bool = False,
                       rows_used=None):
    """The reference's three steps from the run's seed (``tf32``: its
    control, the products in TF32; ``rows_used(rows)``: a fault that
    feeds the reference another batch)."""
    import torch

    batches = []
    for j in range(3):
        r = rows[block(j)]
        if rows_used is not None:
            r = rows_used(r)
        batches.append(torch.from_numpy(r).to(run.device).long())
    return ref.train_readings(
        ref.init_params(cfg, run.seed, run.device), batches, cfg,
        getattr(torch, cfg["dtype"]), tf32=tf32)


def calibrate(run) -> dict:
    """The readings a limit is set from, beyond the program's own (which
    a run gives): the control (the reference with TF32 products) and the
    fault "half of the batch left out, the mean taken over the rest"
    (the reference on the first half of each batch), each compared with
    the reference as a run compares the program.  A step that leaves the
    state unchanged reads 1 on the change and needs no run."""
    p, cfg = run.params, model_cfg(run)
    b = p["batch"]
    rows = token_rows(cfg, run.seed, b * p["row_blocks"], p["seq"] + 1,
                      run.device)

    def block(j):
        return np.arange(j * b, (j + 1) * b)

    base = reference_readings(run, cfg, rows, block)
    out = {}
    for name, kw in (("control_tf32", {"tf32": True}),
                     ("fault_half_batch",
                      {"rows_used": lambda r: r[:len(r) // 2]})):
        out[name] = compare.training_numbers(
            base, reference_readings(run, cfg, rows, block, **kw))
    return out


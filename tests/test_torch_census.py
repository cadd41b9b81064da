"""The port's step census (``distkeras_tpu_torch/analysis/ir_lint.py``)
on the CPU.

The whole target sweep runs once, in ONE child process with a deadline
(torch's fake process group is process-global): every target of
``analysis/targets.py`` at world 8, then the seeded faults.  The parent
holds what it reports:

- every target's census equals the port's recorded budgets
  (``analysis/comm_budget.json``, ``shard_budget.json``);
- the zero parity holds for stages 1-3 of both families: each stage's
  scatter and gather payloads are the parameter bytes, pad-free, and
  each stage's per-rank optimizer moments (and stage 3's parameters)
  are 1/8 of the DP partner's;
- the DP partners' gradient all-reduce payload equals ``params_bytes``;
- seeded steps each raise their rule: an f64 op, a default-generator
  dropout, a ``.item()`` in the decode window, a double-reduced tied
  embedding — and their fixed forms do not;
- the fake group is gone once the sweep ends.

In this process (world 1, no group): each ``traced_for_analysis`` hook's
step equals one ``train`` / ``step`` call of the same object, to 0 ulp.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUDGETS = os.path.join(REPO, "distkeras_tpu_torch", "analysis",
                       "comm_budget.json")
with open(BUDGETS, encoding="utf-8") as _f:
    TARGETS = sorted(json.load(_f)["targets"])
DEADLINE_S = 240
# The sweep runs in the module's first test: the limit sits above it.
pytestmark = pytest.mark.time_limit(300)

CHILD = r"""
import dataclasses, json, sys
import torch
import torch.distributed as dist
from distkeras_tpu_torch.analysis import ir_lint, shard_lint, targets as T
from distkeras_tpu_torch.analysis.__main__ import census, census_findings
from distkeras_tpu_torch.parallel.collectives import all_reduce

def rows(records):
    out = {}
    for name, (spec, art, placed) in records.items():
        moments = sum(v[2] for k, v in placed["tensors"].items()
                      if "/torch_opt/" in k)
        out[name] = {
            "params_bytes": spec.params_bytes,
            "zero_stage": spec.zero_stage,
            "parity_with": spec.zero1_parity_with,
            "decl": ir_lint.declared_zero_exchange(spec, art),
            "census": ir_lint.census_to_budget(ir_lint.comm_census(art)),
            "bytes_by_kind": placed["bytes_by_kind"],
            "moments": moments,
            "events": sorted(set(e[0] for e in art.events)),
        }
    return out

records = census("cpu")
report = {"targets": rows(records),
          "findings": [[f.rule, f.severity, f.path, f.message] for f in
                       census_findings(records,
                                       ir_lint.load_budgets(ir_lint.BUDGET_PATH),
                                       shard_lint.load_shard_budgets())],
          "group_after_sweep": dist.is_initialized()}

def seeded():
    from distkeras_tpu_torch.models import transformer as tfm
    specs = {}
    x = torch.linspace(-1, 1, 16)
    specs["f64"] = ir_lint.TraceSpec("seeded/f64", lambda t: (t.double() * 2).sum(), (x,))
    specs["f64_fixed"] = ir_lint.TraceSpec("seeded/f64_fixed", lambda t: (t * 2).sum(), (x,))
    gen = torch.Generator().manual_seed(0)
    specs["dropout"] = ir_lint.TraceSpec("seeded/dropout", lambda t: tfm._dropout(t, 0.1, None), (x,))
    specs["dropout_fixed"] = ir_lint.TraceSpec("seeded/dropout_fixed", lambda t: tfm._dropout(t, 0.1, gen), (x,))
    eng_specs = T.serving_targets("cpu")
    dec = next(s for s in eng_specs if s.name == "continuousbatcher_greedy_pooled/decode_step")
    eng = dec.fn.__self__
    def window_with_item(n):
        toks = eng._device_window(n)
        eng.pos.max().item()
        return toks
    specs["item"] = dataclasses.replace(dec, name="seeded/item", fn=window_with_item)
    specs["item_fixed"] = dataclasses.replace(dec, name="seeded/item_fixed")
    dp = next(s for s in T.lm_targets("cpu") if s.name == "lmtrainer_dp/train_step")
    params = dp.state["params"]
    def step_twice_reduced(carry, *args):
        out = dp.fn(carry, *args)
        from distkeras_tpu_torch.parallel.mesh import make_mesh
        all_reduce(params["tok_emb"].detach().clone(), make_mesh())
        return out
    specs["tied"] = dataclasses.replace(dp, name="seeded/tied", fn=step_twice_reduced)
    specs["tied_fixed"] = dp
    out = {}
    for key, spec in specs.items():
        found, cen = ir_lint.lint_trace(spec)
        if key.startswith("tied"):
            found += ir_lint.check_dp_volume(spec.name, spec.params_bytes, cen)
        out[key] = sorted({f.rule for f in found if f.gating})
    return out

with ir_lint.fake_world(T.WORLD):
    report["seeded"] = seeded()
report["group_after_seeded"] = dist.is_initialized()
print(json.dumps(report))
"""


@pytest.fixture(scope="module")
def sweep():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("DKT_LOCK_SANITIZER", None)
    res = subprocess.run([sys.executable, "-c", CHILD], cwd=REPO, env=env,
                         capture_output=True, text=True,
                         timeout=DEADLINE_S)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_sweep_covers_the_budgets_and_no_group_survives(sweep):
    assert sorted(sweep["targets"]) == TARGETS
    assert sweep["group_after_sweep"] is False
    assert sweep["group_after_seeded"] is False
    assert not dist.is_initialized()


@pytest.mark.parametrize("name", TARGETS)
def test_target_census_equals_its_budget(sweep, name):
    found = [f for f in sweep["findings"] if f[2] == name]
    assert not [f for f in found if f[1] == "error"], found
    with open(BUDGETS, encoding="utf-8") as f:
        want = json.load(f)["targets"][name]
    assert sweep["targets"][name]["census"] == want
    # No step of the sweep reads the global generator or makes f64.
    assert not {"global-generator", "dtype-f64"} & set(
        sweep["targets"][name]["events"])


def test_no_census_finding_gates(sweep):
    assert [f for f in sweep["findings"] if f[1] != "info"] == []


ZERO = [("adag_zero1/accum_step", "adag_dp/accum_step", 1),
        ("adag_zero2/accum_step", "adag_dp/accum_step", 2),
        ("adag_zero3/accum_step", "adag_dp/accum_step", 3),
        ("lmtrainer_zero1/train_step", "lmtrainer_dp/train_step", 1),
        ("lmtrainer_zero2/train_step", "lmtrainer_dp/train_step", 2),
        ("lmtrainer_zero3/train_step", "lmtrainer_dp/train_step", 3)]


@pytest.mark.parametrize("zero,dp,stage", ZERO)
def test_zero_parity_every_stage_both_families(sweep, zero, dp, stage):
    z, d = sweep["targets"][zero], sweep["targets"][dp]
    P = z["params_bytes"]
    assert P == d["params_bytes"] > 0 and P % 8 == 0
    assert z["parity_with"] == dp and z["zero_stage"] == stage
    assert z["decl"] == {"rs_bytes": P, "ag_bytes": P}
    # Ring identity: RS(P) + AG(P) carries AR(P)'s wire bytes.
    wire = {c["canonical"]: c["wire_bytes"] / c["count"]
            for c in z["census"]["collectives"]}
    assert wire["reduce-scatter"] + wire["all-gather"] == 2 * 7 / 8 * P
    # Per-rank state: the moments 1/8 of the DP partner's, pad-free.
    assert z["moments"] * 8 == d["moments"] == 2 * P
    if stage == 3:
        assert z["bytes_by_kind"]["params"] * 8 == \
            d["bytes_by_kind"]["params"] == P
    else:
        assert z["bytes_by_kind"]["params"] == P


@pytest.mark.parametrize("dp", ["adag_dp/accum_step",
                                "lmtrainer_dp/train_step"])
def test_dp_all_reduce_payload_is_the_parameter_bytes(sweep, dp):
    d = sweep["targets"][dp]
    ar = [c for c in d["census"]["collectives"]
          if c["canonical"] == "all-reduce"]
    assert sum(c["payload_bytes"] * c["count"] for c in ar) \
        == d["params_bytes"]
    assert all(c["group_size"] == 8 and c["dtype"] == "f32" for c in ar)


@pytest.mark.parametrize("fault,rule", [
    ("f64", "dtype-f64"), ("dropout", "global-generator"),
    ("item", "host-sync"), ("tied", "comm-redundant-ar")])
def test_seeded_faults_raise_their_rule(sweep, fault, rule):
    assert sweep["seeded"][fault] == [rule]
    assert sweep["seeded"][f"{fault}_fixed"] == []


# ------------------------------------------- the hooks against train/step


def _lm(**kw):
    import distkeras_tpu_torch as dkt
    from distkeras_tpu_torch.analysis.targets import _lm_cfg

    return dkt.LMTrainer(_lm_cfg(), learning_rate=1e-2, batch_size=4,
                         device="cpu", **kw)


def _same(a, b):
    from distkeras_tpu_torch.models.transformer import named_leaves

    for (ka, x), (kb, y) in zip(named_leaves(a), named_leaves(b),
                                strict=True):
        assert ka == kb
        assert torch.equal(x, y), ka


@pytest.mark.parametrize("kw", [{}, {"grad_accum": 2}],
                         ids=["dp", "accum2"])
def test_lm_hook_step_is_one_train_round(kw):
    assert not dist.is_initialized()
    rows = np.random.default_rng(1).integers(
        0, 64, (4 * kw.get("grad_accum", 1), 17)).astype(np.int32)
    t = _lm(**kw)
    (spec,) = t.traced_for_analysis(tokens=rows)
    assert spec.name == "lmtrainer_dp/train_step"
    (params, _), loss = spec.fn(*spec.args)
    trained = t.train(rows)
    _same(params, trained)
    assert float(loss) == t.history[0]


def test_adag_hook_step_is_one_train_round():
    from distkeras_tpu_torch.analysis.targets import (_mlp_dataset,
                                                      _mlp_trainer)

    ds = _mlp_dataset(rows=8)     # one round: batch 4 x window 2
    t = _mlp_trainer("cpu")
    (spec,) = t.traced_for_analysis(ds)
    assert spec.name == "adag_dp/accum_step"
    state, loss = spec.fn(*spec.args)
    model = t.train(ds)
    for a, b in zip(state.tv, model.parameters(), strict=True):
        assert torch.equal(a, b.detach())


def _engine(cls, **kw):
    from distkeras_tpu_torch.analysis.targets import _lm_cfg
    from distkeras_tpu_torch.models import transformer as tfm

    cfg = _lm_cfg()
    return cls(tfm.init_params(0, cfg, device="cpu"), cfg, lanes=2,
               prompt_buckets=(8,), device="cpu", **kw)


@pytest.mark.parametrize("kind", ["continuous", "paged"])
def test_engine_hook_window_is_one_step(kind):
    import distkeras_tpu_torch as dkt

    cls, kw = ((dkt.ContinuousBatcher, {}) if kind == "continuous" else
               (dkt.PagedBatcher, {"block": 4, "n_blocks": 9}))
    prompt = np.arange(1, 8, dtype=np.int32)
    a, b = _engine(cls, **kw), _engine(cls, **kw)
    la, lb = a.submit(prompt, 4), b.submit(prompt, 4)
    dec = a.traced_for_analysis()[0]
    assert dec.name.endswith("greedy/decode_step") and dec.host_sync_free
    toks = dec.fn(*dec.args)
    want = b.step(1)
    assert toks[la, 0].item() == want[lb][0]
    for name in a.cache:
        assert torch.equal(a.cache[name], b.cache[name]), name
    assert torch.equal(a.pos, b.pos) and torch.equal(a.cur, b.cur)


def test_speculative_hook_step_is_the_engines_step():
    import distkeras_tpu_torch as dkt
    from distkeras_tpu_torch.analysis.targets import _lm_cfg
    from distkeras_tpu_torch.models import transformer as tfm

    cfg = _lm_cfg()
    draft = tfm.TransformerConfig(vocab_size=64, d_model=16, n_heads=2,
                                  n_layers=1, d_ff=32, max_len=16)

    def eng():
        return dkt.SpeculativeBatcher(
            tfm.init_params(0, cfg, device="cpu"),
            tfm.init_params(1, draft, device="cpu"), cfg, draft, lanes=2,
            n_draft=2, prompt_buckets=(8,), device="cpu")

    prompt = np.arange(1, 8, dtype=np.int32)
    a, b = eng(), eng()
    a.submit(prompt, 6)
    b.submit(prompt, 6)
    step = a.traced_for_analysis()[0]
    assert step.name == "speculativebatcher_greedy/step"
    assert step.fn(*step.args) == b.step()

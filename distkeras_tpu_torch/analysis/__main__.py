"""``python -m distkeras_tpu_torch.analysis``: the port's analysis gates.

The port's counterpart of ``scripts/graph_lint.py``::

    python -m distkeras_tpu_torch.analysis                # every gate
    python -m distkeras_tpu_torch.analysis --threads      # thread lint
    python -m distkeras_tpu_torch.analysis --contracts    # contract lint
    python -m distkeras_tpu_torch.analysis --shardings    # plan lint
    python -m distkeras_tpu_torch.analysis --census       # step census
    python -m distkeras_tpu_torch.analysis --update-budgets
    python -m distkeras_tpu_torch.analysis --update-baseline

Run from anywhere on a CPU box.  The census records one real step per
target at world 8 in this one process, on torch's fake process group,
and holds it to
``analysis/comm_budget.json`` / ``analysis/shard_budget.json``;
``--update-budgets`` re-records both (review the diff).  Warn findings
ratchet against ``analysis/lint_baseline.json`` (``--update-baseline``
re-records it); errors always gate.  Exits 1 on any gating finding.
"""

from __future__ import annotations

import argparse
import os
import sys

from distkeras_tpu_torch.analysis import contract_lint, findings as F
from distkeras_tpu_torch.analysis import ir_lint, shard_lint
from distkeras_tpu_torch.analysis.source_lint import lint_paths
from distkeras_tpu_torch.analysis.thread_lint import lint_paths_threads

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
BASELINE_PATH = os.path.join(HERE, "lint_baseline.json")


def _relative(findings, root: str) -> list:
    return [F.Finding(f.rule, f.severity,
                      os.path.relpath(f.path, root).replace(os.sep, "/")
                      if os.path.isabs(f.path) else f.path,
                      f.line, f.message, f.hint, f.suppressed, f.baselined)
            for f in findings]


def source_findings(root: str = ROOT) -> list:
    """The source lint over the whole port, paths relative to ``root``."""
    return _relative(lint_paths([os.path.join(root, "distkeras_tpu_torch")]),
                     root)


def thread_findings(root: str = ROOT) -> list:
    """The thread lint over the port's threaded core."""
    return _relative(lint_paths_threads(
        [os.path.join(root, "distkeras_tpu_torch")]), root)


def contract_findings(root: str = ROOT) -> list:
    return contract_lint.lint_repo_contracts(root)


def census(device: str = "cpu"):
    """Record every standard target once on ``device``: ``{name: (spec,
    artifacts, placement census)}``, inside a fake world (destroyed on
    return)."""
    from distkeras_tpu_torch.analysis import targets as T

    with ir_lint.fake_world(T.WORLD):
        specs = T.default_targets(device)
        out = {}
        for spec in specs:
            art = ir_lint.trace_target(spec)
            out[spec.name] = (spec, art, shard_lint.placement_census(spec))
    return out


def census_findings(records: dict, budgets: dict | None,
                    shard_budgets: dict | None) -> list:
    """Every census rule over recorded targets: the step audits, the
    budgets (skipped when None), the zero parity of each paired target
    and the DP partners' exchange volume."""
    out = []
    dp_partners = set()
    for name, (spec, art, placed) in records.items():
        found, census_ = ir_lint.lint_trace(spec, art)
        out += found
        if budgets is not None:
            out += ir_lint.check_budget(name, census_, budgets)
        if shard_budgets is not None:
            out += shard_lint.check_shard_budget(name, placed,
                                                 shard_budgets)
        partner = spec.zero1_parity_with
        if partner and partner in records:
            dp_partners.add(partner)
            out += ir_lint.check_zero1_parity(
                spec, art, ir_lint.comm_census(records[partner][1]))
    for name in sorted(dp_partners):
        spec, art, _ = records[name]
        out += ir_lint.check_dp_volume(name, spec.params_bytes,
                                       ir_lint.comm_census(art),
                                       spec.suppress)
    return out


def _budget_docs(records: dict) -> tuple[dict, dict]:
    comm = {n: ir_lint.census_to_budget(ir_lint.comm_census(a))
            for n, (_, a, _) in sorted(records.items())}
    shard = {n: p for n, (_, _, p) in sorted(records.items())}
    return comm, shard


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m distkeras_tpu_torch."
                                      "analysis", description=__doc__.split(
                                          "\n")[0])
    mode = ap.add_mutually_exclusive_group()
    for flag in ("threads", "contracts", "shardings", "census"):
        mode.add_argument(f"--{flag}", action="store_true")
    ap.add_argument("--update-budgets", action="store_true",
                    help="re-record analysis/comm_budget.json and "
                         "shard_budget.json from this census")
    ap.add_argument("--update-baseline", action="store_true",
                    help="re-record the warn ratchet "
                         "(analysis/lint_baseline.json)")
    args = ap.parse_args(argv)
    every = not (args.threads or args.contracts or args.shardings
                 or args.census)
    found, records = [], {}
    if every:
        found += source_findings()
    if every or args.threads:
        found += thread_findings()
    if every or args.contracts:
        found += contract_findings()
    if every or args.shardings:
        found += shard_lint.lint_repo_plans()
    if every or args.census or args.update_budgets:
        records = census()
        if args.update_budgets:
            comm, shard = _budget_docs(records)
            ir_lint.save_budgets(ir_lint.BUDGET_PATH, comm)
            shard_lint.save_shard_budgets(shard_lint.BUDGET_PATH, shard)
            print(f"recorded {len(comm)} targets into "
                  f"{ir_lint.BUDGET_PATH} and {shard_lint.BUDGET_PATH}")
        found += census_findings(
            records, ir_lint.load_budgets(ir_lint.BUDGET_PATH),
            shard_lint.load_shard_budgets())
    if args.update_baseline:
        # Keep the counts of census targets this run does not record
        # (phase analysis of chip_smoke.py records the card's own).
        keep = {k: n for k, n in F.load_baseline(BASELINE_PATH).items()
                if not k.split(":", 1)[1].endswith(".py")
                and k.split(":", 1)[1] not in records}
        F.save_baseline(BASELINE_PATH, found, keep)
    found = F.apply_baseline(found, F.load_baseline(BASELINE_PATH))
    print(F.format_findings(found))
    return 1 if any(f.gating for f in found) else 0


if __name__ == "__main__":
    sys.exit(main())

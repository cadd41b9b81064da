"""Static analysis of the port: machine-check the invariants the docs
only claim.

The port's counterpart of ``distkeras_tpu/analysis/``, with the same
module names and ``__all__``.  The lint layers share one findings model
(``findings.py``):

* :mod:`~distkeras_tpu_torch.analysis.ir_lint` — the step census: run
  the trainers' and serving engines' REAL steps once (each subsystem
  hands them out through ``traced_for_analysis()``) under a recording
  dispatch mode, at world 8 in one process on torch's fake process
  group, and audit what they dispatch: the per-step collective census
  against ``analysis/comm_budget.json``, the dtype policy, host reads
  in steps that must have none, draws from the global generator.
* :mod:`~distkeras_tpu_torch.analysis.source_lint` — an AST rule engine
  over the port's source (host syncs in hot loops, device work at
  import time, axis-name typos, JAX imports in the port, torch imports
  in the torch-free modules, ...).
* :mod:`~distkeras_tpu_torch.analysis.thread_lint` — the concurrency
  gate's static half (raw locks, callbacks/blocking under a lock,
  double acquires) over the threaded core.
* :mod:`~distkeras_tpu_torch.analysis.shard_lint` — the partition-plan
  gate: plan lint (dead/shadowed/duplicate rules, axis divisibility,
  replicated giants) over every shipped rule plan, plus the placement
  census (per-tensor placements and per-rank bytes vs
  ``analysis/shard_budget.json``) over the same targets.
* :mod:`~distkeras_tpu_torch.analysis.contract_lint` — the telemetry
  schema, the wire protocol and the resource-pairing proof over the
  port's producers, servers and clients, against the fleet's one
  schema ``scripts/obs_schema.json`` (read as data).

All honor the ``# dkt: ignore[rule]`` suppression syntax.  The CLI is
``python -m distkeras_tpu_torch.analysis`` (``--threads``,
``--contracts``, ``--shardings``, ``--census``, ``--update-budgets``).
:data:`NOT_PORTED_RULES` lists the reference's rules with no port
counterpart, each with its reason, and :data:`RENAMED_RULES` the
reference rules whose port spelling differs.
"""

from distkeras_tpu_torch.analysis import (ir_lint, shard_lint,
                                          source_lint)
from distkeras_tpu_torch.analysis.contract_lint import (build_obs_schema,
                                                        lint_repo_contracts)
from distkeras_tpu_torch.analysis.findings import Finding, format_findings
from distkeras_tpu_torch.analysis.ir_lint import (CollectiveOp, TraceSpec,
                                                  comm_census, lint_trace,
                                                  trace_target)
from distkeras_tpu_torch.analysis.shard_lint import (lint_plan,
                                                     lint_repo_plans,
                                                     placement_census)
from distkeras_tpu_torch.analysis.source_lint import lint_paths, lint_source

#: Every reference rule with no port counterpart, with its reason.
NOT_PORTED_RULES = {**source_lint.NOT_PORTED_RULES,
                    **ir_lint.NOT_PORTED_RULES,
                    **shard_lint.NOT_PORTED_RULES}

#: Reference rule -> the port rule(s) that take its place.
RENAMED_RULES = {**source_lint.RENAMED_RULES, **ir_lint.RENAMED_RULES}

__all__ = ["Finding", "format_findings", "TraceSpec", "CollectiveOp",
           "comm_census", "lint_trace", "trace_target", "lint_plan",
           "lint_repo_plans", "placement_census", "lint_source",
           "lint_paths", "build_obs_schema", "lint_repo_contracts"]

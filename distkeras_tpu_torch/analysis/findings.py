"""The findings model every lint layer of the port shares.

The port's copy of ``distkeras_tpu/analysis/findings.py`` (pure Python).
A finding is (rule id, severity, location, message, fix hint).  The
source layers locate findings at ``path:line``; the step census locates
them at the trace-target name (one recorded step has no one source
line).  Suppression is per-line for source findings — ``# dkt:
ignore[rule-a,rule-b]`` (or a bare ``# dkt: ignore`` for every rule) on
the flagged line — and per-target for census findings (the
``suppress=`` tuple on
:class:`~distkeras_tpu_torch.analysis.ir_lint.TraceSpec`).  Suppressed
findings are still *returned* (marked) so tooling can count them; only
unsuppressed ones gate.
"""

from __future__ import annotations

import dataclasses
import re

# error: a correctness/semantics violation.  warn: a performance or
# hygiene hazard.  info: census/annotation output, never gating.
SEVERITIES = ("error", "warn", "info")

_IGNORE_RE = re.compile(r"#\s*dkt:\s*ignore(?:\[([\w ,\-]*)\])?")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    severity: str
    path: str               # file path, or the IR trace-target name
    line: int | None
    message: str
    hint: str = ""
    suppressed: bool = False
    # Covered by the checked-in warn baseline (analysis/lint_baseline
    # .json): known debt that no longer gates but can only RATCHET
    # down — new findings beyond the recorded count still fail.
    baselined: bool = False

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity must be one of {SEVERITIES}, got "
                f"{self.severity!r}")

    @property
    def gating(self) -> bool:
        """Does this finding fail CI?  Unsuppressed, unbaselined
        error/warn only."""
        return (not self.suppressed and not self.baselined
                and self.severity != "info")

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        sup = (" (suppressed)" if self.suppressed
               else " (baselined)" if self.baselined else "")
        hint = f" — {self.hint}" if self.hint else ""
        return f"{loc}: {self.severity} [{self.rule}]{sup} {self.message}{hint}"


def suppressed_rules(line_text: str) -> frozenset | None:
    """Rules a ``# dkt: ignore[...]`` comment on this line suppresses.

    Returns None when the line carries no ignore comment, an empty
    frozenset for the bare ``# dkt: ignore`` (suppress every rule), or
    the named rule set.  The scan is textual — a string literal
    containing the marker would also match, which is harmless (the
    syntax is ours) and keeps the check independent of the tokenizer.
    """
    m = _IGNORE_RE.search(line_text)
    if m is None:
        return None
    if m.group(1) is None:
        return frozenset()
    return frozenset(r.strip() for r in m.group(1).split(",") if r.strip())


def apply_suppressions(finding: Finding, line_text: str) -> Finding:
    """Mark ``finding`` suppressed if ``line_text`` carries a matching
    ignore comment (bare ignores match every rule)."""
    rules = suppressed_rules(line_text)
    if rules is None:
        return finding
    if rules and finding.rule not in rules:
        return finding
    return dataclasses.replace(finding, suppressed=True)


def format_findings(findings) -> str:
    lines = [f.format() for f in findings]
    gating = sum(f.gating for f in findings)
    lines.append(f"{len(lines)} finding(s), {gating} gating")
    return "\n".join(lines)


# ------------------------------------------------------ warn baselines
#
# Per-finding baselines let `warn` rules RATCHET: a checked-in file
# records how many warn findings each (rule, path) pair is allowed,
# existing debt stops gating, and any NEW warn — a higher count at a
# recorded key, or any unrecorded key — still fails CI.  Errors are
# never baselineable (they are correctness violations, not debt), and
# re-recording with fewer findings tightens the ledger, so the only
# stable direction is down.

def baseline_key(finding: Finding) -> str:
    """The ledger key: rule + path (no line numbers — they churn on
    every unrelated edit, which would make the baseline useless)."""
    return f"{finding.rule}:{finding.path.replace(chr(92), '/')}"


def warn_counts(findings) -> dict:
    """Current unsuppressed-warn census, keyed by :func:`baseline_key`
    — what ``--update-baseline`` records."""
    counts: dict[str, int] = {}
    for f in findings:
        if f.severity == "warn" and not f.suppressed:
            counts[baseline_key(f)] = counts.get(baseline_key(f), 0) + 1
    return counts


def apply_baseline(findings, baseline: dict) -> list:
    """Mark warn findings covered by ``baseline`` (a
    ``{key: allowed_count}`` dict) as ``baselined``.  At most the
    recorded count per key is covered, in encounter order — the excess
    (and every unrecorded key) keeps gating, which is exactly the
    ratchet: counts can only shrink."""
    remaining = dict(baseline)
    out = []
    for f in findings:
        if f.severity == "warn" and not f.suppressed:
            key = baseline_key(f)
            if remaining.get(key, 0) > 0:
                remaining[key] -= 1
                f = dataclasses.replace(f, baselined=True)
        out.append(f)
    return out


def save_baseline(path: str, findings, keep: dict | None = None) -> dict:
    """Write the current warn census to ``path`` (plus ``keep``: recorded
    counts of targets this run did not reach); returns it."""
    import json

    counts = {**(keep or {}), **warn_counts(findings)}
    with open(path, "w") as fh:
        json.dump({"comment": "allowed warn findings per rule:path — "
                              "the ratchet ledger; re-record with "
                              "python -m distkeras_tpu_torch.analysis "
                              "--update-baseline and review the diff "
                              "(counts should only go DOWN)",
                   "warn_counts": counts}, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return counts


def load_baseline(path: str) -> dict:
    """Read the warn ledger; a missing/empty file is an empty ledger
    (every warn gates — the pre-baseline behavior)."""
    import json
    import os

    if not os.path.exists(path):
        return {}
    with open(path) as fh:
        return dict(json.load(fh).get("warn_counts", {}))


__all__ = ["Finding", "SEVERITIES", "suppressed_rules",
           "apply_suppressions", "format_findings", "baseline_key",
           "warn_counts", "apply_baseline", "save_baseline",
           "load_baseline"]

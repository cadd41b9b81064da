"""Per-layer readings from the profiler's trace: the idle share and a
kernel's share of its roofline.  Kernels are matched by substrings of
their names, which each metric's own file gives."""

from __future__ import annotations

from harness import reckon


def idle_share(run):
    t = run.trace_summary
    if not t or not t["window_s"]:
        return None
    return 100 * (1 - t["busy_s"] / t["window_s"])


def launches(run, patterns) -> tuple[int, float]:
    """(count, seconds) of the traced device operations whose name holds
    any of ``patterns``."""
    n, us = 0, 0.0
    for name, dur in (run.trace_summary or {}).get("kernels", ()):
        if any(p in name for p in patterns):
            n, us = n + 1, us + dur
    return n, us / 1e6


def roofline_share(run, call_key: str, kernels: dict):
    """Sum over launches of the least time their call's shapes need,
    over the launches' summed device time (None where the cell makes no
    such call or the trace holds no such launch).  ``kernels`` maps an
    attention call kind of ``reckon.attention_call`` to name patterns;
    ``run.counters[call_key]`` gives the call's shapes."""
    call = run.counters.get(call_key)
    if call is None or not run.trace_summary:
        return None
    bound_s = spent_s = 0.0
    for kind, patterns in kernels.items():
        n, s = launches(run, patterns)
        least, _ = reckon.attention_bound_s(
            kind, call["b"], call["l"], call["h"], call["d"],
            call["causal"], call["dtype"])
        bound_s += n * least
        spent_s += s
    if not spent_s:
        return None
    return 100 * bound_s / spent_s


"""The program's spans as readings: a span's host time a decode step.
A reading gives None, and does not raise, where the spans or fields it
reads are missing (a program that predates them).
"""

from __future__ import annotations


def named(spans, *names) -> list[dict]:
    """The span records among ``spans`` with one of ``names``."""
    return [s for s in spans if s.get("name") in names]


def host_ms_a_step(spans, name: str):
    """The total duration of the ``name`` spans over the decode steps
    they ran (their ``n`` field, 1 where absent), in ms."""
    found = named(spans, name)
    if not found:
        return None
    return 1e3 * sum(s["dur"] for s in found) / sum(
        s["fields"].get("n", 1) for s in found)

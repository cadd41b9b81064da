"""Observability: metrics and structured event tracing, for the port.

The port's own copy of ``distkeras_tpu/obs``'s module API::

    from distkeras_tpu_torch import obs

    with obs.session(trace_path="run.jsonl") as sess:
        engine.step()
    print(sess.registry.render_text())          # Prometheus text

**Disabled is the default and costs (almost) nothing.**  Every hook the
serving engines call (``obs.count`` / ``obs.gauge`` / ``obs.observe`` /
``obs.event`` / ``obs.span``) starts with ``if _ACTIVE is None:
return`` — one module-attribute load and an ``is`` check.  No registry
or trace file exists until :func:`enable` runs, and nothing here touches
a device tensor.  One session is active at a time.

The live telemetry plane of the reference (``serve_port=``,
``slo_rules=``; ``slo.py``, ``live.py``, ``report.py``) is not ported yet
(ROADMAP A10).
"""

from __future__ import annotations

import contextlib

from distkeras_tpu_torch.obs.metrics import (DEFAULT_TIME_BUCKETS, Counter,
                                             Gauge, Histogram,
                                             MetricsRegistry,
                                             percentile_from_buckets)
from distkeras_tpu_torch.obs.trace import EventTrace, read_trace

_ACTIVE = None


class ObsSession:
    """One enabled telemetry window: a :class:`MetricsRegistry` plus an
    optional :class:`EventTrace` (``trace_path=None`` = metrics only).
    On close the registry snapshot is appended to the trace as its final
    ``metrics`` record, so the JSONL file alone carries the run."""

    def __init__(self, trace_path: str | None = None,
                 run_id: str | None = None):
        self.registry = MetricsRegistry()
        self.trace = (EventTrace(trace_path, run_id=run_id)
                      if trace_path else None)
        self.run_id = self.trace.run_id if self.trace else run_id

    def close(self) -> None:
        if self.trace is not None:
            self.trace.metrics(self.registry.snapshot())
            self.trace.close()


def enable(trace_path: str | None = None, run_id: str | None = None,
           **live_kw) -> ObsSession:
    """Activate telemetry; returns the session.  Pair with
    :func:`disable`, or use :func:`session`."""
    global _ACTIVE
    if live_kw:
        raise NotImplementedError(
            f"the live telemetry plane ({', '.join(sorted(live_kw))}) is "
            "not ported yet (ROADMAP A10)")
    if _ACTIVE is not None:
        raise RuntimeError(
            "an obs session is already active; telemetry sessions do "
            "not nest (disable() the current one first)")
    _ACTIVE = ObsSession(trace_path=trace_path, run_id=run_id)
    return _ACTIVE


def disable() -> None:
    """Deactivate and close the current session (no-op when none)."""
    global _ACTIVE
    sess, _ACTIVE = _ACTIVE, None
    if sess is not None:
        sess.close()


@contextlib.contextmanager
def session(trace_path: str | None = None, run_id: str | None = None,
            **live_kw):
    """``with obs.session("run.jsonl") as sess: ...``"""
    sess = enable(trace_path=trace_path, run_id=run_id, **live_kw)
    try:
        yield sess
    finally:
        disable()


def active() -> ObsSession | None:
    """The enabled session, or None."""
    return _ACTIVE


# The hooks.  Each binds _ACTIVE to a local ONCE, so a concurrent
# disable() leaves a hook working on the session it sampled.


def count(name: str, n: float = 1.0, **labels) -> None:
    """Increment a counter (created on first use)."""
    sess = _ACTIVE
    if sess is None:
        return
    sess.registry.counter(name).inc(n, **labels)


def gauge(name: str, value: float, **labels) -> None:
    """Set a gauge (created on first use)."""
    sess = _ACTIVE
    if sess is None:
        return
    sess.registry.gauge(name).set(value, **labels)


def observe(name: str, value: float, buckets=None, **labels) -> None:
    """Record one histogram observation (default latency buckets)."""
    sess = _ACTIVE
    if sess is None:
        return
    h = (sess.registry.histogram(name) if buckets is None
         else sess.registry.histogram(name, buckets=buckets))
    h.observe(value, **labels)


def event(name: str, **fields) -> None:
    """Append a point event to the trace (no-op without a trace)."""
    sess = _ACTIVE
    if sess is None or sess.trace is None:
        return
    sess.trace.event(name, **fields)


_NULL = contextlib.nullcontext()


def span(name: str, **fields):
    """Span context manager; a shared null context when disabled."""
    sess = _ACTIVE
    if sess is None or sess.trace is None:
        return _NULL
    return sess.trace.span(name, **fields)


__all__ = ["ObsSession", "MetricsRegistry", "Counter", "Gauge",
           "Histogram", "EventTrace", "read_trace",
           "percentile_from_buckets", "DEFAULT_TIME_BUCKETS",
           "enable", "disable", "session", "active",
           "count", "gauge", "observe", "event", "span"]

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

**No telemetry under a lock.**  :func:`held` acquires a lock and defers
every hook this thread calls until its outermost ``held`` block has
released the lock, then writes them in order: every serving-plane lock
that telemetry runs under (the engines' admission lock, the router's,
the canary's, the publisher's) is taken through it, so a registry or
trace write never runs inside a serving lock.  Events and spans keep
the times they were taken at.

The live telemetry plane: ``serve_port=`` starts a
:class:`~distkeras_tpu_torch.obs.live.TelemetryServer` on the session's
registry (``/metrics``, ``/snapshot.json``, ``/healthz``,
``/trace/tail``, ``/metrics/cluster``, ``/residency``; port 0 picks a
free port, read ``sess.server.port``), and ``slo_rules=`` starts the
rolling-window :class:`~distkeras_tpu_torch.obs.slo.SloEngine` ticker
(also started, rule-less, whenever the server runs).  Both are stdlib
daemon threads that only READ the registry.  ``obs.report`` renders a
finished trace.
"""

from __future__ import annotations

import contextlib
import threading
import time

from distkeras_tpu_torch.obs.metrics import (DEFAULT_TIME_BUCKETS, Counter,
                                             Gauge, Histogram,
                                             MetricsRegistry,
                                             percentile_from_buckets)
from distkeras_tpu_torch.obs.live import HeartbeatHealth, TelemetryServer
from distkeras_tpu_torch.obs.slo import SloEngine, SloRule
from distkeras_tpu_torch.obs.trace import EventTrace, read_trace

_ACTIVE = None
# Per thread: how deep in held() blocks, and the hook calls they defer.
_HELD = threading.local()


class ObsSession:
    """One enabled telemetry window: a :class:`MetricsRegistry` plus an
    optional :class:`EventTrace` (``trace_path=None`` = metrics only).
    On close the registry snapshot is appended to the trace as its final
    ``metrics`` record, so the JSONL file alone carries the run.

    ``serve_port=`` / ``serve_host=`` / ``health=`` / ``residency=``
    start a :class:`TelemetryServer`; ``slo_rules=`` / ``slo_tick_s=`` an
    :class:`SloEngine` (module docstring).  A failed start closes what it
    opened before re-raising."""

    def __init__(self, trace_path: str | None = None,
                 run_id: str | None = None,
                 serve_port: int | None = None,
                 serve_host: str = "127.0.0.1", health=None,
                 slo_rules=None, slo_tick_s: float = 1.0,
                 residency=None):
        self.registry = MetricsRegistry()
        self.trace = (EventTrace(trace_path, run_id=run_id)
                      if trace_path else None)
        self.run_id = self.trace.run_id if self.trace else run_id
        self.slo = None
        self.server = None
        try:
            if slo_rules is not None or serve_port is not None:
                self.slo = SloEngine(
                    self.registry, slo_rules or (), tick_s=slo_tick_s,
                    emit=self.trace.event if self.trace else None
                ).start()
            if serve_port is not None:
                self.server = TelemetryServer(
                    self.registry, port=serve_port, bind=serve_host,
                    trace_path=trace_path, health=health,
                    residency=residency).start()
        except BaseException:
            # enable() re-raises with _ACTIVE still None, so nothing else
            # could stop the ticker or close the trace file.
            self.close()
            raise

    def close(self) -> None:
        if self.server is not None:
            self.server.stop()
        if self.slo is not None:
            self.slo.stop()
        if self.trace is not None:
            self.trace.metrics(self.registry.snapshot())
            self.trace.close()


def enable(trace_path: str | None = None, run_id: str | None = None,
           **live_kw) -> ObsSession:
    """Activate telemetry; returns the session.  Pair with
    :func:`disable`, or use :func:`session`.  ``live_kw`` opts into the
    live telemetry plane (see :class:`ObsSession`)."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError(
            "an obs session is already active; telemetry sessions do "
            "not nest (disable() the current one first)")
    _ACTIVE = ObsSession(trace_path=trace_path, run_id=run_id, **live_kw)
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


@contextlib.contextmanager
def held(lock):
    """``with obs.held(lock): ...`` holds ``lock`` and defers this
    thread's :func:`count` / :func:`gauge` / :func:`observe` /
    :func:`event` / :func:`span` records until the outermost ``held``
    block has released it, then writes them in order (also when the
    block raises).  An event or span is timed when it happens, not when
    it is written."""
    outer = not getattr(_HELD, "depth", 0)
    if outer:
        _HELD.calls = []
    try:
        with lock:
            _HELD.depth = getattr(_HELD, "depth", 0) + 1
            try:
                yield
            finally:
                _HELD.depth -= 1
    finally:
        if outer:
            calls, _HELD.calls = _HELD.calls, []
            for fn, args, kw in calls:
                fn(*args, **kw)


def _deferred(fn, args, kw) -> bool:
    """Queue a hook call made inside :func:`held`; True if queued."""
    if getattr(_HELD, "depth", 0):
        _HELD.calls.append((fn, args, kw))
        return True
    return False


# The hooks.  Each binds _ACTIVE to a local ONCE, so a concurrent
# disable() leaves a hook working on the session it sampled.


def count(name: str, n: float = 1.0, **labels) -> None:
    """Increment a counter (created on first use)."""
    sess = _ACTIVE
    if sess is None or _deferred(count, (name, n), labels):
        return
    sess.registry.counter(name).inc(n, **labels)


def gauge(name: str, value: float, **labels) -> None:
    """Set a gauge (created on first use)."""
    sess = _ACTIVE
    if sess is None or _deferred(gauge, (name, value), labels):
        return
    sess.registry.gauge(name).set(value, **labels)


def observe(name: str, value: float, buckets=None, **labels) -> None:
    """Record one histogram observation (default latency buckets)."""
    sess = _ACTIVE
    if sess is None or _deferred(observe, (name, value, buckets), labels):
        return
    h = (sess.registry.histogram(name) if buckets is None
         else sess.registry.histogram(name, buckets=buckets))
    h.observe(value, **labels)


def event(name: str, **fields) -> None:
    """Append a point event to the trace (no-op without a trace)."""
    sess = _ACTIVE
    if sess is None or sess.trace is None:
        return
    tr = sess.trace
    if not _deferred(tr.write_event, (name, time.perf_counter(),
                                      tr.current_span(), fields), {}):
        tr.event(name, **fields)


_NULL = contextlib.nullcontext()


@contextlib.contextmanager
def _held_span(trace, name: str, fields: dict):
    """A span inside :func:`held`: timed around the block, its record
    written once the lock is released."""
    sp = trace.open_span(name, fields)
    try:
        yield sp
    finally:
        _HELD.calls.append((trace._write, (trace.close_span(sp),), {}))


def span(name: str, **fields):
    """Span context manager; a shared null context when disabled."""
    sess = _ACTIVE
    if sess is None or sess.trace is None:
        return _NULL
    if getattr(_HELD, "depth", 0):
        return _held_span(sess.trace, name, fields)
    return sess.trace.span(name, **fields)


__all__ = ["ObsSession", "MetricsRegistry", "Counter", "Gauge",
           "Histogram", "EventTrace", "read_trace",
           "percentile_from_buckets", "DEFAULT_TIME_BUCKETS",
           "SloRule", "SloEngine", "TelemetryServer", "HeartbeatHealth",
           "enable", "disable", "session", "active",
           "count", "gauge", "observe", "event", "span"]

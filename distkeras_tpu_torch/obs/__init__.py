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

**Spans on the device's clock.**  ``obs.device_span(name)`` is a span
that also records a CUDA event pair on the current stream; the record's
``dev_dur`` is the device's seconds between them, read when the trace
writes the record (None where CUDA is not in play).  While a
``torch.profiler`` capture runs, every span also enters
``record_function(name)`` at its real start and end, so captures with
host activity show the program's regions by name.  The trace's ``meta``
record carries a ``clock`` anchor (``perf_counter_ns`` beside
``time_ns``); :func:`span_unix_ns` maps a span onto the Unix-ns clock
the profiler stamps its events with, which places spans on a
device-only capture too.  The trace keeps its records in memory and
writes them in batches (every ``obs.trace.BATCH`` records, before the
live server reads its tail, at close, and at interpreter exit), so a
hook on the host that paces the card costs a list append, not a file
write.

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
import sys
import threading
import time

from distkeras_tpu_torch.obs.metrics import (DEFAULT_TIME_BUCKETS, Counter,
                                             Gauge, Histogram,
                                             MetricsRegistry,
                                             percentile_from_buckets)
from distkeras_tpu_torch.obs.live import HeartbeatHealth, TelemetryServer
from distkeras_tpu_torch.obs.slo import SloEngine, SloRule
from distkeras_tpu_torch.obs.trace import (DeviceTimer, EventTrace,
                                           read_trace, span_unix_ns)

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


def _annotation(name: str):
    """``torch.profiler.record_function(name)``, entered, while a
    profiler capture runs; None otherwise (and without torch loaded)."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is None or not prof._is_profiler_enabled:
        return None
    mark = prof.record_function(name)
    mark.__enter__()
    return mark


def _device_timer():
    """A started :class:`~distkeras_tpu_torch.obs.trace.DeviceTimer`
    where CUDA is in play (torch has initialised it in this process);
    None otherwise."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    return DeviceTimer(torch.cuda)


@contextlib.contextmanager
def _span(trace, name: str, fields: dict, timed: bool):
    """The span's record, timed around the block.  A running profiler
    capture sees it as a ``record_function`` region entered and left at
    the same moments; inside :func:`held` the record is written once the
    lock is released."""
    sp = trace.open_span(name, fields)
    mark = _annotation(name)
    timer = _device_timer() if timed else None
    try:
        yield sp
    finally:
        if timer is not None:
            timer.end.record()
        if mark is not None:
            mark.__exit__(None, None, None)
        rec = trace.close_span(sp)
        if timed:
            rec["dev_dur"] = timer
        if getattr(_HELD, "depth", 0):
            _HELD.calls.append((trace._write, (rec,), {}))
        else:
            trace._write(rec)


def span(name: str, **fields):
    """Span context manager; a shared null context when disabled."""
    sess = _ACTIVE
    if sess is None or sess.trace is None:
        return _NULL
    return _span(sess.trace, name, fields, False)


def device_span(name: str, **fields):
    """:func:`span` whose record also carries ``dev_dur``: the seconds
    the current CUDA stream took from the span's start to its end, by a
    pair of CUDA events read when the trace writes the record (None
    where CUDA is not in play).  A shared null context when disabled."""
    sess = _ACTIVE
    if sess is None or sess.trace is None:
        return _NULL
    return _span(sess.trace, name, fields, True)


# The reference's surface; ``device_span`` and ``span_unix_ns`` are the
# port's own.
__all__ = ["ObsSession", "MetricsRegistry", "Counter", "Gauge",
           "Histogram", "EventTrace", "read_trace",
           "percentile_from_buckets", "DEFAULT_TIME_BUCKETS",
           "SloRule", "SloEngine", "TelemetryServer", "HeartbeatHealth",
           "enable", "disable", "session", "active",
           "count", "gauge", "observe", "event", "span"]

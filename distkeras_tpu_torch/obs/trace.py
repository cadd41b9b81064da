"""Structured event trace: nestable spans + point events as JSONL.

One run = one JSONL file.  Every record carries a monotonic timestamp
``t`` (``time.perf_counter`` — durations and ordering are exact within
the process), the run id, and the host (``torch.distributed`` rank when
a group is up) / OS pid, so a multi-process run's files can be merged
and a session reconstructed offline.  The port's own copy of
``distkeras_tpu/obs/trace.py``.

Record kinds:

``meta``   — first line: run id, host/pid, unix wall time anchor (maps
             monotonic ``t`` to wall clock), platform, and ``clock``:
             ``perf_counter_ns`` and ``time_ns`` read back to back (the
             closest of a few pairs), which :func:`span_unix_ns` uses to
             put a span on the Unix-ns clock ``torch.profiler`` stamps
             its events with.
``event``  — a point in time: ``{"kind": "event", "name", "t",
             "fields": {...}}`` (chaos faults, supervisor attempts,
             admission rejects).
``span``   — a closed interval, written at END: ``{"kind": "span",
             "name", "t0", "dur", "id", "parent", "depth",
             "fields"}``.  Nesting is tracked per thread; ``parent``
             is the enclosing span's id (None at top level), so the
             tree reconstructs without begin/end pairing.  A device
             span (``obs.device_span``) adds ``dev_dur``: seconds
             between its two CUDA events, read when the record is
             written (None without CUDA).
``metrics``— a full registry snapshot (the obs session appends one on
             close), so a trace file is self-contained for reports.

The ``meta`` record is written when the trace opens; the others are
kept in memory and written in batches: at :meth:`EventTrace.flush` (the
live server calls it before it reads the file's tail, and it runs at
interpreter exit while the trace is open), every :data:`BATCH` records,
and at close.  A batch is serialised when it is written, so a field's
value is read then: hooks pass values, not objects they change later.
A run killed outright leaves the batches written before it, a parseable
prefix.  Thread safety: one lock around the buffer and the file; span
stacks are thread-local.
"""

from __future__ import annotations

import atexit
import contextlib
import itertools
import json
import os
import threading
import time
import uuid

from distkeras_tpu_torch.utils.locks import TracedLock

#: Records kept before the buffer is written out.
BATCH = 4096


def _host_index() -> int:
    """The ``torch.distributed`` rank when a process group is up; 0
    otherwise.  Never initializes anything."""
    import sys

    dist = sys.modules.get("torch.distributed")
    try:
        if dist is not None and dist.is_available() and dist.is_initialized():
            return dist.get_rank()
    except Exception:
        pass
    return 0


def clock_anchor() -> dict:
    """``perf_counter_ns`` and ``time_ns`` read back to back: of five
    tries, the pair whose two ``perf_counter_ns`` reads around
    ``time_ns`` lie closest (``gap_ns`` apart; ``perf_ns`` is their
    middle)."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        unix = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best["gap_ns"]:
            best = {"perf_ns": (a + b) // 2, "unix_ns": unix,
                    "gap_ns": b - a}
    return best


def span_unix_ns(rec: dict, clock: dict) -> tuple[int, int]:
    """A span record's ``(start, end)`` on the Unix-ns clock, through a
    trace's ``clock`` anchor (its ``meta`` record's): the clock
    ``torch.profiler`` stamps events with, whose ``time_range`` is in
    microseconds after ``kineto_results.trace_start_ns()``."""
    start = clock["unix_ns"] + round(rec["t0"] * 1e9) - clock["perf_ns"]
    return start, start + round(rec["dur"] * 1e9)


class DeviceTimer:
    """A device span's ``dev_dur`` until its record is written: two
    ``torch.cuda.Event(enable_timing=True)`` recorded on the current
    stream, the first at the span's start, the second (``end``) at its
    close."""

    __slots__ = ("start", "end")

    def __init__(self, cuda):
        self.start = cuda.Event(enable_timing=True)
        self.end = cuda.Event(enable_timing=True)
        self.start.record()

    def done(self) -> bool:
        """Whether the card has passed the span's end (never waits)."""
        return self.end.query()

    def seconds(self) -> float:
        """The device's seconds between the two events; waits for the
        second."""
        self.end.synchronize()
        return self.start.elapsed_time(self.end) / 1e3


def _jsonable(obj):
    """``json.dumps`` fallback: a :class:`DeviceTimer` is written as its
    seconds, anything else as its ``str``."""
    return obj.seconds() if isinstance(obj, DeviceTimer) else str(obj)


class Span:
    """Handle yielded by :meth:`EventTrace.span` — carries the ids and
    accepts late fields (``span.fields["x"] = ...`` before exit)."""

    __slots__ = ("name", "id", "parent", "depth", "t0", "fields")

    def __init__(self, name, id, parent, depth, t0, fields):
        self.name = name
        self.id = id
        self.parent = parent
        self.depth = depth
        self.t0 = t0
        self.fields = fields


class EventTrace:
    """JSONL trace writer (see module docstring for the record model).

    ``path``: output file (parent dirs created).  ``run_id`` defaults
    to a fresh ``uuid4`` hex prefix.  Records are buffered and written
    in batches (:meth:`flush`); close (or use as a context manager) to
    write the rest.
    """

    def __init__(self, path: str, run_id: str | None = None):
        self.path = os.path.abspath(path)
        self.run_id = run_id or uuid.uuid4().hex[:12]
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        # "w", not "a": one run = one file (the module contract).
        # Reusing a path across runs must not blend two runs' records
        # — their monotonic clocks have different epochs, so a merged
        # file would report meaningless relative times.
        self._f = open(self.path, "w", encoding="utf-8")
        # Leaf lock: guards the buffer and the file handle; span stacks
        # are thread-local, not locked.
        self._lock = TracedLock("obs.trace")
        self._buf: list[dict] = []
        self._tls = threading.local()
        # Span ids; ``next`` on a count is atomic, so no lock is taken
        # to open a span.
        self._ids = itertools.count(1)
        self.host = _host_index()
        self.pid = os.getpid()
        self.clock = clock_anchor()
        self._f.write(json.dumps({"kind": "meta", "run": self.run_id,
                                  "host": self.host, "pid": self.pid,
                                  "t": time.perf_counter(),
                                  "time_unix": time.time(),
                                  "clock": self.clock},
                                 default=str) + "\n")
        self._f.flush()
        # An exit that skips close() (an escaped exception, a session
        # never disabled) still writes the buffer.
        atexit.register(self.flush)

    # ------------------------------------------------------------ write

    def _write(self, rec: dict) -> None:
        with self._lock:
            if self._f.closed:
                return
            self._buf.append(rec)
            if len(self._buf) >= BATCH:
                self._write_out(self._ready())

    def _ready(self) -> int:
        """How many leading buffered records can be written without
        waiting: those before the first device span whose end the card
        has not reached yet."""
        for i, rec in enumerate(self._buf):
            timer = rec.get("dev_dur")
            if isinstance(timer, DeviceTimer) and not timer.done():
                return i
        return len(self._buf)

    def _write_out(self, n: int) -> None:
        """Write the first ``n`` buffered records (the lock held)."""
        if n:
            self._f.write("".join(json.dumps(r, default=_jsonable) + "\n"
                                  for r in self._buf[:n]))
            del self._buf[:n]
        self._f.flush()

    def flush(self) -> None:
        """Write the buffered records.  A device span's end event is
        waited for here, outside the lock, and never when the span
        closes or a full batch is written."""
        with self._lock:
            timers = [r["dev_dur"] for r in self._buf
                      if isinstance(r.get("dev_dur"), DeviceTimer)]
        for timer in timers:
            timer.end.synchronize()
        with self._lock:
            if not self._f.closed:
                self._write_out(len(self._buf))

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    # -------------------------------------------------------------- API

    def current_span(self) -> int | None:
        """The id of this thread's innermost open span (None at top
        level)."""
        st = self._stack()
        return st[-1].id if st else None

    def event(self, name: str, **fields) -> None:
        """Record a point event now."""
        self.write_event(name, time.perf_counter(), self.current_span(),
                         fields)

    def write_event(self, name: str, t: float, span: int | None,
                    fields: dict) -> None:
        """Write a point event stamped ``t`` inside span ``span`` (an
        event taken earlier and written later keeps its own time)."""
        self._write({"kind": "event", "name": name, "t": t,
                     "span": span, "fields": fields})

    def open_span(self, name: str, fields: dict) -> Span:
        """Start a span on this thread's stack; :meth:`close_span` ends
        it.  Neither writes: :meth:`span` writes the record they make."""
        st = self._stack()
        sp = Span(name=name, id=next(self._ids),
                  parent=st[-1].id if st else None, depth=len(st),
                  t0=time.perf_counter(), fields=fields)
        st.append(sp)
        return sp

    def close_span(self, sp: Span) -> dict:
        """Pop ``sp`` (this thread's innermost span); its record."""
        self._stack().pop()
        return {"kind": "span", "name": sp.name, "t0": sp.t0,
                "dur": time.perf_counter() - sp.t0, "id": sp.id,
                "parent": sp.parent, "depth": sp.depth,
                "fields": sp.fields}

    @contextlib.contextmanager
    def span(self, name: str, **fields):
        """Record a closed interval around the block; nests per
        thread.  The record is written at exit (one line per span)."""
        sp = self.open_span(name, fields)
        try:
            yield sp
        finally:
            self._write(self.close_span(sp))

    def metrics(self, snapshot: dict) -> None:
        """Append a full metrics-registry snapshot record."""
        self._write({"kind": "metrics", "t": time.perf_counter(),
                     "data": snapshot})

    def close(self) -> None:
        self.flush()
        with self._lock:
            if not self._f.closed:
                self._write_out(len(self._buf))
                self._f.close()
        atexit.unregister(self.flush)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def tail_trace(path: str, n: int, kinds=None) -> list[dict]:
    """The last ``n`` records of a trace file, with the same
    torn-final-line tolerance as :func:`read_trace` — safe against a
    LIVE writer (the telemetry server's ``/trace/tail`` calls this
    while the session is still appending; a half-flushed last line is
    dropped, never an error).  Reads a bounded window from the end of
    the file, not the whole trace.  ``kinds``: keep only these record
    kinds (e.g. ``("event",)``)."""
    if n <= 0:
        return []
    # Generous per-record bound: read enough tail bytes for n records
    # plus one potentially-torn leading line, growing if the window
    # started mid-file and yielded too few parseable lines.
    window = max(n * 512, 8192)
    records: list[dict] = []
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        while True:
            start = max(size - window, 0)
            f.seek(start)
            chunk = f.read(size - start).decode("utf-8", "replace")
            lines = chunk.splitlines()
            if start > 0 and lines:
                lines = lines[1:]  # first line may start mid-record
            records = []
            for line in lines:
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn live write (tail) — lenient here
                if kinds is None or rec.get("kind") in kinds:
                    records.append(rec)
            if len(records) >= n or start == 0:
                break
            window *= 4
    return records[-n:]


def read_trace(path: str) -> list[dict]:
    """Parse one JSONL trace file back into records (strict: a
    truncated final line — crashed writer — is tolerated, anything
    else malformed raises)."""
    records = []
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            records.append(json.loads(line))
        except ValueError:
            if i == len(lines) - 1:
                break  # torn final write from a crashed run
            raise
    return records


__all__ = ["BATCH", "DeviceTimer", "EventTrace", "Span", "clock_anchor",
           "read_trace", "span_unix_ns", "tail_trace"]

"""Structured event trace: nestable spans + point events as JSONL.

One run = one append-only JSONL file.  Every record carries a
monotonic timestamp ``t`` (``time.perf_counter`` — durations and
ordering are exact within the process), the run id, and the host
(``torch.distributed`` rank when a group is up) / OS pid, so a
multi-process run's files can be merged and a session reconstructed
offline.  The port's own copy of ``distkeras_tpu/obs/trace.py``.

Record kinds:

``meta``   — first line: run id, host/pid, unix wall time anchor (maps
             monotonic ``t`` to wall clock), platform.
``event``  — a point in time: ``{"kind": "event", "name", "t",
             "fields": {...}}`` (chaos faults, supervisor attempts,
             admission rejects).
``span``   — a closed interval, written at END: ``{"kind": "span",
             "name", "t0", "dur", "id", "parent", "depth",
             "fields"}``.  Nesting is tracked per thread; ``parent``
             is the enclosing span's id (None at top level), so the
             tree reconstructs without begin/end pairing.
``metrics``— a full registry snapshot (the obs session appends one on
             close), so a trace file is self-contained for reports.

Thread safety: one lock around the file write; span stacks are
thread-local.  Writes are ``json.dumps`` + one ``write`` per record —
cheap enough for per-round/per-request cadence (the hot *inner* loops
record through the metrics registry, not the trace).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
import uuid

from distkeras_tpu_torch.utils.locks import TracedLock


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
    to a fresh ``uuid4`` hex prefix.  Close (or use as a context
    manager) to flush; the file is line-buffered in between so a
    crashed run still leaves a parseable prefix.
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
        self._f = open(self.path, "w", buffering=1, encoding="utf-8")
        # Leaf lock: guards the file handle only (one write per
        # record); span stacks are thread-local, not locked.
        self._lock = TracedLock("obs.trace")
        self._tls = threading.local()
        # Span ids; ``next`` on a count is atomic, so no lock is taken
        # to open a span.
        self._ids = itertools.count(1)
        self.host = _host_index()
        self.pid = os.getpid()
        self._write({"kind": "meta", "run": self.run_id,
                     "host": self.host, "pid": self.pid,
                     "t": time.perf_counter(),
                     "time_unix": time.time()})

    # ------------------------------------------------------------ write

    def _write(self, rec: dict) -> None:
        line = json.dumps(rec, default=str)
        with self._lock:
            if self._f.closed:
                return
            self._f.write(line + "\n")

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
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()

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


__all__ = ["EventTrace", "Span", "read_trace", "tail_trace"]

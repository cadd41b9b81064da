"""Instrumented locks and the runtime lock-order sanitizer.

The port's own copy of ``distkeras_tpu/utils/locks.py``.  Every lock of
the serving engines, the prefix pool and the obs registry/trace is built
through :func:`TracedLock` / :func:`TracedRLock`.  With the sanitizer
off (the default) the factories return the raw stdlib lock.  With it on
(``DKT_LOCK_SANITIZER=1`` in the environment, or
:func:`enable_sanitizer`) they return instrumented locks that report:

- **lock-order cycles**: acquiring B while holding A records the edge
  A -> B in one graph; an acquisition that would close a cycle is a
  potential deadlock and is reported with both acquisition stacks (only
  unbounded blocking acquires take part);
- **same-thread double-acquire** of a non-reentrant lock (always
  raised: proceeding would hang);
- **callbacks fired under a lock**: :func:`assert_unlocked` at a fire
  site reports the locks the calling thread still holds.

Unlike the reference, no lock records held-time or wait-time telemetry:
the reference's hook observes into the obs registry while it holds the
sanitizer's state, the lock-order cycle behind a deadlock of its
concurrency stress test.  No lock of the port calls ``obs`` while it is
held.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import sys
import threading

_STACK_LIMIT = 14

# Global, monotone lock ids: survive enable/disable cycles so a stale
# lock from a previous sanitizer window can never alias a fresh one
# (id() reuse would fabricate phantom graph edges).
_UIDS = itertools.count(1)


class LockOrderViolation(RuntimeError):
    """A thread-safety discipline violation the sanitizer detected.

    ``kind`` is one of ``"cycle"`` (lock-order inversion — potential
    deadlock), ``"double-acquire"`` (same thread re-acquiring a
    non-reentrant lock — certain deadlock), or ``"held-in-callback"``
    (a registered callback fired while the calling thread holds a
    sanitized lock)."""

    def __init__(self, kind: str, message: str):
        super().__init__(message)
        self.kind = kind


@dataclasses.dataclass(frozen=True)
class Violation:
    """One recorded finding: the kind, a one-line message, and the
    acquisition stacks involved — ``stacks`` is a tuple of
    ``(label, (frame_line, ...))`` pairs."""

    kind: str
    message: str
    thread: str
    stacks: tuple

    def format(self) -> str:
        lines = [f"[{self.kind}] {self.message} (thread {self.thread})"]
        for label, frames in self.stacks:
            lines.append(f"  {label}:")
            lines.extend(f"    {f}" for f in frames)
        return "\n".join(lines)


def _stack(skip: int = 2) -> tuple:
    """Cheap acquisition stack: a frame walk, newest first, own-module
    frames skipped via ``skip`` (``traceback`` costs 10x as much and
    this runs on every sanitized acquire)."""
    try:
        f = sys._getframe(skip)
    except ValueError:  # pragma: no cover — shallow stack
        return ()
    out = []
    while f is not None and len(out) < _STACK_LIMIT:
        code = f.f_code
        out.append(f"{code.co_filename}:{f.f_lineno} in {code.co_name}")
        f = f.f_back
    return tuple(out)


class _Hold:
    """One entry of a thread's held-lock stack."""

    __slots__ = ("lock", "count", "stack")

    def __init__(self, lock, stack):
        self.lock = lock
        self.count = 1
        self.stack = stack


class _State:
    """The sanitizer: the global lock-order graph, the violation
    ledger, and the per-thread held stacks."""

    def __init__(self, mode: str):
        if mode not in ("raise", "warn"):
            raise ValueError(f"mode must be 'raise' or 'warn', got {mode!r}")
        self.mode = mode
        # A raw lock: the graph mutex must be invisible to itself.
        self._mu = threading.Lock()
        self.adj: dict[int, set[int]] = {}        # uid -> successors
        # (a, b) -> (a_name, b_name, a_hold_stack, b_acquire_stack),
        # recorded at first observation of "b acquired while a held".
        self.edges: dict[tuple, tuple] = {}
        self.seen_locks: set[int] = set()
        self.violations: list[Violation] = []
        self._tls = threading.local()

    # ------------------------------------------------------ per-thread

    def holds(self) -> list:
        h = getattr(self._tls, "holds", None)
        if h is None:
            h = self._tls.holds = []
        return h

    # ----------------------------------------------------------- graph

    def _reaches(self, src: int, dst: int) -> bool:
        """DFS: is ``dst`` reachable from ``src`` in the order graph?"""
        stack, seen = [src], set()
        while stack:
            n = stack.pop()
            if n == dst:
                return True
            if n in seen:
                continue
            seen.add(n)
            stack.extend(self.adj.get(n, ()))
        return False

    def record(self, kind: str, message: str, stacks: tuple) -> "Violation":
        v = Violation(kind=kind, message=message,
                      thread=threading.current_thread().name,
                      stacks=stacks)
        with self._mu:
            self.violations.append(v)
        return v

    def report(self, kind: str, message: str, stacks: tuple) -> None:
        v = self.record(kind, message, stacks)
        if self.mode == "raise" or kind == "double-acquire":
            raise LockOrderViolation(kind, v.format())


_SAN: _State | None = None


class _TracedLockBase:
    """The instrumented lock (only ever constructed while the
    sanitizer is enabled — the factories return raw stdlib locks
    otherwise).  Drop-in for ``threading.Lock``/``RLock``: acquire/
    release/locked/context manager."""

    _reentrant = False

    def __init__(self, name: str | None = None):
        self._inner = (threading.RLock() if self._reentrant
                       else threading.Lock())
        self.name = name or ("rlock" if self._reentrant else "lock")
        self._uid = next(_UIDS)

    def __repr__(self):
        kind = "TracedRLock" if self._reentrant else "TracedLock"
        return f"<{kind} {self.name!r} uid={self._uid}>"

    # ------------------------------------------------------- acquire

    def acquire(self, blocking: bool = True, timeout: float = -1):
        st = _SAN
        if st is None:
            return self._inner.acquire(blocking, timeout)
        holds = st.holds()
        mine = next((h for h in holds if h.lock is self), None)
        if mine is not None and not self._reentrant:
            # Proceeding would block this thread forever: report AND
            # raise (even in warn mode), instead of deadlocking.
            st.report(
                "double-acquire",
                f"non-reentrant lock {self.name!r} re-acquired by its "
                "owning thread — this would deadlock",
                (("first acquisition", mine.stack),
                 ("re-acquisition", _stack())))
        # Only an UNBOUNDED blocking acquire can deadlock, so only it
        # participates in the order graph: a try-acquire / bounded
        # wait is the standard deadlock-AVOIDANCE idiom — raising on
        # its "inverted" order, or recording an edge for an attempt
        # that may never hold both locks, would fabricate violations
        # for code that is correct by construction.
        unbounded = blocking and timeout == -1
        if mine is None and unbounded:
            self._check_order(st, holds)
        if unbounded:
            got = self._inner.acquire()
        else:
            got = self._inner.acquire(blocking, timeout)
        if not got:
            return False
        if mine is not None:
            mine.count += 1
            return True
        st.seen_locks.add(self._uid)  # set.add is atomic under the GIL
        holds.append(_Hold(self, _stack()))
        # Edges are committed only AFTER the acquire succeeded (and
        # only for unbounded acquires, per the above).
        if unbounded:
            self._commit_edges(st, holds)
        return True

    def _check_order(self, st: _State, holds: list) -> None:
        """Pre-acquire cycle check against held -> self edges (read
        only — nothing is recorded until the acquire SUCCEEDS, see
        :meth:`_commit_edges`): an acquisition that would close a
        cycle is a lock-order inversion (potential deadlock),
        reported before blocking on the inner lock."""
        if not holds:
            return
        me = self._uid
        bad = None
        with st._mu:
            for h in holds:
                a = h.lock._uid
                if (a, me) in st.edges:
                    continue
                if self._reentrant and h.lock is self:
                    continue
                if st._reaches(me, a):
                    prior = st.edges.get((me, a))
                    stacks = [(f"now: {h.lock.name!r} held", h.stack),
                              (f"now: acquiring {self.name!r}",
                               _stack(skip=3))]
                    if prior is not None:
                        stacks.append((
                            f"recorded: {prior[1]!r} acquired while "
                            f"{prior[0]!r} held", prior[3]))
                    # Out of st._mu before the (possible) raise.
                    bad = (h.lock.name, tuple(stacks))
                    break
        if bad is not None:
            st.report(
                "cycle",
                f"lock-order inversion: acquiring {self.name!r} while "
                f"holding {bad[0]!r}, but the opposite order was "
                "already observed — potential deadlock",
                bad[1])

    def _commit_edges(self, st: _State, holds: list) -> None:
        """Record held -> self edges now that the lock is actually
        held.  Re-checks reachability under the mutex: a racing
        thread may have committed the opposite edge between our
        pre-check and now — recording ours anyway would close the
        cycle silently (the ``(a, me) in edges`` fast path would then
        skip every later check on the pair), so that race reports
        here instead."""
        if len(holds) < 2:
            return
        me = self._uid
        mine = holds[-1]
        bad = None
        with st._mu:
            for h in holds[:-1]:
                a = h.lock._uid
                st.seen_locks.add(a)
                if (a, me) in st.edges:
                    continue
                if self._reentrant and h.lock is self:
                    continue
                if st._reaches(me, a):
                    if bad is None:
                        bad = (h.lock.name,
                               ((f"now: {h.lock.name!r} held", h.stack),
                                (f"now: holding {self.name!r}",
                                 mine.stack)))
                    continue
                st.edges[(a, me)] = (h.lock.name, self.name,
                                     h.stack, mine.stack)
                st.adj.setdefault(a, set()).add(me)
        if bad is not None:
            # Record-only: the lock is already held here, so raising
            # would leak the hold out of __enter__.  The ledger (and
            # conftest's violation gate) still surfaces it.
            st.record(
                "cycle",
                f"lock-order inversion: {self.name!r} acquired while "
                f"holding {bad[0]!r}, but the opposite order was "
                "already observed — potential deadlock",
                bad[1])

    # ------------------------------------------------------- release

    def release(self):
        st = _SAN
        if st is None:
            self._inner.release()
            return
        holds = st.holds()
        mine = next((h for h in reversed(holds) if h.lock is self), None)
        if mine is not None and mine.count > 1:
            mine.count -= 1
            self._inner.release()
            return
        if mine is not None:
            holds.remove(mine)
        self._inner.release()

    # --------------------------------------------------------- extras

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


class _TracedLockImpl(_TracedLockBase):
    _reentrant = False


class _TracedRLockImpl(_TracedLockBase):
    _reentrant = True


def TracedLock(name: str | None = None):  # noqa: N802 — factory, like threading.Lock
    """A mutex for the threaded core modules.  Sanitizer off: returns
    a RAW ``threading.Lock`` (the fast path is exactly the stdlib
    lock — zero wrapper overhead).  Sanitizer on: an instrumented
    lock participating in order/double-acquire checking, labeled
    ``name`` in reports and histograms."""
    if _SAN is None:
        return threading.Lock()
    return _TracedLockImpl(name)


def TracedRLock(name: str | None = None):  # noqa: N802 — factory
    """Reentrant variant of :func:`TracedLock` (same-thread nesting is
    legal and recorded once per outermost hold)."""
    if _SAN is None:
        return threading.RLock()
    return _TracedRLockImpl(name)


def assert_unlocked(site: str) -> None:
    """Guard for subscriber/callback fire sites: the calling thread
    must hold NO sanitized lock — a callback invoked under a lock can
    re-enter the subsystem and deadlock (the PR-8 ``slo.breach``
    subscriber shape).  No-op when the sanitizer is off."""
    st = _SAN
    if st is None:
        return
    holds = st.holds()
    if not holds:
        return
    names = [h.lock.name for h in holds]
    st.report(
        "held-in-callback",
        f"{site}: callback fired while holding lock(s) {names} — "
        "release before invoking user code",
        tuple((f"{h.lock.name!r} acquired", h.stack) for h in holds))


# ------------------------------------------------------------- control


def enable_sanitizer(mode: str = "raise") -> None:
    """Turn the sanitizer on (idempotent — an already-running window
    keeps its graph).  Locks constructed from now on are instrumented;
    locks that already exist stay raw."""
    global _SAN
    if _SAN is None:
        _SAN = _State(mode)


def disable_sanitizer() -> None:
    """Turn the sanitizer off and drop its graph/ledger.  Locks it
    instrumented keep working (they just stop checking)."""
    global _SAN
    _SAN = None


def sanitizer_enabled() -> bool:
    return _SAN is not None


def violations() -> list:
    """Snapshot of every recorded :class:`Violation` this window."""
    st = _SAN
    if st is None:
        return []
    with st._mu:
        return list(st.violations)


def violation_count() -> int:
    st = _SAN
    return len(st.violations) if st is not None else 0


def clear_violations() -> None:
    st = _SAN
    if st is not None:
        with st._mu:
            st.violations.clear()


def lock_report() -> dict:
    """Small JSON-able summary for timelines (the chaos ladder emits
    one per host): instrumented-lock count, order-graph edge count,
    violation count."""
    st = _SAN
    if st is None:
        return {"enabled": False, "locks": 0, "edges": 0,
                "violations": 0}
    with st._mu:
        return {"enabled": True, "locks": len(st.seen_locks),
                "edges": len(st.edges),
                "violations": len(st.violations)}


_env = os.environ.get("DKT_LOCK_SANITIZER", "").strip().lower()
if _env in ("1", "true", "on", "raise"):
    enable_sanitizer("raise")
elif _env == "warn":
    enable_sanitizer("warn")
del _env


__all__ = ["TracedLock", "TracedRLock", "LockOrderViolation",
           "Violation", "assert_unlocked", "enable_sanitizer",
           "disable_sanitizer", "sanitizer_enabled", "violations",
           "violation_count", "clear_violations", "lock_report"]

"""A time limit on each test that carries ``@pytest.mark.time_limit(
seconds)``: a plugin, which the ``conftest.py`` at the root of the repo
loads with a mark of 120 s on every test under ``tests/`` that has
none (load it alone with ``pytest -p time_limit``, ``tests/`` on
``PYTHONPATH``).

A test's setup, call and teardown together run under its limit.  Two
stages end a test that overruns it:

1. At the limit, SIGALRM on the main thread: the handler dumps every
   thread's stack to stderr, ends the processes the test started,
   renames the threads it left running ``orphan:<name>``, and raises
   ``pytest.fail``.  ``Failed`` is a ``BaseException``, so the broad
   ``except Exception`` blocks of the code under test do not swallow
   it; the test fails under its own id and the run goes on.  The
   renamed threads no longer carry the ``dkt-`` prefix that the suite's
   thread-leak gate looks for, and a lock-sanitizer finding of one
   later names it as an orphan.
2. For a test that never returns to Python (a lock taken in C, a
   compile, a rendezvous), faulthandler's watchdog dumps the stacks and
   ends the process at the limit plus 60 s (plus twice the limit, where
   that is less).  Under xdist the controller reports the test as
   crashed, ends the processes the dead worker left, and starts a new
   worker.  A run without xdist ends there.
"""

import faulthandler
import os
import signal
import sys
import threading
import time

import psutil
import pytest

GRACE_S = 60.0
ORPHAN = "orphan:"

_CLOCK = pytest.StashKey()
# The stderr the run started with, which the second stage writes to:
# fd capture points fd 2 at a temporary file during a test, and a
# process that dies loses it.
_STDERR = None


def pytest_configure(config):
    global _STDERR
    if _STDERR is None:   # capture is suspended here: fd 2 is the real one
        _STDERR = os.dup(2)


def end_processes(procs, wait=1.0):
    """SIGTERM ``procs``, wait up to ``wait`` s, SIGKILL what is left."""
    for p in procs:
        try:
            p.terminate()
        except psutil.Error:
            pass
    _, alive = psutil.wait_procs(procs, timeout=wait)
    for p in alive:
        try:
            p.kill()
        except psutil.Error:
            pass
    psutil.wait_procs(alive, timeout=wait)


def _descendants():
    """This process's descendants, keyed by (pid, start time)."""
    out = {}
    for p in psutil.Process().children(recursive=True):
        try:
            out[(p.pid, p.create_time())] = p
        except psutil.Error:
            pass
    return out


class _Clock:
    """One test's limit, and what the test found running when it began."""

    def __init__(self, item):
        self.item = item
        self.limit = float(item.get_closest_marker("time_limit").args[0])
        self.deadline = time.monotonic() + self.limit
        self.hard_deadline = self.deadline + min(GRACE_S, 2 * self.limit)
        self.threads = set(threading.enumerate())
        self.procs = set(_descendants())
        self.fired = False

    def on_alarm(self, signum, frame):
        __tracebackhide__ = True
        self.fired = True
        print(f"\n{self.item.nodeid}: over its time limit of "
              f"{self.limit:g} s; the stack of every thread:",
              file=sys.stderr, flush=True)
        try:   # the test's captured stderr, shown with its failure
            fd = sys.stderr.fileno()
        except (AttributeError, OSError, ValueError):
            fd = _STDERR
        faulthandler.dump_traceback(file=fd, all_threads=True)
        left = [t for t in threading.enumerate()
                if t.is_alive() and t not in self.threads]
        names = sorted(t.name for t in left)
        for t in left:
            t.name = ORPHAN + t.name
        started = [p for k, p in _descendants().items()
                   if k not in self.procs]
        end_processes(started)
        pytest.fail(
            f"over its time limit of {self.limit:g} s (raise it with "
            f"@pytest.mark.time_limit); ended {len(started)} process(es) "
            f"it started; threads it left running, renamed "
            f"{ORPHAN}<name>: {', '.join(names) or 'none'}")


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item):
    if item.get_closest_marker("time_limit") is not None:
        item.stash[_CLOCK] = _Clock(item)
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()


def _phase(item):
    """Arm both stages at the test's deadlines around one phase; a phase
    after the alarm has fired is left to the second stage."""
    clock = item.stash.get(_CLOCK, None)
    if clock is None:
        return (yield)
    # Armed anew in every phase: pytest's own faulthandler plugin
    # cancels the watchdog when a phase fails.
    faulthandler.dump_traceback_later(
        max(clock.hard_deadline - time.monotonic(), 1e-3), exit=True,
        file=_STDERR)
    if clock.fired \
            or threading.current_thread() is not threading.main_thread():
        return (yield)
    before = signal.signal(signal.SIGALRM, clock.on_alarm)
    signal.setitimer(signal.ITIMER_REAL,
                     max(clock.deadline - time.monotonic(), 1e-3))
    try:
        return (yield)
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM,
                      signal.SIG_DFL if before is None else before)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    return (yield from _phase(item))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    return (yield from _phase(item))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item):
    return (yield from _phase(item))


@pytest.hookimpl(optionalhook=True)
def pytest_testnodedown(node, error):
    """On the xdist controller: a worker that died (the second stage)
    leaves its processes behind; end those of this run's worker."""
    if not error:
        return
    tag = (node.gateway.id, node.workerinput.get("testrunuid"))
    left = []
    for p in psutil.process_iter():
        try:
            env = p.environ()
        except psutil.Error:
            continue
        if (env.get("PYTEST_XDIST_WORKER"),
                env.get("PYTEST_XDIST_TESTRUNUID")) == tag:
            left.append(p)
    end_processes(left)

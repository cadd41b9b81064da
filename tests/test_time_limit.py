"""The per-test time limit (tests/time_limit.py), held on inner pytest
runs of tests with a 1 s limit: one that sleeps past it (the SIGALRM
stage), one that blocks with SIGALRM masked (faulthandler's stage,
under xdist), one under it, and one that leaves a thread behind under
the suite's own thread-leak and lock-sanitizer gates.  Each over-limit
test starts a child process that must not outlive it."""

import os
import re
import signal
import subprocess
import sys
import time

import psutil
import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)

INNER = '''
import signal
import subprocess
import sys
import time

import pytest


def child(tag):
    p = subprocess.Popen([sys.executable, "-c",
                          "import time; time.sleep(600)"])
    with open(tag, "w") as f:
        f.write(str(p.pid))


@pytest.mark.time_limit(1)
def test_sleeps_past_its_limit():
    child("child.pid")
    try:
        time.sleep(30)
    except Exception:  # the broad handler of the code under test
        pass


@pytest.mark.time_limit(1)
def test_blocks_with_sigalrm_masked():
    child("child.pid")
    signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})
    time.sleep(30)


@pytest.mark.time_limit(1)
def test_under_its_limit():
    time.sleep(0.1)
'''

# Records the timer and the SIGALRM handler the tests leave behind.
CONFTEST = '''
import signal


def pytest_sessionfinish(session):
    with open("after.txt", "w") as f:
        f.write(repr((signal.getitimer(signal.ITIMER_REAL),
                      signal.getsignal(signal.SIGALRM))))
'''


# An overrun leaves a dkt- thread behind, blocked until the next test
# lets it commit a lock-order violation; that test also starts a fresh
# thread of the same name, which commits one of its own.
INNER_GATES = '''
import threading
import time

import pytest
from distkeras_tpu.utils.locks import LockOrderViolation, TracedLock

GO = threading.Event()


def probe(wait):
    def run():
        if wait:
            GO.wait(30)
        lk = TracedLock("t.probe")
        try:
            with lk:
                with lk:
                    pass
        except LockOrderViolation:
            pass
    t = threading.Thread(target=run, name="dkt-probe", daemon=True)
    t.start()
    return t


@pytest.mark.time_limit(1)
def test_overruns():
    probe(wait=True)
    time.sleep(30)


@pytest.mark.time_limit(30)
def test_fresh_thread_of_that_name():
    [orphan] = [t for t in threading.enumerate()
                if t.name == "orphan:dkt-probe"]
    GO.set()
    orphan.join(10)
    fresh = probe(wait=False)
    fresh.join(10)
    assert not orphan.is_alive() and not fresh.is_alive()
'''

# The suite's two gates, from tests/conftest.py.
CONFTEST_GATES = f'''
import importlib.util

spec = importlib.util.spec_from_file_location(
    "suite_conftest", {os.path.join(TESTS, "conftest.py")!r})
suite = importlib.util.module_from_spec(spec)
spec.loader.exec_module(suite)
_lock_sanitizer_gate = suite._lock_sanitizer_gate
_no_thread_leaks = suite._no_thread_leaks
'''


def run_inner(tmp_path, name, *opts, inner=INNER, conftest=CONFTEST):
    (tmp_path / "test_inner.py").write_text(inner)
    (tmp_path / "conftest.py").write_text(conftest)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join((TESTS, ROOT)),
               PYTEST_DISABLE_PLUGIN_AUTOLOAD="1")
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "time_limit",
         "-p", "no:cacheprovider", *opts,
         f"test_inner.py::{name}" if name else "test_inner.py"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=60)
    return out.returncode, out.stdout + out.stderr, time.monotonic() - t0


def assert_child_ended(tmp_path):
    pid = int((tmp_path / "child.pid").read_text())
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        try:
            if psutil.Process(pid).status() == psutil.STATUS_ZOMBIE:
                return
        except psutil.NoSuchProcess:
            return
        time.sleep(0.05)
    raise AssertionError(f"the test's child {pid} outlived it")


@pytest.mark.parametrize("case", ["python", "masked", "under", "orphan"])
def test_time_limit(tmp_path, case):
    if case == "python":
        rc, out, took = run_inner(tmp_path, "test_sleeps_past_its_limit")
        assert rc == 1, out
        assert "FAILED test_inner.py::test_sleeps_past_its_limit" in out
        assert "over its time limit of 1 s" in out
        assert "the stack of every thread" in out
        assert "ended 1 process(es) it started" in out
        assert took < 20, took   # the test would sleep 30 s
        assert_child_ended(tmp_path)
    elif case == "masked":
        rc, out, took = run_inner(
            tmp_path, "test_blocks_with_sigalrm_masked", "-p", "xdist",
            "-n", "1", "--max-worker-restart=0")
        assert rc == 1, out
        assert ("crashed while running "
                "'test_inner.py::test_blocks_with_sigalrm_masked'") in out
        assert "Timeout (0:00:0" in out   # 1 s limit + 2 s grace
        # The second stage's dump holds the blocked test's own frame.
        assert re.search(r'File ".*test_inner.py", line \d+ in '
                         r"test_blocks_with_sigalrm_masked", out), out
        assert took < 25, took
        assert_child_ended(tmp_path)
    elif case == "under":
        rc, out, _ = run_inner(tmp_path, "test_under_its_limit")
        assert rc == 0, out
        assert "1 passed" in out
        assert (tmp_path / "after.txt").read_text() == repr(
            ((0.0, 0.0), signal.SIG_DFL))
    else:
        rc, out, _ = run_inner(tmp_path, "", inner=INNER_GATES,
                               conftest=CONFTEST_GATES)
        assert rc == 1, out
        # The overrun names the thread it left; the thread-leak gate
        # does not add it as a second finding, there or later.
        assert "FAILED test_inner.py::test_overruns" in out
        assert "renamed orphan:<name>: dkt-probe" in out
        assert "leaked live background thread" not in out
        # The lock gate still fails the test in which a fresh thread
        # of that name commits a violation, and names the orphan's
        # own violation as the orphan's.
        assert "ERROR at teardown of test_fresh_thread_of_that_name" \
            in out
        assert "(thread dkt-probe)" in out
        assert "(thread orphan:dkt-probe)" in out

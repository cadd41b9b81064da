"""The measured window of a cell that runs steps: dispatch steps until
``seconds`` have passed, one step in flight, and close the window when
the last dispatched step has finished on the device."""

from __future__ import annotations

import time


TRACE_AT, TRACE_STEPS = 2, 3


def run_steps(run, step, seconds: float):
    """Call ``step(i)`` for i = 0, 1, ... until ``seconds`` have passed
    since the window opened; returns ``(steps, window_s)``.  The host
    waits for step i - 1 before it dispatches step i + 1, so it is never
    more than one step ahead and the window ends with the device's
    work.  In a traced run the device's activity is profiled over steps
    ``TRACE_AT .. TRACE_AT + TRACE_STEPS - 1``, and the host's as well
    over the step after them; they and their time are left out of what
    is returned."""
    from harness import device

    prev, n, traced = None, 0, 0
    t0 = run.window_opens()
    while True:
        if run.trace and n == TRACE_AT:
            with run.traced():
                for _ in range(TRACE_STEPS):
                    step(n)
                    n += 1
            with run.traced(host=True):
                step(n)
                n += 1
            traced = TRACE_STEPS + 1
        else:
            step(n)
            n += 1
        ev = device.marker(run.device)
        if prev is not None:
            prev.synchronize()
        prev = ev
        if time.perf_counter() - t0 - run.paused_s >= seconds:
            break
    device.sync(run.device)
    return n - traced, time.perf_counter() - t0 - run.paused_s

"""Step timing: the port's jax-free copy of ``StepTimer``.

Counterpart of ``distkeras_tpu/utils/profiling.py::StepTimer`` (without
its telemetry hooks, whose subsystem is not ported): per-round wall
time with a device synchronization at the measurement boundaries only,
and named phase counters (the trainers record ``"h2d"`` and ``"step"``).
"""

from __future__ import annotations

import contextlib
import statistics
import time

import torch


def synchronize(refs) -> None:
    """Wait for every CUDA device that holds a tensor in ``refs`` (a
    tensor or a nested list / tuple of them); host tensors need no
    wait."""
    stack, devices = [refs], set()
    while stack:
        r = stack.pop()
        if isinstance(r, torch.Tensor):
            if r.is_cuda:
                devices.add(r.device)
        elif isinstance(r, (list, tuple)):
            stack.extend(r)
    for d in devices:
        torch.cuda.synchronize(d)


class StepTimer:
    """Wall-clock stats over repeated step calls.

    Usage::

        timer = StepTimer()
        with timer.round():           # sync boundary outside the loop
            for batch in batches:
                state, loss = step(state, *batch)
        timer.finalize(loss)          # blocks, closes the open round
        timer.mean_step_s, timer.p50_round_s, timer.samples_per_sec(n)

    Device work is async: individual step dispatches return immediately,
    so per-call timing lies.  The timer therefore measures *rounds*
    (sync → work → sync) and divides by the step count you report.

    **Named phase counters** (``phase``/``phase_s``/``phase_stats``)
    accumulate host wall time per phase across the run — the
    distributed trainers record ``"h2d"`` (host-side batch staging +
    transfer dispatch) and ``"step"`` (the step's dispatch), so an
    input-bound run is distinguishable from a compute-bound one without
    a profiler.

    State persists across rounds but NOT across runs: call
    :meth:`reset` at the start of each run (the trainers do, at the
    top of every ``train()``), so ``phase_stats`` always describes the
    run just measured instead of silently accumulating across
    ``train()`` calls.
    """

    def __init__(self, scope: str = "train"):
        self.scope = scope
        self.rounds: list[tuple[float, int]] = []  # (seconds, n_steps)
        self.phases: dict[str, tuple[float, int]] = {}  # name -> (s, calls)
        self._t0: float | None = None
        self._n = 0

    def reset(self) -> None:
        """Drop all recorded rounds and phase stats (fresh run).  Any
        open round is abandoned, not recorded."""
        self.rounds = []
        self.phases = {}
        self._t0 = None
        self._n = 0

    @contextlib.contextmanager
    def phase(self, name: str):
        """Accumulate host wall time under ``name`` (re-entrant safe to
        nest *different* names; never syncs the device — wrap dispatch
        sites, then ``finalize`` closes the round with one barrier).
        """
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            dt = time.perf_counter() - t0
            s, c = self.phases.get(name, (0.0, 0))
            self.phases[name] = (s + dt, c + 1)

    def phase_s(self, name: str) -> float:
        """Total seconds accumulated under ``name`` (0.0 if unused)."""
        return self.phases.get(name, (0.0, 0))[0]

    def phase_stats(self) -> dict:
        """``{name: {"total_s", "calls", "mean_s"}}`` for every phase."""
        return {name: {"total_s": s, "calls": c,
                       "mean_s": s / c if c else 0.0}
                for name, (s, c) in self.phases.items()}

    @contextlib.contextmanager
    def round(self, n_steps: int = 0):
        self._t0 = time.perf_counter()
        self._n = n_steps
        yield self
        # finalize() closes the round after the caller syncs.

    def count(self, n: int = 1) -> None:
        self._n += n

    def finalize(self, *sync_refs) -> None:
        """Wait for the devices of ``sync_refs`` (tensors, or lists of
        them) and close the round."""
        synchronize(sync_refs)
        if self._t0 is not None:
            dur = time.perf_counter() - self._t0
            self.rounds.append((dur, self._n))
            self._t0 = None
            self._n = 0

    # ------------------------------------------------------------- stats

    @property
    def total_s(self) -> float:
        return sum(s for s, _ in self.rounds)

    @property
    def total_steps(self) -> int:
        return sum(n for _, n in self.rounds)

    @property
    def mean_step_s(self) -> float:
        n = self.total_steps
        return self.total_s / n if n else 0.0

    @property
    def p50_round_s(self) -> float:
        return statistics.median(s for s, _ in self.rounds) if self.rounds else 0.0

    def samples_per_sec(self, samples_per_step: int) -> float:
        return (samples_per_step * self.total_steps / self.total_s
                if self.total_s else 0.0)

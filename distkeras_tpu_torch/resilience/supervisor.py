"""Preemption-safe training supervision: retry, backoff, auto-resume.

The port's own copy of ``distkeras_tpu/resilience/supervisor.py``.  The
reference framework's failure story is "the job dies" (SURVEY.md §5:
single-point-of-failure parameter server, no worker retry).  The port
persists training state
(:class:`~distkeras_tpu_torch.checkpoint.CheckpointManager`); this
module adds the loop that *uses* it: a :class:`Supervisor` wraps any trainer's
``train`` with

- **retry + exponential backoff with jitter** on faults (IO errors,
  injected chaos, flaky infrastructure), resuming from the latest
  checkpoint instead of restarting from scratch;
- a **preemption signal handler**: on SIGTERM the trainer's next round
  boundary forces a final *synchronous* checkpoint and raises
  :class:`~distkeras_tpu_torch.resilience.chaos.Preempted`, so an evicted VM
  loses at most one round of work;
- **verified auto-resume**: the latest checkpoint step must never move
  backward across attempts, and the trainers' own restore validation
  (step-counter vs round arithmetic; the dropout generator's state
  saved with the carry) guarantees a resumed run replays the
  uninterrupted trajectory bit for bit (pinned by
  tests/test_torch_resilience.py on the CPU and chip_smoke.py's phase
  ``resume`` on the card).

Works with every trainer in the family — anything built on
``CheckpointingBase`` (``SingleTrainer``, the distributed/elastic
trainers, ``LMTrainer``/``LoRATrainer``) — because the preemption hook
and the chaos probe live in the shared ``_checkpoint`` round
bookkeeping.
"""

from __future__ import annotations

import dataclasses
import random
import signal
import threading
import time

from distkeras_tpu_torch import obs
from distkeras_tpu_torch.resilience.chaos import Preempted


@dataclasses.dataclass
class Attempt:
    """One ``trainer.train`` invocation under the supervisor."""

    index: int
    outcome: str               # "ok" | "fault" | "preempted"
    error: str | None
    resumed_from: int | None   # checkpoint step the attempt started at
    duration: float


class Supervisor:
    """Run ``trainer.train`` to completion across faults and preemptions.

    ``trainer`` must checkpoint periodically (``checkpoint_dir`` +
    ``checkpoint_every``) — without durable mid-run state there is
    nothing to resume and a retry would silently retrain from scratch.

    ``max_retries``: fault retries (beyond the first attempt) before
    giving up and re-raising.  ``max_preemptions`` bounds SIGTERM/
    ``Preempted`` resumptions separately — preemptions are expected
    lifecycle events, not faults, and consume no backoff.

    Backoff for attempt k (1-based) sleeps
    ``min(backoff * backoff_factor**(k-1), max_backoff)`` scaled by
    ``1 + jitter * U[0, 1)`` — the jitter decorrelates a fleet of
    restarting workers (seeded: deterministic in tests).

    ``handle_sigterm``: install a SIGTERM handler for the duration of
    :meth:`run` (restored afterward) that requests a graceful
    preemption; only the main thread can own signal handlers, so pass
    ``False`` when supervising from a worker thread and deliver the
    preemption by setting ``supervisor.preempt_event`` yourself.
    """

    def __init__(self, trainer, max_retries: int = 3,
                 max_preemptions: int = 8, backoff: float = 0.5,
                 backoff_factor: float = 2.0, max_backoff: float = 30.0,
                 jitter: float = 0.5, seed: int = 0,
                 handle_sigterm: bool = True,
                 retryable: tuple = (Exception,),
                 sleep=None):
        if not getattr(trainer, "checkpoint_dir", None):
            raise ValueError(
                "Supervisor needs a trainer with checkpoint_dir set — "
                "retry without durable state would restart from scratch")
        if not getattr(trainer, "checkpoint_every", 0):
            raise ValueError(
                "Supervisor needs checkpoint_every >= 1: a fault must "
                "cost at most checkpoint_every rounds of recompute, not "
                "the whole run")
        if getattr(trainer, "shuffle", False) and trainer.seed is None:
            raise ValueError(
                "supervised training with shuffle=True needs a fixed "
                "seed: auto-resume skips the first N rounds of the "
                "stream, which only lands on the right data if the "
                "permutation is reproducible")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        if backoff < 0 or max_backoff < backoff:
            raise ValueError(
                f"need 0 <= backoff <= max_backoff, got {backoff}, "
                f"{max_backoff}")
        self.trainer = trainer
        self.max_retries = max_retries
        self.max_preemptions = max_preemptions
        self.backoff = backoff
        self.backoff_factor = backoff_factor
        self.max_backoff = max_backoff
        self.jitter = jitter
        self.retryable = retryable
        self.handle_sigterm = handle_sigterm
        self._sleep = sleep
        self._rng = random.Random(seed)
        self.preempt_event = threading.Event()
        self.attempts: list[Attempt] = []

    # ------------------------------------------------------------ state

    def latest_step(self) -> int | None:
        """Latest committed AND valid checkpoint step (a step commits
        by renaming an integer-named directory into place; a torn step
        — died mid-save, no atomic rename — does not count as
        progress, and the trainer's restore validation trims it on
        resume)."""
        from distkeras_tpu_torch.resilience.cluster import latest_valid_step

        d = self.trainer.checkpoint_dir
        return latest_valid_step(d) if d else None

    def backoff_for(self, retry: int) -> float:
        """Sleep before fault retry ``retry`` (1-based)."""
        base = min(self.backoff * self.backoff_factor ** (retry - 1),
                   self.max_backoff)
        return base * (1.0 + self.jitter * self._rng.random())

    def _backoff_sleep(self, wait: float) -> None:
        """Interruptible backoff: a SIGTERM during the window must not
        ride it out — ``preempt_event.wait`` returns the instant the
        preemption arrives, and the next attempt's first round boundary
        then runs the normal forced-sync-checkpoint path (a preemption
        outranks politeness toward a flaky disk).  An injected
        ``sleep=`` (tests) bypasses the event and keeps full control of
        timing."""
        if self._sleep is not None:
            self._sleep(wait)
        else:
            self.preempt_event.wait(wait)

    # -------------------------------------------------------------- run

    def run(self, *args, **kw):
        """``trainer.train(*args, **kw)`` to completion; returns its
        result.  Exhausted retries re-raise the last fault."""
        installed = False
        prev_handler = None
        if self.handle_sigterm:
            prev_handler = signal.signal(
                signal.SIGTERM, lambda *_: self.preempt_event.set())
            installed = True
        self.trainer.preempt_event = self.preempt_event
        orig_resume = getattr(self.trainer, "resume", False)
        retries = preemptions = 0
        try:
            while True:
                resumed_from = self.latest_step()
                if resumed_from is not None:
                    # Auto-resume: the crash-restart case (this process
                    # is the rerun after an eviction) and the retry case
                    # share one path.
                    self.trainer.resume = True
                t0 = time.perf_counter()
                try:
                    result = self.trainer.train(*args, **kw)
                except Preempted as e:
                    self._record("preempted", e, resumed_from, t0)
                    self.preempt_event.clear()
                    preemptions += 1
                    obs.count("supervisor.preemptions")
                    if preemptions > self.max_preemptions:
                        raise
                    self._verify_progress(resumed_from)
                    continue
                except self.retryable as e:
                    self._record("fault", e, resumed_from, t0)
                    retries += 1
                    obs.count("supervisor.retries")
                    if retries > self.max_retries:
                        raise
                    self._verify_progress(resumed_from)
                    wait = self.backoff_for(retries)
                    obs.event("supervisor.backoff", seconds=wait,
                              retry=retries)
                    obs.observe("supervisor.backoff_s", wait)
                    self._backoff_sleep(wait)
                    continue
                self._record("ok", None, resumed_from, t0)
                return result
        finally:
            self.trainer.preempt_event = None
            # resume=True is run()'s internal retry machinery; leaving
            # it flipped would disable the trainer's designed
            # refuse-to-overwrite guard on later direct train() calls.
            self.trainer.resume = orig_resume
            if installed:
                # A None prev_handler means SIGTERM was owned outside
                # Python (unrestorable from here); SIG_DFL at least
                # restores default termination instead of leaving our
                # event-setting lambda installed forever.
                signal.signal(signal.SIGTERM,
                              prev_handler if prev_handler is not None
                              else signal.SIG_DFL)

    # ---------------------------------------------------------- helpers

    def _record(self, outcome, error, resumed_from, t0):
        att = Attempt(
            index=len(self.attempts), outcome=outcome,
            error=None if error is None else repr(error),
            resumed_from=resumed_from,
            duration=time.perf_counter() - t0)
        self.attempts.append(att)
        # Every attempt (and restart) lands in the obs event trace:
        # the machine-readable fault/recovery timeline.
        obs.event("supervisor.attempt", index=att.index,
                  outcome=outcome, resumed_from=resumed_from,
                  duration_s=att.duration, error=att.error)

    def _verify_progress(self, before: int | None):
        """Crash-consistency check between attempts: the checkpoint
        step counter must never move backward (a truncated/corrupted
        store resuming earlier than a previous attempt would silently
        replay — and with a different RNG/step alignment, diverge)."""
        after = self.latest_step()
        if before is not None and (after is None or after < before):
            raise RuntimeError(
                f"checkpoint store at {self.trainer.checkpoint_dir!r} "
                f"moved backward across attempts (step {before} -> "
                f"{after}); refusing to resume from a store that lost "
                "committed state")

"""Admission-control types for the serving engines.

The port's own copy of ``distkeras_tpu/resilience/admission.py``.  The
serving engines (:mod:`distkeras_tpu_torch.serving`) gain three
production behaviors from this layer — all host-side bookkeeping, so
the decode step (and the exact-parity contract it is pinned to) is
untouched:

- **deadlines**: every request may carry a TTL; an expired request is
  evicted from its lane (or dropped from the queue before it ever
  occupies one) and reported as a structured ``timeout`` result.
- **bounded admission queue**: ``enqueue`` buffers requests when all
  lanes are busy, up to ``max_queue``; past that it raises
  :class:`QueueFull` — backpressure the caller can act on (shed load,
  retry elsewhere) instead of an unbounded hidden buffer.
- **drain-then-shutdown**: ``begin_shutdown`` stops admission,
  ``shutdown`` runs the decode loop until every in-flight request
  finishes (or times out) and returns the collected results.
"""

from __future__ import annotations

import dataclasses

import numpy as np


class QueueFull(RuntimeError):
    """Admission rejected: every lane is busy and the bounded queue is
    at capacity.  The backpressure signal — callers shed or retry."""


class EngineClosed(RuntimeError):
    """Admission rejected: the engine is shutting down (drain phase)."""


@dataclasses.dataclass
class RequestResult:
    """Terminal record for one request.

    ``status``: ``"ok"`` (finished by eos/budget), ``"timeout"``
    (deadline expired — ``tokens`` holds the prompt plus whatever was
    generated before eviction; a request that expired before ever
    occupying a lane holds just the prompt), ``"cancelled"`` (dropped
    by shutdown before completing), or ``"error"`` (a queued request
    failed engine-specific admission validation when its lane freed;
    ``error`` carries the message).

    The live-transcript snapshot (``partial()``, the streaming read)
    reuses this record with two NON-terminal statuses: ``"queued"``
    (``tokens`` is just the prompt) and ``"decoding"`` (``tokens`` is
    the prompt plus everything emitted so far) — same prompt-inclusive
    transcript shape, so cursor arithmetic never branches on
    terminality.
    """

    request_id: int
    tokens: np.ndarray
    status: str
    prompt_len: int
    error: str | None = None

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    @property
    def timed_out(self) -> bool:
        return self.status == "timeout"

    @property
    def generated(self) -> np.ndarray:
        """The emitted tokens (prompt stripped)."""
        return self.tokens[self.prompt_len:]


@dataclasses.dataclass
class _Pending:
    """A queued request waiting for a free lane."""

    request_id: int
    prompt: np.ndarray
    max_new: int
    deadline: float | None
    submit_kw: dict
    born: float | None = None  # engine clock() at enqueue (obs latency)

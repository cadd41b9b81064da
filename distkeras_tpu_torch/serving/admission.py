"""Admission control for the serving engines (resilience subsystem).

The port's own copy of ``distkeras_tpu/serving/admission.py``: the
host-side layer both engines inherit: per-request
``ttl``/``deadline`` with lane eviction and structured
:class:`RequestResult` reporting, the bounded ``enqueue`` FIFO with
:class:`QueueFull` backpressure, expired-on-arrival handling, the
drain-then-``shutdown()`` lifecycle, and the engine lock that makes
admission atomic against ``begin_shutdown`` (EngineClosed wins).

The exception/result types live in
:mod:`distkeras_tpu_torch.resilience.admission`; this module re-exports
them and adds the engine-side mixin.  All of it is host bookkeeping —
the decode step and its exact-parity contract are untouched.
"""

from __future__ import annotations

import collections
import time

import numpy as np

from distkeras_tpu_torch import obs
from distkeras_tpu_torch.resilience.admission import (EngineClosed, QueueFull,
                                                 RequestResult, _Pending)
from distkeras_tpu_torch.utils.locks import TracedRLock


class _AdmissionMixin:
    """Admission-control behavior for :class:`_LaneEngine`: queueing,
    deadlines, structured results, lifecycle.  Assumes the host lane
    table (``_lane_state``, ``free_lanes``, ``running``, ``_vacate``)
    and the engine's ``submit``/``step`` exist on the composed class.
    """

    def _init_admission(self, max_queue: int, clock) -> None:
        if max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {max_queue}")
        self.max_queue = max_queue
        self._clock = clock if clock is not None else time.monotonic
        self._pending = collections.deque()
        self._completed: dict[int, RequestResult] = {}
        self._closed = False
        # One lock makes the closed-check and the queue insert ATOMIC:
        # a begin_shutdown() racing an in-flight enqueue() must yield
        # exactly one of two outcomes — the request raised EngineClosed
        # (close won) or it is in the queue/lane and shutdown's drain
        # reaches it (insert won).  Without the lock, the enqueue could
        # pass the closed check, lose the race, and then raise
        # QueueFull off a queue that shutdown was already cancelling —
        # the caller would shed load from an engine that is not
        # overloaded, it is closing.  EngineClosed WINS: once
        # begin_shutdown returns, every later enqueue/submit raises it,
        # even when the queue is also full.  Reentrant because
        # enqueue -> pump -> _admit_pending nests.  Ordering: this lock
        # is acquired FIRST — pool/obs locks nest inside it, never the
        # reverse.
        self._admission_lock = TracedRLock("serving.admission")
        # Internal admission (enqueue -> pump -> submit) threads the
        # request's ENQUEUE-TIME id through to submit, so every span/
        # event the admission path emits carries the id the caller
        # holds.  Doubles as
        # the "internal admission in progress" marker (the
        # ``_admitting_internal`` property): ONE piece of state, so
        # the id and the pump-bypasses-_closed behavior cannot drift.
        self._admit_rid: int | None = None
        # Chunked-prefill scheduler state: lanes with pending admission
        # chunks, FIFO (see engine._run_pending_chunk).
        self._admitting = collections.deque()
        # Elastic-tier bookkeeping (ContinuousBatcher(lane_tiers=...);
        # inert defaults for every other engine).
        self.lane_tiers = None
        self.tier_epoch = 0
        self.scale_up_after = 2
        self.scale_down_after = 8
        self._bp_strikes = 0
        self._idle_strikes = 0
        # The id under which the most recent bare submit() recorded (or
        # will record) its RequestResult — how drain()-style callers
        # that pass a ttl reach their structured timeout via poll/take
        # instead of the pop-everything results().
        self.last_request_id: int | None = None
        self._decline_reason: str | None = None

    def _deadline_of(self, ttl, deadline):
        """Resolve submit/enqueue's ``ttl`` (seconds from now) /
        ``deadline`` (absolute ``clock()`` time) pair."""
        if ttl is not None and deadline is not None:
            raise ValueError("pass ttl (relative) OR deadline "
                             "(absolute), not both")
        if ttl is not None:
            return self._clock() + ttl
        return deadline

    @property
    def _admitting_internal(self) -> bool:
        """True while ``submit`` runs as internal admission (the
        enqueue -> pump path): pump bypasses ``_closed`` and declines
        register under the caller's id, not a fresh one."""
        return self._admit_rid is not None

    def _check_open(self) -> None:
        if self._closed and not self._admitting_internal:
            obs.count("serving.rejected", reason="closed")
            raise EngineClosed(
                "engine is shutting down (begin_shutdown was called); "
                "no new requests are admitted during drain")

    def _obs_request_done(self, status: str, born,
                          rid: int | None = None) -> None:
        """Terminal-request telemetry: status counter, deadline-miss
        counter, the request latency histogram (engine clock, so
        chaos tests with an injected clock stay deterministic), and
        the ``serving.finish`` trace event closing the request's
        submit -> admit -> emit -> finish story."""
        obs.count("serving.requests", status=status)
        if status == "timeout":
            obs.count("serving.deadline_misses")
        if obs.active() is not None:
            if born is not None:
                obs.observe("serving.request_s", self._clock() - born,
                            status=status)
            if rid is not None:
                obs.event("serving.finish", request_id=rid,
                          status=status)

    def _finish(self, rid: int, tokens, status: str, prompt_len: int,
                error: str | None = None, born=None):
        self._obs_request_done(status, born, rid=rid)
        self._completed[rid] = RequestResult(
            request_id=rid, tokens=np.asarray(tokens, np.int32),
            status=status, prompt_len=prompt_len, error=error)

    def _expired_on_arrival(self, dl, prompt, p: int) -> bool:
        """The ONE expired-on-arrival protocol for both engines'
        ``submit``: an already-dead request never occupies a lane; a
        caller-facing submit records the structured timeout under a
        fresh id (exposed as ``last_request_id``), while internal
        admission (enqueue/pump) declines silently — the caller records
        under the request's own id."""
        if dl is None or dl > self._clock():
            return False
        if not self._admitting_internal:
            rid = self._next_id
            self._next_id += 1
            obs.event("serving.submit", request_id=rid, prompt_len=p,
                      expired_on_arrival=True)
            self._finish(rid, prompt, "timeout", p,
                         born=self._clock())
            self.last_request_id = rid
        return True

    def _claim_rid(self) -> int:
        """The id this admission runs under: the enqueue-assigned id
        when submit is running as internal admission (so the admit
        span/events carry the id the caller holds), else a fresh
        allocation.  No ``last_request_id`` side effect — caller-
        facing submits publish it only once the lane commits."""
        if self._admit_rid is not None:
            return self._admit_rid
        rid = self._next_id
        self._next_id += 1
        return rid

    def _decline(self, reason: str) -> None:
        """Record a submit() decline: no request was registered, so a
        stale ``last_request_id`` must not masquerade as this
        request's; enqueue/pump read ``_decline_reason`` to tell a
        storage decline (``"kv_blocks"``, the paged allocator out of
        blocks: retryable backpressure) from a deadline expiry."""
        self._decline_reason = reason
        if not self._admitting_internal:
            obs.count("serving.rejected", reason=reason)
            self.last_request_id = None

    def _decline_full(self) -> None:
        self._decline("no_free_lane")

    def enqueue(self, prompt, max_new_tokens: int, ttl=None, deadline=None,
                **submit_kw) -> int:
        """Admission-controlled submit: returns a request id
        immediately; the terminal :class:`RequestResult` arrives via
        :meth:`poll` / :meth:`take` / :meth:`results` once the request
        finishes, times out, or is cancelled by shutdown.

        No free lane: the request waits in the bounded FIFO queue
        (capacity ``max_queue``); past capacity, raises
        :class:`QueueFull` — the backpressure signal.  An already-
        expired deadline never occupies a lane or a queue slot: the
        structured timeout result is recorded up front.

        ``submit_kw`` forwards to this engine's ``submit`` (per-request
        key / sampling overrides / eos_token / ``prefix_id``);
        engine-specific validation beyond the prompt/budget checks runs
        at admission time, which for a queued request is a later
        ``step()`` — a pooled prefix evicted while its request queues
        therefore surfaces as a structured ``"error"`` result, not a
        crash (queued requests do not pin pool entries).

        Thread safety: the closed check and the queue insert are
        atomic under one engine lock, and **EngineClosed wins** — an
        enqueue racing ``begin_shutdown`` either gets its request in
        (and shutdown's drain reaches it) or raises EngineClosed;
        QueueFull is only ever raised by an engine that is actually
        open and overloaded.  On elastic engines (``lane_tiers``),
        sustained overflow steps the lane tier up instead of raising
        (see the ContinuousBatcher docstring).
        """
        with self._admission_lock:
            self._check_open()
            prompt = self._validate_request_args(prompt, max_new_tokens)
            self._validate_budget(prompt.size, max_new_tokens,
                                  **self._budget_kw(submit_kw))
            dl = self._deadline_of(ttl, deadline)
            rid = self._next_id
            self._next_id += 1
            obs.event("serving.submit", request_id=rid,
                      prompt_len=int(prompt.size),
                      max_new=int(max_new_tokens))
            if dl is not None and dl <= self._clock():
                # born=now: a ~0s latency observation, so the request_s
                # histogram count agrees with the requests counter (the
                # deadline-miss population must not vanish from it).
                self._finish(rid, prompt, "timeout", prompt.size,
                             born=self._clock())
                return rid
            pend = _Pending(rid, prompt, int(max_new_tokens), dl,
                            submit_kw, born=self._clock())
            # FIFO: queued requests get first claim on any free lane
            # (and expired heads are dropped) before this one may jump
            # in.
            self.pump()
            if self.free_lanes() and not self._pending:
                # Immediate admission: validation errors raise to the
                # caller here, synchronously.
                if self._admit_pending(pend):
                    self._bp_strikes = 0
                    return rid
                # A lane was free, so submit declined either because
                # the deadline expired between our check and its
                # re-check, or (paged engines) because the KV-block
                # allocator is exhausted — the latter queues like any
                # other backpressure (blocks free as lanes drain).
                if self._decline_reason != "kv_blocks":
                    self._finish(rid, prompt, "timeout", prompt.size,
                                 born=pend.born)
                    return rid
            while len(self._pending) >= self.max_queue:
                if not self._try_scale_up():
                    obs.count("serving.rejected", reason="queue_full")
                    if self._decline_reason == "kv_blocks":
                        # Name the real bottleneck: lanes may be free,
                        # the paged allocator is what ran dry.
                        raise QueueFull(
                            f"KV block allocator exhausted and the "
                            f"admission queue holds "
                            f"{len(self._pending)}/{self.max_queue} "
                            "requests; shed load, raise n_blocks, or "
                            "bound request budgets")
                    raise QueueFull(
                        f"all {self.lanes} lanes busy and the "
                        f"admission queue holds {len(self._pending)}/"
                        f"{self.max_queue} requests; shed load or "
                        "raise max_queue")
                # Fresh lanes: queued requests keep FIFO priority,
                # then this one takes a lane or the queue headroom.
                self.pump()
                if self.free_lanes() and not self._pending:
                    if self._admit_pending(pend):
                        return rid
                    if self._decline_reason != "kv_blocks":
                        self._finish(rid, prompt, "timeout",
                                     prompt.size, born=pend.born)
                        return rid
            self._bp_strikes = 0
            self._pending.append(pend)
            obs.gauge("serving.queue_depth", len(self._pending))
            return rid

    def _budget_kw(self, submit_kw) -> dict:
        """Budget-validation kwargs enqueue() resolves up front from
        the submit kwargs: the prefix offset, for pooled requests.
        Advisory only — admission re-validates under its own pin, so
        an entry evicted between enqueue and admission still surfaces
        as a structured error, never a wrong-prefix decode."""
        pid = submit_kw.get("prefix_id")
        if pid is None:
            return {}
        if self._prefix_pool is None:
            raise ValueError(
                f"prefix_id needs "
                f"{type(self).__name__}(prefix_pool=...)")
        try:
            return {"off": self._prefix_pool.length_of(pid)}
        except KeyError as e:
            raise ValueError(str(e)) from e

    def _pin_prefix(self, prefix_id):
        """Atomically PIN a pooled prefix for an admission attempt and
        resolve its parameters: returns ``(length, slot, last_token)``.
        Pinning first closes the eviction race — a pinned entry can
        never be LRU-evicted, so the slot the subsequent slab gather
        reads is guaranteed to still hold THIS prefix (a ``put``
        landing concurrently only ever rewrites unpinned slots).  The
        caller owns the pin: it becomes the admitted lane's reference
        on success and MUST be released on every other exit
        (validation failure, expired-on-arrival, engine full)."""
        if self._prefix_pool is None:
            raise ValueError(
                f"prefix_id needs "
                f"{type(self).__name__}(prefix_pool=...)")
        try:
            e = self._prefix_pool.acquire(prefix_id)
        except KeyError as err:
            raise ValueError(str(err)) from err
        return e.length, e.slot, e.last_token

    def _admit_pending(self, pend) -> bool:
        self._admit_rid = pend.request_id
        self._decline_reason = None
        try:
            lane = self.submit(pend.prompt, pend.max_new,
                               deadline=pend.deadline, **pend.submit_kw)
        finally:
            self._admit_rid = None
        if lane is None:
            return False
        st = self._lane_state[lane]
        # submit() admitted under the enqueue-assigned id (_claim_rid)
        # so its admit span/events already carry the id the caller
        # holds; the assignment is belt and braces.
        st.request_id = pend.request_id
        st.managed = True
        if pend.born is not None:
            # Request latency counts from enqueue, queue wait included.
            st.born = pend.born
            if obs.active() is not None:
                obs.observe("serving.queue_wait_s",
                            self._clock() - pend.born)
        return True

    def pump(self) -> list[int]:
        """Admit queued requests into free lanes (FIFO); queued
        requests whose deadline expired are dropped with a structured
        timeout — they never occupy a lane.  Runs automatically at the
        start of every ``step()``; returns the admitted request ids."""
        with self._admission_lock:
            return self._pump_locked()

    def _pump_locked(self) -> list[int]:
        admitted = []
        while self._pending:
            pend = self._pending[0]
            if (pend.deadline is not None
                    and pend.deadline <= self._clock()):
                self._pending.popleft()
                self._finish(pend.request_id, pend.prompt, "timeout",
                             pend.prompt.size, born=pend.born)
                continue
            if not self.free_lanes():
                break
            self._pending.popleft()
            try:
                ok = self._admit_pending(pend)
            except Exception as e:  # noqa: BLE001 — deferred validation
                # Engine-specific validation that enqueue() could not
                # run up front (e.g. the key-iff-sampling rule, or a
                # pooled prefix evicted while queued) fails at
                # admission: the request must still reach a terminal
                # structured result, not crash the decode loop.
                self._finish(pend.request_id, pend.prompt, "error",
                             pend.prompt.size, error=str(e),
                             born=pend.born)
                continue
            if ok:
                admitted.append(pend.request_id)
            elif self._decline_reason == "kv_blocks":
                # Allocator exhausted (paged engine): the request stays
                # at the queue head — blocks free as running lanes
                # drain, and FIFO order must hold.
                self._pending.appendleft(pend)
                break
            else:
                # Free lane + declined admission == the deadline
                # expired between pump's check and submit's re-check.
                self._finish(pend.request_id, pend.prompt, "timeout",
                             pend.prompt.size, born=pend.born)
        # Unconditionally: expired-head drops shrink the queue without
        # admitting anything, and the gauge must not report phantom
        # backlog (no-op when telemetry is disabled).
        obs.gauge("serving.queue_depth", len(self._pending))
        return admitted

    def _reap(self) -> None:
        """Post-step bookkeeping: collect finished managed lanes and
        evict deadline-expired running lanes (structured timeout with
        the partial transcript).  Evicted/collected lanes free
        immediately — the next pump()/submit() reuses them."""
        now = None
        for lane, st in enumerate(self._lane_state):
            if st is None:
                continue
            if st.done:
                if st.managed:
                    self._finish(st.request_id, st.tokens, "ok",
                                 st.prompt_len, born=st.born)
                    self._vacate(lane)
                continue
            if st.deadline is not None:
                if now is None:
                    now = self._clock()
                if st.deadline <= now:
                    self._finish(st.request_id, st.tokens, "timeout",
                                 st.prompt_len, born=st.born)
                    self._vacate(lane)

    # ------------------------------------------------------- results

    def poll(self, request_id: int):
        """The request's :class:`RequestResult`, or None if still
        queued/decoding."""
        return self._completed.get(request_id)

    def take(self, request_id: int):
        """Pop and return the request's result; raises KeyError if it
        has not finished."""
        return self._completed.pop(request_id)

    def partial(self, request_id: int):
        """Live transcript snapshot — the streaming read.

        A terminal request returns its completed
        :class:`RequestResult` (exactly what :meth:`poll` returns); a
        request still decoding returns a ``RequestResult`` with
        status ``"decoding"`` and the transcript SO FAR (prompt +
        every token emitted to date — the same prompt-inclusive shape
        terminal transcripts carry, so a caller's cursor arithmetic
        never branches); a request still queued returns ``"queued"``
        with just the prompt.  ``None`` for unknown ids.  Taken under
        the admission lock so the snapshot never tears against a
        concurrent step's emit — the one rule the streaming relay
        (``/stream``, :meth:`Router.stream`) leans on.
        """
        with self._admission_lock:
            res = self._completed.get(request_id)
            if res is not None:
                return res
            for st in self._lane_state:
                if st is not None and st.request_id == request_id:
                    return RequestResult(
                        request_id=request_id,
                        tokens=np.asarray(st.tokens, np.int32),
                        status="decoding", prompt_len=st.prompt_len,
                        error=None)
            for pend in self._pending:
                if pend.request_id == request_id:
                    return RequestResult(
                        request_id=request_id,
                        tokens=np.asarray(pend.prompt, np.int32),
                        status="queued", prompt_len=pend.prompt.size,
                        error=None)
            return None

    def results(self) -> dict:
        """Pop every completed result: ``{request_id: RequestResult}``."""
        out = self._completed
        self._completed = {}
        return out

    @property
    def queued(self) -> int:
        return len(self._pending)

    @property
    def closed(self) -> bool:
        return self._closed

    # ------------------------------------------------------ lifecycle

    def begin_shutdown(self) -> None:
        """Stop admission (submit/enqueue raise :class:`EngineClosed`);
        in-flight lanes and the queue keep decoding via ``step()``.
        Taken under the admission lock: any enqueue that already
        passed its closed check finishes its insert first (and will be
        drained), and every enqueue after this returns raises
        EngineClosed — never QueueFull (EngineClosed wins)."""
        with self._admission_lock:
            self._closed = True

    def shutdown(self, max_steps: int | None = None) -> dict:
        """Drain-then-shutdown: stop admission, run the decode loop
        until every queued and running request reaches a terminal state
        (finish, eos, or deadline), and return the collected results.

        ``max_steps`` bounds the drain; requests still unfinished when
        it trips are cancelled (structured ``"cancelled"`` results,
        partial transcripts for lanes already decoding).  Lanes that
        were admitted with bare ``submit()`` and already finished are
        left for their caller's ``drain()`` — only live work blocks
        shutdown.
        """
        self.begin_shutdown()
        steps = 0
        while self.running() or self._pending:
            if max_steps is not None and steps >= max_steps:
                break
            if not self.running() and not self.free_lanes():
                # Queue blocked behind finished-but-undrained manual
                # lanes: stepping cannot make progress.
                break
            self.step()
            steps += 1
        for pend in self._pending:
            self._finish(pend.request_id, pend.prompt, "cancelled",
                         pend.prompt.size, born=pend.born)
        self._pending.clear()
        obs.gauge("serving.queue_depth", 0)
        for lane, st in enumerate(self._lane_state):
            if st is not None and not st.done:
                self._finish(st.request_id, st.tokens, "cancelled",
                             st.prompt_len, born=st.born)
                self._vacate(lane)
        return self.results()


__all__ = ["EngineClosed", "QueueFull", "RequestResult", "_Pending",
           "_AdmissionMixin"]

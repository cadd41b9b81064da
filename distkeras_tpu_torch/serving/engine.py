"""Shared lane machinery for the serving engines.

The port's counterpart of ``distkeras_tpu/serving/engine.py``.
``_LaneEngine`` is the host-side core both engines build on: the lane
table (free/running/drain), the per-step emission loop and the
chunked-prefill scheduler, plus — through the mixins it composes —
admission control (:mod:`~distkeras_tpu_torch.serving.admission`) and
elastic lane tiers (:mod:`~distkeras_tpu_torch.serving.elastic`).  The
one-lane admission step lives here too, shared by
:class:`~distkeras_tpu_torch.serving.lanes.ContinuousBatcher` and
:class:`~distkeras_tpu_torch.serving.speculative.SpeculativeBatcher`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from distkeras_tpu_torch import obs
from distkeras_tpu_torch.models.generate import _decode_chunk
from distkeras_tpu_torch.models.quant import QTensor
from distkeras_tpu_torch.models.transformer import named_leaves
from distkeras_tpu_torch.serving.admission import _AdmissionMixin
from distkeras_tpu_torch.serving.elastic import _ElasticMixin


@dataclasses.dataclass
class _Lane:
    request_id: int
    prompt_len: int
    max_new: int
    tokens: list         # host-side transcript, prompt included
    done: bool = False
    eos: object = None   # per-request eos token (engine default)
    deadline: float | None = None  # absolute clock() time; None = none
    managed: bool = False  # admitted via enqueue(): auto-collected
    born: float | None = None  # clock() at admission (obs latency)
    # Chunked prefill: remaining (start, rows) admission
    # chunks; non-None means the lane is still ADMITTING — parked out
    # of the emission loop until the last chunk lands.
    chunks: list | None = None
    # Shared-prefix bookkeeping: the request's prefix length (0 =
    # none) and its PrefixPool id (refcount released at vacation).
    off: int = 0
    prefix_id: int | None = None
    # Engine-clock time of the lane's previous emission (TTFT/TPOT
    # telemetry; None until the first token lands).
    last_emit: float | None = None


def _lane_view(cache, lane: int):
    """One lane's slice ``[L, 1, S, kv, hd]`` of a cache dict: views, so
    writes through them land in the engine's cache in place."""
    return {name: a[:, lane:lane + 1] for name, a in cache.items()}


def _seed_lane(view, source) -> None:
    """Overwrite a lane's whole cache row: from ``source`` (a batch-1
    prefill cache — prefix slots filled, the rest zero), or with zeros.
    A fresh occupant never sees the previous request's K/V."""
    for name, a in view.items():
        if source is None:
            a.zero_()
        else:
            a.copy_(source[name])


def _make_lane_admit(model_params, model_cfg, prefix_lane=None,
                     pooled: bool = False, seed: bool = True):
    """The one-lane admission step shared by both engines:
    ``admit(cache, rows, lane, off, *pool)`` prefills the bucket-padded
    ``rows [1, W]`` into lane ``lane``'s row of ``cache`` at position
    ``off``, in place, through ``_decode_chunk(uniform_pos=True)`` (the
    plain attention over the lane's cache, as the reference admits).

    The lane is first seeded from the engine's ``prefix_lane``, from a
    :class:`PrefixPool` segment (``pooled=True``: ``pool = (slab,
    slot)``, ``slot < 0`` seeds zeros), or with zeros.  ``seed=False``
    is chunked prefill's continuation: the chunk lands on the lane's
    earlier chunks untouched.  Padded tail slots stay masked until the
    decode loop overwrites them."""
    def admit(cache, rows, lane: int, off: int, *pool):
        view = _lane_view(cache, lane)
        if seed:
            if pooled:
                slab, slot = pool
                _seed_lane(view, None if slot < 0 else
                           {n: a[slot] for n, a in slab.items()})
            else:
                _seed_lane(view, prefix_lane)
        dev = cache["k"].device
        rows = torch.as_tensor(rows, device=dev).long()
        with torch.no_grad():
            _decode_chunk(model_params, view, rows,
                          torch.full((1,), off, dtype=torch.long,
                                     device=dev),
                          model_cfg, uniform_pos=True)
        return cache
    return admit


def _make_lane_reseed(prefix_lane=None, pooled: bool = False):
    """Prefix copy into one lane WITHOUT an admission chunk (a 1-token
    prompt runs no chunk but still needs the prefix K/V)."""
    def reseed(cache, lane: int, *pool):
        if pooled:
            slab, slot = pool
            source = {n: a[slot] for n, a in slab.items()}
        else:
            source = prefix_lane
        _seed_lane(_lane_view(cache, lane), source)
        return cache
    return reseed


class _LaneEngine(_AdmissionMixin, _ElasticMixin):
    """Host-side lane machinery shared by the serving engines: the
    lane table, free/running/drain, the per-step emission loop (append
    to the transcript, stop at budget or the lane's eos), and the
    chunked-prefill scheduler, with the admission-control layer
    (deadlines/TTLs, the bounded FIFO queue with :class:`QueueFull`
    backpressure, structured :class:`RequestResult` reporting, the
    drain-then-shutdown lifecycle) and the elastic-tier bookkeeping.
    An evicted lane just stops being read; its row keeps decoding until
    admission reseeds it, like any done lane."""

    # Engines without a pool leave this None.
    _prefix_pool = None

    def free_lanes(self):
        return [i for i, s in enumerate(self._lane_state) if s is None]

    def running(self):
        return [i for i, s in enumerate(self._lane_state)
                if s is not None and not s.done]

    def drain(self, lane):
        """Return the finished lane's [prompt + generation] tokens and
        free the lane; raises if the lane is still running."""
        st = self._lane_state[lane]
        if st is None:
            raise ValueError(f"lane {lane} is empty")
        if not st.done:
            raise ValueError(f"lane {lane} is still decoding")
        self._vacate(lane)
        self._obs_request_done("ok", st.born, rid=st.request_id)
        return np.asarray(st.tokens, np.int32)

    def _vacate(self, lane) -> None:
        """THE one lane-release path (drain, reap, eviction, shutdown
        cancellation): frees the lane slot, drops it from the chunked-
        admission queue, releases its prefix-pool pin, and hands the
        lane's storage back through :meth:`_release_lane_storage`."""
        st = self._lane_state[lane]
        self._lane_state[lane] = None
        if st is None:
            return
        if st.chunks is not None:
            try:
                self._admitting.remove(lane)
            except ValueError:  # pragma: no cover — defensive
                pass
        if st.prefix_id is not None and self._prefix_pool is not None:
            self._prefix_pool.release(st.prefix_id)
        self._release_lane_storage(lane, st)

    def _release_lane_storage(self, lane, st) -> None:
        """Storage hook of :meth:`_vacate`: a monolithic lane owns a
        fixed cache row (stale and masked until its next admission seeds
        it: nothing to release); the paged engine drops the lane's block
        references here, the ONE place, so no eviction path leaks a
        block."""

    def residency(self) -> dict:
        """The engine's residency digest: resident prefix-pool ids,
        resident paged stem hashes (the paged engine fills them) and the
        live load signals.  Host counters and id lists only (no device
        work), JSON-safe."""
        with self._admission_lock:
            return {
                "engine": type(self).__name__,
                "lanes": self.lanes,
                "model_shards": 1,
                "lanes_busy": len(self.running()),
                "queue_depth": len(self._pending),
                "block": None,
                "prefix_ids": (self._prefix_pool.ids()
                               if self._prefix_pool is not None else []),
                "stem_hashes": [],
                "param_version": 0,
            }

    def memory_footprint(self) -> dict:
        """Param and KV bytes, read from the live tensors (one device,
        so the per-device figures equal the totals)."""
        def nbytes(tree):
            return sum(t.numel() * t.element_size()
                       for _, leaf in named_leaves(tree)
                       for t in ((leaf.q, leaf.s) if isinstance(
                           leaf, QTensor) else (leaf,)))

        p_bytes, kv_bytes = nbytes(self.params), nbytes(self.cache)
        return {"param_bytes": p_bytes, "param_bytes_per_device": p_bytes,
                "kv_bytes": kv_bytes, "kv_bytes_per_device": kv_bytes}

    def _validate_request_args(self, prompt, max_new_tokens: int):
        """The prompt/budget checks every engine's submit() runs —
        one definition (ContinuousBatcher and SpeculativeBatcher must
        not drift); returns the canonicalized 1-D int64 prompt."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must contain at least one token")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        return prompt

    def _emit(self, lane_tokens):
        """Feed each live lane's new tokens (``lane_tokens(lane)``)
        through the transcript/budget/eos bookkeeping; returns the
        ``{lane: [emitted...]}`` step result.  The ONE site that
        counts emitted tokens (``serving.tokens``) — every step path
        funnels through here, so the throughput metric is
        structurally complete, and so are the per-request latency
        signals it derives: ``serving.ttft_s`` (born -> first token,
        queue wait included for managed requests) and
        ``serving.tpot_s`` (inter-token gap per emitted token), plus
        one ``serving.emit`` trace event per emitting lane carrying
        its ``request_id``.  Lanes still ADMITTING
        (pending prefill chunks) are parked: their decode rows are
        burnt compute, never emission."""
        out = {}
        active = obs.active() is not None
        now = self._clock() if active else None
        for lane, st in enumerate(self._lane_state):
            if st is None or st.done or st.chunks is not None:
                continue
            emitted = []
            for tok in lane_tokens(lane):
                st.tokens.append(int(tok))
                emitted.append(int(tok))
                budget = len(st.tokens) - st.prompt_len >= st.max_new
                if budget or (st.eos is not None and tok == st.eos):
                    st.done = True
                    break
            out[lane] = emitted
            if active and emitted:
                first = (len(st.tokens) - st.prompt_len
                         == len(emitted))
                if first and st.born is not None:
                    obs.observe("serving.ttft_s", now - st.born)
                elif st.last_emit is not None:
                    obs.observe("serving.tpot_s",
                                (now - st.last_emit) / len(emitted))
                st.last_emit = now
                obs.event("serving.emit", request_id=st.request_id,
                          lane=lane, n=len(emitted), first=first)
        if active:
            obs.count("serving.tokens",
                      sum(len(v) for v in out.values()))
        return out

    # --------------------------------------------- chunked admission

    def _run_pending_chunk(self) -> None:
        """Execute ONE pending admission chunk (FIFO across admitting
        lanes) — called at the top of every ``step()``, so a long
        prompt's prefill interleaves with decode at one chunk per step
        and the other lanes' inter-token gap stays bounded by one
        chunk.  Completing the last chunk un-parks the lane: its
        position/current-token are set and it joins THIS step's decode
        (the same "admission then the next step processes the final
        prompt token" convention as monolithic admission)."""
        if not self._admitting:
            return
        lane = self._admitting[0]
        st = self._lane_state[lane]
        start, rows = st.chunks.pop(0)
        with obs.span("serving.admit_chunk", bucket=rows.shape[1],
                      remaining=len(st.chunks),
                      request_id=st.request_id):
            self._exec_chunk(lane, start, rows)
        if not st.chunks:
            self._admitting.popleft()
            st.chunks = None
            self._finish_admission(lane, st)

    def _exec_chunk(self, lane, start, rows):  # pragma: no cover
        raise NotImplementedError(
            "this engine does not support chunked prefill")

    def _finish_admission(self, lane, st):  # pragma: no cover
        raise NotImplementedError(
            "this engine does not support chunked prefill")




__all__ = ["_Lane", "_LaneEngine", "_make_lane_admit", "_make_lane_reseed"]

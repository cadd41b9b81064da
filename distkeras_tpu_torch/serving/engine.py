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
import hashlib
import math

import numpy as np
import torch

from distkeras_tpu_torch import obs
from distkeras_tpu_torch.models.generate import _decode_chunk, local_kv_heads
from distkeras_tpu_torch.models.quant import QTensor
from distkeras_tpu_torch.models.transformer import named_leaves
from distkeras_tpu_torch.parallel import collectives as C
from distkeras_tpu_torch.parallel.layout import Layout, Sharded, Views, views
from distkeras_tpu_torch.parallel.mesh import _backend_device
from distkeras_tpu_torch.parallel.rules import serving_kv_axis
from distkeras_tpu_torch.parallel.tree import (tree_flatten,
                                               tree_flatten_with_names,
                                               tree_unflatten)
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


def _tensor_leaves(tree):
    """``(tensors, spec)``: a param tree's leaves in JAX's order, an int8
    :class:`QTensor` contributing its values and then its scales."""
    leaves, spec = tree_flatten(tree)
    out = []
    for x in leaves:
        out += [x.q, x.s] if isinstance(x, QTensor) else [x]
    return out, spec


def _own_params(tree):
    """A copy of a param tree that shares no storage with it, where it
    lives.  A ``hot_swap`` engine serves its own copy: :meth:`_LaneEngine.
    swap_params` writes into the live leaves, so engines built on one
    tree (and the caller's tree) must not alias them."""
    leaves, spec = tree_flatten(tree)
    out = tree_unflatten(spec, [
        QTensor(x.q.clone(), x.s.clone()) if isinstance(x, QTensor)
        else x.clone() if isinstance(x, torch.Tensor) else x
        for x in leaves])
    if isinstance(tree, Views):  # a sharded engine's view keeps its axis
        out = Views(out)
        out.tp = tree.tp
    return out


def _host_leaf(x) -> torch.Tensor:
    """A pushed leaf as a tensor: torch tensors as they are, anything
    else (numpy) copied into a host tensor."""
    return x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))


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
    # Live weight push: engines built with ``hot_swap=True`` take
    # :meth:`swap_params`.  ``param_version`` is 0 until the first swap;
    # every engine carries it (the router's fleet snapshot reads it).
    _hot_swap = False
    param_version = 0

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

    # Sharded serving: set by _setup_plan for plan= / mesh= engines.
    mesh = None
    plan = None
    _kv_axis = None
    _placed = None

    def _setup_plan(self, params, cfg, plan, mesh):
        """Validate ``plan=`` / ``mesh=`` (the reference's checks) and
        return the params the engine computes with: ``params`` itself
        unsharded, else the compute view of their placement under the
        plan (a tree placed already keeps its layout)."""
        if (plan is None) != (mesh is None):
            raise ValueError(
                "pass plan= and mesh= together: the plan's rules only "
                "mean something against a concrete mesh (use "
                "parallel.sharding.serving_plan() for the standard TP "
                "layout)")
        self.plan, self.mesh = plan, mesh
        if plan is None:
            return params
        if cfg.attention_window is not None:
            raise ValueError(
                "pod-sharded serving needs a full-cache config "
                "(no attention_window): the ring slab's rolling "
                "scatter has no stable sharded layout to pin")
        self._kv_axis = serving_kv_axis(plan, mesh, cfg)
        self._placed = (params if isinstance(params, Sharded)
                        else Layout(plan, mesh, params, stages=False,
                                    experts=False).shard(params))
        return views(self._placed)

    def _kv_heads(self):
        """The kv heads of this rank's cache (every head unsharded)."""
        return local_kv_heads(self.params, self.cfg)

    def _check_same_call(self, what: str, *values) -> None:
        """SPMD guard of a sharded engine: every rank must make the same
        call with the same values; a digest compared over the mesh
        raises on every rank, naming the call, when they differ (a
        diverged stream would otherwise hang in a collective)."""
        if self.mesh is None or self.mesh.world_size == 1:
            return
        blob = repr([np.asarray(v).tolist() if isinstance(
            v, (np.ndarray, list, tuple)) else v for v in values])
        h = int.from_bytes(hashlib.blake2b(blob.encode(),
                                           digest_size=7).digest(), "big")
        world = self.mesh.whole()
        dev = _backend_device(world.group)
        lo = C.all_reduce(torch.tensor([h], device=dev), world,
                          torch.distributed.ReduceOp.MIN)
        hi = C.all_reduce(torch.tensor([h], device=dev), world,
                          torch.distributed.ReduceOp.MAX)
        if int(lo) != int(hi):
            raise ValueError(
                f"{type(self).__name__}.{what}: the ranks of the mesh made "
                "different calls (a sharded engine runs SPMD: every rank "
                "must submit the same requests in the same order)")

    def residency(self) -> dict:
        """The engine's residency digest: resident prefix-pool ids,
        resident paged stem hashes (the paged engine fills them) and the
        live load signals.  Host counters and id lists only (no device
        work), JSON-safe."""
        with obs.held(self._admission_lock):
            return {
                "engine": type(self).__name__,
                "lanes": self.lanes,
                "model_shards": (int(self.mesh.shape[self._kv_axis])
                                 if self._kv_axis is not None else 1),
                "lanes_busy": len(self.running()),
                "queue_depth": len(self._pending),
                "block": None,
                "prefix_ids": (self._prefix_pool.ids()
                               if self._prefix_pool is not None else []),
                "stem_hashes": [],
                "param_version": self.param_version,
            }

    def swap_params(self, new_params, version: int,
                    allow_downgrade: bool = False) -> int:
        """Replace the engine's weights BETWEEN steps, in place.

        Every new leaf is copied into the live leaf tensor, so the swap
        allocates nothing on the device and no tensor changes address.
        A sharded engine takes the full tree (every rank the same, in
        the same call) and copies into its compute view: this rank's
        block of each natively split leaf, every other leaf whole.
        The live leaves are the engine's own (``hot_swap=True`` copies
        the tree it was built on, once, at construction), so a swap
        changes no other engine and not the caller's tree
        (the admission and decode paths hold the same tensors and read
        the new values; a captured decode step stays valid).  In-flight
        requests continue on the new weights over their existing K/V:
        tokens emitted under version N are functions of version N.

        ``version`` must be strictly greater than ``param_version``
        unless ``allow_downgrade=True`` (the canary rollback).  The tree
        is validated leaf for leaf (structure, shape, dtype) and every
        leaf is staged as a tensor before the first copy, so a refused
        swap leaves the engine on its old weights bit for bit.  Returns
        the new ``param_version``."""
        if not self._hot_swap:
            raise ValueError(
                "engine was built without hot_swap=True: rebuild with "
                "hot_swap=True for live weight push")
        version = int(version)
        with obs.held(self._admission_lock):
            if version <= self.param_version and not allow_downgrade:
                raise ValueError(
                    f"swap_params(version={version}) <= live version "
                    f"{self.param_version}: versions are monotone "
                    "(rollback passes allow_downgrade=True)")
            if self._placed is not None:  # the full tree -> the view
                lay = self._placed.layout
                named, spec = tree_flatten_with_names(new_params)
                new_params = tree_unflatten(spec, [
                    lay.view_leaf(n, _host_leaf(x)) if n in lay.specs
                    else x for n, x in named])
            old_leaves, old_spec = _tensor_leaves(self.params)
            new_leaves, new_spec = _tensor_leaves(new_params)
            if old_spec != new_spec or len(old_leaves) != len(new_leaves):
                raise ValueError(
                    "swap_params: param tree structure changed — a push "
                    "must carry the exact geometry the engine serves")
            staged = []
            for i, (o, nw) in enumerate(zip(old_leaves, new_leaves)):
                t = _host_leaf(nw)
                if tuple(t.shape) != tuple(o.shape) or t.dtype != o.dtype:
                    raise ValueError(
                        f"swap_params: leaf {i} is [{tuple(t.shape)} "
                        f"{t.dtype}], the engine serves [{tuple(o.shape)} "
                        f"{o.dtype}]")
                staged.append(t)
            with torch.no_grad():
                for o, t in zip(old_leaves, staged):
                    if t.data_ptr() != o.data_ptr():
                        o.copy_(t)
            old = self.param_version
            self.param_version = version
            obs.count("serving.param_swaps")
            obs.event("serving.param_swap", version=version,
                      from_version=old, engine=type(self).__name__)
            return version

    def memory_footprint(self) -> dict:
        """Param and KV bytes, total and on this device, read from the
        live tensors.  Unsharded, the per-device figures equal the
        totals; sharded, the per-device ones are this rank's placed
        slices and cache heads (the reference's addressable-shard
        count; the compute view's gathered embeddings are not part of
        the placement)."""
        def nbytes(tree):
            return sum(t.numel() * t.element_size()
                       for _, leaf in named_leaves(tree)
                       for t in ((leaf.q, leaf.s) if isinstance(
                           leaf, QTensor) else (leaf,)))

        if self._placed is None:
            p_bytes, kv_bytes = nbytes(self.params), nbytes(self.cache)
            return {"param_bytes": p_bytes,
                    "param_bytes_per_device": p_bytes,
                    "kv_bytes": kv_bytes, "kv_bytes_per_device": kv_bytes}
        lay = self._placed.layout
        p_total = sum(math.prod(lay.full_shapes[n]) * t.element_size()
                      for n, t in named_leaves(self._placed))
        kv_dev = nbytes(self.cache)
        split = (int(self.mesh.shape[self._kv_axis])
                 if self._kv_axis is not None else 1)
        return {"param_bytes": p_total,
                "param_bytes_per_device": nbytes(self._placed),
                "kv_bytes": kv_dev * split, "kv_bytes_per_device": kv_dev}

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
        width = rows.shape[1]
        with obs.span("serving.admit_chunk", bucket=width,
                      tokens=min(width, st.prompt_len - 1 - (start - st.off)),
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

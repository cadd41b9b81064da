"""Paged KV: a block-granular cache with per-lane page tables.

The port's counterpart of ``distkeras_tpu/serving/paged.py``.  The
monolithic engine gives every lane a full ``[max_len]`` KV row, so memory
caps the lane count, and two requests with a common stem share nothing
unless it was registered in a :class:`PrefixPool`.  Here:

- **One slab of fixed-size blocks.**  The whole cache is ONE allocation
  of ``n_blocks`` blocks of ``block`` positions (``[L, n_blocks, block,
  kv_heads, head_dim]`` per leaf: ``init_cache`` at ``batch=n_blocks,
  max_len=block``, int8 scale leaves included).  Block 0 is the TRASH
  block: unallocated page-table entries point at it, so idle, done and
  parked lanes' clamped writes and admission pad writes land there.
- **Per-lane page tables.**  Each lane maps logical block ``k`` to a slab
  block.  The host owns the authoritative numpy tables (the allocator is
  host bookkeeping) and pushes a copy to the device when they change.
- **The step gathers, runs the shared body, scatters.**  A ``step(n)``
  window gathers every lane's contiguous ``[max_len]`` view through its
  table (``index_select`` on the block axis, then a reshape: exactly the
  monolithic cache's shape and layout), runs
  :meth:`ContinuousBatcher._decode_window` over it (one definition of
  the per-token body), and writes back only the window's ``n`` new
  positions with ``index_put_`` at ``(block, offset)``.  ``block`` must
  divide ``max_len``, so greedy and seeded-sampled tokens are the
  monolithic engine's exactly.
- **Content-hash stem sharing at admission.**  Every full block of warm
  prompt tokens is chain-hashed (:mod:`.residency`); a prompt whose
  prefix hashes to resident blocks refcounts them and prefills only the
  rest.  Pinned prefixes (:meth:`PagedBatcher.pin_prefix`) are
  refcount-held block runs in the same slab.  A hash registers only once
  its block's content has been dispatched (chunked prefill lands over
  several steps).
- **Copy-on-write fork** (:meth:`PagedBatcher.fork`): full blocks are
  shared, only the partial tail block is copied.

The invariant all of it leans on: a block becomes shared (stem hit, pin,
fork) only when it lies wholly BELOW its owner's write frontier, and
every write lands at or above the writer's frontier (or in trash), so a
shared block is immutable while shared.

Allocator exhaustion is backpressure: admission declines (``enqueue``
queues, then raises :class:`QueueFull`); a lane that cannot grow
mid-decode is evicted with a structured ``"error"`` result and its
private blocks return to the free list (shared blocks survive).

The gather materializes a ``[lanes, max_len]`` working view per window,
so per-step memory traffic is higher than the monolithic read: the gain
is resident bytes (lanes at a fixed slab), sharing and O(block) forks.
The gather, scatter and block copy are torch indexing ops, as they are
plain array ops in the reference; ``kv_int8="prefill"`` admission runs
:func:`prefill`, whose attention is the flash forward kernel on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from distkeras_tpu_torch import obs
from distkeras_tpu_torch.models.generate import (_decode_chunk, _not_ported,
                                                 init_cache, prefill)
from distkeras_tpu_torch.models.quant import is_quantized
from distkeras_tpu_torch.models.transformer import TransformerConfig
from distkeras_tpu_torch.serving.disagg import (BlockShipment,
                                                leaf_dtype_names)
from distkeras_tpu_torch.serving.engine import _Lane
from distkeras_tpu_torch.serving.lanes import ContinuousBatcher
from distkeras_tpu_torch.serving.prefix import PinnedStems
from distkeras_tpu_torch.serving.residency import chain_hash, stem_hashes
from distkeras_tpu_torch.utils.locks import TracedRLock
from distkeras_tpu_torch.utils.serialization import (dtype_name, from_words,
                                                     host_words)

# Physical block 0 is never handed out: unallocated page-table entries
# read it (masked anyway) and redirected pad/clamp writes land in it.
TRASH_BLOCK = 0

# kv_int8="prefill" parity bound: max |logit delta| of the first decode
# step after a prefill-BUILT int8 admission against the decode-built
# cache (the reference's constant, measured on its d32 / L2 test config).
KV_INT8_PREFILL_LOGIT_TOL = 0.05


def _gather_view(leaf, tables):
    """``leaf [L, N, B, ...]`` gathered through ``tables [rows, mb]``
    into the contiguous per-lane view ``[L, rows, mb*B, ...]`` the shared
    decode body expects (a fresh contiguous tensor, laid out as the
    monolithic cache)."""
    g = leaf.index_select(1, tables.reshape(-1))
    return g.reshape((leaf.shape[0], tables.shape[0],
                      tables.shape[1] * leaf.shape[2]) + leaf.shape[3:])


class BlockAllocator:
    """Host-side refcounted block allocator with content-hash residency.

    A block is **live** (refcount > 0: a lane's page table, a pinned
    stem or a fork holds it) or on the **free list** (refcount 0).  A
    freed block keeps its content hash until the free list recycles it,
    so a later request can revive it by hash.  ``alloc`` pops the oldest
    free block and purges its hash; ``share_by_hash`` revives or
    refcounts a resident block.  A leaf lock makes it thread-safe
    (engines call it under their admission lock).
    """

    def __init__(self, n_blocks: int, block: int, reserved: int = 1):
        if n_blocks <= reserved:
            raise ValueError(
                f"n_blocks ({n_blocks}) must exceed the {reserved} "
                "reserved trash block(s)")
        self.block = int(block)
        self.n_blocks = int(n_blocks)
        self.capacity = self.n_blocks - reserved
        # dict-as-ordered-set: FIFO free list with O(1) revival.
        self._free: dict[int, None] = dict.fromkeys(
            range(reserved, n_blocks))
        self._refs: dict[int, int] = {}
        self._hash_of: dict[int, bytes] = {}
        self._by_hash: dict[bytes, int] = {}
        self._lock = TracedRLock("serving.kv_allocator")

    # ------------------------------------------------------ lifecycle

    def alloc(self) -> int | None:
        """Pop the oldest free block (purging any resident hash) with one
        reference, or None when exhausted: the backpressure signal, never
        an exception (the engine decides the policy)."""
        with self._lock:
            if not self._free:
                return None
            bid = next(iter(self._free))
            del self._free[bid]
            h = self._hash_of.pop(bid, None)
            if h is not None and self._by_hash.get(h) == bid:
                del self._by_hash[h]
            self._refs[bid] = 1
            return bid

    def free(self, bid: int) -> None:
        """Drop one reference; at zero the block moves to the free list
        (its hash stays resident until recycled)."""
        with self._lock:
            r = self._refs.get(bid)
            if r is None:
                raise ValueError(f"block {bid} is not live (double "
                                 "free, or never allocated)")
            if r > 1:
                self._refs[bid] = r - 1
            else:
                del self._refs[bid]
                self._free[bid] = None

    def share(self, bid: int) -> None:
        """One more reference to a LIVE block (fork / pin)."""
        with self._lock:
            if bid not in self._refs:
                raise ValueError(f"block {bid} is not live")
            self._refs[bid] += 1

    def share_by_hash(self, digest: bytes) -> int | None:
        """Refcount the resident block holding ``digest``'s content
        (reviving it off the free list if unreferenced); None on a
        miss."""
        with self._lock:
            bid = self._by_hash.get(digest)
            if bid is None:
                return None
            if bid in self._free:
                del self._free[bid]
                self._refs[bid] = 1
            else:
                self._refs[bid] += 1
            return bid

    def register(self, bid: int, digest: bytes) -> None:
        """Publish a live block's content hash for sharing.  First writer
        wins: if the digest is mapped already (two identical admissions
        that both missed), the second block stays private."""
        with self._lock:
            if bid not in self._refs:
                raise ValueError(f"block {bid} is not live")
            if digest in self._by_hash:
                return
            old = self._hash_of.pop(bid, None)
            if old is not None and self._by_hash.get(old) == bid:
                del self._by_hash[old]
            self._hash_of[bid] = digest
            self._by_hash[digest] = bid

    # ----------------------------------------------------- inspection

    def refs_of(self, bid: int) -> int:
        with self._lock:
            return self._refs.get(bid, 0)

    def resident_hashes(self) -> list[bytes]:
        """Every digest resident now (live, or free but not yet
        recycled: both hit on :meth:`share_by_hash`)."""
        with self._lock:
            return list(self._by_hash)

    def stats(self) -> dict:
        """``used`` / ``free`` / ``shared`` block counts (shared = live
        with more than one reference) and hash residency."""
        with self._lock:
            return {
                "capacity": self.capacity,
                "used": len(self._refs),
                "free": len(self._free),
                "shared": sum(1 for r in self._refs.values() if r > 1),
                "resident_hashes": len(self._by_hash),
            }


class PagedBatcher(ContinuousBatcher):
    """:class:`ContinuousBatcher` on block-granular paged KV storage.

    The same host API (``submit`` / ``enqueue`` / ``step`` / ``drain``,
    admission control, ``per_request_sampling``, chunked prefill,
    elastic ``lane_tiers``) and the same contract: every request's tokens
    are the monolithic engine's and its solo ``generate``'s.  Plus:

    - ``block`` / ``n_blocks``: the slab geometry.  ``block`` must divide
      ``cfg.max_len``; ``n_blocks`` defaults to the monolithic-equivalent
      ``lanes * max_len / block + 1`` (the top tier's lanes on elastic
      engines).  Shrink it to serve more lanes than monolithic memory
      allows, at the price of ``QueueFull`` backpressure when blocks run
      dry and ``"error"`` eviction if a lane cannot grow mid-decode.
    - **stem sharing** is automatic; :meth:`pin_prefix` /
      :meth:`unpin_prefix` hold a prefix's blocks in the slab.
    - :meth:`fork`: copy-on-write lane fork.
    - ``kv_int8``: ``True`` is the decode-built int8 cache (the
      monolithic ``kv_int8=True`` engine's tokens); ``"prefill"`` also
      builds a from-scratch single-chunk admission through
      ``prefill(kv_int8=True)`` (the flash forward kernel on the card):
      full-precision in-chunk attention, quantized once, within
      :data:`KV_INT8_PREFILL_LOGIT_TOL` on the first step's logits.
    - ``lane_tiers=``: a tier move gathers the per-lane rows only and
      remaps the page tables on the host; the slab never moves.
      :meth:`fork` is refused there (lane ids move on a resize).

    Not supported: ``attention_window`` (a ring slot has no stable block
    identity), ``prompt_cache=`` / ``prefix_pool=`` (pinned stems subsume
    them).  :meth:`export_blocks` / :meth:`import_blocks`: the two halves
    of disaggregated serving (a stem's blocks read off one slab, shipped,
    and spliced into another).  Not ported yet: ``plan=`` / ``mesh=``
    (ROADMAP A7b) and ``traced_for_analysis`` (A11).  Runs on ``device``
    (the card unless ``device="cpu"``), where the params must already
    live.
    """

    def __init__(self, params, cfg: TransformerConfig, lanes: int = 8,
                 block: int = 16, n_blocks: int | None = None,
                 temperature: float = 0.0, top_k=None, top_p=None,
                 min_p=None, eos_token=None, exact_top_k: bool = False,
                 prompt_buckets=(8, 32, 128, 512), kv_int8=False,
                 per_request_sampling: bool = False,
                 max_queue: int = 0, clock=None,
                 lane_tiers=None, scale_up_after: int = 2,
                 scale_down_after: int = 8, step_windows=(1,),
                 prefill_chunk: int | None = None, plan=None,
                 mesh=None, device=None):
        if plan is not None or mesh is not None:
            raise _not_ported("pod-sharded paging (plan= / mesh=)", "A7b")
        if cfg.attention_window is not None:
            raise ValueError(
                "paged KV needs a full-cache config (no "
                "attention_window): a ring slot has no stable block "
                "identity to share or fork")
        block = int(block)
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        if cfg.max_len % block:
            raise ValueError(
                f"block ({block}) must divide max_len ({cfg.max_len}): "
                "the page-table gather must tile the position axis "
                "exactly or the step's mask arithmetic (and the parity "
                "contract) would drift from the monolithic engine")
        if kv_int8 not in (False, True, "prefill"):
            raise ValueError(
                f'kv_int8 must be False, True, or "prefill", got '
                f"{kv_int8!r}")
        self.kv_int8_prefill = kv_int8 == "prefill"
        if self.kv_int8_prefill and is_quantized(params):
            raise ValueError(
                'kv_int8="prefill" runs the batched prefill forward at '
                "admission, which needs full-precision params "
                "(decode-built kv_int8=True composes with int8 weights)")
        self.block = block
        self._mb = cfg.max_len // block
        if n_blocks is None:
            # Monolithic-equivalent: every lane can hold max_len tokens
            # (elastic engines: the top tier's lanes; the slab never
            # resizes).  The paged win comes from shrinking it.
            cap = max(int(t) for t in lane_tiers) if lane_tiers else lanes
            n_blocks = cap * self._mb + 1
        self.n_blocks = int(n_blocks)
        self._alloc = BlockAllocator(self.n_blocks, block)
        # Admission bookkeeping by lane: the warm frontier the pad
        # redirect uses, and hashes waiting for their block's content to
        # be dispatched before they may be shared.
        self._lane_limit: dict[int, int] = {}
        self._pending_hashes: dict[int, list] = {}
        self._stems = PinnedStems()
        # Cumulative admission stem hits (blocks refcounted instead of
        # prefilled); the serving.stem_hit_blocks counter mirrors it.
        self.stem_hit_blocks = 0
        super().__init__(params, cfg, lanes=lanes,
                         temperature=temperature, top_k=top_k,
                         top_p=top_p, min_p=min_p, eos_token=eos_token,
                         exact_top_k=exact_top_k,
                         prompt_buckets=prompt_buckets,
                         kv_int8=bool(kv_int8),
                         per_request_sampling=per_request_sampling,
                         max_queue=max_queue, clock=clock,
                         lane_tiers=lane_tiers,
                         scale_up_after=scale_up_after,
                         scale_down_after=scale_down_after,
                         step_windows=step_windows,
                         prefill_chunk=prefill_chunk, device=device)

    # ------------------------------------------------ storage layout

    def _fresh_cache(self, lanes: int):
        # The slab's capacity is n_blocks, independent of the lane count
        # (that decoupling IS the feature).
        del lanes
        slab_cfg = dataclasses.replace(self.cfg, max_len=self.block)
        return init_cache(slab_cfg, self.n_blocks, kv_int8=self.kv_int8,
                          device=self.device)

    def _init_device_state(self, lanes: int) -> None:
        super()._init_device_state(lanes)
        self._lane_blocks: list[list[int]] = [[] for _ in range(lanes)]
        self._tables_np = np.zeros((lanes, self._mb), np.int64)
        self._push_tables()

    def _push_tables(self) -> None:
        self.tables = self._to_device(self._tables_np)

    def _to_device(self, table) -> torch.Tensor:
        """A device copy of a host page table.  The host copy is
        authoritative and keeps mutating, so the push copies it first:
        on the card into pinned memory (``pin_memory`` copies), from
        which the transfer runs asynchronously, without waiting for the
        queued device work as a copy from pageable memory would."""
        t = torch.from_numpy(table)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    # ------------------------------------------------- elastic tiers

    def _resize_state(self, idx) -> None:
        # Rows only: the slab is lane-count-independent, so a tier move
        # gathers the per-lane rows and remaps the page tables on the
        # host (occupied lanes move to the low slots in index order, as
        # _resize_to compacts _lane_state; fresh lanes arrive with empty
        # block lists and all-TRASH tables).  Refcounts are untouched.
        self._resize_rows(idx)
        tier = len(idx)
        keep = [i for i, s in enumerate(self._lane_state) if s is not None]
        blocks: list[list[int]] = [[] for _ in range(tier)]
        tables = np.full((tier, self._mb), TRASH_BLOCK, np.int64)
        limits: dict[int, int] = {}
        pending: dict[int, list] = {}
        for j, i in enumerate(keep):
            blocks[j] = self._lane_blocks[i]
            tables[j] = self._tables_np[i]
            if i in self._lane_limit:
                limits[j] = self._lane_limit[i]
            if i in self._pending_hashes:
                pending[j] = self._pending_hashes[i]
        self._lane_blocks = blocks
        self._tables_np = tables
        self._lane_limit = limits
        self._pending_hashes = pending
        self._push_tables()

    # ------------------------------------------------- device programs

    def _dispatch_step(self, n: int):
        """Grow the lanes' block lists for this window, gather every
        lane's view through the tables, run the shared window body over
        it, scatter the window's ``n`` positions per lane back to the
        slab (clamped at ``max_len - 1`` as the body's advance clamps:
        duplicate clamp writes carry identical values), then ONE
        device-to-host copy of the token matrix."""
        self._ensure_growth(n)
        pos0 = self.pos
        view = {name: _gather_view(a, self.tables)
                for name, a in self.cache.items()}
        toks = self._decode_window(view, n)
        ar = torch.arange(n, device=self.device)
        q = torch.clamp(pos0[:, None] + ar, max=self.cfg.max_len - 1)
        blk = self.tables.gather(1, q // self.block)      # [lanes, n]
        off = q % self.block
        lane = torch.arange(self.lanes, device=self.device)[:, None]
        with torch.no_grad():
            for name, a in self.cache.items():
                a[:, blk, off] = view[name][:, lane, q]
        return toks.cpu().numpy()

    def _build_admission_programs(self) -> None:
        params, cfg, B = self.params, self.cfg, self.block

        def admit(row, rows, start: int, limit: int):
            # The lane's view is gathered, the chunk runs the SAME
            # uniform-position _decode_chunk as monolithic admission, and
            # the chunk span scatters back: pad positions past the warm
            # frontier ``limit`` redirect to the trash block, so
            # allocated blocks hold live tokens only.  Fresh blocks need
            # no zeroing: stale content is masked until overwritten, the
            # monolithic lane-reuse argument.
            view = {name: _gather_view(a, row[None])
                    for name, a in self.cache.items()}
            w = rows.shape[1]
            with torch.no_grad():
                _decode_chunk(params, view, rows,
                              torch.full((1,), start, dtype=torch.long,
                                         device=rows.device),
                              cfg, uniform_pos=True)
                q = start + torch.arange(w, device=rows.device)
                self._write_span(row, q, limit,
                                 {n: v[:, 0] for n, v in view.items()})

        self._admit = admit
        # The chunked-prefill continuation IS the same step; no prefix
        # seeding exists on the slab.
        self._admit_cont = self._reseed = self._reseed_pool = None

        self._admit_prefill = None
        if self.kv_int8_prefill:
            def admit_prefill(row, rows, limit: int):
                # A from-scratch single chunk through the batched prefill
                # forward (the flash kernel on the card): full-precision
                # attention, quantized once at the end.
                cache, _ = prefill(params, rows, cfg, last_logits=False,
                                   kv_int8=True, device=self.device)
                w = rows.shape[1]
                with torch.no_grad():
                    self._write_span(
                        row, torch.arange(w, device=rows.device), limit,
                        {n: c[:, 0] for n, c in cache.items()})
            self._admit_prefill = admit_prefill

    def _write_span(self, row, q, limit: int, src) -> None:
        """Write positions ``q`` of one lane's view (``src[name]`` ``[L,
        S, ...]``) into its blocks through table ``row``; positions at or
        past the warm frontier ``limit`` go to the trash block."""
        blk = torch.where(q < limit, row[q // self.block], TRASH_BLOCK)
        off = q % self.block
        for name, a in self.cache.items():
            a[:, blk, off] = src[name][:, q]

    def _copy_block(self, src: int, dst: int) -> None:
        # The CoW fork's divergent-tail copy: O(block) bytes.
        with torch.no_grad():
            for a in self.cache.values():
                a[:, dst] = a[:, src]

    # ----------------------------------------------------- admission

    def _stage_blocks(self, tokens, warm: int):
        """The ONE stem-share + allocate staging path (admission AND
        :meth:`pin_prefix`): chain-hash the full blocks of
        ``tokens[:warm]``, refcount the longest resident hashed prefix,
        resolve the chunk plan for the rest, and allocate fresh blocks
        for it.  Returns ``(blocks, shared, hashes, plan)``, or None when
        the allocator is exhausted, with every reference this attempt
        took rolled back.

        A stem hit must never make a valid request unplannable: if no
        admission bucket fits the unshared span at the skip offset,
        shared blocks are handed back from the end until the plan fits
        (skip 0 was validated by ``_validate_budget``)."""
        B = self.block
        hashes, digest = [], b""
        for k in range(warm // B):
            digest = chain_hash(digest, tokens[k * B:(k + 1) * B])
            hashes.append(digest)
        shared_blocks = []
        for h in hashes:
            bid = self._alloc.share_by_hash(h)
            if bid is None:
                break
            shared_blocks.append(bid)
        while shared_blocks:
            try:
                plan = self._chunk_plan(0, warm,
                                        skip=len(shared_blocks) * B)
                break
            except ValueError:
                self._alloc.free(shared_blocks.pop())
        else:
            plan = self._chunk_plan(0, warm)
        shared = len(shared_blocks)
        need = (-(-warm // B) - shared) if warm else 0
        fresh = []
        for _ in range(need):
            bid = self._alloc.alloc()
            if bid is None:
                # Exhausted: no half-staged lane, no leak.
                for b in fresh + shared_blocks:
                    self._alloc.free(b)
                return None
            fresh.append(bid)
        return shared_blocks + fresh, shared, hashes, plan

    def _admission_plan(self, lane, prompt, off: int, warm: int):
        assert off == 0, "paged engines carry no engine-level prefix"
        staged = self._stage_blocks(prompt, warm)
        if staged is None:
            return None   # DECLINE: the caller surfaces kv_blocks
        blocks, shared, hashes, plan = staged
        self._lane_blocks[lane] = blocks
        self._lane_limit[lane] = warm
        # Fresh full blocks become shareable once their content has been
        # dispatched (_register_written).
        self._pending_hashes[lane] = [(k, hashes[k]) for k in
                                      range(shared, warm // self.block)]
        row = self._tables_np[lane]
        row[:] = TRASH_BLOCK
        row[:len(blocks)] = blocks
        self._push_tables()
        if shared:
            self.stem_hit_blocks += shared
            obs.count("serving.stem_hit_blocks", shared)
            obs.event("serving.stem_hit", lane=lane, shared_blocks=shared,
                      shared_tokens=shared * self.block)
        self._obs_blocks()
        return plan

    def _abort_admission(self, lane) -> None:
        if self._lane_state[lane] is not None:
            return  # committed; the failure happened later
        self._release_lane_storage(lane, None)

    def _exec_admit(self, lane, start, rows, slot) -> None:
        assert slot is None  # no prefix pool on paged engines
        self._exec_chunk(lane, start, rows)

    def _exec_chunk(self, lane, start, rows) -> None:
        limit = self._lane_limit[lane]
        row = self._to_device(self._tables_np[lane])
        rows = torch.as_tensor(rows, device=self.device).long()
        w = rows.shape[1]
        if (self._admit_prefill is not None and start == 0
                and w >= limit):
            # From-scratch single-chunk admission under
            # kv_int8="prefill".  Chunked continuations and stem-shared
            # tails keep the decode-built path (they attend PRIOR cache,
            # which prefill cannot).
            self._admit_prefill(row, rows, limit)
        else:
            self._admit(row, rows, start, limit)
        self._register_written(lane, min(start + w, limit))

    def _register_written(self, lane, end: int) -> None:
        pend = self._pending_hashes.get(lane)
        if not pend:
            return
        blocks = self._lane_blocks[lane]
        keep = []
        for k, h in pend:
            if (k + 1) * self.block <= end:
                self._alloc.register(blocks[k], h)
            else:
                keep.append((k, h))
        self._pending_hashes[lane] = keep

    # -------------------------------------------------- decode growth

    def _ensure_growth(self, n: int) -> None:
        """Allocate the blocks this window's writes need, per live lane.
        A lane the allocator cannot grow is evicted with a structured
        ``"error"`` result; its private blocks return to the free list at
        once (possibly unblocking the other lanes), shared blocks
        survive."""
        changed = False
        for lane, st in enumerate(self._lane_state):
            if st is None or st.done or st.chunks is not None:
                continue
            pos = st.off + len(st.tokens) - 1
            # The last K/V write the REQUEST can need: its final emitted
            # token is never processed, so the frontier stops at prompt +
            # max_new - 2.  Window positions past it are discarded
            # garbage that redirects to trash.
            last = min(pos + n - 1, self.cfg.max_len - 1,
                       st.off + st.prompt_len + st.max_new - 2)
            hi = last // self.block
            blocks = self._lane_blocks[lane]
            while len(blocks) <= hi:
                bid = self._alloc.alloc()
                if bid is None:
                    obs.count("serving.kv_oom_evictions")
                    obs.event("serving.kv_oom_evict", lane=lane,
                              request_id=st.request_id,
                              live_tokens=len(st.tokens))
                    self._finish(
                        st.request_id, st.tokens, "error",
                        st.prompt_len,
                        error="KV block allocator exhausted mid-growth: "
                              "raise n_blocks, lower lane count, or "
                              "bound request budgets",
                        born=st.born)
                    self._vacate(lane)
                    break
                blocks.append(bid)
                self._tables_np[lane, len(blocks) - 1] = bid
                changed = True
        if changed:
            self._push_tables()
            self._obs_blocks()

    def _release_lane_storage(self, lane, st) -> None:
        del st
        for bid in self._lane_blocks[lane]:
            self._alloc.free(bid)
        self._lane_blocks[lane] = []
        self._pending_hashes.pop(lane, None)
        self._lane_limit.pop(lane, None)
        self._tables_np[lane, :] = TRASH_BLOCK
        self._push_tables()
        self._obs_blocks()

    # -------------------------------------------------- CoW forking

    def fork(self, lane: int, token: int, key=None):
        """Copy-on-write fork of a live lane into a free lane; returns
        the new lane id, or None under backpressure (no free lane, no
        free block).

        The fork diverges at the source's CURRENT position: its
        transcript is the source's with the LAST token replaced by
        ``token`` (``st.tokens[-1]`` gives an exact replica: a
        speculative checkpoint; the runner-up token gives a beam branch).
        Full blocks below the write frontier are refcount-shared; only
        the partially written tail block is copied.  ``key`` is the
        fork's sampling seed on sampling engines (the port's per-request
        seed in the reference's ``key`` place; a fork replaying its
        source's seed and positions would replay its draws).

        The forked lane is a bare-submit occupant: poll it with
        ``running()`` and collect it with ``drain()``.  Refused on
        elastic (``lane_tiers=``) engines: a resize moves lane ids."""
        if self.lane_tiers is not None:
            raise ValueError(
                "fork() is not available on elastic (lane_tiers=) paged "
                "engines: a tier resize compacts lane ids, so the lane id "
                "fork returns could silently dangle — use a fixed lanes= "
                "engine to fork")
        with obs.held(self._admission_lock):
            self._check_open()
            st = self._lane_state[lane]
            if st is None:
                raise ValueError(f"lane {lane} is empty")
            if st.chunks is not None:
                raise ValueError(
                    f"lane {lane} is still admitting (fork after its "
                    "prefill chunks land)")
            if st.done:
                raise ValueError(
                    f"lane {lane} already finished; drain it instead")
            token = int(token)
            if not 0 <= token < self.cfg.vocab_size:
                raise ValueError(
                    f"fork token {token} outside vocab "
                    f"[0, {self.cfg.vocab_size})")
            if key is not None and not (self.temperature > 0
                                        or self.per_request_sampling):
                raise ValueError(
                    "fork key= needs a sampling engine (greedy engines "
                    "carry no per-lane seeds)")
            free = self.free_lanes()
            if not free:
                self._decline_full()
                return None
            dst = free[0]
            frontier = st.off + len(st.tokens) - 1   # written slots
            j = frontier // self.block
            src_blocks = self._lane_blocks[lane]
            shared = src_blocks[:min(j, len(src_blocks))]
            for bid in shared:
                self._alloc.share(bid)
            new_blocks = list(shared)
            if frontier % self.block and j < len(src_blocks):
                # Divergent tail: both lanes will write into block j's
                # position range, so the fork gets a copy.
                bid = self._alloc.alloc()
                if bid is None:
                    for b in shared:
                        self._alloc.free(b)
                    self._decline("kv_blocks")
                    return None
                try:
                    self._copy_block(src_blocks[j], bid)
                except Exception:
                    # Not yet reachable from any table: roll back, or the
                    # block and the refcount bumps leak for good.
                    self._alloc.free(bid)
                    for b in shared:
                        self._alloc.free(b)
                    raise
                new_blocks.append(bid)
            self._lane_blocks[dst] = new_blocks
            row = self._tables_np[dst]
            row[:] = TRASH_BLOCK
            row[:len(new_blocks)] = new_blocks
            self._push_tables()
            self._set_lane(dst, int(self._hpos[lane]), token)
            for a in (self.temps, self.tps, self.mps):
                a[dst] = a[lane]
            self._htemps[dst] = self._htemps[lane]
            self._seeds[dst] = key if key is not None else self._seeds[lane]
            rid = self._next_id
            self._next_id += 1
            self._lane_state[dst] = _Lane(
                request_id=rid, prompt_len=st.prompt_len,
                max_new=st.max_new, tokens=st.tokens[:-1] + [token],
                eos=st.eos, deadline=st.deadline, born=self._clock(),
                off=st.off)
            self.last_request_id = rid
            obs.count("serving.cow_forks")
            obs.event("serving.fork", src=lane, dst=dst, request_id=rid,
                      shared_blocks=len(shared),
                      copied_blocks=len(new_blocks) - len(shared))
            self._obs_blocks()
            return dst

    # ------------------------------------------------ pinned prefixes

    def pin_prefix(self, tokens) -> int:
        """Prefill ``tokens``' full blocks into the slab and PIN them
        (the registry holds a reference): any later prompt starting with
        those tokens hash-hits the blocks, with no prefill work for the
        pinned span and no id at submit.  The length rounds DOWN to a
        block multiple (a partial tail block is mutable, so it cannot be
        shared).  Returns the ``prefix_id`` for :meth:`unpin_prefix`;
        raises ``RuntimeError`` when the allocator cannot hold the run."""
        with obs.held(self._admission_lock):
            self._check_open()
            tokens = np.asarray(tokens, np.int64).reshape(-1)
            B = self.block
            span = (tokens.size // B) * B
            if span < B:
                raise ValueError(
                    f"a pinned prefix needs at least one full block "
                    f"({B} tokens); got {tokens.size}")
            if span > self.cfg.max_len - 2:
                raise ValueError(
                    f"pinned prefix of {span} tokens must leave room for "
                    f"a tail token and one generated token under "
                    f"max_len={self.cfg.max_len}")
            full = span // B
            staged = self._stage_blocks(tokens, span)
            if staged is None:
                raise RuntimeError(
                    "no free KV blocks to pin the prefix; grow n_blocks, "
                    "or drain/unpin first")
            blocks, shared, hashes, plan = staged
            try:
                if shared < full:
                    row = np.full((self._mb,), TRASH_BLOCK, np.int64)
                    row[:len(blocks)] = blocks
                    row_t = self._to_device(row)
                    # _chunk_rows reads warm = prompt.size - 1 tokens: the
                    # pseudo prompt makes the pinned span the warm region.
                    pseudo = np.zeros((span + 1,), np.int64)
                    pseudo[:span] = tokens[:span]
                    for start, w in plan:
                        rows = torch.as_tensor(
                            self._chunk_rows(pseudo, 0, start, w),
                            device=self.device)
                        if (self._admit_prefill is not None
                                and start == 0 and len(plan) == 1):
                            self._admit_prefill(row_t, rows, span)
                        else:
                            self._admit(row_t, rows, start, span)
                    for k in range(shared, full):
                        self._alloc.register(blocks[k], hashes[k])
                pid = self._stems.add(blocks, span)
            except Exception:
                # A failure after staging (a dispatch fault) hands every
                # staged reference back: the pin was never published.
                for b in blocks:
                    self._alloc.free(b)
                raise
            obs.event("serving.pin_prefix", prefix_id=pid, length=span,
                      shared_blocks=shared)
            self._obs_blocks()
            return pid

    def unpin_prefix(self, prefix_id: int) -> None:
        """Release a pinned prefix's block references.  Lanes sharing
        the blocks keep theirs; the blocks stay hash-resident until the
        free list recycles them."""
        with obs.held(self._admission_lock):
            for bid in self._stems.pop(prefix_id):
                self._alloc.free(bid)
            self._obs_blocks()

    def residency(self) -> dict:
        """The paged residency digest: the base load fields plus the
        slab geometry and every resident stem hash (hex), the same bytes
        :func:`~distkeras_tpu_torch.serving.residency.stem_hexes`
        computes."""
        out = super().residency()
        out["block"] = self.block
        out["stem_hashes"] = [h.hex() for h in self._alloc.resident_hashes()]
        out["prefix_ids"] = self._stems.ids()
        out["kv_blocks_free"] = self._alloc.stats()["free"]
        return out

    @property
    def pinned(self) -> PinnedStems:
        return self._stems

    @property
    def allocator(self) -> BlockAllocator:
        return self._alloc

    # ------------------------------------- disaggregated block transfer

    def _block_template(self) -> dict:
        """The shape of ONE slab block per leaf (``[L, 1, block, ...]``,
        no storage): what a shipped block's leaves must match."""
        return {n: torch.empty((a.shape[0], 1) + tuple(a.shape[2:]),
                               dtype=a.dtype, device="meta")
                for n, a in self.cache.items()}

    def export_blocks(self, tokens) -> BlockShipment:
        """Prefill ``tokens``' full blocks and read them off the slab into
        a host-side :class:`BlockShipment`: the prefill half of
        disaggregated serving.

        Staging goes through :meth:`pin_prefix` (the ONE share-and-
        allocate path): resident stems are reused, only the cold
        remainder prefills.  The blocks are gathered on the device and
        copied to the host synchronously (the bytes are final when this
        returns); the pin is released before returning, and the blocks
        stay hash-resident until the free list recycles them.  Raises
        ``ValueError`` for spans below one block and ``RuntimeError`` when
        the allocator cannot hold the run (the router's fallback
        signals)."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        pid = self.pin_prefix(tokens)
        try:
            with obs.held(self._admission_lock):
                blocks = self._stems.blocks_of(pid)
                span = self._stems.length_of(pid)
                hashes = stem_hashes(tokens[:span], self.block)
                names = sorted(self.cache)
                idx = torch.as_tensor(list(blocks), device=self.device)
                host = {n: self.cache[n].index_select(1, idx).cpu()
                        for n in names}
        finally:
            self.unpin_prefix(pid)
        runs = tuple(tuple(host_words(host[n][:, j:j + 1]) for n in names)
                     for j in range(len(blocks)))
        ship = BlockShipment(
            block=self.block, hashes=tuple(hashes), blocks=runs,
            dtypes=tuple(dtype_name(host[n].dtype) for n in names))
        obs.count("serving.disagg.blocks_out", len(ship))
        obs.count("serving.disagg.bytes_out", ship.nbytes)
        obs.event("serving.block_export", blocks=len(ship),
                  bytes=ship.nbytes, span=span)
        return ship

    def import_blocks(self, shipment: BlockShipment) -> dict | None:
        """Adopt a shipped block run by page-table splice and PIN it (the
        reference held through :class:`PinnedStems`, as
        :meth:`pin_prefix` holds it): the decode half of disaggregated
        serving.

        Blocks whose chain digest is already resident are refcounted in
        place, with no device write (adopt hits); cold blocks are
        allocated, copied into the slab (``slab[:, bid].copy_(block)``
        under the admission lock, between step windows) and
        hash-registered so later prompts and re-imports hit them.

        Returns ``{"prefix_id", "blocks", "hits", "bytes"}`` — the caller
        owns the pin and must :meth:`unpin_prefix` it when the consuming
        request goes terminal — or ``None`` when the allocator cannot
        hold the run (backpressure: the router routes the raw prompt
        instead).  Any failure mid-adopt hands back every reference this
        import took."""
        with obs.held(self._admission_lock):
            self._check_open()
            if shipment.block != self.block:
                raise ValueError(
                    f"shipment carries {shipment.block}-token blocks; "
                    f"this slab is paged at {self.block}")
            if not len(shipment):
                raise ValueError("refusing to adopt an empty shipment")
            if shipment.span > self.cfg.max_len - 2:
                raise ValueError(
                    f"shipment spans {shipment.span} tokens; pinned "
                    f"runs must leave room for a tail token and one "
                    f"generated token under max_len={self.cfg.max_len}")
            names = sorted(self.cache)
            tmpl = self._block_template()
            dtypes = leaf_dtype_names(shipment)
            taken: list[int] = []
            hits = 0
            try:
                for h, leaves in zip(shipment.hashes, shipment.blocks):
                    bid = self._alloc.share_by_hash(h)
                    if bid is not None:
                        # Content already resident: refcount, no write.
                        taken.append(bid)
                        hits += 1
                        continue
                    if len(leaves) != len(names):
                        raise ValueError(
                            f"shipment blocks carry {len(leaves)} "
                            f"leaves; this slab has {len(names)}")
                    for a, dt, n in zip(leaves, dtypes, names):
                        want = tuple(tmpl[n].shape)
                        want_dt = dtype_name(tmpl[n].dtype)
                        if tuple(a.shape) != want or dt != want_dt:
                            raise ValueError(
                                f"shipment leaf {tuple(a.shape)}/{dt} "
                                f"does not match slab block "
                                f"{want}/{want_dt} (model config or "
                                "kv_int8 mode mismatch)")
                    bid = self._alloc.alloc()
                    if bid is None:
                        for b in taken:
                            self._alloc.free(b)
                        taken = []
                        obs.count("serving.disagg.import_declines")
                        return None
                    taken.append(bid)
                    with torch.no_grad():
                        for a, n in zip(leaves, names):
                            slab = self.cache[n]
                            slab[:, bid].copy_(
                                from_words(a, slab.dtype)[:, 0])
                    self._alloc.register(bid, h)
                pid = self._stems.add(taken, shipment.span)
            except Exception:
                for b in taken:
                    self._alloc.free(b)
                raise
            obs.count("serving.disagg.blocks_in", len(taken))
            obs.count("serving.disagg.adopt_hits", hits)
            obs.count("serving.disagg.bytes_in", shipment.nbytes)
            obs.event("serving.block_import", prefix_id=pid,
                      blocks=len(taken), hits=hits, bytes=shipment.nbytes)
            self._obs_blocks()
            return {"prefix_id": pid, "blocks": len(taken),
                    "hits": hits, "bytes": shipment.nbytes}

    def traced_for_analysis(self):
        raise _not_ported("the IR lint's trace targets", "A11")

    # -------------------------------------------------------- obs

    def _obs_blocks(self) -> None:
        if obs.active() is None:
            return
        st = self._alloc.stats()
        obs.gauge("serving.kv_blocks_used", st["used"])
        obs.gauge("serving.kv_blocks_free", st["free"])
        obs.gauge("serving.kv_shared_blocks", st["shared"])


__all__ = ["PagedBatcher", "BlockAllocator", "TRASH_BLOCK",
           "KV_INT8_PREFILL_LOGIT_TOL"]

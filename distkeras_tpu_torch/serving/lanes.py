"""ContinuousBatcher: lane-based continuous batching over one decode step.

The port's counterpart of ``distkeras_tpu/serving/lanes.py``.  The engine
holds ``lanes`` decode rows in ONE preallocated KV cache and decodes them
together, each row at its own position
(:func:`~distkeras_tpu_torch.models.generate._decode_chunk`, per-row
device positions, cache written in place).  A new request is admitted
into any free lane mid-flight with a bucket-padded chunk of just that
lane, while the other lanes keep decoding.

Contract: every request's emitted tokens are EXACTLY what
``generate(params, prompt[None], cfg, max_new_tokens, ...)`` emits for
it alone.  Lane-local positions start at 0 per request (at the prefix
length past a shared or pooled prefix); a sampled lane at position ``q``
draws its ``[1, V]`` uniforms from ``_position_generator(seed, q)``, the
stream a batch-1 ``generate(seed=...)`` draws there, whatever the other
lanes do; and stale cache slots of a lane's previous occupant are
masked until overwritten.

Host syncs: ``cur``, ``pos`` and the per-lane sampling values live on
the device, the cache is allocated once and updated in place, and a
``step(n)`` window reads the device once, for its ``[lanes, n]`` token
matrix; eos and budgets are checked on that host copy.  The host keeps
a mirror of each lane's position (it advances deterministically) to seed
the sampling streams without reading the device.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from distkeras_tpu_torch import obs
from distkeras_tpu_torch.models.generate import (_decode_chunk, _min_p_mask,
                                                 _position_generator,
                                                 _resolve_prompt_cache,
                                                 _top_p_mask, init_cache,
                                                 local_kv_heads,
                                                 rolling_eligible,
                                                 top_k_mask)
from distkeras_tpu_torch.models.transformer import TransformerConfig
from distkeras_tpu_torch.resilience import chaos
from distkeras_tpu_torch.serving.elastic import _ElasticLanesMixin
from distkeras_tpu_torch.serving.engine import (_Lane, _LaneEngine,
                                                _make_lane_admit,
                                                _make_lane_reseed,
                                                _own_params)
from distkeras_tpu_torch.serving.prefix import _spec
from distkeras_tpu_torch.utils.device import check_on_device, resolve_device

# Below this many lanes (at the largest tier) a kv_int8 cache earns an
# advisory at construction: decode is weight-bound there, and on the
# H100 the int8 cache's decode was measured no faster than bf16's.
KV_INT8_LANE_ADVISORY = 16


class ContinuousBatcher(_ElasticLanesMixin, _LaneEngine):
    """Lane-based continuous batching over one decode step.

    Args mirror ``generate``'s sampling surface: ``temperature``,
    ``top_k`` / ``top_p`` / ``min_p``, ``eos_token`` — fixed per engine.
    Per-request seeds arrive with ``submit``.  ``exact_top_k`` is
    accepted for the reference's signature; the port's ``top_k`` is
    always exact.

    ``per_request_sampling=True`` carries per-lane temperature / top_p /
    min_p as ``[lanes]`` device tensors: ``submit`` then takes
    per-request overrides, and greedy and sampled requests mix in one
    batch, each matching its solo ``generate`` run.  The constructor
    values become the defaults.  ``top_k`` stays engine-level.

    ``lanes``: decode rows held by the engine; ``prompt_buckets``:
    admission pad widths (a prompt of length P admits through the
    smallest bucket >= P - 1).

    Full-cache configs, or rope + ``attention_window`` configs, which run
    ROLLING lanes: every lane decodes past ``max_len`` on the ring cache
    with no total-length cap (prompts must still fit the ring).

    ``prompt_cache=(segment, P)``: one shared prefilled prefix every
    request decodes past (admission seeds the lane from it).
    ``prefix_pool=``: a :class:`~distkeras_tpu_torch.serving.PrefixPool`;
    ``submit`` / ``enqueue`` take ``prefix_id=`` and the lane is seeded
    from the pooled segment on the device.  A pooled request matches
    ``generate(tail, prompt_cache=(segment, P))``.  Requests pin their
    entry until the lane is vacated; queued requests do not pin.

    ``prefill_chunk=W`` (chunked prefill): a prompt longer than ``W``
    admits in ``W``-wide chunks, the first at ``submit`` and one per
    ``step()`` before the decode window, so the other lanes' gap between
    tokens stays bounded by one chunk's compute; the parked lane joins
    decode when its last chunk lands, with the tokens of monolithic
    admission.  Full-cache configs only; ``W`` joins ``prompt_buckets``.

    ``lane_tiers=(2, 4, 8)`` (elastic): the engine starts at the smallest
    tier; ``scale_up_after`` consecutive queue overflows step it up (the
    overflowing enqueue is absorbed instead of raising
    :class:`QueueFull`) and ``scale_down_after`` idle steps step it down.
    A resize compacts the occupied lanes by a device gather, so lane ids
    move: elastic engines admit through :meth:`enqueue` only.
    ``step_windows``: the ``step(n)`` window sizes an elastic engine
    accepts (the reference compiles exactly those).

    ``kv_int8=True``: the cache holds int8 K/V with f32 scales (rolling
    rings included), and every request matches its solo
    ``generate(kv_int8=True, use_prefill=False)`` run (admission and the
    sequential path both attend the already-quantized cache; only a K/V
    value that two products round to either side of a .5 boundary can
    part them).  An int8 tree (``quantize_params``) serves as is.

    ``kv_int8="prefill"`` is a
    :class:`~distkeras_tpu_torch.serving.PagedBatcher` admission mode
    and is refused here.

    ``hot_swap=True``: live weight push through :meth:`swap_params`
    (copied into the live weight tensors in place; ``param_version``
    counts the pushes).  The engine then serves its own copy of
    ``params``, made once here, so engines built on one tree swap
    independently and the caller's tree never changes.  Refused with ``prompt_cache=`` / ``prefix_pool=``:
    their K/V was computed under the weights they were prefilled with.

    ``plan=`` / ``mesh=``: sharded serving, SPMD on every rank of the
    mesh (``serving/engine.py``); ``params`` is the full tree (or a
    placed one), the cache holds this rank's kv heads.  Full-cache
    configs only; ``prompt_cache=`` is refused, a ``prefix_pool=`` must
    be built with the same mesh and KV axis, and ``hot_swap=True`` takes
    full trees (every rank the same).
    Runs on ``device`` (the card unless ``device="cpu"``), where the
    params must already live.
    """

    def __init__(self, params, cfg: TransformerConfig, lanes: int = 8,
                 temperature: float = 0.0, top_k=None, top_p=None,
                 min_p=None, eos_token=None, exact_top_k: bool = False,
                 prompt_buckets=(8, 32, 128, 512), prompt_cache=None,
                 kv_int8: bool = False,
                 per_request_sampling: bool = False,
                 max_queue: int = 0, clock=None,
                 lane_tiers=None, scale_up_after: int = 2,
                 scale_down_after: int = 8, step_windows=(1,),
                 prefill_chunk: int | None = None, prefix_pool=None,
                 plan=None, mesh=None, hot_swap: bool = False,
                 device=None):
        if plan is not None and prompt_cache is not None:
            raise ValueError(
                "plan= does not compose with prompt_cache= (one "
                "baked-in prefix); use prefix_pool= built with "
                "the same mesh, or a PagedBatcher pinned stem")
        if not isinstance(kv_int8, bool):
            raise ValueError(
                f"kv_int8 must be a bool here (got {kv_int8!r}); "
                'kv_int8="prefill" is a PagedBatcher admission mode')
        self.device = resolve_device(device)
        check_on_device(params, self.device)
        params = self._setup_plan(params, cfg, plan, mesh)
        self._rolling = False
        if cfg.attention_window is not None:
            if not rolling_eligible(cfg):
                raise ValueError(
                    "windowed continuous batching runs rolling lanes, "
                    "which needs rope=True and attention_window <= "
                    "max_len (full-cache configs need no window)")
            if prompt_cache is not None:
                raise ValueError("prompt_cache requires a full-cache "
                                 "config (no attention_window)")
            if prefix_pool is not None:
                raise ValueError("prefix_pool requires a full-cache "
                                 "config (no attention_window)")
            if prefill_chunk is not None:
                raise ValueError(
                    "chunked prefill (prefill_chunk=) requires a "
                    "full-cache config: a rolling ring has no parking "
                    "slot whose garbage writes stay masked, and ring "
                    "prompts are already bounded by the ring size")
            self._rolling = True
        _tiers = None
        _windows = tuple(sorted({int(n) for n in step_windows}))
        if not _windows or _windows[0] < 1:
            raise ValueError(
                f"step_windows must be positive ints, got {step_windows}")
        if lane_tiers is not None:
            _tiers = tuple(sorted({int(t) for t in lane_tiers}))
            if len(_tiers) < 2:
                raise ValueError(
                    f"lane_tiers needs >= 2 distinct tiers, got "
                    f"{lane_tiers} (a single fixed size is just lanes=)")
            if _tiers[0] < 1:
                raise ValueError(f"lane tiers must be >= 1, got {_tiers}")
            if scale_up_after < 1 or scale_down_after < 1:
                raise ValueError(
                    "scale_up_after/scale_down_after must be >= 1 "
                    f"(got {scale_up_after}, {scale_down_after})")
            if 1 not in _windows:
                raise ValueError(
                    "step_windows must include 1 — drain/shutdown "
                    "steps one token at a time")
            if max_queue < 1:
                raise ValueError(
                    "lane_tiers needs max_queue >= 1: the queue "
                    "overflow IS the scale-up signal")
            lanes = _tiers[0]
        if lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {lanes}")
        if prompt_cache is not None and prefix_pool is not None:
            raise ValueError(
                "pass prompt_cache (ONE engine-level prefix, baked "
                "into admission) OR prefix_pool (per-request pooled "
                "prefixes), not both")
        if prompt_cache is not None and prompt_cache[1] >= cfg.max_len:
            raise ValueError(
                f"shared prefix length {prompt_cache[1]} must leave "
                f"room under max_len={cfg.max_len}")
        self._hot_swap = bool(hot_swap)
        if self._hot_swap and (prompt_cache is not None
                               or prefix_pool is not None):
            raise ValueError(
                "hot_swap=True does not compose with "
                "prompt_cache=/prefix_pool=: prefix K/V is baked from "
                "the params it was prefilled with, so a weight swap "
                "would silently mix param versions mid-sequence — "
                "rebuild the prefix under the new version instead")
        if (temperature <= 0
                and (top_k
                     or (top_p is not None and top_p < 1.0)
                     or (min_p is not None and min_p > 0.0))
                and not per_request_sampling):
            # With per-request sampling the constructor values are only
            # defaults; the no-op values (top_p=1.0 / min_p=0.0) are
            # legal everywhere, as in generate and submit().
            raise ValueError(
                "top_k/top_p/min_p need temperature > 0 (greedy always "
                "takes the argmax)")
        if temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if top_k is not None and not 1 <= top_k <= cfg.vocab_size:
            raise ValueError(
                f"top_k must be in [1, vocab_size={cfg.vocab_size}], "
                f"got {top_k}")
        if top_p is not None and not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if min_p is not None and not 0.0 <= min_p <= 1.0:
            raise ValueError(f"min_p must be in [0, 1], got {min_p}")
        if eos_token is not None and not 0 <= eos_token < cfg.vocab_size:
            raise ValueError(
                f"eos_token {eos_token} outside vocab [0, "
                f"{cfg.vocab_size})")
        # A hot-swap engine serves its own copy (``_own_params``).
        self.params = _own_params(params) if self._hot_swap else params
        self.cfg = cfg
        self.lanes = lanes
        self.kv_int8 = kv_int8
        top = max(_tiers or (lanes,))
        if kv_int8 and top < KV_INT8_LANE_ADVISORY:
            msg = (f"kv_int8=True with {top} lanes: below "
                   f"~{KV_INT8_LANE_ADVISORY} lanes decode is "
                   "weight-bound, so the int8 cache's byte saving cannot "
                   "pay for the dequant (on the H100 its decode was "
                   "measured no faster than bf16's)")
            warnings.warn(msg, RuntimeWarning, stacklevel=2)
            obs.event("serving.advisory", kind="kv_int8_small_lanes",
                      lanes=top, detail=msg)
        # Shared prefix: admission seeds the lane from it instead of
        # zeros, and every position shifts by its length.
        self._off = 0
        self._prefix_lane = None
        if prompt_cache is not None:
            self._prefix_lane, self._off = _resolve_prompt_cache(
                prompt_cache, cfg, 1, 1, 1, None, self.device, kv_int8)
        if prefix_pool is not None:
            if prefix_pool.draft_cfg is not None:
                raise ValueError(
                    "this pool holds (target, draft) speculative "
                    "pairs; build a plain PrefixPool(cfg, ...) for "
                    "ContinuousBatcher")
            if prefix_pool.kv_int8 != kv_int8:
                raise ValueError(
                    "prefix_pool quantization must match kv_int8= "
                    "(build the pool with the engine's kv_int8)")
            if getattr(prefix_pool, "mesh", None) is not mesh:
                raise ValueError(
                    "prefix_pool placement must match the engine's: "
                    "build the pool with PrefixPool(..., mesh=, "
                    "kv_axis=) matching plan=/mesh= (a slab placed "
                    "differently from the cache would make every "
                    "pooled admission reshard the segment)")
            if (mesh is not None
                    and getattr(prefix_pool, "kv_axis", None)
                    != self._kv_axis):
                raise ValueError(
                    f"prefix_pool kv_axis="
                    f"{getattr(prefix_pool, 'kv_axis', None)!r} does "
                    f"not match the plan-derived KV axis "
                    f"{self._kv_axis!r}")
            want = _spec(init_cache(cfg, 1, kv_int8=kv_int8,
                                    device=self.device,
                                    kv_heads=local_kv_heads(params, cfg)))
            got = {n: (tuple(a.shape[1:]), a.dtype)
                   for n, a in prefix_pool.slab.items()}
            if want != got or prefix_pool.device != self.device:
                raise ValueError(
                    f"prefix_pool was built for a different config or "
                    f"device (pool segment {got} on "
                    f"{prefix_pool.device}, engine cache {want} on "
                    f"{self.device})")
        self._prefix_pool = prefix_pool
        self.eos_token = eos_token
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.min_p = min_p
        self.exact_top_k = exact_top_k
        self.per_request_sampling = per_request_sampling
        if prefill_chunk is not None:
            prefill_chunk = int(prefill_chunk)
            if prefill_chunk < 1:
                raise ValueError(
                    f"prefill_chunk must be >= 1, got {prefill_chunk}")
            if self._off + prefill_chunk > cfg.max_len:
                raise ValueError(
                    f"prefill_chunk {prefill_chunk} exceeds the cache "
                    f"slots past the prefix ({cfg.max_len - self._off})")
        self.prefill_chunk = prefill_chunk
        # Buckets clamp to the cache slots past the shared prefix and
        # always include the largest legal width (and the chunk width,
        # so chunked admission's full chunks have an exact bucket).
        cap = cfg.max_len - self._off
        self._buckets = tuple(sorted(
            {min(int(w), cap) for w in prompt_buckets} | {cap}
            | ({prefill_chunk} if prefill_chunk else set())))
        self._lane_state: list[_Lane | None] = [None] * lanes
        self._next_id = 0
        self._init_admission(max_queue, clock)
        if _tiers is not None:
            self.lane_tiers = _tiers
            self.scale_up_after = scale_up_after
            self.scale_down_after = scale_down_after
        self._step_windows = _windows
        self._temp_t = torch.full((1,), float(temperature or 1.0),
                                  device=self.device)
        self._init_device_state(lanes)
        self._build_admission_programs()

    def _build_admission_programs(self) -> None:
        """The admission steps: the first chunk (seeded from zeros, the
        engine's prefix or a pool segment), chunked prefill's
        continuation, and the prefix reseeds of 1-token prompts.  The
        paged engine overrides this with its block-table admission."""
        pooled = self._prefix_pool is not None
        self._admit = _make_lane_admit(self.params, self.cfg,
                                       prefix_lane=self._prefix_lane,
                                       pooled=pooled)
        self._admit_cont = (_make_lane_admit(self.params, self.cfg,
                                             seed=False)
                            if self.prefill_chunk is not None else None)
        self._reseed = (_make_lane_reseed(prefix_lane=self._prefix_lane)
                        if self._prefix_lane is not None else None)
        self._reseed_pool = (_make_lane_reseed(pooled=True)
                             if pooled else None)

    # ------------------------------------------------------ device state

    def _fresh_cache(self, lanes: int):
        """A zeroed KV store for ``lanes`` decode rows: the ONE
        cache-layout decision point (monolithic ``[L, lanes, max_len,
        ...]`` here; the paged engine returns its block slab)."""
        return init_cache(self.cfg, lanes, kv_int8=self.kv_int8,
                          device=self.device, kv_heads=self._kv_heads())

    def _init_device_state(self, lanes: int) -> None:
        """One cache, per-lane position and current token (the one the
        next step processes) and per-lane sampling values on the device;
        host mirrors of the positions, temperatures and seeds."""
        dev = self.device
        self.cache = self._fresh_cache(lanes)
        self.pos = torch.zeros((lanes,), dtype=torch.long, device=dev)
        self.cur = torch.zeros((lanes,), dtype=torch.long, device=dev)
        t0 = float(self.temperature)
        self.temps = torch.full((lanes,), t0, device=dev)
        self.tps = torch.full((lanes,), float(self.top_p or 1.0), device=dev)
        self.mps = torch.full((lanes,), float(self.min_p or 0.0), device=dev)
        self._hpos = np.zeros(lanes, np.int64)
        self._htemps = np.full(lanes, t0)
        self._seeds: list[int | None] = [None] * lanes

    def _set_lane(self, lane: int, pos: int, cur: int) -> None:
        self.pos[lane] = pos
        self.cur[lane] = cur
        self._hpos[lane] = pos

    def _advance(self, pos):
        """Next position of every lane (device tensor or host array).
        Full-cache engines pin free / done / parked lanes at the last
        slot (their outputs are discarded and admission reseeds them);
        rolling engines' positions are unbounded (ring slot = pos %
        max_len)."""
        if self._rolling:
            return pos + 1
        if isinstance(pos, torch.Tensor):
            return torch.clamp(pos + 1, max=self.cfg.max_len - 1)
        return np.minimum(pos + 1, self.cfg.max_len - 1)

    def _pick(self, logits, draw_lanes, hpos):
        """One token per lane from ``logits [lanes, V]``: greedy argmax,
        or the filters and a Gumbel-max draw whose uniforms for lane
        ``l`` come from ``_position_generator(seed_l, hpos[l])`` — a
        batch-1 ``generate``'s stream at that position."""
        if not draw_lanes:      # every live lane is greedy
            return logits.argmax(dim=-1)
        dev = logits.device
        u = torch.full_like(logits, 0.5)
        for lane in draw_lanes:
            gen = _position_generator(self._seeds[lane], int(hpos[lane]),
                                      dev)
            u[lane] = torch.rand((1, logits.shape[-1]), generator=gen,
                                 device=dev)[0]
        noise = torch.log(-torch.log(u))
        if self.per_request_sampling:
            # Greedy lanes (t <= 0) take the raw argmax; the draw runs
            # for every lane and is selected per lane.  top_p >= 1.0
            # rows bypass the nucleus mask (its cumsum can overshoot 1.0
            # and drop a tail token an unfiltered draw could take);
            # min_p's 0.0 rows are exact no-ops.
            safe_t = torch.where(self.temps > 0, self.temps, 1.0)
            scaled = logits / safe_t[:, None]
            if self.top_k is not None:
                scaled = top_k_mask(scaled, self.top_k)
            scaled = torch.where(
                self.tps[:, None] >= 1.0, scaled,
                _top_p_mask(scaled, self.tps[:, None]))
            scaled = _min_p_mask(scaled, self.mps[:, None])
            return torch.where(self.temps > 0,
                               (scaled - noise).argmax(dim=-1),
                               logits.argmax(dim=-1))
        scaled = logits / self._temp_t
        if self.top_k is not None:
            scaled = top_k_mask(scaled, self.top_k)
        if self.top_p is not None and self.top_p < 1.0:
            scaled = _top_p_mask(scaled, self.top_p)
        if self.min_p is not None and self.min_p > 0.0:
            scaled = _min_p_mask(scaled, self.min_p)
        return (scaled - noise).argmax(dim=-1)

    # ------------------------------------------------------------ API

    def _validate_budget(self, p: int, max_new_tokens: int,
                         off: int | None = None) -> None:
        off = self._off if off is None else off
        if (not self._rolling
                and off + p + max_new_tokens > self.cfg.max_len):
            raise ValueError(
                f"prefix ({off}) + prompt ({p}) + "
                f"max_new_tokens ({max_new_tokens}) exceeds "
                f"max_len={self.cfg.max_len}")
        warm = p - 1
        if warm:
            # Every chunk of the admission plan needs a padded write
            # that fits the cache.
            self._chunk_plan(off, warm)

    def _bucket_for(self, width: int, start: int) -> int:
        """Smallest admission bucket >= ``width`` whose padded write at
        ``start`` stays inside the cache."""
        b = next((w for w in self._buckets
                  if w >= width and start + w <= self.cfg.max_len), None)
        if b is None:
            raise ValueError(
                f"no admission bucket fits {width} prompt tokens at "
                f"cache offset {start} (buckets {self._buckets}, "
                f"max_len={self.cfg.max_len}); raise prompt_buckets "
                "or add a finer width")
        return b

    def _chunk_plan(self, off: int, warm: int, skip: int = 0) -> list:
        """The admission plan for ``warm`` prompt tokens decoding past
        ``off`` cached positions: ``[(start, width)]``.  One bucket-padded
        chunk at ``off`` unless chunked prefill is on and the warm length
        exceeds the chunk width; then full ``W``-wide chunks on the
        ``off + skip + k*W`` grid plus a bucket-padded tail whose start
        backs up so its padded end lands exactly at the warm frontier
        (re-prefilling the overlap writes the same K/V).  ``skip`` drops
        the first ``skip`` warm tokens from the plan: the paged engine's
        stem sharing, whose shared blocks hold those positions already
        (the backed-up tail never reaches into them: it is at most one
        chunk wide, and the chunked branch runs only when more than a
        chunk remains).  Raises if any padded write would overflow the
        cache."""
        if warm <= skip:
            return []
        w_chunk = self.prefill_chunk
        lo, span = off + skip, warm - skip
        if self._rolling or w_chunk is None or span <= w_chunk:
            return [(lo, self._bucket_for(span, lo))]
        m, rem = divmod(span, w_chunk)
        plan = [(lo + k * w_chunk, w_chunk) for k in range(m)]
        if plan[-1][0] + w_chunk > self.cfg.max_len:
            raise ValueError(
                f"chunked admission grid overflows the cache (chunk at "
                f"{plan[-1][0]} + {w_chunk} > {self.cfg.max_len})")
        if rem:
            b = next(w for w in self._buckets if w >= rem)
            plan.append((off + warm - b, b))
        return plan

    def _admission_plan(self, lane, prompt, off: int, warm: int):
        """Stage lane storage for an admission and return its chunk
        plan, or None to DECLINE for lack of KV storage (the paged
        engine's allocator-exhausted signal, surfaced as ``kv_blocks``
        backpressure by enqueue/pump).  A monolithic lane's storage is
        its cache row, so it never declines here."""
        del lane, prompt
        return self._chunk_plan(off, warm)

    def _abort_admission(self, lane) -> None:
        """Failure between storage staging and lane commit: release what
        :meth:`_admission_plan` staged (nothing for monolithic lanes;
        the paged engine frees the staged blocks)."""

    def _exec_admit(self, lane, start, rows, slot) -> None:
        """Run the FIRST admission chunk (the one that seeds the lane);
        ``slot`` is the pinned prefix-pool slot or None."""
        if self._prefix_pool is not None:
            # A plain request on a pooled engine seeds zeros (slot -1).
            self._admit(self.cache, rows, lane, start,
                        self._prefix_pool.slab,
                        -1 if slot is None else slot)
        else:
            self._admit(self.cache, rows, lane, start)

    def _exec_reseed(self, lane, slot) -> None:
        """No admission chunk ran (1-token prompt), but the lane still
        needs its prefix K/V; without a prefix, stale slots stay masked
        until the decode loop overwrites them."""
        if slot is not None:
            self._reseed_pool(self.cache, lane, self._prefix_pool.slab,
                              slot)
        elif self._prefix_lane is not None:
            self._reseed(self.cache, lane)

    def _chunk_rows(self, prompt, off: int, start: int,
                    width: int) -> np.ndarray:
        """Bucket-padded token rows for the chunk over positions
        ``[start, start + width)`` (real tokens up to the warm frontier,
        zero pad beyond — masked until overwritten)."""
        warm = prompt.size - 1
        rows = np.zeros((1, width), np.int64)
        lo = start - off
        hi = min(lo + width, warm)
        rows[0, :hi - lo] = prompt[lo:hi]
        return rows

    def _exec_chunk(self, lane, start, rows):
        self._admit_cont(self.cache, rows, lane, start)

    def _finish_admission(self, lane, st):
        """Last chunk landed: un-park the lane where monolithic
        admission leaves one."""
        self._set_lane(lane, st.off + st.prompt_len - 1,
                       int(st.tokens[st.prompt_len - 1]))

    def submit(self, prompt, max_new_tokens: int, seed=None,
               temperature=None, top_p=None, min_p=None, eos_token=None,
               ttl=None, deadline=None, prefix_id=None):
        """Admit one request; returns its lane id, or None if the engine
        is full.  ``prompt``: 1-D int tokens; ``seed``: the request's
        sampling seed (required iff THIS request samples).

        ``temperature`` / ``top_p`` / ``min_p``: per-request overrides of
        the engine defaults (``per_request_sampling=True`` engines
        only); ``top_p=1.0`` / ``min_p=0.0`` are the explicit no-op
        values.  ``eos_token`` works on every engine.

        ``ttl`` (seconds from now) / ``deadline`` (absolute ``clock()``
        time): an already-expired request never occupies a lane (its
        structured timeout is recorded, see :meth:`results`, and None is
        returned); one that expires mid-decode is evicted at the next
        ``step()``.  ``prefix_id``: decode past a pooled prefix
        (``prefix_pool=`` engines).  On a ``prefill_chunk=`` engine a
        prompt longer than the chunk returns its lane PARKED: the other
        chunks run one per ``step()``.  Elastic engines admit through
        :meth:`enqueue` only.  Runs under the engine lock."""
        self._check_same_call("submit", prompt, max_new_tokens, seed,
                              temperature, top_p, min_p, eos_token,
                              prefix_id)
        with obs.held(self._admission_lock):
            return self._submit_locked(prompt, max_new_tokens, seed,
                                       temperature, top_p, min_p,
                                       eos_token, ttl, deadline, prefix_id)

    def _submit_locked(self, prompt, max_new_tokens, seed, temperature,
                       top_p, min_p, eos_token, ttl, deadline,
                       prefix_id=None):
        if self.lane_tiers is not None and not self._admitting_internal:
            raise ValueError(
                "elastic engines (lane_tiers=...) admit through "
                "enqueue(): a tier resize compacts lanes, so the lane "
                "id submit() would return can dangle")
        self._check_open()
        prompt = self._validate_request_args(prompt, max_new_tokens)
        p = prompt.size
        if ((temperature is not None or top_p is not None
             or min_p is not None) and not self.per_request_sampling):
            raise ValueError(
                "per-request temperature/top_p/min_p need "
                "ContinuousBatcher(per_request_sampling=True)")
        if top_p is not None and not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if min_p is not None and not 0.0 <= min_p <= 1.0:
            raise ValueError(f"min_p must be in [0, 1], got {min_p}")
        if temperature is not None and temperature < 0:
            raise ValueError(
                f"temperature must be >= 0, got {temperature}")
        if eos_token is not None and not (
                0 <= eos_token < self.cfg.vocab_size):
            raise ValueError(
                f"eos_token {eos_token} outside vocab [0, "
                f"{self.cfg.vocab_size})")
        eff_t = self.temperature if temperature is None else temperature
        if eff_t <= 0 and ((top_p is not None and top_p < 1.0)
                           or (min_p is not None and min_p > 0.0)):
            raise ValueError(
                "per-request top_p/min_p need a sampling temperature "
                f"(effective temperature is {eff_t})")
        off, slot, lane = self._off, None, None
        if prefix_id is not None:
            # Pin FIRST: a concurrent pool.put can never evict a pinned
            # entry.  Every non-admission exit releases the pin.
            off, slot, _ = self._pin_prefix(prefix_id)
        try:
            self._validate_budget(p, max_new_tokens, off=off)
            if (seed is None) == (eff_t > 0):
                raise ValueError(
                    "pass a per-request seed iff this request samples "
                    f"(effective temperature={eff_t})")
            dl = self._deadline_of(ttl, deadline)
            if self._expired_on_arrival(dl, prompt, p):
                if prefix_id is not None:
                    self._prefix_pool.release(prefix_id)
                return None
            free = self.free_lanes()
            if not free:
                self._decline_full()
                if prefix_id is not None:
                    self._prefix_pool.release(prefix_id)
                return None
            lane = free[0]
            chaos.probe("serving.admit")
            rid = self._claim_rid()
            if not self._admitting_internal:
                obs.event("serving.submit", request_id=rid,
                          prompt_len=p, max_new=int(max_new_tokens))
            warm = p - 1
            plan = self._admission_plan(lane, prompt, off, warm)
            if plan is None:
                # KV-storage decline (the paged allocator is out of
                # blocks): no lane is occupied; enqueue/pump treat it as
                # backpressure, not a timeout.
                self._decline("kv_blocks")
                if prefix_id is not None:
                    self._prefix_pool.release(prefix_id)
                return None
            chunks = None
            if plan:
                start0, width0 = plan[0]
                rows = self._chunk_rows(prompt, off, start0, width0)
                with obs.span("serving.admit", bucket=width0,
                              tokens=min(width0, warm - (start0 - off)),
                              chunks=len(plan), lane=lane,
                              request_id=rid):
                    self._exec_admit(lane, start0, rows, slot)
                if len(plan) > 1:
                    chunks = [(s, self._chunk_rows(prompt, off, s, w))
                              for s, w in plan[1:]]
            else:
                self._exec_reseed(lane, slot)
            if chunks is None:
                self._set_lane(lane, off + warm, int(prompt[-1]))
            else:
                # Parked: the lane decodes garbage at the clamp slot
                # until its last chunk lands; the request's own final
                # decode step rewrites that slot.
                self._set_lane(lane, self.cfg.max_len - 1, 0)
            self._seeds[lane] = seed
            self._htemps[lane] = eff_t
            if self.per_request_sampling:
                self.temps[lane] = float(eff_t)
                self.tps[lane] = float(
                    (self.top_p or 1.0) if top_p is None else top_p)
                self.mps[lane] = float(
                    (self.min_p or 0.0) if min_p is None else min_p)
            # The pin taken above becomes the lane's reference here.
            self._lane_state[lane] = _Lane(
                request_id=rid, prompt_len=p,
                max_new=max_new_tokens, tokens=list(prompt),
                eos=self.eos_token if eos_token is None else eos_token,
                deadline=dl, born=self._clock(), chunks=chunks,
                off=off, prefix_id=prefix_id)
            if not self._admitting_internal:
                self.last_request_id = rid
        except Exception:
            # A failure between pin and lane commit must leak neither
            # the prefix reference nor (paged engine) the staged blocks.
            if prefix_id is not None:
                self._prefix_pool.release(prefix_id)
            if lane is not None:
                self._abort_admission(lane)
            raise
        if chunks is not None:
            self._admitting.append(lane)
        return lane

    def step(self, n: int = 1):
        """Advance every lane ``n`` tokens with ONE read of the device;
        returns ``{lane: [tokens...]}`` for lanes that emitted.

        A lane that hits its eos or budget mid-window keeps decoding
        privately; the surplus is discarded here, so the emitted tokens
        are exactly ``step(1)``'s.  At most ONE pending admission chunk
        runs per call (FIFO across parked lanes) before the decode
        window.  Runs under the engine lock end to end: a concurrent
        ``enqueue`` can trigger a tier resize."""
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        if self.lane_tiers is not None and n not in self._step_windows:
            raise ValueError(
                f"elastic engines run declared decode windows only; "
                f"step({n}) is not in step_windows={self._step_windows}"
                " — declare it at construction")
        with obs.held(self._admission_lock):
            self.pump()
            # Tier hysteresis BEFORE the idle early-out: an idle
            # elastic engine must still step its lane count back down.
            self._maybe_scale_down()
            self._run_pending_chunk()
            # Idle engine (every lane empty, finished or still
            # admitting): nothing can emit, so no device work.  Reap
            # first: a parked lane whose deadline expired is evicted.
            if all(s is None or s.done or s.chunks is not None
                   for s in self._lane_state):
                self._reap()
                return {}
            chaos.probe("serving.step")
            if obs.active() is not None:
                obs.gauge("serving.lanes_busy", len(self.running()))
            with obs.span("serving.step", n=n):
                toks = self._dispatch_step(n)
            out = self._emit(lambda lane: toks[lane].tolist())
            self._reap()
            return out

    def _dispatch_step(self, n: int):
        """The ``n``-token device window, then ONE device-to-host copy of
        the ``[lanes, n]`` token matrix: the spans ``serving.dispatch``
        (the host enqueueing the window) and ``serving.readback`` (the
        host waiting for the card and the copy) inside ``serving.step``."""
        with obs.span("serving.dispatch", n=n):
            toks = self._device_window(n)
        with obs.span("serving.readback", n=n):
            return toks.cpu().numpy()

    def _device_window(self, n: int):
        """The device half of ``step(n)``: the ``n``-token decode window
        over every lane of the cache; the ``[lanes, n]`` tokens stay on
        the device (the paged engine gathers and scatters its slab
        around the same window)."""
        return self._decode_window(self.cache, n)

    def traced_for_analysis(self):
        """Census targets (``analysis/ir_lint.py``): the one-token decode
        window over the engine's live lane state (:meth:`_device_window`,
        the device half of ``step(1)``, which must read nothing back to
        the host), and the first admission chunk at the smallest bucket
        into lane 0 (:meth:`_exec_admit`, what ``submit`` runs).
        Running a spec's step advances the engine's state in place, as
        the engine's own call does."""
        from distkeras_tpu_torch.analysis.ir_lint import TraceSpec

        mode = ("per_request" if self.per_request_sampling
                else "sampled" if self.temperature > 0 else "greedy")
        if self._prefix_pool is not None:
            mode += "_pooled"
        if self._kv_axis is not None:
            mode += f"_tp{int(self.mesh.shape[self._kv_axis])}"
        name = f"{type(self).__name__.lower()}_{mode}"
        rows = np.zeros((1, self._buckets[0]), np.int64)
        state = {"params": self.params, "kv": self.cache}
        groups = ({a: int(s) for a, s in self.mesh.shape.items()
                   if int(s) > 1} if self.mesh is not None else {})
        return [
            TraceSpec(name=f"{name}/decode_step", fn=self._device_window,
                      args=(1,), host_sync_free=True, group_sizes=groups,
                      state=state),
            TraceSpec(name=f"{name}/admit_b{self._buckets[0]}",
                      fn=self._exec_admit, args=(0, 0, rows, None),
                      group_sizes=groups, state=state),
        ]

    def _decode_window(self, cache, n: int):
        """``n`` runs of :meth:`_one_step` over a CONTIGUOUS ``[lanes,
        max_len]`` cache (written in place); advances ``cur`` / ``pos``
        and returns the ``[lanes, n]`` token matrix on the device.  The
        monolithic step runs it over ``self.cache``, the paged step over
        the page-table-gathered view: one definition, so the two
        engines' tokens cannot drift."""
        draw_lanes = [lane for lane, st in enumerate(self._lane_state)
                      if st is not None and not st.done
                      and st.chunks is None and self._htemps[lane] > 0]
        toks = torch.empty((self.lanes, n), dtype=torch.long,
                           device=self.device)
        cur, pos, hpos = self.cur, self.pos, self._hpos
        with torch.no_grad():
            for j in range(n):
                cur, pos, hpos = self._one_step(cache, cur, pos, hpos,
                                                draw_lanes)
                toks[:, j] = cur
        self.cur, self.pos, self._hpos = cur, pos, hpos
        return toks

    def _one_step(self, cache, cur, pos, hpos, draw_lanes):
        """The per-token body: ``_decode_chunk`` (T = 1) over every lane
        at its own position, the sampling pick, the position advance.
        Returns the next ``(cur, pos, hpos)``."""
        logits, _ = _decode_chunk(self.params, cache, cur[:, None], pos,
                                  self.cfg)
        cur = self._pick(logits[:, 0], draw_lanes, hpos)
        return cur, self._advance(pos), self._advance(hpos)


__all__ = ["ContinuousBatcher", "KV_INT8_LANE_ADVISORY"]

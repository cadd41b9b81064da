"""Multi-prefix KV pool: N prefilled prefix segments, device-resident.

The port's counterpart of ``distkeras_tpu/serving/prefix.py``.
:class:`PrefixPool` holds up to ``slots`` prefilled prefix segments
stacked in ONE device slab; requests carry ``prefix_id`` at ``submit`` /
``enqueue`` and admission copies the segment into the lane on the
device, so the prefix tokens cost no prefill work per request.

Bookkeeping is host-side:

- **refcounts**: a lane decoding past a prefix pins it (the engines
  call ``acquire`` / ``release`` at admission and at lane vacation); a
  pinned entry is never evicted;
- **LRU eviction**: ``put`` on a full pool evicts the least-recently
  used entry with no references; if every entry is pinned, ``put``
  raises instead of corrupting an in-flight lane;
- **ids are never reused**: a stale ``prefix_id`` fails loudly.

Segments are what :func:`~distkeras_tpu_torch.models.generate.prefill`
returns for one prefix — a full-``max_len`` batch-1 cache, prefix slots
filled and the rest zero, so building one runs the flash forward kernel
on the card.  For :class:`~distkeras_tpu_torch.serving.SpeculativeBatcher`
pools (``draft_cfg=``) a segment is the ``(target_cache, draft_cache)``
pair.

:class:`PinnedStems` is the paged engine's counterpart: a host-side
registry of pinned block runs in the engine's one slab.
"""

from __future__ import annotations

import dataclasses

from distkeras_tpu_torch.models.generate import init_cache
from distkeras_tpu_torch.models.transformer import TransformerConfig
from distkeras_tpu_torch.utils.device import resolve_device
from distkeras_tpu_torch.utils.locks import TracedRLock


@dataclasses.dataclass
class _Entry:
    slot: int
    length: int
    refs: int = 0
    tick: int = 0
    last_token: int | None = None


def _spec(tree):
    """``{name: (shape, dtype)}`` of a cache dict, or a tuple of them."""
    if isinstance(tree, tuple):
        return tuple(_spec(t) for t in tree)
    if not isinstance(tree, dict):
        return None
    return {name: (tuple(a.shape), a.dtype) for name, a in tree.items()}


class PrefixPool:
    """Refcounted, LRU-evicting pool of prefilled prefix segments.

    ``cfg``: the serving model config (segment shape =
    ``init_cache(cfg, 1)``).  ``slots``: device capacity, ~``slots`` x
    one lane's cache bytes.  ``draft_cfg``: a speculative pool instead
    (segments are ``(target, draft)`` cache pairs).  ``device``: where
    the slab lives — the card unless ``device="cpu"``; it must be the
    engine's.  ``kv_int8``: int8 segments (``prefill(..., kv_int8=True)``)
    for a ``ContinuousBatcher(kv_int8=True)``; speculative pools hold
    full-precision caches.

    ``mesh=`` / ``kv_axis=`` (default ``"model"``): a pool for a sharded
    ``ContinuousBatcher(plan=, mesh=)``, whose slab holds this rank's kv
    heads, split over ``kv_axis`` as the engine's cache is (``None``:
    every head); its segments come from ``prefill`` on the engine's
    sharded params.

    Thread-safe: one leaf lock serializes ``put`` / ``acquire`` /
    ``release`` (engines call acquire/release under their own admission
    locks; nothing is acquired under this one).
    """

    def __init__(self, cfg: TransformerConfig, slots: int = 4,
                 kv_int8: bool = False,
                 draft_cfg: TransformerConfig | None = None, device=None,
                 mesh=None, kv_axis: str | None = "model"):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if mesh is not None and draft_cfg is not None:
            raise ValueError(
                "sharded pools serve pod-sharded ContinuousBatchers; "
                "SpeculativeBatcher has no plan= mode, so a sharded "
                "speculative pool has no consumer")
        if cfg.attention_window is not None or (
                draft_cfg is not None
                and draft_cfg.attention_window is not None):
            raise ValueError(
                "prefix pools need full-cache configs (no "
                "attention_window): a ring slot has no stable notion "
                "of 'the first P positions' to seed from")
        if draft_cfg is not None and kv_int8:
            raise ValueError(
                "speculative pools hold full-precision caches "
                "(SpeculativeBatcher has no kv_int8 mode)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.draft_cfg = draft_cfg
        self.kv_int8 = kv_int8
        self.slots = slots
        self.mesh = mesh
        self.kv_axis = kv_axis if mesh is not None else None
        kv_heads = None
        if self.kv_axis is not None:
            n = int(mesh.shape[self.kv_axis])
            if cfg.kv_heads % n:
                raise ValueError(
                    f"kv_heads={cfg.kv_heads} is not divisible by "
                    f"mesh axis {self.kv_axis!r} (size {n})")
            kv_heads = cfg.kv_heads // n
        if draft_cfg is None:
            seg = init_cache(cfg, 1, kv_int8=kv_int8, device=self.device,
                             kv_heads=kv_heads)
            self.slab = {n: a.new_zeros((slots,) + a.shape)
                         for n, a in seg.items()}
        else:
            seg = (init_cache(cfg, 1, device=self.device),
                   init_cache(draft_cfg, 1, device=self.device))
            self.slab = tuple({n: a.new_zeros((slots,) + a.shape)
                               for n, a in s.items()} for s in seg)
        self._seg_spec = _spec(seg)
        self._entries: dict[int, _Entry] = {}
        self._next_id = 0
        self._tick = 0
        self._lock = TracedRLock("serving.prefix_pool")

    # -------------------------------------------------------- mutation

    def put(self, segment, length: int, last_token: int | None = None
            ) -> int:
        """Insert a prefilled segment; returns its ``prefix_id``.

        ``segment``: the ``prefill(prefix[None], ...)`` cache (or the
        ``(target, draft)`` pair for speculative pools), matching the
        pool's spec exactly.  ``length``: the prefix token count it
        holds.  ``last_token``: the prefix's final token, which a
        :class:`SpeculativeBatcher` needs to admit a 1-token prompt
        against this prefix.

        A full pool evicts the least-recently-used entry with zero
        references; if every entry is referenced by a lane, raises
        ``RuntimeError``.  The segment is copied into the slab."""
        if length < 1:
            raise ValueError(f"prefix length must be >= 1, got {length}")
        if length >= self.cfg.max_len:
            raise ValueError(
                f"prefix length {length} must leave room under "
                f"max_len={self.cfg.max_len}")
        if _spec(segment) != self._seg_spec:
            raise ValueError(
                f"segment does not match the pool's spec "
                f"{self._seg_spec} (build it with prefill() on the "
                "pool's config, kv_int8 matching)")
        with self._lock:
            used = {e.slot for e in self._entries.values()}
            free = [s for s in range(self.slots) if s not in used]
            if free:
                slot = free[0]
            else:
                victims = [(e.tick, pid) for pid, e in
                           self._entries.items() if e.refs == 0]
                if not victims:
                    raise RuntimeError(
                        f"prefix pool full: all {self.slots} slots are "
                        "referenced by live lanes; wait for requests "
                        "to finish or grow slots")
                _, victim = min(victims)
                slot = self._entries.pop(victim).slot
            pairs = (zip(self.slab, segment) if self.draft_cfg is not None
                     else [(self.slab, segment)])
            for slab, seg in pairs:
                for name, a in slab.items():
                    a[slot].copy_(seg[name])
            pid = self._next_id
            self._next_id += 1
            self._tick += 1
            self._entries[pid] = _Entry(slot=slot, length=int(length),
                                        tick=self._tick,
                                        last_token=last_token)
            return pid

    def acquire(self, prefix_id: int) -> _Entry:
        """Pin the entry (a lane is about to decode against it) and mark
        it recently used; returns the entry."""
        with self._lock:
            e = self._entry(prefix_id)
            e.refs += 1
            self._tick += 1
            e.tick = self._tick
            return e

    def release(self, prefix_id: int) -> None:
        """Unpin (the referencing lane was vacated)."""
        with self._lock:
            e = self._entries.get(prefix_id)
            if e is not None and e.refs > 0:
                e.refs -= 1

    # ------------------------------------------------------ inspection

    def _entry(self, prefix_id: int) -> _Entry:
        e = self._entries.get(prefix_id)
        if e is None:
            raise KeyError(
                f"unknown prefix_id {prefix_id} (evicted or never "
                "inserted; ids are never reused)")
        return e

    def length_of(self, prefix_id: int) -> int:
        return self._entry(prefix_id).length

    def slot_of(self, prefix_id: int) -> int:
        return self._entry(prefix_id).slot

    def last_token_of(self, prefix_id: int) -> int | None:
        return self._entry(prefix_id).last_token

    def refs_of(self, prefix_id: int) -> int:
        return self._entry(prefix_id).refs

    def ids(self) -> list[int]:
        return sorted(self._entries)

    def __contains__(self, prefix_id: int) -> bool:
        return prefix_id in self._entries

    def __len__(self) -> int:
        return len(self._entries)


@dataclasses.dataclass
class _Stem:
    blocks: tuple          # block ids pinned for this prefix, in order
    length: int            # prefix token count (a multiple of block)


class PinnedStems:
    """Host-side registry of PINNED block runs on a paged KV slab: the
    :class:`PrefixPool` story in the paged engine's one-allocator world.

    A pinned stem is a run of ordinary cache blocks in the engine's slab
    whose references this registry holds, each block hash-registered
    like any admitted block, so a prompt that starts with the pinned
    tokens hits them through ordinary stem sharing (no id at submit).
    Pure bookkeeping: :meth:`PagedBatcher.pin_prefix` prefills the
    blocks and takes the references; ``pop`` hands back exactly the
    blocks of one pin.  Ids are never reused.
    """

    def __init__(self):
        self._entries: dict[int, _Stem] = {}
        self._next_id = 0
        self._lock = TracedRLock("serving.pinned_stems")

    def add(self, blocks, length: int) -> int:
        with self._lock:
            pid = self._next_id
            self._next_id += 1
            self._entries[pid] = _Stem(tuple(blocks), int(length))
            return pid

    def pop(self, prefix_id: int) -> tuple:
        """Remove the pin and return its block run (the caller releases
        the references)."""
        with self._lock:
            e = self._entries.pop(prefix_id, None)
            if e is None:
                raise KeyError(
                    f"unknown pinned prefix {prefix_id} (unpinned "
                    "already or never pinned; ids are never reused)")
            return e.blocks

    def length_of(self, prefix_id: int) -> int:
        return self._entry(prefix_id).length

    def blocks_of(self, prefix_id: int) -> tuple:
        return self._entry(prefix_id).blocks

    def _entry(self, prefix_id: int) -> _Stem:
        e = self._entries.get(prefix_id)
        if e is None:
            raise KeyError(f"unknown pinned prefix {prefix_id}")
        return e

    def ids(self) -> list[int]:
        return sorted(self._entries)

    def __contains__(self, prefix_id: int) -> bool:
        return prefix_id in self._entries

    def __len__(self) -> int:
        return len(self._entries)


__all__ = ["PrefixPool", "PinnedStems"]

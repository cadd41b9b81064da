"""Elastic lane tiers: load-driven resizing of a serving engine.

The port's counterpart of ``distkeras_tpu/serving/elastic.py``.
:class:`_ElasticMixin` is the host-side hysteresis every
:class:`~distkeras_tpu_torch.serving.engine._LaneEngine` carries (inert
unless ``lane_tiers`` is set): sustained ``enqueue`` overflow steps the
lane count up one tier, sustained idle steps step it back down, and a
resize compacts the occupied lanes.  :class:`_ElasticLanesMixin` is
:class:`~distkeras_tpu_torch.serving.lanes.ContinuousBatcher`'s device
half: the resize is one device gather over the cache's lane axis and the
per-lane rows.  Eager torch compiles nothing, so where the reference
warms every tier's programs at construction, the port keeps only the
contracts that warm-up fixed: the declared tiers and step windows.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from distkeras_tpu_torch import obs


class _ElasticMixin:
    """Host-side tier hysteresis; inert when ``lane_tiers`` is None."""

    def _try_scale_up(self) -> bool:
        """One overflow strike; step the lane tier up once the
        backpressure is sustained (``scale_up_after`` consecutive
        overflowing enqueues).  Returns whether a resize happened —
        False means the caller raises QueueFull."""
        if self.lane_tiers is None:
            return False
        i = self.lane_tiers.index(self.lanes)
        if i + 1 >= len(self.lane_tiers):
            return False
        self._bp_strikes += 1
        if self._bp_strikes < self.scale_up_after:
            return False
        self._resize_to(self.lane_tiers[i + 1])
        return True

    def _maybe_scale_down(self) -> None:
        """After ``scale_down_after`` consecutive steps with the queue
        empty and occupancy at or under the next tier down, shrink to it
        (free lanes burn a decode row per step).  Runs under the
        admission lock: the resize compacts ``_lane_state``."""
        if self.lane_tiers is None:
            return
        with obs.held(self._admission_lock):
            i = self.lane_tiers.index(self.lanes)
            if i == 0:
                return
            lower = self.lane_tiers[i - 1]
            busy = sum(1 for s in self._lane_state if s is not None)
            if busy <= lower and not self._pending:
                self._idle_strikes += 1
            else:
                self._idle_strikes = 0
                return
            if self._idle_strikes >= self.scale_down_after:
                self._resize_to(lower)

    def _resize_to(self, tier: int) -> None:
        """Move the engine to ``tier`` lanes: occupied lanes compact into
        the low indices (device rows gathered, host records remapped —
        the chunked-admission queue included); new lanes arrive free,
        their stale rows masked until admission overwrites them."""
        old = self.lanes
        keep = [i for i, s in enumerate(self._lane_state) if s is not None]
        assert len(keep) <= tier, "resize below occupancy"
        self._resize_state(np.asarray(keep + [0] * (tier - len(keep)),
                                      np.int64))
        state: list = [None] * tier
        new_of = {}
        for j, i in enumerate(keep):
            state[j] = self._lane_state[i]
            new_of[i] = j
        self._lane_state = state
        self._admitting = collections.deque(
            new_of[lane] for lane in self._admitting)
        self.lanes = tier
        self.tier_epoch += 1
        self._bp_strikes = self._idle_strikes = 0
        obs.gauge("serving.lanes_tier", tier)
        obs.count("serving.resizes",
                  direction="up" if tier > old else "down")
        obs.event("serving.resize", from_lanes=old, to_lanes=tier,
                  tier_epoch=self.tier_epoch)

    def _resize_state(self, idx) -> None:  # pragma: no cover
        raise NotImplementedError(
            "this engine does not support lane_tiers")


class _ElasticLanesMixin:
    """ContinuousBatcher's device half of elasticity: the resize
    gather of lanes ``idx[j] -> j`` over the whole lane state."""

    def _resize_state(self, idx) -> None:
        at = torch.as_tensor(idx, device=self.device)
        self.cache = {name: a.index_select(1, at)
                      for name, a in self.cache.items()}
        self._resize_rows(idx)

    def _resize_rows(self, idx) -> None:
        """The per-lane row state of a resize (the paged engine's whole
        device move: its slab is lane-count-independent)."""
        at = torch.as_tensor(idx, device=self.device)
        self.cur, self.pos, self.temps, self.tps, self.mps = (
            a.index_select(0, at)
            for a in (self.cur, self.pos, self.temps, self.tps, self.mps))
        self._hpos = self._hpos[idx]
        self._htemps = self._htemps[idx]
        self._seeds = [self._seeds[i] for i in idx]


__all__ = ["_ElasticMixin", "_ElasticLanesMixin"]

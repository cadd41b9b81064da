"""Seeded deterministic trace-replay load driver for the serving engines.

The port's own copy of ``distkeras_tpu/serving/traffic.py``.  A load
test is only repeatable against a load signal that is *reproducible*:
the same trace must produce the same queue build-up on every run.  This
module is that signal — a :class:`TraceReplay` whose request schedule is
a **pure function of ``(seed, tick)``** under a virtual clock
(independent ``SeedSequence`` draws per tick, so ticks can be generated
in any order and two runs are bit-identical).

Four trace shapes:

==============  =====================================================
shape           offered load per tick
==============  =====================================================
``diurnal``     a smooth ramp ``base -> peak -> base`` over
                ``period`` ticks (``sin(pi * t / period)``) — the
                slow swing scale-up/scale-down must track without
                thrashing.
``spike``       flat ``base_rate`` except a flash window
                ``[spike_at, spike_at + spike_len)`` at
                ``spike_rate`` — the event a warm pool exists for.
``shuffle``     flat ``base_rate`` with **stem locality destroyed**:
                every request gets a unique stem, so the affinity
                table buys nothing and routing degenerates to
                least-loaded (the adversarial floor for cache-aware
                fleets).
``tenant_mix``  flat ``base_rate`` split across weighted tenants —
                the multi-tenant fairness axis (per-tenant request
                counters let a report attribute load).
==============  =====================================================

Requests are (tenant, stem, tail) triples: ``stem`` indexes a small
shared stem pool (the locality handle — repeated stems are what the
router's affinity table keys on), ``tail`` is unique per request, and
:meth:`TraceReplay.prompt` expands the triple into deterministic
tokens.  :meth:`TraceReplay.replay` additionally emits the
``traffic.offered`` gauge and ``traffic.requests`` counter, an auditable
offered-load record.  Trace generation is host arithmetic only.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from distkeras_tpu_torch import obs

TRACE_SHAPES = ("diurnal", "spike", "shuffle", "tenant_mix")

# Independent SeedSequence lanes: shape-id keys the per-tick arrival
# stream, the STEM/TAIL keys derive prompt tokens — disjoint from the
# arrival lane so reading a prompt never perturbs the schedule.
_SHAPE_IDS = {s: i for i, s in enumerate(TRACE_SHAPES)}
_STEM_KEY = 101
_TAIL_KEY = 202
# Unique-id span per tick: tails (and shuffle stems) are
# ``tick * _TAIL_SPAN + index`` — collision-free for any tick, no RNG
# involved, so uniqueness survives reordering.
_TAIL_SPAN = 1 << 20


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One scheduled arrival: ``tick``/``index`` place it in the
    trace, ``tenant`` labels it, ``stem`` is the shared-prefix handle
    (equal stems -> equal warm prompt -> an affinity hit), ``tail``
    is unique per request, ``max_new`` the decode budget."""

    tick: int
    index: int
    tenant: str
    stem: int
    tail: int
    max_new: int


class TraceReplay:
    """The deterministic trace (module docstring has the shapes).

    ``tenants`` is ``((name, weight), ...)``; weights are normalized.
    ``max_new`` is an inclusive ``(lo, hi)`` decode-budget range.
    ``stems`` sizes the shared stem pool (ignored by ``shuffle``,
    which makes every stem unique on purpose).
    """

    def __init__(self, shape: str, seed: int = 0, *,
                 base_rate: float = 2.0, peak_rate: float = 8.0,
                 period: int = 64, spike_at: int = 16,
                 spike_len: int = 8, spike_rate: float = 12.0,
                 stems: int = 4, tenants=(("t0", 1.0),),
                 max_new=(4, 8)):
        if shape not in TRACE_SHAPES:
            raise ValueError(
                f"shape must be one of {TRACE_SHAPES}, got {shape!r}")
        if base_rate <= 0 or peak_rate <= 0 or spike_rate <= 0:
            raise ValueError("rates must be > 0")
        if period < 2:
            raise ValueError(f"period must be >= 2, got {period}")
        if spike_len < 1:
            raise ValueError(f"spike_len must be >= 1, got {spike_len}")
        if stems < 1:
            raise ValueError(f"stems must be >= 1, got {stems}")
        if not tenants:
            raise ValueError("need at least one tenant")
        lo, hi = int(max_new[0]), int(max_new[1])
        if not 1 <= lo <= hi:
            raise ValueError(f"max_new must be 1 <= lo <= hi, "
                             f"got ({lo}, {hi})")
        self.shape = shape
        self.seed = int(seed)
        self.base_rate = float(base_rate)
        self.peak_rate = float(peak_rate)
        self.period = int(period)
        self.spike_at = int(spike_at)
        self.spike_len = int(spike_len)
        self.spike_rate = float(spike_rate)
        self.stems = int(stems)
        self.tenant_names = tuple(str(n) for n, _ in tenants)
        w = np.asarray([float(x) for _, x in tenants], float)
        if (w <= 0).any():
            raise ValueError("tenant weights must be > 0")
        self.tenant_weights = w / w.sum()
        self.max_new_range = (lo, hi)

    # ------------------------------------------------------------ shape

    def rate(self, tick: int) -> float:
        """Offered requests per tick — deterministic arithmetic, no
        RNG (the trace's mean-load envelope)."""
        t = int(tick)
        if self.shape == "diurnal":
            phase = (t % self.period) / self.period
            return self.base_rate + (self.peak_rate - self.base_rate) \
                * math.sin(math.pi * phase)
        if self.shape == "spike":
            if self.spike_at <= t < self.spike_at + self.spike_len:
                return self.spike_rate
            return self.base_rate
        return self.base_rate  # shuffle / tenant_mix: flat

    # --------------------------------------------------------- schedule

    def requests_at(self, tick: int) -> tuple[TraceRequest, ...]:
        """The tick's arrivals — a pure function of ``(seed, shape,
        tick)`` via an independent ``SeedSequence`` per tick (the
        AsyncSchedule contract: any tick, any order, bit-identical
        across runs)."""
        t = int(tick)
        if t < 0:
            raise ValueError(f"tick must be >= 0, got {tick}")
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed, _SHAPE_IDS[self.shape], t]))
        n = int(rng.poisson(self.rate(t)))
        lo, hi = self.max_new_range
        out = []
        for i in range(n):
            tenant = self.tenant_names[int(rng.choice(
                len(self.tenant_names), p=self.tenant_weights))]
            stem = int(rng.integers(self.stems))
            if self.shape == "shuffle":
                # Adversarial: a unique stem per request means no two
                # prompts share a warm prefix — affinity scores 0
                # everywhere and the cache-aware policy degenerates
                # to least-loaded.
                stem = self.stems + t * _TAIL_SPAN + i
            out.append(TraceRequest(
                tick=t, index=i, tenant=tenant, stem=stem,
                tail=t * _TAIL_SPAN + i,
                max_new=int(rng.integers(lo, hi + 1))))
        return tuple(out)

    def replay(self, tick: int) -> tuple[TraceRequest, ...]:
        """:meth:`requests_at` plus the audit-trail emissions: the
        per-tick ``traffic.offered`` gauge and one
        ``traffic.requests`` increment per arrival."""
        reqs = self.requests_at(tick)
        obs.gauge("traffic.offered", float(len(reqs)),
                  shape=self.shape)
        for r in reqs:
            obs.count("traffic.requests", shape=self.shape,
                      tenant=r.tenant)
        return reqs

    # ---------------------------------------------------------- prompts

    def prompt(self, req: TraceRequest, *, stem_len: int = 8,
               tail_len: int = 2, vocab: int = 64) -> np.ndarray:
        """Expand a request into prompt tokens: ``stem_len`` tokens
        derived from ``req.stem`` (equal stems -> identical warm
        prefix) plus ``tail_len`` unique tokens from ``req.tail``.
        Deterministic and independent of the arrival stream."""
        if stem_len < 1 or tail_len < 1:
            raise ValueError("stem_len and tail_len must be >= 1")
        if vocab < 2:
            raise ValueError(f"vocab must be >= 2, got {vocab}")
        stem_rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed, _STEM_KEY, int(req.stem)]))
        tail_rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed, _TAIL_KEY, int(req.tail)]))
        return np.concatenate([
            stem_rng.integers(0, vocab, size=stem_len),
            tail_rng.integers(0, vocab, size=tail_len),
        ]).astype(np.int32)


__all__ = ["TraceReplay", "TraceRequest", "TRACE_SHAPES"]

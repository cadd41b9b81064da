"""SpeculativeBatcher: draft-assisted continuous batching.

The port's counterpart of ``distkeras_tpu/serving/speculative.py``.
Every lane advances up to ``n_draft + 1`` positions per step:
``n_draft`` draft proposals, ONE target verify chunk, per-lane
acceptance.  The lane and admission machinery is
:class:`~distkeras_tpu_torch.serving.lanes.ContinuousBatcher`'s, through
:class:`~distkeras_tpu_torch.serving.engine._LaneEngine`.
"""

from __future__ import annotations

import numpy as np
import torch

from distkeras_tpu_torch import obs
from distkeras_tpu_torch.models.generate import (_decode_chunk, _not_ported,
                                                 _position_generator,
                                                 init_cache,
                                                 rolling_eligible)
from distkeras_tpu_torch.models.speculative import (_draw_generator,
                                                    _gumbel_pick,
                                                    speculative_accept)
from distkeras_tpu_torch.models.transformer import TransformerConfig
from distkeras_tpu_torch.resilience import chaos
from distkeras_tpu_torch.serving.engine import (_Lane, _LaneEngine,
                                                _make_lane_admit,
                                                _make_lane_reseed)
from distkeras_tpu_torch.serving.prefix import _spec
from distkeras_tpu_torch.utils.device import check_on_device, resolve_device


class SpeculativeBatcher(_LaneEngine):
    """Draft-assisted continuous batching: every lane advances up to
    ``n_draft + 1`` positions per step.

    The step is one iteration of :func:`speculative_generate`'s body
    vectorized over lanes at divergent positions: ``n_draft`` draft
    proposals (the first a T=2 chunk closing the full-acceptance cache
    gap, as the solo loop does), ONE target verify chunk, per-lane
    acceptance and an advance of ``accepted + 1`` tokens.  Rejected-tail
    cache writes land beyond each lane's frontier and stay masked until
    overwritten, so lanes never interact.

    Contract: every request's tokens are exactly its solo batch-1
    ``speculative_generate`` run's (same seed).  Greedy, that is
    ``generate``'s greedy rollout; sampled (engine-level ``temperature >
    0``, per-request seeds), each lane keeps its own iteration counter,
    so its draws come from the solo run's ``(seed, iteration, slot)``
    streams whenever it was admitted.

    Pooled prefixes: a ``PrefixPool(cfg, slots, draft_cfg=draft_cfg)``
    holds ``(target, draft)`` segment pairs; ``submit`` takes
    ``prefix_id=`` and both lane caches are seeded from the pair.  A
    1-token prompt against a prefix needs its ``last_token`` recorded at
    ``PrefixPool.put``.  Full-cache configs only.

    Budget (full-cache): ``prefix + prompt + max_new_tokens + n_draft <=
    max_len`` on both models.  Finished lanes keep decoding with their
    frontier clamped at the last budget-safe position.  Rolling lanes:
    when both configs are rope + ``attention_window`` with ``window +
    n_draft + 1 <= max_len``, lanes decode past ``max_len`` on the rings.

    A fault in the draft half of a step (``serving.draft`` chaos probe)
    degrades the engine for good to a target-only decode step: requests
    still complete, and greedy ones keep their tokens.  Either tree may be
    int8 (``quantize_params``); the engine has no ``kv_int8`` mode, as in
    the reference.  ``plan=`` / ``mesh=`` raise (ROADMAP A7b).
    """

    def __init__(self, params, draft_params, cfg: TransformerConfig,
                 draft_cfg: TransformerConfig, lanes: int = 8,
                 n_draft: int = 4, temperature: float = 0.0,
                 eos_token=None, prompt_buckets=(8, 32, 128, 512),
                 max_queue: int = 0, clock=None, prefix_pool=None,
                 plan=None, mesh=None, device=None):
        if plan is not None or mesh is not None:
            raise _not_ported("pod-sharded serving (plan= / mesh=)", "A7b")
        self.device = resolve_device(device)
        check_on_device(params, self.device)
        check_on_device(draft_params, self.device)
        self._rolling = False
        if (cfg.attention_window is None) != (draft_cfg.attention_window
                                              is None):
            raise ValueError(
                "speculative serving needs the target and draft caches "
                "to agree: both full-cache or both windowed (got "
                f"target window={cfg.attention_window}, draft "
                f"window={draft_cfg.attention_window})")
        if cfg.attention_window is not None:
            if prefix_pool is not None:
                raise ValueError("prefix_pool requires full-cache "
                                 "configs (no attention_window)")
            for name, c in (("cfg", cfg), ("draft_cfg", draft_cfg)):
                if not rolling_eligible(c):
                    raise ValueError(
                        f"windowed speculative serving runs rolling "
                        f"lanes, which needs {name}.rope=True and "
                        f"attention_window <= max_len")
                if c.attention_window + n_draft + 1 > c.max_len:
                    raise ValueError(
                        f"rolling speculative lanes need "
                        f"{name}.attention_window "
                        f"({c.attention_window}) + n_draft + 1 "
                        f"({n_draft + 1}) <= max_len ({c.max_len}): "
                        "the verify chunk's rejected tail must alias "
                        "outside every live query's band")
            self._rolling = True
        if draft_cfg.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft vocab_size {draft_cfg.vocab_size} != target "
                f"{cfg.vocab_size} — the models must share a tokenizer")
        if n_draft < 1:
            raise ValueError(f"n_draft must be >= 1, got {n_draft}")
        if min(cfg.max_len, draft_cfg.max_len) <= n_draft + 1:
            raise ValueError(
                f"n_draft={n_draft} leaves no decode budget: the verify "
                f"chunk needs n_draft + 1 cache slots of slack, but "
                f"min(max_len)={min(cfg.max_len, draft_cfg.max_len)} "
                f"(target {cfg.max_len}, draft {draft_cfg.max_len}) <= "
                f"n_draft + 1 = {n_draft + 1}; lower n_draft or raise "
                "max_len")
        if lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {lanes}")
        if temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if eos_token is not None and not 0 <= eos_token < cfg.vocab_size:
            raise ValueError(
                f"eos_token {eos_token} outside vocab [0, "
                f"{cfg.vocab_size})")
        if prefix_pool is not None:
            if prefix_pool.draft_cfg is None:
                raise ValueError(
                    "SpeculativeBatcher needs a speculative pool — "
                    "PrefixPool(cfg, slots, draft_cfg=draft_cfg), whose "
                    "segments are (target, draft) cache pairs")
            want = _spec((init_cache(cfg, 1, device=self.device),
                          init_cache(draft_cfg, 1, device=self.device)))
            got = tuple({n: (tuple(a.shape[1:]), a.dtype)
                         for n, a in s.items()} for s in prefix_pool.slab)
            if want != got or prefix_pool.device != self.device:
                raise ValueError(
                    f"prefix_pool was built for different configs or "
                    f"device (pool segments {got}, engine caches {want})")
        self._prefix_pool = prefix_pool
        self.params, self.draft_params = params, draft_params
        self.cfg, self.draft_cfg = cfg, draft_cfg
        self.lanes, self.n_draft = lanes, n_draft
        self.temperature = temperature
        self.eos_token = eos_token
        # The verify chunk writes k+1 slots past the frontier on BOTH
        # caches; rolling engines cap only the prompt (its uniform warm
        # chunk must not wrap).
        if self._rolling:
            self._cap = None
            bucket_cap = min(cfg.max_len, draft_cfg.max_len) - 1
        else:
            self._cap = min(cfg.max_len, draft_cfg.max_len) - n_draft - 1
            bucket_cap = self._cap
        self._buckets = tuple(sorted(
            {min(int(w), bucket_cap) for w in prompt_buckets}
            | {bucket_cap}))
        self._lane_state: list[_Lane | None] = [None] * lanes
        self._next_id = 0
        self._init_admission(max_queue, clock)
        self._degraded = False
        self.degraded_error = None

        dev = self.device
        self.tcache = init_cache(cfg, lanes, device=dev)
        self.dcache = init_cache(draft_cfg, lanes, device=dev)
        self.pos = torch.zeros((lanes,), dtype=torch.long, device=dev)
        self.cur = torch.zeros_like(self.pos)     # token at pos
        self.prev = torch.zeros_like(self.pos)    # token at pos - 1
        # Host mirrors: per-lane seeds, iteration counters and (for the
        # degraded path's draws) positions.
        self._seeds: list[int | None] = [None] * lanes
        self._iters = np.zeros(lanes, np.int64)
        self._hpos = np.zeros(lanes, np.int64)
        self._step_idx = torch.arange(n_draft + 1, device=dev)
        pooled = prefix_pool is not None
        self._admit_t = _make_lane_admit(params, cfg, pooled=pooled)
        self._admit_d = _make_lane_admit(draft_params, draft_cfg,
                                         pooled=pooled)
        if pooled:
            self._reseed_t = _make_lane_reseed(pooled=True)
            self._reseed_d = _make_lane_reseed(pooled=True)

    # -------------------------------------------------------------- API

    def _validate_budget(self, p: int, max_new_tokens: int,
                         off: int = 0) -> None:
        if self._rolling:
            if p - 1 > self._buckets[-1]:
                raise ValueError(
                    f"prompt length {p} exceeds the largest admission "
                    f"bucket ({self._buckets[-1]} + 1); rolling "
                    "speculative prompts must fit the ring")
            return
        if off + p + max_new_tokens - 1 > self._cap:
            raise ValueError(
                f"prefix ({off}) + prompt ({p}) + max_new_tokens "
                f"({max_new_tokens}) + n_draft ({self.n_draft}) exceeds "
                f"max_len={min(self.cfg.max_len, self.draft_cfg.max_len)}"
                " (the verify chunk needs n_draft + 1 slots of slack)")
        warm = p - 1
        if warm and self._bucket(warm, off) is None:
            raise ValueError(
                f"no admission bucket fits {warm} prompt tokens past a "
                f"{off}-token prefix (buckets {self._buckets}); raise "
                "prompt_buckets or add a finer width")

    def _bucket(self, warm: int, off: int):
        top = min(self.cfg.max_len, self.draft_cfg.max_len)
        return next((w for w in self._buckets
                     if w >= warm and off + w <= top), None)

    def submit(self, prompt, max_new_tokens: int, seed=None,
               eos_token=None, ttl=None, deadline=None, prefix_id=None):
        """Admit one request; returns its lane id, or None if full.
        ``seed``: the request's sampling seed (required iff the engine
        samples).  ``ttl`` / ``deadline`` and the engine lock as in
        :meth:`ContinuousBatcher.submit`; ``prefix_id``: decode past a
        pooled (target, draft) prefix pair."""
        with obs.held(self._admission_lock):
            return self._submit_locked(prompt, max_new_tokens, seed,
                                       eos_token, ttl, deadline, prefix_id)

    def _submit_locked(self, prompt, max_new_tokens, seed, eos_token,
                       ttl, deadline, prefix_id=None):
        self._check_open()
        prompt = self._validate_request_args(prompt, max_new_tokens)
        p = prompt.size
        if (seed is None) == (self.temperature > 0):
            raise ValueError(
                "pass a per-request seed iff the engine samples "
                f"(temperature={self.temperature})")
        off, slot, pre_last = 0, None, None
        if prefix_id is not None:
            off, slot, pre_last = self._pin_prefix(prefix_id)
        try:
            if prefix_id is not None and p == 1 and pre_last is None:
                raise ValueError(
                    "a 1-token prompt against a pooled prefix needs "
                    "the prefix's last token recorded at "
                    "PrefixPool.put(last_token=...): the draft chunk "
                    "rewrites the position before the prompt")
            self._validate_budget(p, max_new_tokens, off=off)
            if eos_token is not None and not (
                    0 <= eos_token < self.cfg.vocab_size):
                raise ValueError(
                    f"eos_token {eos_token} outside vocab [0, "
                    f"{self.cfg.vocab_size})")
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
            pool = self._prefix_pool
            if warm:
                width = self._bucket(warm, off)
                rows = np.zeros((1, width), np.int64)
                rows[0, :warm] = prompt[:-1]
                with obs.span("serving.admit", bucket=width, lane=lane,
                              request_id=rid):
                    if pool is not None:
                        t_slab, d_slab = pool.slab
                        at = -1 if slot is None else slot
                        self._admit_t(self.tcache, rows, lane, off,
                                      t_slab, at)
                        self._admit_d(self.dcache, rows, lane, off,
                                      d_slab, at)
                    else:
                        self._admit_t(self.tcache, rows, lane, 0)
                        self._admit_d(self.dcache, rows, lane, 0)
            elif slot is not None:
                # 1-token prompt on a pooled prefix: no chunk, but both
                # lane caches still need the prefix K/V.
                t_slab, d_slab = pool.slab
                self._reseed_t(self.tcache, lane, t_slab, slot)
                self._reseed_d(self.dcache, lane, d_slab, slot)
            # prev seeds the draft's T=2 gap-closure chunk: the token at
            # pos - 1 (the second-to-last prompt token, or the prefix's
            # recorded last token).
            self.pos[lane] = off + p - 1
            self.cur[lane] = int(prompt[-1])
            self.prev[lane] = (int(prompt[-2]) if p > 1 else
                               int(pre_last) if pre_last is not None
                               else 0)
            self._hpos[lane] = off + p - 1
            self._seeds[lane] = seed
            self._iters[lane] = 0
            self._lane_state[lane] = _Lane(
                request_id=rid, prompt_len=p,
                max_new=max_new_tokens, tokens=list(prompt),
                eos=self.eos_token if eos_token is None else eos_token,
                deadline=dl, born=self._clock(), off=off,
                prefix_id=prefix_id)
            if not self._admitting_internal:
                self.last_request_id = rid
        except Exception:
            if prefix_id is not None:
                self._prefix_pool.release(prefix_id)
            raise
        return lane

    # ------------------------------------------------- degraded mode

    @property
    def degraded(self) -> bool:
        """True once the engine fell back to the plain decode step."""
        return self._degraded

    def degrade(self, error=None) -> None:
        """Switch for good to the target-only decode step (called when
        the draft half of a step faults; an operator who knows the draft
        is bad may call it directly)."""
        if not self._degraded:
            obs.count("serving.degraded")
            obs.event("serving.degrade",
                      error=None if error is None else repr(error))
        self._degraded = True
        if error is not None and self.degraded_error is None:
            self.degraded_error = error

    # ------------------------------------------------------------ step

    def _draws(self, lanes, slot: int, shape):
        """Uniforms ``[lanes_total, *shape[1:]]``: row ``l`` from lane
        ``l``'s ``(seed, iteration, slot)`` stream for each sampled live
        lane in ``lanes``, 0.5 elsewhere (discarded rows)."""
        u = torch.full((self.lanes,) + shape, 0.5, device=self.device)
        for lane in lanes:
            gen = _draw_generator(self._seeds[lane], int(self._iters[lane]),
                                  slot, self.device)
            u[lane] = torch.rand((1,) + shape, generator=gen,
                                 device=self.device)[0]
        return u

    def _draft(self, live):
        """The draft half of a speculative iteration over every lane
        (device work only; it writes the draft cache and nothing else);
        returns the proposals ``d [lanes, k]`` and, sampled, the draft's
        log-probabilities of each slot."""
        k, vocab = self.n_draft, self.cfg.vocab_size
        sampled = self.temperature > 0
        pos, cur, prev = self.pos, self.cur, self.prev
        draw_lanes = live if sampled else []
        chaos.probe("serving.draft")
        # ---- draft: a T=2 chunk rewriting [pos-1, pos] first.
        pos0 = torch.clamp(pos - 1, min=0)
        first = torch.where((pos == 0)[:, None],
                            torch.stack([cur, torch.zeros_like(cur)], 1),
                            torch.stack([prev, cur], 1))
        lg2, _ = _decode_chunk(self.draft_params, self.dcache, first, pos0,
                               self.draft_cfg)
        lg = torch.gather(lg2, 1, (pos - pos0)[:, None, None].expand(
            -1, 1, vocab))[:, 0]
        d_toks, q_logps = [], []
        for j in range(k):
            if sampled:
                logp = torch.log_softmax(lg / self.temperature, dim=-1)
                nxt = _gumbel_pick(logp, self._draws(draw_lanes, j,
                                                     (vocab,)))
                q_logps.append(logp)
            else:
                nxt = lg.argmax(dim=-1)
            d_toks.append(nxt)
            if j < k - 1:
                lgj, _ = _decode_chunk(self.draft_params, self.dcache,
                                       nxt[:, None], pos + 1 + j,
                                       self.draft_cfg)
                lg = lgj[:, 0]
        return torch.stack(d_toks, dim=1), q_logps          # [lanes, k]

    def _verify(self, live, d, q_logps):
        """The target half: ONE verify chunk over ``[cur, d_1..d_k]``,
        per-lane acceptance and the advance; returns ``(win [lanes,
        k+1], adv [lanes])``."""
        k, vocab = self.n_draft, self.cfg.vocab_size
        sampled = self.temperature > 0
        pos, cur, prev = self.pos, self.cur, self.prev
        draw_lanes = live if sampled else []
        tlog, _ = _decode_chunk(self.params, self.tcache,
                                torch.cat([cur[:, None], d], dim=1), pos,
                                self.cfg)
        if sampled:
            p_logp = torch.log_softmax(tlog / self.temperature, dim=-1)
            n, corr_logits = speculative_accept(
                p_logp, torch.stack(q_logps, dim=1), d,
                self._draws(draw_lanes, k + 1, (k,)))
            corrective = _gumbel_pick(corr_logits, self._draws(
                draw_lanes, k + 2, (vocab,)))
        else:
            t_pred = tlog.argmax(dim=-1)
            n = torch.cumprod((d == t_pred[:, :k]).long(), dim=1).sum(1)
            corrective = torch.gather(t_pred, 1, n[:, None])[:, 0]
        d_ext = torch.cat([d, d[:, -1:]], dim=1)
        win = torch.where(self._step_idx[None, :] < n[:, None], d_ext,
                          corrective[:, None])
        # ---- advance: accepted + corrective; full-cache frontiers clamp
        # at the budget-safe cap (live lanes never reach it).
        if self._rolling:
            adv = n + 1
        else:
            adv = torch.where(pos >= self._cap, 0,
                              torch.minimum(n + 1, self._cap - pos))
        last = torch.gather(win, 1, torch.clamp(adv - 1, min=0)[:, None])
        second = torch.gather(win, 1, torch.clamp(adv - 2, min=0)[:, None])
        self.prev = torch.where(adv >= 2, second[:, 0],
                                torch.where(adv == 1, cur, prev))
        self.cur = torch.where(adv > 0, last[:, 0], cur)
        self.pos = pos + adv
        return win, adv

    def _plain_step(self):
        """The degraded step: one target token per lane (sampled lanes
        draw from ``_position_generator(seed, pos)``, as generate does),
        frontier clamped like the speculative step's; rolling lanes keep
        their unbounded ring positions."""
        pos, cur = self.pos, self.cur
        logits, _ = _decode_chunk(self.params, self.tcache, cur[:, None],
                                  pos, self.cfg)
        logits = logits[:, 0]
        if self.temperature > 0:
            u = torch.full_like(logits, 0.5)
            for lane in self.running():
                gen = _position_generator(self._seeds[lane],
                                          int(self._hpos[lane]), self.device)
                u[lane] = torch.rand((1, logits.shape[-1]), generator=gen,
                                     device=self.device)[0]
            nxt = _gumbel_pick(logits / self.temperature, u)
        else:
            nxt = logits.argmax(dim=-1)
        if self._rolling:
            adv = torch.ones_like(pos)
        else:
            adv = (pos < self._cap).long()
        self.cur = torch.where(adv > 0, nxt, cur)
        self.pos = pos + adv
        return nxt[:, None], adv

    def step(self):
        """One decode round for every lane; returns ``{lane:
        [tokens...]}`` — up to ``n_draft + 1`` tokens per lane (exactly 1
        once degraded).  One read of the device per round (the window
        and the advances).  Runs under the engine lock."""
        with obs.held(self._admission_lock):
            self.pump()
            if all(s is None or s.done for s in self._lane_state):
                return {}
            chaos.probe("serving.step")
            live = self.running()
            obs.gauge("serving.lanes_busy", len(live))
            win = None
            if not self._degraded:
                with obs.span("serving.step", speculative=True), \
                        torch.no_grad():
                    try:
                        proposals = self._draft(live)
                    except Exception as e:  # noqa: BLE001 — degrade
                        # Only the draft cache was written: the target
                        # cache and the lane rows are intact.  A fault
                        # in the verify half raises.
                        self.degrade(e)
                    else:
                        win, adv = self._verify(live, *proposals)
                        self._iters += 1
            speculative = win is not None
            if not speculative:
                with obs.span("serving.step", speculative=False):
                    with torch.no_grad():
                        win, adv = self._plain_step()
            host = torch.cat([win, adv[:, None]], dim=1).cpu().numpy()
            win, adv = host[:, :-1], host[:, -1]
            self._hpos = self._hpos + adv
            if speculative and obs.active() is not None:
                # Each live lane advanced accepted + 1 positions.
                obs.count("serving.spec.proposed", self.n_draft * len(live))
                obs.count("serving.spec.accepted",
                          int(np.maximum(adv[live] - 1, 0).sum()))
            out = self._emit(lambda lane: win[lane, :adv[lane]].tolist())
            self._reap()
            return out


__all__ = ["SpeculativeBatcher"]

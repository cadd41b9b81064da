"""Speculative decoding: draft-model-assisted generation, in PyTorch.

Counterpart of ``distkeras_tpu/models/speculative.py``.  A small draft
model proposes ``n_draft`` tokens one at a time, and the target scores
all of them in ONE chunked forward (:func:`~distkeras_tpu_torch.models.
generate._decode_chunk`, per-row positions), so accepted prefixes
advance several positions per target pass.  The output is exact:

- greedy (``temperature=0``): acceptance is argmax agreement and the
  corrective token is the target's argmax, so the sequence equals
  ``generate``'s greedy rollout (up to float ties between the chunked
  and per-step products);
- sampled: the Leviathan/Chen rule (accept a draft token x with
  probability min(1, p(x)/q(x)); on the first rejection draw from
  norm(max(p - q, 0))) makes every token an exact sample of the target.

Random draws: iteration ``i``'s draft draws (slot ``j``), accept
uniforms (slot ``n_draft + 1``) and corrective draw (slot
``n_draft + 2``) come from ``torch.Generator``s that are pure functions
of ``(seed, i, slot)`` (:func:`_draw_generator`) — JAX's
``fold_in(key, i)`` keys cannot be reproduced — so a batch-1 run replays
exactly inside :class:`~distkeras_tpu_torch.serving.SpeculativeBatcher`.
The loop reads one boolean per iteration (is any row unfinished) on the
host; everything else stays on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from distkeras_tpu_torch.models.generate import (_check_eos, _decode_chunk,
                                                 init_cache, prefill,
                                                 rolling_eligible)
from distkeras_tpu_torch.models.quant import is_quantized
from distkeras_tpu_torch.models.transformer import TransformerConfig
from distkeras_tpu_torch.utils.device import check_on_device, resolve_device


def _draw_generator(seed: int, it: int, slot: int, device) -> torch.Generator:
    """The stream of one draw of speculative iteration ``it``: a pure
    function of ``(seed, it, slot)``."""
    state = np.random.SeedSequence([seed, it, slot]).generate_state(
        1, np.uint64)
    return torch.Generator(device=device).manual_seed(
        int(state[0]) & (2**63 - 1))


def _gumbel_pick(logp, u):
    """One categorical draw per row from log-probabilities (or logits)
    by the Gumbel-max trick on uniforms ``u`` of the same shape."""
    return (logp - torch.log(-torch.log(u))).argmax(dim=-1)


def _validate(params, draft_params, cfg, draft_cfg, p, max_new_tokens,
              n_draft, temperature, seed, eos_token=None):
    _check_eos(eos_token, cfg)
    if draft_cfg.vocab_size != cfg.vocab_size:
        raise ValueError(
            f"draft vocab_size {draft_cfg.vocab_size} != target "
            f"{cfg.vocab_size} — the models must share a tokenizer")
    if n_draft < 1:
        raise ValueError(f"n_draft must be >= 1, got {n_draft}")
    if max_new_tokens < 1:
        raise ValueError(
            f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if p < 1:
        raise ValueError("prompt must contain at least one token")
    if temperature > 0 and seed is None:
        raise ValueError("temperature sampling needs an explicit seed")
    total = p + max_new_tokens
    # Full-cache configs: the verify chunk reaches position cur + n_draft
    # <= total - 1 + n_draft, so the cache needs n_draft slots of slack.
    # Windowed configs: the ring absorbs any total, but rolling needs
    # rope and a fitting window, the prompt warm pass cannot wrap, and
    # window + n_draft + 1 <= max_len keeps a rejected tail's ring slots
    # outside every live query's band.
    for name, c in (("cfg", cfg), ("draft_cfg", draft_cfg)):
        if c.attention_window is None:
            if total + n_draft > c.max_len:
                raise ValueError(
                    f"speculative decoding needs cache slack: "
                    f"{name}.max_len={c.max_len} < prompt ({p}) + "
                    f"max_new_tokens ({max_new_tokens}) + n_draft "
                    f"({n_draft})")
            continue
        if c.attention_window + n_draft + 1 > c.max_len:
            raise ValueError(
                f"speculative decoding on a ring cache needs "
                f"{name}.attention_window ({c.attention_window}) + "
                f"n_draft + 1 ({n_draft + 1}) <= max_len "
                f"({c.max_len}): the verify chunk's rejected tail "
                "must alias outside every live query's band")
        if p > c.max_len:
            raise ValueError(
                f"prompt ({p}) exceeds {name}.max_len={c.max_len} "
                "(the prompt warm pass cannot wrap the ring)")
        if total + n_draft > c.max_len and not rolling_eligible(c):
            raise ValueError(
                f"speculative decoding past {name}.max_len={c.max_len} "
                "rolls the ring cache, which needs rope=True and "
                f"attention_window <= max_len (got rope={c.rope})")
    return total


def speculative_accept(p_logp, q_logp, d, u):
    """The Leviathan/Chen acceptance and residual, shared by the solo
    loop and :class:`~distkeras_tpu_torch.serving.SpeculativeBatcher`.

    ``p_logp [B, k+1, V]`` target log-probs, ``q_logp [B, k, V]`` draft
    log-probs, ``d [B, k]`` draft tokens, ``u [B, k]`` uniforms.  Returns
    ``(n [B], corrective_logits [B, V])``: accepted prefix lengths and
    ``log(norm(max(p - q, 0)))`` at the first rejected position (past
    the end it reduces to p itself: q is padded with zeros)."""
    k = q_logp.shape[1]
    p_d = torch.gather(p_logp[:, :k], 2, d[..., None])[..., 0]
    q_d = torch.gather(q_logp, 2, d[..., None])[..., 0]
    accept = u < torch.exp(torch.clamp(p_d - q_d, max=0.0))   # [B, k]
    n = torch.cumprod(accept.long(), dim=1).sum(dim=1)         # [B]
    at_n = n[:, None, None].expand(-1, 1, p_logp.shape[-1])
    p_n = torch.gather(torch.exp(p_logp), 1, at_n)[:, 0]      # [B, V]
    q_pad = torch.cat([torch.exp(q_logp),
                       torch.zeros_like(q_logp[:, :1])], dim=1)
    q_n = torch.gather(q_pad, 1, at_n)[:, 0]
    r = torch.clamp(p_n - q_n, min=0.0)
    rs = r.sum(dim=-1, keepdim=True)
    r = torch.where(rs > 0, r / torch.clamp(rs, min=1e-30), p_n)
    return n, torch.log(r + 1e-30)


def _warm_cache(model_params, model_cfg, buf, p, device, kv_int8=False):
    """A cache holding the prompt positions before p-1 (position p-1 is
    re-processed by the first verify/draft chunk, as generate()'s prefill
    path does): by :func:`prefill` (the flash kernel on the card) for a
    full-precision tree; for an int8 tree, by teacher-forced chunks of up
    to 128 positions through the plain decode attention, as the
    reference warms it.  A 1-token prompt needs no warm-up."""
    if p > 1 and not is_quantized(model_params):
        cache, _ = prefill(model_params, buf[:, :p], model_cfg,
                           last_logits=False, kv_int8=kv_int8, device=device)
        return cache
    b = buf.shape[0]
    cache = init_cache(model_cfg, b, kv_int8=kv_int8, device=device)
    for start in range(0, p - 1, 128):
        width = min(128, p - 1 - start)
        _decode_chunk(model_params, cache, buf[:, start:start + width],
                      torch.full((b,), start, dtype=torch.long,
                                 device=device), model_cfg,
                      uniform_pos=True)
    return cache


def speculative_generate(params, draft_params, prompt, cfg: TransformerConfig,
                         draft_cfg: TransformerConfig, max_new_tokens: int,
                         n_draft: int = 4, temperature: float = 0.0,
                         seed: int | None = None,
                         eos_token: int | None = None,
                         kv_int8: bool = False, device=None):
    """Decode ``max_new_tokens`` past ``prompt [B, P]`` with draft
    assistance; returns ``(tokens int32 [B, P+N], stats)``.

    ``stats`` (0-dim tensors): ``iterations`` — target passes run;
    ``acceptance_rate`` — accepted draft tokens / tokens proposed by
    unfinished rows.  ``eos_token`` is sticky like :func:`generate`'s:
    once a row's accepted stream emits it, its remaining slots fill with
    it and the row stops consuming passes.  Either model may run a rope
    + ``attention_window`` ring cache, rolling past ``max_len``, under
    ``window + n_draft + 1 <= max_len``.  Uniform-length prompts; runs on
    ``device`` (the card unless ``device="cpu"``).  Either tree may be
    int8 (``quantize_params``: the self-speculative int8 draft of its own
    parent); ``kv_int8=True`` stores both caches as int8.
    """
    device = resolve_device(device)
    check_on_device(params, device)
    check_on_device(draft_params, device)
    prompt = torch.as_tensor(prompt, device=device).long()
    b, p = prompt.shape
    total = _validate(params, draft_params, cfg, draft_cfg, p,
                      max_new_tokens, n_draft, temperature, seed, eos_token)
    k = n_draft
    vocab = cfg.vocab_size
    sampled = temperature > 0
    # k+1 scratch columns past `total`: every iteration writes its whole
    # [k+1] window at cur+1, so a finished row's window (cur = total-1)
    # still lands in the buffer; finalized positions are never rewritten.
    buf = torch.zeros((b, total + k + 1), dtype=torch.long, device=device)
    buf[:, :p] = prompt
    idx = torch.arange(k + 1, device=device)
    two = torch.arange(2, device=device)
    with torch.no_grad():
        tcache = _warm_cache(params, cfg, buf, p, device, kv_int8)
        dcache = _warm_cache(draft_params, draft_cfg, buf, p, device,
                             kv_int8)
        cur = torch.full((b,), p - 1, dtype=torch.long, device=device)
        acc = torch.zeros((), dtype=torch.long, device=device)
        props = torch.zeros((), dtype=torch.long, device=device)
        it = 0
        while bool((cur < total - 1).any()):
            draw = lambda slot, shape: torch.rand(
                shape, device=device,
                generator=_draw_generator(seed, it, slot, device))
            # ---- k draft proposals.  The first is a T=2 chunk over
            # [buf[cur-1], buf[cur]]: after a full-acceptance iteration
            # slot cur-1 is unwritten in the draft cache (the draft never
            # processed its own last proposal); rewriting it closes the
            # gap.  At cur == 0 the clamped chunk covers [0, 1] and slot
            # 1's garbage is overwritten before anything reads it.
            pos0 = torch.clamp(cur - 1, min=0)
            first = torch.gather(buf, 1, pos0[:, None] + two)
            lg2, _ = _decode_chunk(draft_params, dcache, first, pos0,
                                   draft_cfg)
            lg = torch.gather(lg2, 1, (cur - pos0)[:, None, None].expand(
                -1, 1, vocab))[:, 0]
            d_toks, q_logps = [], []
            for j in range(k):
                if sampled:
                    logp = torch.log_softmax(lg / temperature, dim=-1)
                    nxt = _gumbel_pick(logp, draw(j, (b, vocab)))
                    q_logps.append(logp)
                else:
                    nxt = lg.argmax(dim=-1)
                d_toks.append(nxt)
                if j < k - 1:
                    lgj, _ = _decode_chunk(draft_params, dcache,
                                           nxt[:, None], cur + 1 + j,
                                           draft_cfg)
                    lg = lgj[:, 0]
            d = torch.stack(d_toks, dim=1)                       # [B, k]

            # ---- one target pass over [token@cur, d_1..d_k]
            chunk = torch.cat([torch.gather(buf, 1, cur[:, None]), d], 1)
            tlog, _ = _decode_chunk(params, tcache, chunk, cur, cfg)
            if sampled:
                p_logp = torch.log_softmax(tlog / temperature, dim=-1)
                n, corr_logits = speculative_accept(
                    p_logp, torch.stack(q_logps, dim=1), d,
                    draw(k + 1, (b, k)))
                corrective = _gumbel_pick(corr_logits,
                                          draw(k + 2, (b, vocab)))
            else:
                t_pred = tlog.argmax(dim=-1)                     # [B, k+1]
                n = torch.cumprod((d == t_pred[:, :k]).long(),
                                  dim=1).sum(dim=1)
                corrective = torch.gather(t_pred, 1, n[:, None])[:, 0]

            # ---- write [d_1..d_n, corrective, <garbage>] at cur+1
            done = cur >= total - 1
            advance = torch.where(done, 0, torch.minimum(n + 1,
                                                         total - 1 - cur))
            d_ext = torch.cat([d, d[:, -1:]], dim=1)             # [B, k+1]
            win = torch.where(idx[None, :] < n[:, None], d_ext,
                              corrective[:, None])
            if eos_token is not None:
                # Sticky eos: the advance stops at the first accepted
                # eos, the tail fills, and the row takes no more passes.
                is_eos = ((win == eos_token)
                          & (idx[None, :] < advance[:, None]))
                hit = is_eos.any(dim=1)
                first_eos = is_eos.long().argmax(dim=1)
                advance = torch.where(hit, first_eos + 1, advance)
            buf.scatter_(1, (cur + 1)[:, None] + idx[None, :], win)
            if eos_token is not None:
                span = torch.arange(buf.shape[1], device=device)
                fill = (hit[:, None]
                        & (span[None, :] > (cur + advance)[:, None])
                        & (span[None, :] < total))
                buf.masked_fill_(fill, eos_token)
                cur_next = torch.where(hit, total - 1, cur + advance)
            else:
                cur_next = cur + advance
            live = (~done).long()
            acc = acc + (n * live).sum()
            props = props + k * live.sum()
            cur = cur_next
            it += 1
    stats = {"iterations": torch.tensor(it),
             "acceptance_rate": acc.float() / torch.clamp(props, min=1)}
    return buf[:, :total].to(torch.int32), stats


__all__ = ["speculative_generate", "speculative_accept"]

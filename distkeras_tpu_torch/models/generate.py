"""KV-cached autoregressive decoding for the transformer LM, in PyTorch.

Counterpart of ``distkeras_tpu/models/generate.py``.  The cache is one
preallocated ``[L, B, max_len, kv_heads, head_dim]`` buffer per K and V;
:func:`prefill` fills the prompt positions in one batched forward (flash
attention — the Hopper kernel on the card), then a Python loop runs
:func:`_decode_step` per position.  Greedy decoding emits the JAX
package's tokens exactly; sampling draws from a per-position
``torch.Generator`` seeded from ``(seed, pos)`` (JAX's ``fold_in`` keys
cannot be reproduced), and ``top_k`` is always exact.

Not in this slice: ``prompt_cache``, ``kv_int8``, int8 weights, per-row
(speculative) chunks and ``beam_search`` (ROADMAP A5, A9).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from distkeras_tpu_torch.models.quant import deq, embed_rows, unembed_logits
from distkeras_tpu_torch.models.transformer import (
    TransformerConfig,
    _check_supported,
    _dot,
    _embed,
    _ffn,
    _layer,
    _rms_norm,
    _unembed,
    block_apply,
    rope_angles,
    rope_rotate,
)
from distkeras_tpu_torch.ops.attention import flash_attention
from distkeras_tpu_torch.utils.device import check_on_device, resolve_device


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def init_cache(cfg: TransformerConfig, batch: int, dtype=None, device=None):
    """Per-layer KV buffers [L, B, max_len, kv_heads, head_dim] (GQA
    configs cache only the shared K/V heads)."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.max_len, cfg.kv_heads, cfg.head_dim)
    dtype = dtype or cfg.torch_dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prefill(params, prompt, cfg: TransformerConfig,
            last_logits: bool = True, device=None):
    """Fill the KV cache for all prompt positions in ONE batched pass
    (the same ``block_apply`` body as the forward, flash attention over
    [B, P]).  Returns ``(cache, last [B, V] f32 or None)``."""
    device = resolve_device(device)
    check_on_device(params, device)
    _check_supported(cfg)
    prompt = torch.as_tensor(prompt, device=device).long()
    b, p_len = prompt.shape
    if p_len > cfg.max_len:
        raise ValueError(
            f"prompt length {p_len} exceeds max_len={cfg.max_len} "
            "(the KV cache size)")
    cache = init_cache(cfg, b, device=device)
    attention_fn = lambda q, k, v: flash_attention(
        q, k, v, True, window=cfg.attention_window)
    with torch.no_grad():
        x, rope_ang = _embed(params, prompt, cfg)
        for i in range(cfg.n_layers):
            x, _, (k, v) = block_apply(_layer(params["layers"], i), x, cfg,
                                       attention_fn, rope_ang,
                                       return_kv=True)
            # In place into the preallocated cache (copy_ casts to the
            # cache dtype, as the reference's astype does).
            cache["k"][i, :, :p_len].copy_(k)
            cache["v"][i, :, :p_len].copy_(v)
        if not last_logits:
            return cache, None
        x = _rms_norm(x, params["ln_f_scale"])
        return cache, _unembed(x[:, -1:], params, cfg)[:, 0]


def _layer_slab_update(cache_all, i: int, rows, pos: int):
    """Write ``rows [B, T, kv, hd]`` into layer ``i`` of the stacked cache
    ``[L, B, S, kv, hd]`` at position ``pos`` (clamped to ``S - T``, as
    ``dynamic_update_slice`` clamps).  Unlike the reference, which
    returns a new array, this writes IN PLACE into the preallocated
    buffer and returns it — no cache copy per step."""
    t_len = rows.shape[1]
    pos = min(max(int(pos), 0), cache_all.shape[2] - t_len)
    cache_all[i, :, pos:pos + t_len].copy_(rows)
    return cache_all


def _attend(qg, ck, cv, mask, cfg: TransformerConfig):
    """Decode attention over the cache in f32: ``qg [B, T, kv, G, hd]``
    against ``ck/cv [B, S, kv, hd]`` under a boolean mask broadcastable to
    ``[B, T, kv, G, S]``; masked slots take the literal -1e30."""
    logits = torch.einsum("btcgk,bsck->btcgs", qg, ck.float())
    logits = logits / math.sqrt(cfg.head_dim)
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("btcgs,bsck->btcgk", probs, cv.float())


def _decode_layers(params, cache, x, rope_ang, wr_pos: int, mask,
                   cfg: TransformerConfig):
    """The cached layer stack shared by the decode paths: ``x [B, T, D]``
    at cache slots ``wr_pos .. wr_pos + T - 1``; returns f32 logits
    [B, T, V] and writes the new K/V into ``cache`` in place."""
    dtype = cfg.torch_dtype
    b, t_len = x.shape[:2]
    groups = cfg.n_heads // cfg.kv_heads
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = _rms_norm(x, lp["ln1_scale"])
        q = _dot(h, deq(lp["attn"]["wq"]))
        k = _dot(h, deq(lp["attn"]["wk"]))
        v = _dot(h, deq(lp["attn"]["wv"]))
        if rope_ang is not None:
            q, k = rope_rotate(q, rope_ang), rope_rotate(k, rope_ang)
        _layer_slab_update(cache["k"], i, k, wr_pos)
        _layer_slab_update(cache["v"], i, v, wr_pos)
        # GQA: grouped einsums read only the kv-head cache.
        qg = q.float().reshape(b, t_len, cfg.kv_heads, groups, cfg.head_dim)
        attn = _attend(qg, cache["k"][i], cache["v"][i], mask, cfg).reshape(
            b, t_len, cfg.n_heads, cfg.head_dim)
        x = x + _dot(attn.to(dtype), deq(lp["attn"]["wo"]), n=2)
        x = x + _ffn(lp["ffn"], _rms_norm(x, lp["ln2_scale"]))
    x = _rms_norm(x, params["ln_f_scale"])
    return unembed_logits(x, params["tok_emb"], dtype).float()


def _decode_chunk(params, cache, tokens, pos0: int, cfg: TransformerConfig):
    """Process ``tokens [B, T]`` at positions ``pos0 .. pos0 + T - 1``
    (the same for every row) against the cache in one pass ->
    ``(logits [B, T, V] f32, cache)``; queries attend every cached
    position <= their own, in-chunk causality included.  Windowed
    configs follow the reference's no-wrap contract
    (``pos0 % max_len + T <= max_len``).  Per-row positions
    (speculative decoding) are a later slice."""
    dtype = cfg.torch_dtype
    t_len = tokens.shape[1]
    x = embed_rows(params["tok_emb"], tokens, dtype)
    pos_ids = pos0 + torch.arange(t_len, device=tokens.device)   # [T]
    rope_ang = None
    if cfg.rope:
        rope_ang = rope_angles(pos_ids, cfg.head_dim,
                               cfg.rope_theta)[None, :, None, :]
    else:
        x = x + params["pos_emb"][pos_ids][None].to(dtype)
    span = torch.arange(cfg.max_len, device=tokens.device)
    if cfg.attention_window is not None:
        delta = torch.remainder(pos_ids[:, None] - span[None, :],
                                cfg.max_len)
        mask = ((delta < cfg.attention_window)
                & (pos_ids[:, None] - delta >= 0))
        wr_pos = pos0 % cfg.max_len
    else:
        mask = span[None, :] <= pos_ids[:, None]
        wr_pos = pos0
    mask = mask[None, :, None, None, :]                   # [1, T, 1, 1, S]
    return _decode_layers(params, cache, x, rope_ang, wr_pos, mask,
                          cfg), cache


def _decode_step(params, cache, tokens, pos: int, cfg: TransformerConfig,
                 pad_lens=None):
    """One position: ``tokens [B]`` at position ``pos`` ->
    ``(logits [B, V] f32, cache)``.

    Windowed configs write ring slot ``pos % max_len`` and attend the
    band of the last ``attention_window`` positions (rolling decode past
    max_len).  ``pad_lens [B]`` (left-padded ragged prompts): slots
    below a row's pad are never attended, and position ids count from
    the row's true start, so each row decodes as it would alone.
    """
    if pad_lens is None:
        out, cache = _decode_chunk(params, cache, tokens[:, None], pos, cfg)
        return out[:, 0], cache
    dtype = cfg.torch_dtype
    x = embed_rows(params["tok_emb"], tokens, dtype)[:, None]     # [B, 1, D]
    pos_ids = torch.clamp(pos - pad_lens, min=0)                   # [B]
    rope_ang = None
    if cfg.rope:
        rope_ang = rope_angles(pos_ids, cfg.head_dim,
                               cfg.rope_theta)[:, None, None, :]
    else:
        x = x + params["pos_emb"][pos_ids][:, None].to(dtype)
    span = torch.arange(cfg.max_len, device=tokens.device)
    if cfg.attention_window is not None:
        # Ring band: slot s holds global position pos - ((pos - s) mod C);
        # keep it iff real (>= 0) and inside the window.
        delta = torch.remainder(pos - span, cfg.max_len)
        row_mask = (delta < cfg.attention_window) & (pos - delta >= 0)
        slot = pos % cfg.max_len
    else:
        row_mask = span <= pos
        slot = pos
    mask = row_mask[None, :] & (span[None, :] >= pad_lens[:, None])  # [B, S]
    mask = mask[:, None, None, None, :]
    out = _decode_layers(params, cache, x, rope_ang, slot, mask, cfg)
    return out[:, 0], cache


def top_k_mask(logits, k: int):
    """Keep the k highest logits per row; the rest go to -inf.  Always
    exact (``torch.topk``): the reference's approximate TPU threshold has
    no counterpart here."""
    if k < 1:
        raise ValueError(f"top_k must be >= 1, got {k}")
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, -torch.inf, logits)


def _validate_unit_interval(name, p, zero_ok: bool = False):
    """Range-check a sampling filter value, scalar or per-row array;
    ``zero_ok`` admits 0.0 in arrays only (the per-row "no filter")."""
    vals = (p.detach().cpu().numpy() if isinstance(p, torch.Tensor)
            else np.asarray(p))
    zero_ok = zero_ok and vals.ndim > 0
    lo_ok = (vals >= 0.0) if zero_ok else (vals > 0.0)
    if not np.all(lo_ok & (vals <= 1.0)):
        lo = "[0, 1]" if zero_ok else "(0, 1]"
        raise ValueError(
            f"{name} must be in {lo}, got "
            f"{p if np.ndim(vals) == 0 else vals}")


def min_p_mask(logits, min_p):
    """Keep tokens whose probability is at least ``min_p`` times the top
    token's; the rest go to -inf.  ``min_p`` may be a per-row [B, 1]
    array (a row of 0.0 is a no-op)."""
    _validate_unit_interval("min_p", min_p, zero_ok=True)
    gap = logits - logits.amax(dim=-1, keepdim=True)
    thr = torch.log(torch.as_tensor(min_p, dtype=torch.float32,
                                    device=logits.device))
    return torch.where(gap >= thr, logits, -torch.inf)


def top_p_mask(logits, p):
    """Nucleus filtering: keep the smallest set of tokens whose mass
    reaches ``p`` (exclusive cumulative sum, so the top token is always
    kept); the rest go to -inf.  ``p`` may be a per-row [B, 1] array."""
    _validate_unit_interval("top_p", p)
    sl = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sl, dim=-1)
    exclusive = torch.cumsum(probs, dim=-1) - probs
    p = torch.as_tensor(p, dtype=logits.dtype, device=logits.device)
    thr = torch.where(exclusive < p, sl, torch.inf).amin(dim=-1,
                                                         keepdim=True)
    return torch.where(logits < thr, -torch.inf, logits)


def rolling_eligible(cfg: TransformerConfig) -> bool:
    """Can this config decode past ``max_len`` on the ring-buffer cache
    (rope + a window that fits the ring)?"""
    return (cfg.rope and cfg.attention_window is not None
            and cfg.attention_window <= cfg.max_len)


def _check_eos(eos_token, cfg: TransformerConfig) -> None:
    if eos_token is not None and not 0 <= eos_token < cfg.vocab_size:
        raise ValueError(
            f"eos_token must be in [0, vocab_size={cfg.vocab_size}), "
            f"got {eos_token}")


def _check_decode_budget(p: int, max_new_tokens: int,
                         cfg: TransformerConfig, eos_token: int | None,
                         rolling_ok: bool = False) -> int:
    """Prompt/length/eos validation; returns ``total`` = p + new."""
    if p < 1:
        raise ValueError(
            "prompt must contain at least one token (decoding starts from "
            "its last position; pass a BOS token for unconditional samples)")
    total = p + max_new_tokens
    if total > cfg.max_len and not (rolling_ok and rolling_eligible(cfg)):
        raise ValueError(
            f"prompt ({p}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"max_len={cfg.max_len}" + (
                "" if cfg.attention_window is None or not cfg.rope else
                " (rolling decode past max_len needs rope=True, an "
                "attention_window <= max_len, and a uniform-length "
                "prompt)"))
    _check_eos(eos_token, cfg)
    return total


def _resolve_prefill(cfg: TransformerConfig, p: int,
                     use_prefill: bool | None, ragged: bool) -> bool:
    """Prefill eligibility: a uniform prompt of >= 2 tokens that fits the
    cache (int8 weights, which also bar it in the reference, are not
    ported)."""
    can = not ragged and 1 < p <= cfg.max_len
    if use_prefill is None:
        return can
    if use_prefill and not can:
        raise ValueError(
            "use_prefill=True needs a uniform-length (no prompt_lengths) "
            "prompt of >= 2 tokens that fits the cache (p <= max_len)")
    return use_prefill


def beam_search(*args, **kwargs):
    """Beam search (ancestry attention) comes with a later slice."""
    raise _not_ported("beam_search", "A5")


def _position_generator(seed: int, pos: int, device) -> torch.Generator:
    """The sampling stream of one position: a pure function of
    (seed, pos), so the prefill and sequential paths draw alike."""
    state = np.random.SeedSequence([seed, pos]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(
        int(state[0]) & (2**63 - 1))


def _sample(logits, temperature, top_k, top_p, min_p, gen):
    """Filter the temperature-scaled logits (top-k, nucleus, min-p, in
    that order) and draw one token per row by the Gumbel-max trick."""
    scaled = logits / temperature
    if top_k is not None:
        scaled = top_k_mask(scaled, top_k)
    if top_p is not None and top_p < 1.0:
        scaled = top_p_mask(scaled, top_p)
    if min_p is not None and min_p > 0.0:
        scaled = min_p_mask(scaled, min_p)
    u = torch.rand(scaled.shape, generator=gen, device=scaled.device)
    return (scaled - torch.log(-torch.log(u))).argmax(dim=-1)


def generate(params, prompt, cfg: TransformerConfig, max_new_tokens: int,
             temperature: float = 0.0, seed: int | None = None,
             top_k: int | None = None, top_p: float | None = None,
             min_p: float | None = None, prompt_lengths=None,
             eos_token: int | None = None, use_prefill: bool | None = None,
             kv_int8: bool = False, prompt_cache=None, device=None):
    """Decode ``max_new_tokens`` past ``prompt [B, P]``; returns int32
    ``[B, P + N]``.

    Uniform prompts run :func:`prefill` (the flash kernel on the card)
    and the loop starts at the last prompt position, recomputing it in
    place; ragged prompts (``prompt_lengths [B]``, right-padded)
    teacher-force every prompt position through the cached step.
    ``use_prefill`` overrides the choice.  ``temperature == 0`` is greedy
    argmax; ``temperature > 0`` samples (needs ``seed``) after the
    ``top_k`` / ``top_p`` / ``min_p`` filters.  ``eos_token`` makes
    completion sticky per row.  Runs on ``device`` — the card unless
    ``device="cpu"`` — where the params must already live.
    """
    if prompt_cache is not None:
        raise _not_ported("prompt_cache", "A5")
    if kv_int8:
        raise _not_ported("kv_int8", "A9")
    device = resolve_device(device)
    check_on_device(params, device)
    _check_supported(cfg)
    prompt = torch.as_tensor(prompt, device=device).long()
    b, p = prompt.shape
    total = _check_decode_budget(p, max_new_tokens, cfg, eos_token,
                                 rolling_ok=prompt_lengths is None)
    if temperature > 0 and seed is None:
        raise ValueError("temperature sampling needs an explicit seed")
    if ((top_k is not None
         or (top_p is not None and top_p < 1.0)
         or (min_p is not None and min_p > 0.0))
            and temperature <= 0):
        raise ValueError(
            "top_k/top_p/min_p filter a sampling distribution; they "
            "need temperature > 0")
    if top_k is not None and not 1 <= top_k <= cfg.vocab_size:
        raise ValueError(
            f"top_k must be in [1, vocab_size={cfg.vocab_size}], got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if min_p is not None and not 0.0 <= min_p <= 1.0:
        raise ValueError(f"min_p must be in [0, 1], got {min_p}")

    pad_lens = None
    if prompt_lengths is not None:
        host_lens = np.asarray(prompt_lengths)
        if host_lens.shape != (b,):
            raise ValueError(
                f"prompt_lengths must be [batch={b}], got {host_lens.shape}")
        if host_lens.min() < 1 or host_lens.max() > p:
            raise ValueError(
                f"prompt_lengths must lie in [1, {p}] (the padded prompt "
                f"width), got range [{host_lens.min()}, {host_lens.max()}]")
        pad_lens = torch.as_tensor(p - host_lens, device=device).long()
        # Right-align each row: [tok..., pad...] -> [pad..., tok...].
        idx = torch.remainder(torch.arange(p, device=device)[None]
                              - pad_lens[:, None], p)
        prompt = torch.gather(prompt, 1, idx)
    use_prefill = _resolve_prefill(cfg, p, use_prefill,
                                   ragged=pad_lens is not None)

    buf = torch.zeros((b, total), dtype=torch.long, device=device)
    buf[:, :p] = prompt
    with torch.no_grad():
        if use_prefill:
            # The cache holds K/V for [0, p); the loop starts at the last
            # prompt position (its step recomputes identical K/V in place
            # and yields the logits that pick token p).
            cache, _ = prefill(params, prompt, cfg, last_logits=False,
                               device=device)
            start = p - 1
        else:
            cache = init_cache(cfg, b, device=device)
            start = 0
        done = torch.zeros(b, dtype=torch.bool, device=device)
        for pos in range(start, total - 1):
            logits, cache = _decode_step(params, cache, buf[:, pos], pos,
                                         cfg, pad_lens)
            if pos + 1 < p:
                continue  # prompt positions are forced
            if temperature > 0:
                nxt = _sample(logits, temperature, top_k, top_p, min_p,
                              _position_generator(seed, pos, device))
            else:
                nxt = logits.argmax(dim=-1)
            if eos_token is not None:
                nxt = torch.where(done, eos_token, nxt)  # sticky fill
                done = done | (nxt == eos_token)
            buf[:, pos + 1] = nxt
    if pad_lens is not None:
        # Back to the input layout: prompt, generation, then padding.
        idx = torch.remainder(torch.arange(total, device=device)[None]
                              + pad_lens[:, None], total)
        buf = torch.gather(buf, 1, idx)
    return buf.to(torch.int32)

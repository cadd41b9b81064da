"""KV-cached autoregressive decoding for the transformer LM, in PyTorch.

Counterpart of ``distkeras_tpu/models/generate.py``.  The cache is one
preallocated ``[L, B, max_len, kv_heads, head_dim]`` buffer per K and V;
:func:`prefill` fills the prompt positions in one batched forward (flash
attention — the Hopper kernel on the card), then a Python loop runs
:func:`_decode_step` per position.  Greedy decoding emits the JAX
package's tokens exactly; sampling draws from a per-position
``torch.Generator`` seeded from ``(seed, pos)`` (JAX's ``fold_in`` keys
cannot be reproduced), and ``top_k`` is always exact.

:func:`_decode_chunk` runs T tokens per row at per-row device positions
(the serving engines' step, speculative verification, admission chunks
and ``prompt_cache`` suffixes), writing the preallocated cache in place.

MoE configs prefill with the capacity-free dense routing and decode with
the reference's per-token expert gather (T = 1) or the dense block
(T > 1).  int8 trees (``models.quant.quantize_params``) decode on the
sequential path, every weight read through ``deq``; ``kv_int8=True``
stores K/V as int8 with per-token, per-kv-head f32 scales that ride the
same slot arithmetic as K/V.

:func:`beam_search` keeps ``W`` hypotheses per row: beam lanes tile the
batch, and each step either reads every beam's history through a
slot-indexed ancestor map (ancestry attention, the cache never
reordered) or reorders the cache rows by parent (``beam_impl=
"physical"``).  Its prompt pass is :func:`prefill`, the flash kernel on
the card.

Sharded params (``parallel/layout.py``) decode through the same code on
every rank of the mesh: the cache holds this rank's kv heads
(``[L, B, max_len, kv_heads / m, head_dim]`` under a head split, every
head when the heads are whole), each layer's attention and FFN outputs
are all-reduced over the model axis, and the logits after the last
all-reduce are alike on every rank, so every rank picks the same token.
A call gathers the tree's compute view once and decodes with it.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from distkeras_tpu_torch.models.quant import (deq, embed_rows, is_quantized,
                                              quantize_kv, unembed_logits)
from distkeras_tpu_torch.models.transformer import (
    TransformerConfig,
    _dot,
    _einsum,
    _embed,
    _gelu,
    _layers,
    _moe_dense_block,
    _moe_gates,
    _rms_norm,
    _unembed,
    block_apply,
    moe_scope,
    rope_angles,
    rope_rotate,
)
from distkeras_tpu_torch.ops.attention import flash_attention
from distkeras_tpu_torch.parallel.layout import tp_of, views
from distkeras_tpu_torch.utils.device import check_on_device, resolve_device


def local_kv_heads(params, cfg: TransformerConfig) -> int:
    """The kv heads this rank caches: ``wk``'s heads dimension in the
    compute view (``cfg.kv_heads`` unless the model axis splits them)."""
    wk = params["layers"]["attn"]["wk"]
    return int((wk.q if hasattr(wk, "q") else wk).shape[2])


def init_cache(cfg: TransformerConfig, batch: int, dtype=None,
               kv_int8: bool = False, device=None, kv_heads=None):
    """Per-layer KV buffers [L, B, max_len, kv_heads, head_dim] (GQA
    configs cache only the shared K/V heads; ``kv_heads`` overrides the
    count: a rank's share under a head split).  ``kv_int8``: int8 K/V
    plus f32 ``k_scale`` / ``v_scale`` [L, B, max_len, kv_heads]; the
    scale leaves are what switches the decode attention to the
    dequantizing form."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.max_len, kv_heads or cfg.kv_heads,
             cfg.head_dim)
    dtype = torch.int8 if kv_int8 else (dtype or cfg.torch_dtype)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if kv_int8:
        cache["k_scale"] = torch.zeros(shape[:-1], device=device)
        cache["v_scale"] = torch.zeros(shape[:-1], device=device)
    return cache


def prefill(params, prompt, cfg: TransformerConfig,
            last_logits: bool = True, kv_int8: bool = False, device=None):
    """Fill the KV cache for all prompt positions in ONE batched pass
    (the same ``block_apply`` body as the forward, flash attention over
    [B, P]).  Returns ``(cache, last [B, V] f32 or None)``.

    MoE configs run the capacity-free dense routing, so prefilled and
    sequential prompts match.  ``kv_int8``: the forward runs in full
    precision and each layer's K/V are quantized after the fact.
    Full-precision params only (an int8 tree decodes sequentially)."""
    device = resolve_device(device)
    check_on_device(params, device)
    if is_quantized(params):
        raise ValueError(
            "prefill runs the batched forward, which needs full-precision "
            "params; an int8 tree decodes on the sequential path "
            "(generate picks it)")
    params = views(params, whole_experts=True)
    tp = tp_of(params)
    prompt = torch.as_tensor(prompt, device=device).long()
    b, p_len = prompt.shape
    if p_len > cfg.max_len:
        raise ValueError(
            f"prompt length {p_len} exceeds max_len={cfg.max_len} "
            "(the KV cache size)")
    cache = init_cache(cfg, b, kv_int8=kv_int8, device=device,
                       kv_heads=local_kv_heads(params, cfg))
    attention_fn = lambda q, k, v: flash_attention(
        q, k, v, True, window=cfg.attention_window)
    moe = moe_scope(params) if cfg.num_experts else None
    with torch.no_grad():
        x, rope_ang = _embed(params, prompt, cfg)
        for i, lp in enumerate(_layers(params["layers"], cfg.n_layers)):
            x, _, (k, v) = block_apply(lp, x, cfg, attention_fn, rope_ang,
                                       return_kv=True,
                                       moe_dense_routing=True, tp=tp,
                                       moe=moe)
            if kv_int8:
                (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
                cache["k_scale"][i, :, :p_len].copy_(ks)
                cache["v_scale"][i, :, :p_len].copy_(vs)
            # In place into the preallocated cache (copy_ casts to the
            # cache dtype, as the reference's astype does).
            cache["k"][i, :, :p_len].copy_(k)
            cache["v"][i, :, :p_len].copy_(v)
        if not last_logits:
            return cache, None
        x = _rms_norm(x, params["ln_f_scale"])
        return cache, _unembed(x[:, -1:], params, cfg)[:, 0]


def _attend(qg, ck, cv, mask, cfg: TransformerConfig, scales=None):
    """Decode attention over the cache in f32: ``qg [B, T, kv, G, hd]``
    against ``ck/cv [B, S, kv, hd]`` under a boolean mask broadcastable to
    ``[B, T, kv, G, S]``; masked slots take the literal -1e30.
    ``scales = (k_scale, v_scale) [B, S, kv]``: an int8 cache, whose
    scales multiply the scores and the probabilities, as in the
    reference."""
    sc_b = lambda sc: sc.transpose(1, 2)[:, None, :, None, :]
    logits = torch.einsum("btcgk,bsck->btcgs", qg, ck.float())
    if scales is not None:
        logits = logits * sc_b(scales[0])
    logits = logits / math.sqrt(cfg.head_dim)
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    if scales is not None:
        probs = probs * sc_b(scales[1])
    return torch.einsum("btcgs,bsck->btcgk", probs, cv.float())


def _ancestry_attend(qg, ck, cv, anc_oh, mask_b, cfg: TransformerConfig,
                     w_beams: int, kv_scales=None):
    """Beam ancestry attention for ONE position.

    ``qg [B, kv, G, hd]`` f32 queries (beam lanes tiled batch-major, B =
    bt * W), ``ck/cv [B, S, kv, hd]`` the per-lane cache, ``anc_oh [bt,
    W, S, W]`` f32 one-hot ancestor map (slot s of lane w reads lane
    ``anc[b, w, s]``), ``mask_b [bt, W, S]`` the valid-slot mask
    (position mask full-cache, band mask windowed).  Scores every
    (query-lane, source-lane) pair, so the cache is read once at W x the
    decode attention's operations, then the one-hot selects each slot's
    true ancestor.  The score tensor and its post-softmax select are
    ``[bt, W, kv, G, W, S]`` f32 each (``_ancestry_score_bytes``).
    ``kv_scales = (k_scale, v_scale) [B, S, kv]``: an int8 cache.
    Returns ``attn [B, n_heads, hd]`` f32."""
    b, s_len = qg.shape[0], ck.shape[1]
    kvh, groups = qg.shape[1], qg.shape[2]  # this rank's heads
    bt = b // w_beams
    qb = qg.reshape(bt, w_beams, kvh, -1, cfg.head_dim)
    kb = ck.float().reshape(bt, w_beams, s_len, kvh, cfg.head_dim)
    vb = cv.float().reshape(bt, w_beams, s_len, kvh, cfg.head_dim)
    la = torch.einsum("bwcgk,bvsck->bwcgvs", qb, kb)
    if kv_scales is not None:
        # [B, S, C] -> [bt, 1, C, 1, v(=w), S] over la's dims.
        bsc = lambda sc: sc.reshape(bt, w_beams, s_len, kvh
                                    ).permute(0, 3, 1, 2)[:, None, :, None]
        la = la * bsc(kv_scales[0])
    logits = torch.einsum("bwcgvs,bwsv->bwcgs", la, anc_oh)
    del la
    logits = logits / math.sqrt(cfg.head_dim)
    logits = torch.where(mask_b[:, :, None, None, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    pm = torch.einsum("bwcgs,bwsv->bwcgvs", probs, anc_oh)
    if kv_scales is not None:
        pm = pm * bsc(kv_scales[1])
    return torch.einsum("bwcgvs,bvsck->bwcgk", pm, vb).reshape(
        b, kvh * groups, cfg.head_dim)


def _rows_update(cache_layer, rows, pos0):
    """Write ``rows [B, T, ...]`` into ``cache_layer [B, S, ...]`` (K/V
    rows, or their int8 scales)
    at per-row offsets ``pos0 [B]`` (device tensor), IN PLACE: one
    ``index_put_`` over the ``[B, T]`` slots.  Starts clamp to
    ``S - T`` as the reference's ``dynamic_update_slice`` clamps them
    (callers keep their writes in range; the clamp keeps a stray one
    from faulting the device)."""
    t_len = rows.shape[1]
    ar = torch.arange(t_len, device=rows.device)
    start = pos0.clamp(0, cache_layer.shape[1] - t_len)
    brow = torch.arange(rows.shape[0], device=rows.device)[:, None]
    cache_layer.index_put_((brow, start[:, None] + ar),
                           rows.to(cache_layer.dtype))
    return cache_layer


def _rows_update_ring(cache_layer, rows, pos0, max_len: int):
    """Per-row T-span write at ring slots ``(pos0[b] + t) % max_len``, in
    place: the modular form of :func:`_rows_update` for windowed chunks
    that may wrap mid-chunk (speculative decoding at divergent per-row
    positions on a ring cache)."""
    t_len = rows.shape[1]
    ar = torch.arange(t_len, device=rows.device)
    idx = torch.remainder(pos0[:, None] + ar, max_len)       # [B, T]
    brow = torch.arange(rows.shape[0], device=rows.device)[:, None]
    cache_layer.index_put_((brow, idx), rows.to(cache_layer.dtype))
    return cache_layer


def _layer_slab_update(cache_layer, rows, pos):
    """Write ``rows [B, T, ...]`` (every row at the same position) into
    ``cache_layer [B, S, ...]`` at ``pos`` (a ``[1]`` device tensor),
    in place: one ``index_copy_`` over the T slots, start clamped to
    ``S - T`` as ``dynamic_update_slice`` clamps."""
    t_len = rows.shape[1]
    start = pos.clamp(0, cache_layer.shape[1] - t_len)
    idx = start + torch.arange(t_len, device=rows.device)
    cache_layer.index_copy_(1, idx, rows.to(cache_layer.dtype))
    return cache_layer


def _decode_chunk(params, cache, tokens, pos0, cfg: TransformerConfig,
                  uniform_pos: bool = False, beam_anc=None):
    """Process T new tokens per row against the cache in ONE pass:
    ``tokens [B, T]`` at global positions ``pos0[b] + (0..T-1)`` (``pos0``
    a ``[B]`` int tensor on the device) -> ``(logits [B, T, V] f32,
    cache)``; the chunk's K/V land in the preallocated cache in place.

    Queries attend every cached position <= their own (in-chunk
    causality included), so rows at different positions share one call.
    Windowed configs run in the reference's three shapes: per-row T == 1
    (each row writes ring slot ``pos0[b] % max_len`` under its own band
    mask: the serving engine's decode step); ``uniform_pos`` chunks under
    the no-wrap contract ``pos0[0] % max_len + T <= max_len`` (admission);
    per-row multi-token chunks through a modular scatter, guarded by
    ``T + window <= max_len`` (speculative decoding on a ring).  Stale
    slots past a row's position are masked until overwritten.

    ``uniform_pos``: every row holds the same position, so each layer's
    write is one slab ``index_copy_`` instead of a per-row scatter.  An
    int8 cache (``k_scale`` in ``cache``) writes its scales by the same
    slot arithmetic, in all three windowed shapes.
    Nothing here reads a device value on the host.

    ``beam_anc = (anc [B/W, W, S] long, W)``: beam ancestry attention
    (T == 1, uniform positions; full-cache or windowed).  Rows are beam
    lanes (batch-major ``b*W + w``); each lane writes its own cache lane
    in place, and lane ``w`` reads slot ``s`` from lane ``anc[b, w, s]``
    (:func:`_ancestry_attend`).
    """
    params = views(params, whole_experts=True)
    dtype = cfg.torch_dtype
    b, t_len = tokens.shape
    dev = tokens.device
    ar = torch.arange(t_len, device=dev)
    pos_ids = pos0[:, None] + ar[None, :]                    # [B, T]
    x = embed_rows(params["tok_emb"], tokens, dtype)         # [B, T, D]
    rope_ang = None
    if cfg.rope:
        rope_ang = rope_angles(pos_ids, cfg.head_dim,
                               cfg.rope_theta)[:, :, None, :]
    else:
        # XLA's gather clamps an index past the table; so does this.
        x = x + params["pos_emb"][pos_ids.clamp(max=cfg.max_len - 1)
                                  ].to(dtype)
    win = cfg.attention_window is not None
    if (win and t_len > 1 and not uniform_pos
            and t_len + cfg.attention_window > cfg.max_len):
        raise ValueError(
            f"windowed per-row chunk of {t_len} tokens + "
            f"attention_window={cfg.attention_window} exceeds the ring "
            f"size (max_len={cfg.max_len}); shrink the chunk or grow "
            "the ring")
    span = torch.arange(cfg.max_len, device=dev)
    if win:
        # Ring band: slot s holds global position pos - ((pos - s) mod C);
        # keep it iff real (>= 0) and inside the window.
        delta = torch.remainder(pos_ids[:, :, None] - span, cfg.max_len)
        mask = ((delta < cfg.attention_window)
                & (pos_ids[:, :, None] - delta >= 0))
        wr_pos = torch.remainder(pos0, cfg.max_len)
    else:
        mask = span <= pos_ids[:, :, None]
        wr_pos = pos0
    mask = mask[:, :, None, None, :]                         # [B, T, 1, 1, S]
    beam = None
    if beam_anc is not None:
        anc, w_beams = beam_anc
        if t_len != 1 or not uniform_pos:
            raise ValueError("beam ancestry attention requires T == 1 "
                             "and uniform positions")
        # One-hot over source lanes, f32 for the einsum contractions.
        beam = (torch.nn.functional.one_hot(anc, w_beams).float(), w_beams,
                mask[:, 0, 0, 0, :].reshape(b // w_beams, w_beams, -1))
    if uniform_pos:
        write = lambda c, r: _layer_slab_update(c, r, wr_pos[:1])
    elif win and t_len > 1:
        write = lambda c, r: _rows_update_ring(c, r, pos0, cfg.max_len)
    else:
        write = lambda c, r: _rows_update(c, r, wr_pos)
    return _decode_layers(params, cache, x, rope_ang, write, mask,
                          cfg, beam), cache


def _decode_layers(params, cache, x, rope_ang, write, mask,
                   cfg: TransformerConfig, beam=None):
    """The cached layer stack shared by the decode paths: ``x [B, T, D]``;
    ``write(cache_layer, rows)`` lands each layer's new K/V (and, for an
    int8 cache, their scales) in place.  Every weight read goes through
    ``deq``.  ``beam = (anc_oh, W, mask_b)``: ancestry attention (T ==
    1).  Returns f32 logits [B, T, V]."""
    dtype = cfg.torch_dtype
    b, t_len = x.shape[:2]
    groups = cfg.n_heads // cfg.kv_heads
    kv_q = "k_scale" in cache
    tp = tp_of(params)
    for i, lp in enumerate(_layers(params["layers"], cfg.n_layers)):
        h = _rms_norm(x, lp["ln1_scale"])
        q = _dot(h, deq(lp["attn"]["wq"]))
        k = _dot(h, deq(lp["attn"]["wk"]))
        v = _dot(h, deq(lp["attn"]["wv"]))
        if rope_ang is not None:
            q, k = rope_rotate(q, rope_ang), rope_rotate(k, rope_ang)
        scales = None
        if kv_q:  # post-rotation, like the full-precision cache
            (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
            scales = (write(cache["k_scale"][i], ks),
                      write(cache["v_scale"][i], vs))
        ck, cv = write(cache["k"][i], k), write(cache["v"][i], v)
        # GQA: grouped einsums read only the kv-head cache (this rank's
        # kv heads under a head split).
        kvh = k.shape[2]
        qg = q.float().reshape(b, t_len, kvh, groups, cfg.head_dim)
        if beam is not None:
            anc_oh, w_beams, mask_b = beam
            attn = _ancestry_attend(qg[:, 0], ck, cv, anc_oh, mask_b, cfg,
                                    w_beams, scales)[:, None]
        else:
            attn = _attend(qg, ck, cv, mask, cfg, scales).reshape(
                b, t_len, kvh * groups, cfg.head_dim)
        a = _dot(attn.to(dtype), deq(lp["attn"]["wo"]), n=2)
        x = x + (tp.leave(a, tp.attn) if tp else a)
        y = _decode_ffn(lp, _rms_norm(x, lp["ln2_scale"]), cfg)
        x = x + (tp.leave(y, tp.ffn) if tp else y)
    x = _rms_norm(x, params["ln_f_scale"])
    return unembed_logits(x, params["tok_emb"], dtype).float()


def _decode_ffn(lp, h, cfg: TransformerConfig):
    """The FFN of a decode chunk ``h [B, T, D]``.  MoE: T > 1 takes the
    batched :func:`_moe_dense_block`; T = 1 gathers each row's top-k
    expert slabs (cast to the compute dtype) and combines them UNMASKED,
    as the reference's decode step does.  Dense: through ``deq``.  Under
    a model axis both run this rank's ``d_ff`` columns (the caller sums
    the partial outputs).  Experts come whole (``views(params,
    whole_experts=True)``)."""
    dtype = cfg.torch_dtype
    if cfg.num_experts and h.shape[1] > 1:
        return _moe_dense_block(lp["moe"], h, cfg)
    if cfg.num_experts:
        moe = lp["moe"]
        probs = torch.softmax(_dot(h.float(), moe["wg"]), dim=-1)
        gates, expert = _moe_gates(probs, cfg)             # [B, T, k]
        w1 = moe["w1"][expert]                             # [B, T, k, ., .]
        w2 = moe["w2"][expert]
        hk = _gelu(_einsum("btd,btkdf->btkf", h, w1.to(dtype)))
        yk = _einsum("btkf,btkfd->btkd", hk, w2.to(dtype))
        return _einsum("btkd,btk->btd", yk, gates.to(dtype))
    ffn = lp["ffn"]
    return _dot(_gelu(_dot(h, deq(ffn["w1"]))), deq(ffn["w2"]))


def _decode_step(params, cache, tokens, pos: int, cfg: TransformerConfig,
                 pad_lens=None, beam_anc=None):
    """One position: ``tokens [B]`` at position ``pos`` ->
    ``(logits [B, V] f32, cache)``.

    Windowed configs write ring slot ``pos % max_len`` and attend the
    band of the last ``attention_window`` positions (rolling decode past
    max_len).  ``pad_lens [B]`` (left-padded ragged prompts): slots
    below a row's pad are never attended, and position ids count from
    the row's true start, so each row decodes as it would alone.
    ``beam_anc``: beam ancestry attention (see :func:`_decode_chunk`).
    """
    b = tokens.shape[0]
    pos_t = torch.full((b,), pos, dtype=torch.long, device=tokens.device)
    if pad_lens is None:
        out, cache = _decode_chunk(params, cache, tokens[:, None], pos_t, cfg,
                                   uniform_pos=True, beam_anc=beam_anc)
        return out[:, 0], cache
    if beam_anc is not None:
        raise ValueError("beam ancestry attention does not compose with "
                         "pad_lens (beam search is uniform-prompt only)")
    params = views(params, whole_experts=True)
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
        delta = torch.remainder(pos - span, cfg.max_len)
        row_mask = (delta < cfg.attention_window) & (pos - delta >= 0)
        slot = pos % cfg.max_len
    else:
        row_mask = span <= pos
        slot = pos
    mask = row_mask[None, :] & (span[None, :] >= pad_lens[:, None])  # [B, S]
    mask = mask[:, None, None, None, :]
    slot_t = torch.full((1,), slot, dtype=torch.long, device=tokens.device)
    out = _decode_layers(params, cache, x, rope_ang,
                         lambda c, r: _layer_slab_update(c, r, slot_t),
                         mask, cfg)
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
    ``zero_ok`` admits 0.0 in arrays only (the per-row "no filter").  A
    tensor is checked where it lives, by one device reduction and one
    read of its boolean (a card tensor costs one sync per call; the
    serving engine validates its values on the host at ``submit`` and
    calls the unchecked :func:`_min_p_mask` / :func:`_top_p_mask`)."""
    if isinstance(p, torch.Tensor):
        vals = p.detach()
        zero_ok = zero_ok and vals.dim() > 0
        lo_ok = (vals >= 0.0) if zero_ok else (vals > 0.0)
        if bool(torch.all(lo_ok & (vals <= 1.0))):
            return
        vals = vals.cpu().numpy()
    else:
        vals = np.asarray(p)
        zero_ok = zero_ok and vals.ndim > 0
        lo_ok = (vals >= 0.0) if zero_ok else (vals > 0.0)
        if np.all(lo_ok & (vals <= 1.0)):
            return
    lo = "[0, 1]" if zero_ok else "(0, 1]"
    raise ValueError(f"{name} must be in {lo}, got "
                     f"{p if np.ndim(vals) == 0 else vals}")


def min_p_mask(logits, min_p):
    """Keep tokens whose probability is at least ``min_p`` times the top
    token's; the rest go to -inf.  ``min_p`` may be a per-row [B, 1]
    array (a row of 0.0 is a no-op)."""
    _validate_unit_interval("min_p", min_p, zero_ok=True)
    return _min_p_mask(logits, min_p)


def _min_p_mask(logits, min_p):
    """:func:`min_p_mask` for a ``min_p`` validated already (no range
    check, so no host sync)."""
    gap = logits - logits.amax(dim=-1, keepdim=True)
    thr = torch.log(torch.as_tensor(min_p, dtype=torch.float32,
                                    device=logits.device))
    return torch.where(gap >= thr, logits, -torch.inf)


def top_p_mask(logits, p):
    """Nucleus filtering: keep the smallest set of tokens whose mass
    reaches ``p`` (exclusive cumulative sum, so the top token is always
    kept); the rest go to -inf.  ``p`` may be a per-row [B, 1] array."""
    _validate_unit_interval("top_p", p)
    return _top_p_mask(logits, p)


def _top_p_mask(logits, p):
    """:func:`top_p_mask` for a ``p`` validated already (no range check,
    so no host sync)."""
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


def _resolve_prefill(params, cfg: TransformerConfig, p: int,
                     use_prefill: bool | None, ragged: bool) -> bool:
    """Prefill eligibility: a uniform prompt of >= 2 tokens that fits the
    cache, and full-precision params (an int8 tree takes the sequential
    path and launches no kernel, as in the reference)."""
    can = (not ragged and 1 < p <= cfg.max_len
           and not is_quantized(params))
    if use_prefill is None:
        return can
    if use_prefill and not can:
        raise ValueError(
            "use_prefill=True needs a uniform-length (no prompt_lengths) "
            "prompt of >= 2 tokens that fits the cache (p <= max_len) and "
            "full-precision params (the batched prefill forward wants the "
            "training weights)")
    return use_prefill


def _resolve_prompt_cache(prompt_cache, cfg: TransformerConfig, b: int,
                          p: int, max_new_tokens: int, use_prefill,
                          device, kv_int8: bool = False, kv_heads=None):
    """The ``prompt_cache`` contract (the reference's
    ``_resolve_prompt_cache``): validates the config, budget and batch,
    and returns ``(cache, cached_len)`` -- a COPY of the segment, fanned
    out to ``b`` rows when it was prefilled at batch 1, so decoding in
    place never writes into the caller's segment."""
    pc_cache, cached_len = prompt_cache
    if cfg.attention_window is not None:
        raise ValueError("prompt_cache requires a full-cache config "
                         "(no attention_window)")
    if use_prefill is not None:
        raise ValueError(
            "use_prefill has no effect with prompt_cache (the suffix "
            "always runs as one chunked pass); drop the argument")
    if cached_len < 1:
        raise ValueError(
            f"cached prefix length must be >= 1, got {cached_len} "
            "(an empty prefix is just a plain call)")
    if cached_len > cfg.max_len - p - max_new_tokens:
        raise ValueError(
            f"cached prefix length {cached_len} + prompt {p} + "
            f"{max_new_tokens} new tokens must fit max_len={cfg.max_len}")
    if ("k_scale" in pc_cache) != kv_int8:
        raise ValueError(
            "prompt_cache quantization must match kv_int8= (build the "
            "prefix cache with prefill(..., kv_int8=...))")
    want = (cfg.n_layers, cfg.max_len, kv_heads or cfg.kv_heads,
            cfg.head_dim)
    names = {"k", "v"} | ({"k_scale", "v_scale"} if kv_int8 else set())
    if (set(pc_cache) != names
            or any(tuple(a.shape[:1] + a.shape[2:])
                   != (want if n in ("k", "v") else want[:-1])
                   for n, a in pc_cache.items())):
        raise ValueError(
            "prompt_cache must be a prefill() cache of this config: "
            f"{sorted(names)} of [L, B, max_len, kv_heads, head_dim] = "
            f"[{want[0]}, B, {', '.join(map(str, want[1:]))}]"
            + (" (scales without head_dim)" if kv_int8 else ""))
    pcb = pc_cache["k"].shape[1]
    if pcb not in (1, b):
        raise ValueError(
            f"prompt_cache batch {pcb} incompatible with prompt "
            f"batch {b} (must match or be 1)")
    # A shared prefix (a system prompt) prefilled once at batch 1 fans
    # out per request; repeat copies either way.  An int8 segment keeps
    # its int8 K/V and f32 scales.
    reps = b // pcb
    out = {}
    for name, a in pc_cache.items():
        a = torch.as_tensor(a, device=device)
        if not kv_int8:
            a = a.to(cfg.torch_dtype)
        out[name] = a.repeat(1, reps, *([1] * (a.dim() - 2)))
    return out, int(cached_len)


# Ancestry attention materializes per-layer score tensors of
# B x W^2 x n_heads x S f32 (x2: the scores and the post-softmax select),
# quadratic in beam width.  Above this ceiling the physical parent
# gather, slower per step, is the path that fits.
ANCESTRY_SCORE_LIMIT_BYTES = 1 << 28  # 256 MiB per layer


def _ancestry_score_bytes(b: int, w: int, cfg: TransformerConfig) -> int:
    """Estimated per-layer peak of the ancestry attention intermediates:
    the ``[B, W, kv_heads, groups, W, S]`` f32 score tensor (``b`` the
    untiled batch) and its post-softmax select, of the same shape."""
    return 2 * b * w * w * cfg.n_heads * cfg.max_len * 4


def _top_w(x, w: int):
    """The ``w`` largest entries of each row of ``x`` and their indices,
    ties to the lower index as ``jax.lax.top_k`` breaks them (the first
    ``w`` of a stable descending sort; ``torch.topk`` promises no tie
    order)."""
    order = torch.sort(x, dim=-1, descending=True, stable=True)
    return order.values[..., :w], order.indices[..., :w]


def beam_search(params, prompt, cfg: TransformerConfig,
                max_new_tokens: int, beam_width: int = 4,
                eos_token: int | None = None,
                use_prefill: bool | None = None,
                length_penalty: float = 0.0, kv_int8: bool = False,
                prompt_cache=None, beam_impl: str = "auto",
                _force_physical: bool = False, device=None):
    """Beam search decode: ``prompt [B, P]`` -> ``(sequences, scores)``
    with ``sequences`` int32 ``[B, W, P + N]`` and ``scores`` f32 ``[B,
    W]`` (the sum of the generated tokens' log-probabilities), best beam
    first.

    The first expansion takes the top-W first tokens of the untiled
    batch, so beams start distinct; every later step scores the ``W x V``
    continuations of each row and keeps the top W (ties to the lower
    index, as the reference's ``lax.top_k``).  ``eos_token`` freezes a
    finished beam: its only continuation is another ``eos_token`` at
    unchanged score.  ``length_penalty`` > 0 re-ranks the RETURNED beams
    by ``score / ((5 + n) / 6) ** alpha`` over each beam's generated
    length n (frozen beams stop counting) and returns those values; the
    search itself prunes on raw scores.  Uniform-length prompts only;
    int8 trees decode on the sequential prompt path.
    ``prompt_cache=(cache, cached_len)``: a prefilled shared prefix, as
    in :func:`generate`.  Rope + window configs run rolling beams past
    ``max_len``.

    ``beam_impl``: ``"auto"`` (ancestry attention, unless its score
    intermediates exceed :data:`ANCESTRY_SCORE_LIMIT_BYTES`, then the
    physical gather with a warning), ``"ancestry"`` (raises above the
    limit) or ``"physical"`` (reorder the cache rows by parent every
    step: the same hypotheses, more memory traffic).  ``_force_physical``
    is the reference's private spelling of ``"physical"``.  Runs on
    ``device`` (the card unless ``device="cpu"``), where the params must
    already live; the prompt pass is :func:`prefill` (the flash kernel)
    when eligible.
    """
    device = resolve_device(device)
    check_on_device(params, device)
    params = views(params, whole_experts=True)
    kvh = local_kv_heads(params, cfg)
    prompt = torch.as_tensor(prompt, device=device).long()
    b, p = prompt.shape
    w = beam_width
    if max_new_tokens < 1:
        raise ValueError(
            f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if not 1 <= w <= cfg.vocab_size:
        raise ValueError(
            f"beam_width must be in [1, vocab_size={cfg.vocab_size}], "
            f"got {w}")
    if length_penalty < 0:
        raise ValueError(
            f"length_penalty must be >= 0, got {length_penalty}")
    # Resolved with the other argument checks: a bad beam_impl or an
    # over-limit ancestry config raises before any device work.
    if beam_impl not in ("auto", "ancestry", "physical"):
        raise ValueError(
            f"beam_impl must be 'auto', 'ancestry', or 'physical', "
            f"got {beam_impl!r}")
    if _force_physical:
        beam_impl = "physical"
    use_anc = beam_impl != "physical"
    if use_anc:
        est = _ancestry_score_bytes(b, w, cfg)
        if est > ANCESTRY_SCORE_LIMIT_BYTES:
            msg = (f"ancestry attention's per-layer score intermediate "
                   f"would be ~{est / 2**20:.0f} MiB (batch {b} x width "
                   f"{w}^2 x {cfg.n_heads} heads x max_len {cfg.max_len}, "
                   f"f32 x2) — over the "
                   f"{ANCESTRY_SCORE_LIMIT_BYTES / 2**20:.0f} MiB limit")
            if beam_impl == "ancestry":
                raise ValueError(
                    msg + "; use beam_impl='physical' (exact same "
                    "hypotheses via cache reorder) or shrink "
                    "batch/beam_width/max_len")
            warnings.warn(msg + "; falling back to the physical "
                          "parent-gather (same hypotheses, more HBM "
                          "traffic per step)", stacklevel=2)
            use_anc = False
    total = _check_decode_budget(p, max_new_tokens, cfg, eos_token,
                                 rolling_ok=prompt_cache is None)
    off = 0
    with torch.no_grad():
        # ---- prompt pass on the untiled [B] batch
        if prompt_cache is not None:
            cache, off = _resolve_prompt_cache(
                prompt_cache, cfg, b, p, max_new_tokens, use_prefill,
                device, kv_int8, kvh)
            _decode_chunk(params, cache, prompt,
                          torch.full((b,), off, dtype=torch.long,
                                     device=device), cfg, uniform_pos=True)
        elif _resolve_prefill(params, cfg, p, use_prefill, ragged=False):
            cache, _ = prefill(params, prompt, cfg, last_logits=False,
                               kv_int8=kv_int8, device=device)
        else:
            cache = init_cache(cfg, b, kv_int8=kv_int8, device=device,
                               kv_heads=kvh)
            for q in range(p - 1):
                _decode_step(params, cache, prompt[:, q], q, cfg)
        # Logits of the first generated position (recomputes the last
        # prompt position in place, as generate's prefill path does).
        logits, cache = _decode_step(params, cache, prompt[:, p - 1],
                                     off + p - 1, cfg)
        logp0 = torch.log_softmax(logits, dim=-1)             # [B, V]

        # ---- first expansion: top-W distinct first tokens
        scores, first = _top_w(logp0, w)                      # [B, W]
        done = (first == eos_token if eos_token is not None else
                torch.zeros((b, w), dtype=torch.bool, device=device))
        lengths = torch.ones((b, w), dtype=torch.long, device=device)
        # Beam lanes tile the batch: row b's beams are b*W .. b*W+W-1.
        # Positions are absolute (past the prefix ``off``).
        total = off + total
        buf = torch.zeros((b, w, total), dtype=torch.long, device=device)
        buf[:, :, off:off + p] = prompt[:, None, :]
        buf[:, :, off + p] = first
        cache = {n: a.repeat_interleave(w, dim=1) for n, a in cache.items()}
        # Ancestry: every lane is its own ancestor for the prompt and the
        # first token (the tiled copies agree).
        lane_ids = torch.arange(w, device=device)
        anc = lane_ids[None, :, None].expand(b, w, cfg.max_len).clone()
        if eos_token is not None:
            frozen = torch.full((cfg.vocab_size,), -1e30, device=device)
            frozen[eos_token] = 0.0
        rows = torch.arange(b, device=device)[:, None]
        for q in range(off + p, total - 1):
            logits, cache = _decode_step(
                params, cache, buf[:, :, q].reshape(b * w), q, cfg,
                beam_anc=(anc, w) if use_anc else None)
            logp = torch.log_softmax(logits, dim=-1).reshape(b, w, -1)
            v = logp.shape[-1]
            cand = scores[:, :, None] + logp                 # [B, W, V]
            if eos_token is not None:
                # A finished beam's only continuation is eos at
                # unchanged score; everything else is pruned.
                cand = torch.where(done[:, :, None],
                                   scores[:, :, None] + frozen, cand)
            scores, idx = _top_w(cand.reshape(b, w * v), w)
            parent, token = idx // v, idx % v                 # [B, W]
            buf = buf[rows, parent]
            buf[:, :, q + 1] = token
            done = done[rows, parent]
            lengths = lengths[rows, parent]
            lengths = torch.where(done, lengths, lengths + 1)
            if eos_token is not None:
                done = done | (token == eos_token)
            if use_anc:
                # A kept beam inherits its parent's ancestry for s <= q
                # (the parent's lane wrote position q this step); its
                # next write slot is its own lane.  Slot-indexed: under
                # rolling decode this retires the reused slot's ancestry
                # in the step that overwrites its K/V.
                anc = anc[rows, parent]
                anc[:, :, (q + 1) % cfg.max_len] = lane_ids
            else:
                flat = (parent + rows * w).reshape(b * w)
                cache = {n: a.index_select(1, flat)
                         for n, a in cache.items()}
        if length_penalty > 0:
            norm = scores / torch.pow((5.0 + lengths) / 6.0,
                                      length_penalty)
            order = torch.sort(-norm, dim=1, stable=True).indices
            buf = buf[rows, order]
            scores = norm.gather(1, order)
    return buf[:, :, off:].to(torch.int32), scores


def _position_generator(seed: int, pos: int, device) -> torch.Generator:
    """The sampling stream of one position: a pure function of
    (seed, pos), so the prefill and sequential paths draw alike."""
    state = np.random.SeedSequence([seed, pos]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(
        int(state[0]) & (2**63 - 1))


def _sample(logits, temperature, top_k, top_p, min_p, gen):
    """Filter the temperature-scaled logits (top-k, nucleus, min-p, in
    that order) and draw one token per row by the Gumbel-max trick.  The
    temperature divides as a device tensor (a true division on every
    device, as the serving engine's per-lane temperatures divide; CUDA
    turns a division by a host scalar into a reciprocal product)."""
    scaled = logits / torch.full((1,), temperature, device=logits.device)
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

    ``prompt_cache=(cache, cached_len)`` reuses a prefilled prefix (the
    system-prompt pattern): ``prefill`` the prefix once, at the request
    batch or at batch 1 (which fans out), and pass each request's
    remaining prompt here.  The suffix runs as ONE chunked pass against a
    copy of the prefix cache, positions (and sampling streams) count from
    the prefix start, and the result is ``[B, P + N]`` without the
    prefix.  Full-cache configs only; the segment's quantization must
    match ``kv_int8``.

    ``kv_int8=True`` stores the cache as int8 K/V with f32 scales (the
    prefill forward attends in full precision and quantizes after the
    fact; the sequential path attends the quantized cache).  An int8
    tree (``quantize_params``) decodes sequentially.
    """
    device = resolve_device(device)
    check_on_device(params, device)
    params = views(params, whole_experts=True)
    kvh = local_kv_heads(params, cfg)
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
    cached_len = 0
    if prompt_cache is not None:
        if prompt_lengths is not None:
            raise ValueError("prompt_cache requires uniform prompts "
                             "(no prompt_lengths)")
        cache, cached_len = _resolve_prompt_cache(
            prompt_cache, cfg, b, p, max_new_tokens, use_prefill, device,
            kv_int8, kvh)

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
    if prompt_cache is None:
        use_prefill = _resolve_prefill(params, cfg, p, use_prefill,
                                       ragged=pad_lens is not None)

    # Absolute positions: the prompt occupies [cached_len, cached_len + p).
    total = cached_len + total
    buf = torch.zeros((b, total), dtype=torch.long, device=device)
    buf[:, cached_len:cached_len + p] = prompt
    with torch.no_grad():
        if prompt_cache is not None:
            # The suffix in one chunked pass over the prefix cache; the
            # loop starts at the last prompt position, as after prefill.
            _decode_chunk(params, cache, prompt,
                          torch.full((b,), cached_len, dtype=torch.long,
                                     device=device), cfg, uniform_pos=True)
            start = cached_len + p - 1
        elif use_prefill:
            # The cache holds K/V for [0, p); the loop starts at the last
            # prompt position (its step recomputes identical K/V in place
            # and yields the logits that pick token p).
            cache, _ = prefill(params, prompt, cfg, last_logits=False,
                               kv_int8=kv_int8, device=device)
            start = p - 1
        else:
            cache = init_cache(cfg, b, kv_int8=kv_int8, device=device,
                               kv_heads=kvh)
            start = 0
        done = torch.zeros(b, dtype=torch.bool, device=device)
        for pos in range(start, total - 1):
            logits, cache = _decode_step(params, cache, buf[:, pos], pos,
                                         cfg, pad_lens)
            if pos + 1 < cached_len + p:
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
    return buf[:, cached_len:].to(torch.int32)

"""The flagship LM in plain PyTorch: weights from a seed, the forward
pass, the next-token loss, one AdamW step, and the logits a served token
is judged by.

A pre-norm decoder: RMSNorm (eps 1e-6), multi-head causal attention
with half-split rotary embeddings (RoPE, theta from the configuration),
a residual add, RMSNorm, a two-matrix FFN with tanh-approximated GELU,
a residual add; a final RMSNorm and the tied unembedding.  Weights keep
the reference's layout (per-layer leaves stacked on a leading layer
axis): ``tok_emb [V, d]``, ``ln_f_scale [d]``, ``layers/ln1_scale``,
``ln2_scale [L, d]``, ``attn/wq``, ``wk``, ``wv [L, d, H, hd]``, ``wo [L,
H, hd, d]``, ``ffn/w1 [L, d, f]``, ``w2 [L, f, d]``.

``act`` names the activation dtype the configuration states: the
embedding rows and the tied table are cast to it, and every product
promotes its operands to the wider of the two, so f32 weights under a
bf16 configuration compute in f32 past the embedding.  The attention is
the plain softmax over the masked score matrix, in f32.

This file imports nothing of the program: it is the yardstick.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference.precision import tf32 as _tf32

ADAMW = {"lr": 3e-4, "b1": 0.9, "b2": 0.999, "eps": 1e-8, "wd": 1e-4}


def leaf_shapes(cfg: dict) -> dict:
    d, f, h, L = cfg["d_model"], cfg["d_ff"], cfg["n_heads"], cfg["n_layers"]
    hd = d // h
    return {"tok_emb": ((cfg["vocab_size"], d), d),
            "ln_f_scale": ((d,), None),
            "layers/ln1_scale": ((L, d), None),
            "layers/ln2_scale": ((L, d), None),
            "layers/attn/wq": ((L, d, h, hd), d),
            "layers/attn/wk": ((L, d, h, hd), d),
            "layers/attn/wv": ((L, d, h, hd), d),
            "layers/attn/wo": ((L, h, hd, d), d),
            "layers/ffn/w1": ((L, d, f), d),
            "layers/ffn/w2": ((L, f, d), f)}


def init_params(cfg: dict, seed: int, device, dtype=torch.float32) -> dict:
    """Seeded weights in the reference's scales (a normal over sqrt of
    the fan-in; unit norm scales), made on ``device`` by one draw from a
    generator there, then cut into leaves.  The same seed gives the same
    bits."""
    shapes = leaf_shapes(cfg)
    total = sum(math.prod(s) for s, fan in shapes.values() if fan)
    gen = torch.Generator(device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, i = {}, 0
    for path, (shape, fan) in shapes.items():
        if fan is None:
            leaf = torch.ones(shape, device=device)
        else:
            n = math.prod(shape)
            leaf = flat[i:i + n].view(shape) / math.sqrt(fan)
            i += n
        out[path] = leaf.to(dtype)
    del flat
    return nest(out)


def nest(flat: dict) -> dict:
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _wide(*xs):
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in xs]


def _rms_norm(x, scale, eps=1e-6):
    var = x.float().square().mean(-1, keepdim=True)
    y = (x * torch.rsqrt(var + eps)).to(x.dtype)
    y, scale = _wide(y, scale)
    return y * scale


def _rope(x, pos, theta):
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = pos.float()[:, None] * inv                      # [S, half]
    c, s = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], -1).to(x.dtype)


def _proj(x, w, n=1):
    x, w = _wide(x, w)
    inner = math.prod(w.shape[:n])
    return (x.reshape(-1, inner) @ w.reshape(inner, -1)).reshape(
        *x.shape[:x.dim() - n], *w.shape[n:])


def _attention(q, k, v):
    """Causal softmax attention, f32: ``[B, S, H, hd]`` each."""
    s = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(q.shape[-1])
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), -1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


def hidden(params: dict, tokens, cfg: dict, act):
    """Final-norm hidden states ``[B, S, d]`` of int ``tokens [B, S]``."""
    x = params["tok_emb"][tokens].to(act)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    lay = params["layers"]
    for i in range(cfg["n_layers"]):
        h = _rms_norm(x, lay["ln1_scale"][i])
        a = lay["attn"]
        q = _proj(h, a["wq"][i])
        k = _proj(h, a["wk"][i])
        v = _proj(h, a["wv"][i])
        if cfg.get("rope"):
            q = _rope(q, pos, cfg["rope_theta"])
            k = _rope(k, pos, cfg["rope_theta"])
        x, y = _wide(x, _proj(_attention(q, k, v), a["wo"][i], 2))
        x = x + y
        h = _rms_norm(x, lay["ln2_scale"][i])
        ffn = lay["ffn"]
        u = F.gelu(_proj(h, ffn["w1"][i]), approximate="tanh")
        x, y = _wide(x, _proj(u, ffn["w2"][i]))
        x = x + y
    return _rms_norm(x, params["ln_f_scale"])


def logits(params: dict, tokens, cfg: dict, act):
    """f32 next-token logits ``[B, S, V]`` (the tied table in ``act``)."""
    h = hidden(params, tokens, cfg, act)
    return _proj(h, params["tok_emb"].to(act).t()).float()


def loss(params: dict, rows, cfg: dict, act):
    """Mean next-token cross-entropy of ``rows [B, S + 1]``."""
    lg = logits(params, rows[:, :-1], cfg, act)
    logp = torch.log_softmax(lg, -1)
    return -logp.gather(-1, rows[:, 1:, None])[..., 0].mean()


def loss_and_grads(params: dict, rows, cfg: dict, act, chunk: int = 1):
    """The batch's mean loss and its gradients, accumulated over blocks
    of ``chunk`` rows (each block's loss weighted by its share), so that
    one block's activations fit beside the weights."""
    leaves = flatten(params)
    for p in leaves.values():
        p.requires_grad_(True)
    grads = {k: torch.zeros_like(p) for k, p in leaves.items()}
    total = torch.zeros((), dtype=torch.float64, device=rows.device)
    b = rows.shape[0]
    for i in range(0, b, chunk):
        part = rows[i:i + chunk]
        li = loss(params, part, cfg, act) * (part.shape[0] / b)
        gs = torch.autograd.grad(li, list(leaves.values()))
        for k, g in zip(leaves, gs):
            grads[k] += g
        total += li.detach().double()
    for p in leaves.values():
        p.requires_grad_(False)
    return float(total), grads


@torch.no_grad()
def adamw_step(params: dict, grads: dict, state: dict, t: int,
               hp=ADAMW) -> None:
    """One AdamW update in place (decoupled decay, bias-corrected
    moments; ``t`` counts from 1).  ``state`` holds ``m`` and ``v``."""
    c1, c2 = 1 - hp["b1"] ** t, 1 - hp["b2"] ** t
    for k, p in flatten(params).items():
        g = grads[k]
        m = state.setdefault(("m", k), torch.zeros_like(p))
        v = state.setdefault(("v", k), torch.zeros_like(p))
        p.mul_(1 - hp["lr"] * hp["wd"])
        m.mul_(hp["b1"]).add_(g, alpha=1 - hp["b1"])
        v.mul_(hp["b2"]).addcmul_(g, g, value=1 - hp["b2"])
        p.sub_(hp["lr"] / c1 * m / (v.sqrt() / math.sqrt(c2) + hp["eps"]))


def train_readings(params: dict, batches, cfg: dict, act, chunk: int = 1,
                   tf32: bool = False):
    """Three AdamW steps from ``params`` (changed in place) over
    ``batches`` (three ``[B, S + 1]`` row blocks): the three losses, the
    first gradient's norm by leaf, the norm of each leaf's change after
    the three steps, and the first gradient itself by leaf.  Products in
    full f32 (``tf32``: TF32, the control)."""
    with _tf32(tf32):
        return _train_readings(params, batches, cfg, act, chunk)


def _train_readings(params, batches, cfg, act, chunk):
    start = {k: p.clone() for k, p in flatten(params).items()}
    state, losses, g1, first = {}, [], None, None
    for t, rows in enumerate(batches, 1):
        value, grads = loss_and_grads(params, rows, cfg, act, chunk)
        losses.append(value)
        if t == 1:
            g1 = {k: float(g.norm()) for k, g in grads.items()}
            first = grads
        adamw_step(params, grads, state, t)
        del grads
    change = {k: float((p - start[k]).norm())
              for k, p in flatten(params).items()}
    return losses, g1, change, first


@torch.no_grad()
def served_gaps(params: dict, cfg: dict, prompt, served, act):
    """By how much each served token's logit lies below the best logit
    at its position (one forward over the prompt and the served tokens,
    full f32 products)."""
    seq = torch.cat([prompt, served])[None]
    with _tf32(False):
        lg = logits(params, seq[:, :-1], cfg, act)[0, prompt.numel() - 1:]
    return lg.max(-1).values - lg.gather(-1, served[:, None])[:, 0]

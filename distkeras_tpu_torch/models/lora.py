"""LoRA fine-tuning: low-rank adapters over a frozen transformer base.

Counterpart of ``distkeras_tpu/models/lora.py``.  An adapter trains the
rank-r delta ``W + (alpha / r) * A @ B`` of a chosen projection; the
adapters merge into the base inside the loss (``make_lora_loss``), so the
forward is the standard ``apply`` (flash kernels on the card) and the
merged tree serves through every decode path unchanged
(:func:`lora_merge`).

The port's train step updates in place, where the reference's step is
pure: the optimizer is built over the adapter leaves only
(``Optimizer.masked(lora_mask)``, the port's ``optax.masked``), the loss
merges a detached base, so the base gets no gradient, no moment and no
update, and comes out of any number of steps bit-identical.
``lora_init`` draws from an explicit ``torch.Generator`` (JAX's key
stream cannot be matched; carry adapters across with
``utils.serialization.lora_from_numpy``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from distkeras_tpu_torch.models import transformer as tfm
from distkeras_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    """``rank`` r and scale ``alpha`` (delta = alpha / r * A @ B);
    ``targets`` name the adapted weights: attention projections ("wq",
    "wk", "wv", "wo") and / or the dense-FFN mats ("w1", "w2")."""

    rank: int = 8
    alpha: float = 16.0
    targets: tuple = ("wq", "wv")


# target -> (a-shape fn, b-shape fn, merge einsum); shapes get (cfg, r)
# and carry the leading [L] stack axis like every other param.
_ATTN = {
    "wq": (lambda c, r: (c.n_layers, c.d_model, r),
           lambda c, r: (c.n_layers, r, c.n_heads, c.head_dim),
           "ldr,lrhk->ldhk"),
    "wk": (lambda c, r: (c.n_layers, c.d_model, r),
           lambda c, r: (c.n_layers, r, c.kv_heads, c.head_dim),
           "ldr,lrhk->ldhk"),
    "wv": (lambda c, r: (c.n_layers, c.d_model, r),
           lambda c, r: (c.n_layers, r, c.kv_heads, c.head_dim),
           "ldr,lrhk->ldhk"),
    "wo": (lambda c, r: (c.n_layers, c.n_heads, c.head_dim, r),
           lambda c, r: (c.n_layers, r, c.d_model),
           "lhkr,lrd->lhkd"),
}
_FFN = {
    "w1": (lambda c, r: (c.n_layers, c.d_model, r),
           lambda c, r: (c.n_layers, r, c.d_ff),
           "ldr,lrf->ldf"),
    "w2": (lambda c, r: (c.n_layers, c.d_ff, r),
           lambda c, r: (c.n_layers, r, c.d_model),
           "lfr,lrd->lfd"),
}


def _validate(cfg: tfm.TransformerConfig, lcfg: LoRAConfig) -> None:
    known = set(_ATTN) | set(_FFN)
    bad = set(lcfg.targets) - known
    if bad:
        raise ValueError(f"unknown LoRA targets {sorted(bad)}; "
                         f"known: {sorted(known)}")
    if not lcfg.targets:
        raise ValueError("LoRAConfig.targets is empty — nothing to train")
    if len(set(lcfg.targets)) != len(lcfg.targets):
        raise ValueError(
            f"duplicate LoRA targets in {lcfg.targets} — likely a typo "
            "for a different projection; a duplicate would silently "
            "collapse into one adapter")
    if lcfg.rank < 1:
        raise ValueError(f"rank must be >= 1, got {lcfg.rank}")
    if cfg.num_experts and set(lcfg.targets) & set(_FFN):
        raise ValueError(
            "LoRA FFN targets (w1/w2) need a dense-FFN config; this MoE "
            "config's expert mats are not adapted (attention targets "
            "work fine on MoE configs)")


def lora_init(rng, cfg: tfm.TransformerConfig, lcfg: LoRAConfig,
              device=None):
    """Adapter tree ``{"attn": {name: {"a", "b"}}, "ffn": {...}}``, f32 on
    ``device`` (the card unless ``device="cpu"``).  A ~ N(0, 1/fan_in),
    B = 0: the delta starts at exactly zero.  ``rng`` is a CPU
    ``torch.Generator`` or an int seed; targets draw in sorted order."""
    _validate(cfg, lcfg)
    device = resolve_device(device)
    gen = rng if isinstance(rng, torch.Generator) else \
        torch.Generator().manual_seed(int(rng))
    tree = {}
    for name in sorted(lcfg.targets):
        group, specs = ("attn", _ATTN) if name in _ATTN else ("ffn", _FFN)
        a_shape = specs[name][0](cfg, lcfg.rank)
        b_shape = specs[name][1](cfg, lcfg.rank)
        fan_in = math.prod(a_shape[1:-1])
        tree.setdefault(group, {})[name] = {
            "a": (torch.randn(a_shape, generator=gen)
                  / math.sqrt(fan_in)).to(device),
            "b": torch.zeros(b_shape, device=device),
        }
    return tree


def lora_merge(params, adapters, cfg: tfm.TransformerConfig,
               lcfg: LoRAConfig):
    """Base params + scaled low-rank deltas -> a servable params tree
    (the ``init_params`` layout; new tensors for the adapted leaves, the
    base's own for the rest)."""
    _validate(cfg, lcfg)
    scale = lcfg.alpha / lcfg.rank
    params = dict(params)
    layers = dict(params["layers"])
    for group, specs in (("attn", _ATTN), ("ffn", _FFN)):
        if group not in adapters:
            continue
        sub = dict(layers[group])
        for name, ab in adapters[group].items():
            delta = torch.einsum(specs[name][2], ab["a"], ab["b"]) * scale
            sub[name] = sub[name] + delta.to(sub[name].dtype)
        layers[group] = sub
    params["layers"] = layers
    return params


def make_lora_loss(cfg: tfm.TransformerConfig, lcfg: LoRAConfig):
    """An ``lm_loss``-signature callable over the packed ``(adapters,
    base)`` tree: merges a detached base with the adapters (inside the
    step), then defers to ``lm_loss``.  Plug into
    ``make_train_step(..., loss_fn=...)``."""
    _validate(cfg, lcfg)

    def loss(packed, tokens, cfg_, attention_fn=None, apply_fn=None,
             dropout_rng=None, hidden_fn=None, segment_ids=None):
        adapters, base = packed
        frozen = tfm._map_leaves(lambda t: t.detach(), base)
        merged = lora_merge(frozen, adapters, cfg_, lcfg)
        return tfm.lm_loss(merged, tokens, cfg_, attention_fn, apply_fn,
                           dropout_rng, hidden_fn, segment_ids)

    return loss


def lora_mask(packed):
    """Trainability mask over the packed ``(adapters, base)`` tree: True on
    the adapter leaves, False on the base — ``Optimizer.masked`` builds
    its state for the True leaves only."""
    adapters, base = packed
    return (tfm._map_leaves(lambda _: True, adapters),
            tfm._map_leaves(lambda _: False, base))


__all__ = ["LoRAConfig", "lora_init", "lora_merge", "make_lora_loss",
           "lora_mask"]

"""The LM path's optimizers: ``torch.optim`` with optax's defaults and
formulas.

Counterpart of ``distkeras_tpu/trainers/lm.py::_OPTS`` and of the optax
chain that ``LMTrainer``'s constructor builds around it:

- ``adam`` / ``adamw`` / ``sgd`` are ``torch.optim.Adam`` / ``AdamW`` /
  ``SGD`` with optax's defaults: b1 0.9, b2 0.999, eps 1e-8, adamw's
  weight decay 1e-4 (torch's default is 1e-2), and sgd without momentum.
  torch's update formulas equal optax's (decoupled decay scaled by the
  learning rate, bias-corrected moments); only rounding differs.
- ``weight_decay=`` (adamw only) decays every leaf except the RMSNorm
  scales (names ending in ``_scale``): the reference's decay mask, as two
  parameter groups.
- ``grad_clip_norm`` is optax's ``clip_by_global_norm``: the gradients
  become ``(g / norm) * max_norm`` only when ``norm >= max_norm`` (no
  ``+ 1e-6`` as in ``torch.nn.utils.clip_grad_norm_``).
- A callable ``learning_rate`` is a schedule of the optimizer step count
  (0 for the first update), as optax's schedules are.
- ``ema_decay`` keeps a shadow ``decay * s + (1 - decay) * p`` of the
  post-step params (the reference's ``_with_ema``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from distkeras_tpu_torch.models.transformer import (_leaves, _map_leaves,
                                                   global_norm, named_leaves)

NAMES = ("adam", "adamw", "sgd")

# optax's defaults.
_BETAS = (0.9, 0.999)
_EPS = 1e-8
_ADAMW_DECAY = 1e-4


@dataclasses.dataclass
class OptState:
    """What ``Optimizer.init`` builds: the torch optimizer over the
    params' leaves, the number of updates applied, and the EMA shadow
    (a params-like dict, or None)."""
    torch_opt: torch.optim.Optimizer
    count: int = 0
    ema: dict | None = None


class Optimizer:
    """One of :data:`NAMES` with the reference's clip and EMA wrappers.

    ``init(params)`` makes every leaf of ``params`` require grad and
    returns an :class:`OptState`; ``update(params, state)`` applies one
    step in place from the leaves' ``.grad``.
    """

    def __init__(self, name: str = "adamw",
                 learning_rate: float | Callable = 3e-4,
                 weight_decay: float | None = None,
                 grad_clip_norm: float | None = None,
                 ema_decay: float | None = None):
        if name not in NAMES:
            raise ValueError(f"unknown optimizer {name!r}; known: "
                             f"{sorted(NAMES)}")
        if not callable(learning_rate) and learning_rate <= 0:
            raise ValueError(
                f"learning_rate must be positive, got {learning_rate}")
        if weight_decay is not None and name != "adamw":
            raise ValueError(
                "weight_decay only applies to optimizer='adamw'; got "
                f"optimizer={name!r}")
        if grad_clip_norm is not None and grad_clip_norm <= 0:
            raise ValueError(
                f"grad_clip_norm must be positive, got {grad_clip_norm}")
        if ema_decay is not None and not 0.0 < ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in (0, 1), got {ema_decay}")
        self.name = name
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.grad_clip_norm = grad_clip_norm
        self.ema_decay = ema_decay

    def _lr(self, count: int) -> float:
        if callable(self.learning_rate):
            return float(self.learning_rate(count))
        return float(self.learning_rate)

    def init(self, params) -> OptState:
        named = named_leaves(params)
        for _, p in named:
            p.requires_grad_(True)
        leaves = [p for _, p in named]
        lr = self._lr(0)
        if self.name == "sgd":
            opt = torch.optim.SGD(leaves, lr=lr, momentum=0.0)
        elif self.name == "adam":
            opt = torch.optim.Adam(leaves, lr=lr, betas=_BETAS, eps=_EPS)
        elif self.weight_decay is None:
            opt = torch.optim.AdamW(leaves, lr=lr, betas=_BETAS, eps=_EPS,
                                    weight_decay=_ADAMW_DECAY)
        else:
            scales = [p for n, p in named if n.endswith("_scale")]
            decayed = [p for n, p in named if not n.endswith("_scale")]
            opt = torch.optim.AdamW(
                [{"params": decayed, "weight_decay": self.weight_decay},
                 {"params": scales, "weight_decay": 0.0}],
                lr=lr, betas=_BETAS, eps=_EPS)
        ema = None
        if self.ema_decay is not None:
            ema = _map_leaves(lambda p: p.detach().clone(), params)
        return OptState(opt, 0, ema)

    @torch.no_grad()
    def update(self, params, state: OptState) -> None:
        """One step, in place: clip, set the scheduled rate, step the
        torch optimizer, then move the EMA shadow toward the new
        params."""
        leaves = _leaves(params)
        grads = [p.grad for p in leaves if p.grad is not None]
        if self.grad_clip_norm is not None and grads:
            norm = global_norm(grads)
            keep = norm < self.grad_clip_norm
            for g in grads:
                g.copy_(torch.where(keep, g, (g / norm) * self.grad_clip_norm))
        lr = self._lr(state.count)
        for group in state.torch_opt.param_groups:
            group["lr"] = lr
        state.torch_opt.step()
        state.count += 1
        if state.ema is not None:
            d = self.ema_decay
            for s, p in zip(_leaves(state.ema), leaves):
                s.copy_(d * s + (1.0 - d) * p)

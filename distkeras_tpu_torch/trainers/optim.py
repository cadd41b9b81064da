"""The port's optimizers: optax's formulas and defaults in torch.

Counterpart of ``distkeras_tpu/trainers/lm.py::_OPTS`` and of the optax
chain that ``LMTrainer``'s constructor builds around it, and of the
optimizer names ``distkeras_tpu/ops/optimizers.py::resolve_optimizer``
gives the Keras trainer family (``ops/optimizers.py`` resolves those
names to this class):

- ``adam`` / ``adamw`` / ``sgd`` are ``torch.optim.Adam`` / ``AdamW`` /
  ``SGD`` with optax's defaults: b1 0.9, b2 0.999, eps 1e-8, adamw's
  weight decay 1e-4 (torch's default is 1e-2), and sgd without momentum
  (``momentum=`` / ``nesterov=`` give optax's ``trace``, which is torch's
  SGD with ``dampening=0``).  torch's update formulas equal optax's
  (decoupled decay scaled by the learning rate, bias-corrected moments);
  only rounding differs.
- ``nadam`` / ``adagrad`` / ``rmsprop`` / ``adadelta`` are written here,
  because torch's versions differ from optax's: ``nadam`` is optax's
  ``adam(nesterov=True)`` (no ``momentum_decay`` schedule), ``adagrad``
  starts its accumulator at 0.1 and divides by ``sqrt(acc + 1e-7)``,
  ``rmsprop`` decays by 0.9 and divides by ``sqrt(nu + 1e-8)`` from
  ``nu = 0``, ``adadelta`` uses rho 0.9 and eps 1e-6.
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
- ``masked(mask_fn)`` is ``optax.masked``: the optimizer is built over
  the leaves ``mask_fn(params)`` marks True only, so moments exist for
  them alone and no update touches the rest (LoRA's frozen base).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable

import torch

from distkeras_tpu_torch.models.transformer import (_leaves, _map_leaves,
                                                   global_norm, named_leaves)

NAMES = ("adam", "adamw", "sgd", "nadam", "adagrad", "adadelta", "rmsprop")
# The LM path's subset (the reference's ``trainers/lm.py::_OPTS``).
LM_NAMES = ("adam", "adamw", "sgd")

# optax's defaults.
_BETAS = (0.9, 0.999)
_EPS = 1e-8
_ADAMW_DECAY = 1e-4


@dataclasses.dataclass
class OptState:
    """What ``Optimizer.init`` builds: the torch optimizer over the
    trained leaves, the number of updates applied, the EMA shadow (a
    params-like dict, or None) and the trained leaves themselves."""
    torch_opt: torch.optim.Optimizer
    count: int = 0
    ema: dict | None = None
    leaves: list = dataclasses.field(default_factory=list)


class Optimizer:
    """One of :data:`NAMES` with the reference's clip and EMA wrappers.

    ``init(params)`` makes every trained leaf of ``params`` (a nested
    dict, a tuple of them, or a list of tensors) require grad and returns
    an :class:`OptState`; ``update(params, state)`` applies one step in
    place from the trained leaves' ``.grad``.
    """

    mask = None

    def __init__(self, name: str = "adamw",
                 learning_rate: float | Callable = 3e-4,
                 weight_decay: float | None = None,
                 grad_clip_norm: float | None = None,
                 ema_decay: float | None = None,
                 momentum: float | None = None, nesterov: bool = False):
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
        if (momentum is not None or nesterov) and name != "sgd":
            raise ValueError("momentum / nesterov only apply to "
                             f"optimizer='sgd'; got optimizer={name!r}")
        if nesterov and not momentum:
            raise ValueError("nesterov=True needs a momentum")
        self.name = name
        self.momentum = momentum
        self.nesterov = nesterov
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.grad_clip_norm = grad_clip_norm
        self.ema_decay = ema_decay

    def _lr(self, count: int) -> float:
        if callable(self.learning_rate):
            return float(self.learning_rate(count))
        return float(self.learning_rate)

    def masked(self, mask_fn: Callable) -> "Optimizer":
        """A copy that trains only the leaves ``mask_fn(params)`` marks
        True (a tree of bools shaped like the params), as
        ``optax.masked`` does; it cannot keep an EMA of a masked tree."""
        if self.ema_decay is not None:
            raise ValueError("ema_decay does not compose with a mask: the "
                             "shadow would cover the frozen leaves too")
        out = copy.copy(self)
        out.mask = mask_fn
        return out

    def init(self, params) -> OptState:
        named = _named(params)
        if self.mask is not None:
            keep = [bool(m) for _, m in named_leaves(self.mask(params))]
            named = [leaf for leaf, k in zip(named, keep) if k]
        for _, p in named:
            p.requires_grad_(True)
        leaves = [p for _, p in named]
        lr = self._lr(0)
        if self.name == "sgd":
            opt = torch.optim.SGD(leaves, lr=lr, momentum=self.momentum or 0.0,
                                  nesterov=self.nesterov)
        elif self.name in _OPTAX:
            opt = _OPTAX[self.name](leaves, lr)
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
        return OptState(opt, 0, ema, leaves)

    def exchange(self, params, state: OptState) -> None:
        """Merge the gradients over the data-parallel group: nothing to
        do for one replica (``parallel/collectives.py`` wraps this)."""

    def grad_norm(self, params, state: OptState):
        """The global norm of the trained leaves' gradients (the
        ``probe_metrics`` reading)."""
        return global_norm([p.grad for p in state.leaves
                            if p.grad is not None])

    @torch.no_grad()
    def update(self, params, state: OptState, norm_fn=None) -> None:
        """One step, in place: clip, set the scheduled rate, step the
        torch optimizer, then move the EMA shadow toward the new
        params.  ``norm_fn(grads)`` replaces the clip's global norm (a
        sharded update sums it over the group)."""
        leaves = state.leaves
        grads = [p.grad for p in leaves if p.grad is not None]
        if self.grad_clip_norm is not None and grads:
            norm = (norm_fn or global_norm)(grads)
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


def _named(params):
    """``[(name, tensor)]`` of a params tree: key paths of nested dicts,
    indices of tuples and lists."""
    return named_leaves(params)


class _Elementwise(torch.optim.Optimizer):
    """An optax update rule written per leaf: ``_update(g, state, lr,
    count)`` returns the step added to the leaf (``count`` counts this
    update, from 1); state tensors are made by ``_init``."""

    def __init__(self, params, lr: float):
        super().__init__(params, {"lr": lr})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st.update(self._init(p))
                    st["count"] = 0
                st["count"] += 1
                p.add_(self._update(p.grad, st, group["lr"], st["count"]))


class _NAdam(_Elementwise):
    """optax ``nadam`` = ``adam(nesterov=True)``: the Nesterov first
    moment ``b1 mu / (1 - b1^(t+1)) + (1 - b1) g / (1 - b1^t)``."""

    def _init(self, p):
        return {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

    def _update(self, g, st, lr, t):
        b1, b2 = _BETAS
        st["mu"].mul_(b1).add_((1 - b1) * g)
        st["nu"].mul_(b2).add_((1 - b2) * (g * g))
        mu_hat = (b1 * (st["mu"] / (1 - b1 ** (t + 1)))
                  + (1 - b1) * (g / (1 - b1 ** t)))
        nu_hat = st["nu"] / (1 - b2 ** t)
        return -lr * (mu_hat / (torch.sqrt(nu_hat) + _EPS))


class _Adagrad(_Elementwise):
    """optax ``adagrad``: accumulator from 0.1, ``g / sqrt(acc + 1e-7)``."""

    def _init(self, p):
        return {"acc": torch.full_like(p, 0.1)}

    def _update(self, g, st, lr, t):
        acc = st["acc"].add_(g * g)
        return -lr * (torch.where(acc > 0, torch.rsqrt(acc + 1e-7), 0.0) * g)


class _RMSProp(_Elementwise):
    """optax ``rmsprop``: ``nu = 0.9 nu + 0.1 g^2`` from 0,
    ``g / sqrt(nu + 1e-8)``."""

    def _init(self, p):
        return {"nu": torch.zeros_like(p)}

    def _update(self, g, st, lr, t):
        decay = 0.9
        nu = st["nu"].mul_(decay).add_((1 - decay) * (g * g))
        return -lr * (torch.rsqrt(nu + 1e-8) * g)


class _Adadelta(_Elementwise):
    """optax ``adadelta`` (rho 0.9, eps 1e-6): the step
    ``sqrt(e_x + eps) / sqrt(e_g + eps) g`` and its running square."""

    def _init(self, p):
        return {"e_g": torch.zeros_like(p), "e_x": torch.zeros_like(p)}

    def _update(self, g, st, lr, t):
        rho, eps = 0.9, 1e-6
        e_g = st["e_g"].mul_(rho).add_((1 - rho) * (g * g))
        u = torch.sqrt(st["e_x"] + eps) / torch.sqrt(e_g + eps) * g
        st["e_x"].mul_(rho).add_((1 - rho) * (u * u))
        return -lr * u


_OPTAX = {"nadam": _NAdam, "adagrad": _Adagrad, "rmsprop": _RMSProp,
          "adadelta": _Adadelta}

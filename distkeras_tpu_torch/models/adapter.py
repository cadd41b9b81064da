"""Stateless functional view of a ``torch.nn`` model: the Keras family's
substrate.

Counterpart of ``distkeras_tpu/models/adapter.py``: the adapter extracts
the model's variables once and every step is

    state, loss = step(state, x, y)

over explicit lists of tensors, run through ``torch.func.functional_call``
with ``tv`` bound to the module's parameters (Keras' trainable variables,
in order) and ``ntv`` to its buffers (the non-trainable ones).  The steps
update ``state`` in place (one copy of the weights on the device) and
return it; the optimizer is a :class:`~distkeras_tpu_torch.trainers.
optim.Optimizer` with optax's formulas.

Everything runs on ``device`` (the card unless ``device="cpu"``).  Step
inputs are tensors on that device; ``preprocess`` (e.g.
``lambda x: x.float() / 255``) runs there, so the host can ship uint8
pixels.
"""

from __future__ import annotations

import copy
import dataclasses
import warnings
from typing import Any, Callable, Sequence

import torch
from torch import nn
from torch.func import functional_call

from distkeras_tpu_torch.models.transformer import global_norm
from distkeras_tpu_torch.ops.losses import resolve_loss
from distkeras_tpu_torch.ops.optimizers import resolve_optimizer
from distkeras_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class TrainState:
    """Everything a train step needs: the trainable / non-trainable
    values (in the module's parameter / buffer order), the optimizer
    state over ``tv`` and the number of optimizer updates taken."""

    tv: list
    ntv: list
    opt_state: Any
    step: int = 0

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


class ModelAdapter:
    """Wraps an ``nn.Module`` into stateless apply / train-step builders.

    ``loss`` and ``optimizer`` are names (or a callable / an Optimizer)
    as the reference takes them; ``metrics`` may hold ``"accuracy"``.
    """

    def __init__(self, model, loss="categorical_crossentropy",
                 optimizer="sgd", learning_rate=None,
                 metrics: Sequence[str] = (),
                 preprocess: Callable | None = None, device=None):
        if not isinstance(model, nn.Module):
            raise TypeError(f"expected a torch.nn.Module, got {type(model)}")
        if any(isinstance(p, nn.parameter.UninitializedParameter)
               for p in model.parameters()):
            raise ValueError(
                "the model must be built (run it once so its lazy layers "
                "have shapes) before wrapping in ModelAdapter")
        self.model = model
        self.device = resolve_device(device)
        self.loss_fn = resolve_loss(loss)
        self.optimizer = resolve_optimizer(optimizer, learning_rate)
        self.metrics = tuple(metrics)
        unknown = [m for m in self.metrics if m != "accuracy"]
        if unknown:  # fail at construction, not after a whole run
            raise ValueError(
                f"unknown metric(s) {unknown}; known: ['accuracy']")
        self.preprocess = preprocess
        self.tv_paths = [n for n, _ in model.named_parameters()]
        self.ntv_paths = [n for n, _ in model.named_buffers()]

    # ---------------------------------------------------------------- state

    def initial_tv(self) -> list:
        """A copy of the module's parameters on the device."""
        return [p.detach().to(self.device, copy=True)
                for p in self.model.parameters()]

    def init_state(self) -> TrainState:
        """A fresh TrainState: a real copy of the module's variables (the
        steps update the state in place, never the module)."""
        tv = self.initial_tv()
        ntv = [b.detach().to(self.device, copy=True)
               for b in self.model.buffers()]
        return TrainState(tv=tv, ntv=ntv, opt_state=self.optimizer.init(tv))

    def write_back(self, state: TrainState) -> None:
        """Copy trained values from a TrainState back into the module."""
        with torch.no_grad():
            for var, val in zip(self.model.parameters(), state.tv):
                var.copy_(val)
            for var, val in zip(self.model.buffers(), state.ntv):
                var.copy_(val)

    def export_model(self, state: TrainState):
        """Write the trained values back into the module and return a
        *new* module holding them (the reference's trainers return a
        fresh model).  The exported module does not embed the
        ``preprocess`` hook: a warning says so."""
        if self.preprocess is not None:
            warnings.warn(
                "export_model: the trained weights expect inputs "
                "transformed by this adapter's preprocess hook, but the "
                "exported module does not embed it. Apply the same "
                "transform before calling it, or run inference through "
                "the adapter's predict fn.", UserWarning, stacklevel=2)
        self.write_back(state)
        return copy.deepcopy(self.model)

    # ---------------------------------------------------------------- fns

    def stateless_apply(self, tv, ntv, x, training: bool = False):
        """Forward pass on explicit variables: ``(outputs, ntv)`` (a
        training-mode buffer update lands in ``ntv`` in place)."""
        if self.preprocess is not None:
            x = self.preprocess(x)
        self.model.train(training)
        bound = dict(zip(self.tv_paths, tv))
        bound.update(zip(self.ntv_paths, ntv))
        return functional_call(self.model, bound, (x,)), ntv

    def make_loss_fn(self) -> Callable:
        """``f(tv, ntv, x, y) -> (loss, ntv')`` in training mode."""
        loss_fn = self.loss_fn

        def compute_loss(tv, ntv, x, y):
            preds, ntv2 = self.stateless_apply(tv, ntv, x, training=True)
            return loss_fn(y, preds), ntv2

        return compute_loss

    def _value_and_grad(self):
        compute_loss = self.make_loss_fn()

        def vag(tv, ntv, x, y):
            with torch.enable_grad():
                loss, ntv2 = compute_loss(tv, ntv, x, y)
                grads = torch.autograd.grad(loss, tv)
            return loss.detach(), ntv2, grads

        return vag

    def _apply_update(self, state: TrainState, grads, ntv) -> None:
        for p, g in zip(state.tv, grads):
            p.grad = g
        self.optimizer.update(state.tv, state.opt_state)
        for p in state.tv:
            p.grad = None
        state.ntv = list(ntv)
        state.step += 1

    def make_train_step(self) -> Callable:
        """``step(state, x, y) -> (state, loss)``: one optimizer update."""
        vag = self._value_and_grad()

        def train_step(state: TrainState, x, y):
            loss, ntv2, grads = vag(state.tv, state.ntv, x, y)
            self._apply_update(state, grads, ntv2)
            return state, loss

        return train_step

    def make_accum_train_step(self, window: int, probe: bool = False
                              ) -> Callable:
        """``step(state, xs, ys)`` with ``xs: [window, B, ...]``: the
        gradients of the ``window`` microbatches summed, one update on
        their mean (the reference's ``communication_window`` commit
        cadence).  The loss is the mean of the microbatch losses (f32).
        ``probe=True`` returns ``(state, (loss, {"grad_norm": ...}))``."""
        vag = self._value_and_grad()

        def train_step(state: TrainState, xs, ys):
            ntv, g_sum = state.ntv, None
            loss_sum = torch.zeros((), dtype=torch.float32, device=xs.device)
            for i in range(window):
                loss, ntv, grads = vag(state.tv, ntv, xs[i], ys[i])
                g_sum = (list(grads) if g_sum is None
                         else [a + b for a, b in zip(g_sum, grads)])
                loss_sum = loss_sum + loss
            grads = [g / window for g in g_sum]
            norm = global_norm(grads) if probe else None
            self._apply_update(state, grads, ntv)
            loss = loss_sum / window
            if probe:
                return state, (loss, {"grad_norm": norm})
            return state, loss

        return train_step

    def make_multi_train_step(self, n_steps: int) -> Callable:
        """``step(state, xs, ys) -> (state, losses)``: ``n_steps``
        optimizer updates, one per ``xs[i]`` (not accumulation);
        ``losses`` is ``[n_steps]``."""
        train_step = self.make_train_step()

        def multi(state: TrainState, xs, ys):
            losses = []
            for i in range(n_steps):
                state, loss = train_step(state, xs[i], ys[i])
                losses.append(loss)
            return state, torch.stack(losses)

        return multi

    def make_indexed_train_step(self, n_steps: int) -> Callable:
        """``step(state, X, Y, idx) -> (state, losses)`` over a dataset
        staged on the device: ``idx: [n_steps, B]`` picks each update's
        rows there, so only indices reach the device per call."""
        multi = self.make_multi_train_step(n_steps)

        def window(state: TrainState, X, Y, idx):
            if idx.shape[0] != n_steps:
                raise ValueError(
                    f"index block carries {idx.shape[0]} steps but this "
                    f"step was built for n_steps={n_steps}; the step "
                    "counter and round bookkeeping depend on them agreeing")
            return multi(state, _gather(X, idx), _gather(Y, idx))

        return window

    def make_indexed_accum_train_step(self, window: int) -> Callable:
        """:meth:`make_accum_train_step` over a dataset staged on the
        device: ``idx: [window, B]``."""
        accum = self.make_accum_train_step(window)

        def step(state: TrainState, X, Y, idx):
            if idx.shape[0] != window:
                raise ValueError(
                    f"index block carries {idx.shape[0]} microbatches "
                    f"but this step accumulates window={window}")
            return accum(state, _gather(X, idx), _gather(Y, idx))

        return step

    def make_eval_fn(self) -> Callable:
        """``f(tv, ntv, x, y) -> {"loss": ..., metric...}`` in inference
        mode (``"accuracy"``: argmax match for multiclass logits, the
        0.5 threshold — logit > 0 — for one binary logit)."""
        loss_fn, names = self.loss_fn, self.metrics

        def class_labels(y, preds):
            """Integer class per row from sparse, one-hot, or [N, 1]
            binary labels (never a broadcast to [N, N])."""
            if y.dim() == preds.dim() and y.shape[-1] == preds.shape[-1] > 1:
                return y.argmax(-1)  # one-hot
            if y.dim() == preds.dim() and y.shape[-1] == 1:
                y = y[..., 0]  # [N, 1] binary/sparse
            if y.dim() != preds.dim() - 1:
                raise ValueError(
                    f"label shape {tuple(y.shape)} incompatible with "
                    f"prediction shape {tuple(preds.shape)} for accuracy")
            return y.to(torch.int32)

        @torch.no_grad()
        def evaluate(tv, ntv, x, y):
            preds, _ = self.stateless_apply(tv, ntv, x, training=False)
            out = {"loss": loss_fn(y, preds)}
            if "accuracy" in names:
                labels = class_labels(y, preds)
                if preds.shape[-1] == 1:
                    hit = (preds[..., 0] > 0).to(torch.int32) == labels
                else:
                    hit = preds.argmax(-1) == labels
                out["accuracy"] = hit.float().mean()
            return out

        return evaluate

    def make_predict_fn(self) -> Callable:
        """``f(tv, ntv, x) -> outputs`` in inference mode."""

        @torch.no_grad()
        def predict(tv, ntv, x):
            return self.stateless_apply(tv, ntv, x, training=False)[0]

        return predict


def _gather(X, idx):
    """Rows ``idx`` ([..., B] int) of ``X``, shaped ``[..., B, *row]``."""
    rows = torch.index_select(X, 0, idx.reshape(-1))
    return rows.reshape(*idx.shape, *X.shape[1:])

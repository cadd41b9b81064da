"""Local-replica trainers: AEASGD, EAMSGD, DOWNPOUR, Averaging, Ensemble.

Counterpart of ``distkeras_tpu/trainers/elastic.py`` (reference parity:
distkeras/trainers.py and the DeltaParameterServer's center variable).
Each replica keeps its own parameters and optimizer state across rounds,
takes ``communication_window`` local steps, then runs its algorithm's
synchronization rule against the center variable:

  * AEASGD — elastic: x_i -= a (x_i - c);  c += a sum_i (x_i - c), a = rho lr
  * EAMSGD — AEASGD with Nesterov momentum on the local steps
  * DOWNPOUR — commit the mean delta and pull: c += mean_i (x_i - c); x_i = c
  * Averaging — c = mean_i x_i once per epoch; x_i = c
  * Ensemble — no synchronization; independent models

A rule is a function ``(local_tv, center_tv, reduce) -> (new_local_tv,
new_center_tv)`` where ``reduce`` sums a tensor over the replicas: an
``all_reduce(SUM)`` over the process group, where each rank trains one
replica (the identity for a single process).  Rank ``r`` trains on the
slab of each round that the reference's stacked replica ``r`` takes;
the center variable is computed alike on every rank.

Each replica keeps its own non-trainable state (BatchNorm statistics);
the center is evaluated and exported with replica 0's, as the
reference's is.

A checkpoint holds the reference's ``{"stacked", "center_tv"}``: every
replica's state stacked over the ranks (``trainers/carry.py``), and the
center; on resume each rank takes its own replica back.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.models.adapter import _gather
from distkeras_tpu_torch.parallel.collectives import all_gather, all_reduce
from distkeras_tpu_torch.trainers.carry import (copy_leaves, stack_tree,
                                                unstack_tree)
from distkeras_tpu_torch.trainers.distributed import DistributedTrainer
from distkeras_tpu_torch.trainers.optim import Optimizer
from distkeras_tpu_torch.utils.serialization import (keras_numpy_from_module,
                                                     module_from_keras_numpy)


def easgd_sync(alpha: float):
    """The elastic rule with coefficient ``alpha``."""
    def sync(tv, center, reduce):
        diff = [x - c for x, c in zip(tv, center)]
        new_tv = [x - alpha * d for x, d in zip(tv, diff)]
        new_center = [c + alpha * reduce(d) for c, d in zip(center, diff)]
        return new_tv, new_center
    return sync


def downpour_sync(n: int):
    """Commit the mean delta of ``n`` replicas and pull the center."""
    def sync(tv, center, reduce):
        new_center = [c + reduce(x - c) / n for c, x in zip(center, tv)]
        return new_center, new_center
    return sync


def averaging_sync(n: int):
    """The mean of ``n`` replicas becomes the center and every replica."""
    def sync(tv, center, reduce):
        mean = [reduce(x) / n for x in tv]
        return mean, mean
    return sync


def no_sync(tv, center, reduce):
    return tv, center


def local_sum(t):
    """``reduce`` of one replica: the sum over one replica is itself."""
    return t


class ReplicaTrainer(DistributedTrainer):
    """Shared machinery: a replica's state, rounds of local steps, and
    the subclass's sync rule (``make_sync``) at the end of each round.

    One round consumes ``[n_replicas, window, batch, ...]`` rows of the
    stream (``_round_stream``, the reference's layout), this replica's
    ``[window, batch, ...]`` of them.  ``device_data=True`` stages the
    replica's rows on the device once and feeds index blocks.
    """

    _supports_device_data = True

    def __init__(self, keras_model, loss="categorical_crossentropy", **kw):
        if kw.pop("fsdp", False):
            raise ValueError(
                f"{type(self).__name__} cannot use FSDP: each replica "
                "holds intentionally divergent full weights (that is the "
                "algorithm), so there is no single parameter set to "
                "scatter. Use ADAG/DynSGD with fsdp=True for "
                "memory-sharded data parallelism.")
        plan = kw.get("plan")
        if kw.pop("zero1", False) or kw.pop("zero", 0) or (
                plan is not None and getattr(plan, "zero", 0)):
            raise ValueError(
                f"{type(self).__name__} cannot use zero1/zero=: each "
                "replica runs its own full optimizer on intentionally "
                "divergent weights (that is the algorithm), so there is "
                "no single update to shard. Use ADAG/DynSGD with zero= "
                "for the sharded stages.")
        super().__init__(keras_model, loss=loss, **kw)
        self.sync_fn = self.make_sync()

    def make_sync(self):
        return no_sync

    # ------------------------------------------------------------ state

    def _replica_state(self):
        return self.adapter.init_state()

    def _eval_state_view(self, pytree):
        """Mid-fit: the center variable (the algorithm's product), with
        replica 0's non-trainable state (BatchNorm statistics: every
        replica keeps its own)."""
        if isinstance(pytree, dict):
            return pytree["center_tv"], self._replica0(pytree["state"].ntv)
        return super()._eval_state_view(pytree)

    def _replica0(self, ntv) -> list:
        """Replica 0's copy of ``ntv`` on every rank (a collective in a
        process group)."""
        if self.mesh.group is None:
            return list(ntv)
        return [all_gather(t.detach().reshape(-1), self.mesh)[0]
                .reshape(t.shape) for t in ntv]

    # ------------------------------------------------------------ fit

    def _round_stream(self, dataset: Dataset, window: int):
        """Yield this replica's ``[window, B, ...]`` per round: of the
        reference's round ``[n, window, B, ...]``, slab ``rank``."""
        n, rank = self.num_workers, self.mesh.rank
        for _ in range(self.num_epoch):
            for xs, ys in dataset.batches(
                    self.batch_size, features_col=self.features_col,
                    label_col=self.label_col, window=n * window):
                xs = xs.reshape((n, window) + xs.shape[1:])[rank]
                ys = ys.reshape((n, window) + ys.shape[1:])[rank]
                yield (torch.as_tensor(xs, device=self.device),
                       torch.as_tensor(ys, device=self.device))

    def _index_rounds(self, dataset: Dataset, window: int):
        """Device-resident analogue of :meth:`_round_stream`: this
        replica's stream staged once (rounds ``[rounds, n, w*B]``, slab
        ``rank``), then one ``[window, B]`` index block per round (the
        same rows, in order)."""
        n, rank = self.num_workers, self.mesh.rank
        wb = window * self.batch_size
        rounds = len(dataset) // (n * wb)

        def stage(col):
            a = np.asarray(col[:rounds * n * wb])
            a = a.reshape((rounds, n, wb) + a.shape[1:])[:, rank]
            return torch.as_tensor(np.ascontiguousarray(
                a.reshape((rounds * wb,) + a.shape[2:])), device=self.device)

        X, Y = stage(dataset[self.features_col]), stage(
            dataset[self.label_col])
        for _ in range(self.num_epoch):
            for r in range(rounds):
                idx = torch.arange(r * wb, (r + 1) * wb, device=self.device
                                   ).reshape(window, self.batch_size)
                yield _gather(X, idx), _gather(Y, idx)

    def _reduce(self):
        """The rules' ``reduce``: the sum over the group's replicas."""
        if self.mesh.group is None:
            return local_sum
        return lambda t: all_reduce(t.contiguous().clone(), self.mesh)

    def _window(self, dataset: Dataset) -> int:
        return self.communication_window

    def _round_tree(self, state, center) -> dict:
        """``{"stacked": every replica's state, "center_tv"}`` (a
        collective in a process group)."""
        return {"stacked": stack_tree(self._state_tree(state), self.mesh),
                "center_tv": list(center)}

    def _publish_tree(self, tree_fn):
        """Live weight push: the center variable (the algorithm's
        product) and replica 0's ``ntv``, as the reference publishes."""
        tree = tree_fn()
        return {"tv": tree["center_tv"],
                "ntv": [a[0] for a in tree["stacked"]["ntv"]]}

    def _fit(self, dataset: Dataset):
        window = self._window(dataset)
        state = self._replica_state()
        center = self.adapter.initial_tv()
        tree, start = self._restore_or()
        if start:
            self._load_state(state, unstack_tree(tree["stacked"],
                                                 self.mesh.rank))
            copy_leaves(center, tree["center_tv"])
        train_step = self.adapter.make_train_step()
        n, reduce = self.num_workers, self._reduce()
        rounds = (self._index_rounds(dataset, window) if self.device_data
                  else self._round_stream(dataset, window))
        losses, rnd = [], 0
        for rnd, (xs, ys) in enumerate(rounds, 1):
            if rnd <= start:
                continue
            with self.step_timer.phase("step"):
                local = []
                for i in range(window):
                    state, loss = train_step(state, xs[i], ys[i])
                    local.append(loss)
                new_tv, center = self.sync_fn(state.tv, center, reduce)
                with torch.no_grad():
                    for p, v in zip(state.tv, new_tv):
                        p.copy_(v)
                losses.append(torch.stack(local).mean())
            self._checkpoint(lambda: self._round_tree(state, center), rnd)
            self._eval_hook({"state": state, "center_tv": center}, rnd)
        if losses or not start:  # resumed past the end skips to export
            self._require_steps(losses, self.batch_size * n * window,
                                len(dataset))
            self._record(losses)
            self._checkpoint(lambda: self._round_tree(state, center), rnd,
                             final=True)
        self._final_states = [state]  # kept for the ensemble's export
        # Export the center variable, with replica 0's non-trainable
        # state.
        return state.replace(tv=center, ntv=self._replica0(state.ntv))


class AEASGD(ReplicaTrainer):
    """Asynchronous Elastic Averaging SGD, synchronous-elastic form.

    Reference parity: distkeras/trainers.py::AEASGD (rho,
    communication_window, learning_rate); the elastic coefficient is
    ``alpha = rho * learning_rate``.
    """

    def __init__(self, keras_model, communication_window: int = 32,
                 rho: float = 5.0, learning_rate: float = 0.01, **kw):
        if callable(learning_rate):
            raise ValueError(
                "AEASGD/EAMSGD need a scalar learning_rate: the elastic "
                "coefficient alpha = rho * learning_rate is part of the "
                "algorithm's fixed-point math (reference elastic force), "
                "not just an optimizer step size, so a schedule has no "
                "single value to derive it from. Use a scalar here, or "
                "ADAG/DOWNPOUR/SingleTrainer for a scheduled rate.")
        self.rho = rho
        self._learning_rate = learning_rate
        super().__init__(keras_model, learning_rate=learning_rate, **kw)
        self.communication_window = communication_window

    def make_sync(self):
        alpha = self.rho * self._learning_rate
        n = self.num_workers
        if alpha * n >= 1.0:
            # Keep the center update contractive.
            clamped = 0.9 / n
            warnings.warn(
                f"AEASGD elastic coefficient rho*learning_rate = {alpha:g} "
                f"violates the synchronous stability bound "
                f"rho*learning_rate*num_workers < 1 (num_workers={n}); "
                f"clamping to {clamped:g}. Lower rho or learning_rate to "
                "run the requested coefficient (see docs/algorithms.md).",
                stacklevel=4)
            alpha = clamped
        self.alpha = alpha
        return easgd_sync(alpha)


class EAMSGD(AEASGD):
    """Elastic Averaging Momentum SGD: AEASGD with Nesterov momentum on
    the local steps (reference parity: distkeras/trainers.py::EAMSGD)."""

    def __init__(self, keras_model, communication_window: int = 32,
                 rho: float = 5.0, learning_rate: float = 0.01,
                 momentum: float = 0.9, **kw):
        kw.setdefault("worker_optimizer",
                      Optimizer("sgd", learning_rate, momentum=momentum,
                                nesterov=True))
        super().__init__(keras_model,
                         communication_window=communication_window,
                         rho=rho, learning_rate=learning_rate, **kw)
        self.momentum = momentum


class DOWNPOUR(ReplicaTrainer):
    """DOWNPOUR SGD, synchronous form (reference parity:
    distkeras/trainers.py::DOWNPOUR): replicas commit their mean delta
    every ``communication_window`` steps and restart from the new
    center; each keeps its optimizer state (adagrad by default)."""

    def __init__(self, keras_model, communication_window: int = 5, **kw):
        kw.setdefault("worker_optimizer", "adagrad")
        super().__init__(keras_model, **kw)
        self.communication_window = communication_window

    def make_sync(self):
        return downpour_sync(self.num_workers)


class AveragingTrainer(ReplicaTrainer):
    """Model averaging once per epoch (reference parity:
    distkeras/trainers.py::AveragingTrainer)."""

    def make_sync(self):
        return averaging_sync(self.num_workers)

    def _window(self, dataset: Dataset) -> int:
        # One sync per epoch: window = batches each replica owns per epoch.
        w = len(dataset) // (self.batch_size * self.num_workers)
        if w < 1:
            raise ValueError("dataset too small for one batch per replica")
        return w


class EnsembleTrainer(ReplicaTrainer):
    """Train independent models; ``train()`` returns a list of them
    (reference parity: distkeras/trainers.py::EnsembleTrainer).  Member
    ``i`` starts from ``_reinit_weights`` with seed ``seed + i``, drawn
    on Keras-layout arrays, so members equal the reference's."""

    def __init__(self, keras_model, num_models: int | None = None, **kw):
        window = kw.pop("communication_window", 8)
        if kw.get("eval_every"):
            raise ValueError(
                "EnsembleTrainer has no single model to evaluate "
                "mid-training (its members are intentionally "
                "independent); evaluate the returned models with "
                "ModelPredictor + AccuracyEvaluator instead")
        if num_models is not None:
            kw.setdefault("num_workers", num_models)
        super().__init__(keras_model, **kw)
        self.num_models = self.num_workers
        self.communication_window = window

    def train(self, dataset, features_col=None, label_col=None,
              eval_dataset=None):
        if eval_dataset is not None:
            raise ValueError(
                "EnsembleTrainer returns k independent models; evaluate "
                "them individually (ModelPredictor + AccuracyEvaluator) "
                "rather than through eval_dataset")
        return super().train(dataset, features_col=features_col,
                             label_col=label_col)

    def _replica_state(self):
        member = self.mesh.rank  # this rank trains member `rank`
        model = self.adapter.model
        tv, ntv = keras_numpy_from_module(model)
        seed = None if self.seed is None else self.seed + member
        module_from_keras_numpy(model, _reinit_weights(tv, seed), ntv)
        try:
            return self.adapter.init_state()
        finally:
            module_from_keras_numpy(model, tv, ntv)

    def _export(self, state) -> list:
        """Every member on every rank: each member's weights gathered
        from the rank that trained it."""
        mine = self._final_states[0]
        if self.mesh.group is None:
            return [self.adapter.export_model(mine)]
        def member(leaves):
            stacked = [all_gather(t.detach().reshape(-1), self.mesh)
                       for t in leaves]
            return lambda i: [s[i].reshape(t.shape)
                              for s, t in zip(stacked, leaves)]

        tv, ntv = member(mine.tv), member(mine.ntv)
        return [self.adapter.export_model(mine.replace(tv=tv(i), ntv=ntv(i)))
                for i in range(self.num_workers)]


def _reinit_weights(weights, seed=None):
    """Fresh glorot-ish reinitialization for matrices (Keras layout: the
    last two axes are fan-in and fan-out); 1-D weights keep their
    original values."""
    rng = np.random.default_rng(seed)
    out = []
    for w in weights:
        if w.ndim >= 2:
            fan_in, fan_out = w.shape[-2], w.shape[-1]
            limit = np.sqrt(6.0 / (fan_in + fan_out))
            out.append(rng.uniform(-limit, limit, w.shape).astype(w.dtype))
        else:
            out.append(np.array(w, copy=True))
    return out

"""Synchronous data-parallel trainers: ADAG and DynSGD.

Counterpart of ``distkeras_tpu/trainers/distributed.py`` (reference
parity: distkeras/trainers.py::ADAG / DynSGD).  ``communication_window``
is the gradient-accumulation depth of one global step: each round takes
``window`` microbatches of ``batch_size * num_workers`` rows, sums their
gradients and applies one optimizer update on the mean.  DynSGD's
staleness-scaled rate is ``lr / (tau + 1)`` with ``tau == 0`` under
synchronous execution, so it is ADAG (kept for API parity).

One process trains one replica: ``num_workers`` is the world size of the
``torch.distributed`` group (1 with no group), and every rank reads the
same stream and takes its ``batch_size`` rows of each microbatch — rank
``r`` rows ``[r * batch_size, (r + 1) * batch_size)``, where
``P("data")`` places them in the reference.  Each rank's gradient is the
mean over its rows; the exchange makes it the global mean (an all-reduce
per ~4 MB bucket), or the policy that ``zero=`` / ``merge_rule=`` /
``sync_every=`` / ``compress=`` name (``parallel/collectives.py``,
``parallel/exchange.py``).  The losses in ``history`` are the global
means, from one all-reduce at the end of the run.  ``fsdp=True``, a
mesh with a non-data axis and rule-driven plans are ROADMAP A7b.
"""

from __future__ import annotations

import numpy as np
import torch

from distkeras_tpu_torch import obs
from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.parallel.collectives import (DataParallel,
                                                      all_reduce,
                                                      gather_tree,
                                                      true_div,
                                                      zero1_enable,
                                                      zero_validate)
from distkeras_tpu_torch.parallel.exchange import (ExchangeConfig,
                                                   ExchangeOptimizer,
                                                   residual_norm_of)
from distkeras_tpu_torch.parallel.mesh import check_axes, global_batch, \
    make_mesh
from distkeras_tpu_torch.parallel.sharding import (ExchangePlan,
                                                   ShardingPlan, Zero1Plan,
                                                   dp_plan, zero1_plan,
                                                   zero3_plan)
from distkeras_tpu_torch.trainers.base import (Trainer,
                                               normalize_zero_args)
from distkeras_tpu_torch.trainers.carry import copy_leaves, load_opt_tree

_A7B = "(ROADMAP A7b: rule-driven parameter sharding, tensor parallelism)"


class DistributedTrainer(Trainer):
    """Base of the data-parallel trainers: ``num_workers`` replicas, one
    per process of the group (``mesh=`` a :class:`~distkeras_tpu_torch.
    parallel.mesh.Mesh`; default the initialized group's).

    ``zero=1|2|3`` (aliases ``zero1=True``, ``plan=zero1_plan()`` /
    ``zero3_plan()``) shards the update, then the gradient accumulator,
    then the parameters (``[cols]`` chunks of ~``zero_bucket_mb``
    buckets).  ADAG/DynSGD also take the exchange policies
    ``merge_rule="adasum"``, ``sync_every=H`` and ``compress="int8" |
    "topk"`` (``topk_frac``; int8 composes with ``zero=1``), with the
    reference's compositions and refusals, and ``probe_metrics=True``
    (the global gradient norm per step in ``probe_history``).
    ``device_data=True`` (where ``_supports_device_data``) stages this
    rank's rows on its device once and feeds index blocks.
    """

    _supports_device_data = False
    _supports_exchange = False

    def __init__(self, keras_model, loss="categorical_crossentropy",
                 worker_optimizer="sgd", learning_rate=None,
                 batch_size: int = 32, num_epoch: int = 1,
                 num_workers: int | None = None, mesh=None,
                 plan: ShardingPlan | None = None, fsdp: bool = False,
                 zero: int | None = None, zero1: bool = False,
                 zero1_bucket_mb: float | None = None,
                 zero_bucket_mb: float | None = None,
                 device_data: bool = False, merge_rule: str = "mean",
                 sync_every: int = 1, compress=None,
                 topk_frac: float = 0.01, probe_metrics: bool = False,
                 **kw):
        super().__init__(keras_model, loss=loss,
                         worker_optimizer=worker_optimizer,
                         learning_rate=learning_rate, batch_size=batch_size,
                         num_epoch=num_epoch, **kw)
        zero, zero1, zero_bucket_mb = normalize_zero_args(
            zero, zero1, zero_bucket_mb, zero1_bucket_mb)
        if fsdp:
            raise NotImplementedError(
                f"{type(self).__name__}(fsdp=True) is not ported yet {_A7B};"
                " zero=3 shards the parameters over the data axis")
        if plan is not None and not isinstance(plan, ShardingPlan):
            raise NotImplementedError(
                f"plan={plan!r} is not ported yet {_A7B}; the port takes "
                "dp_plan() / zero1_plan() / zero3_plan()")
        if device_data and not self._supports_device_data:
            raise ValueError(
                f"device_data=True is not supported by "
                f"{type(self).__name__}; it is implemented for "
                "ADAG/DynSGD, the replica family (AEASGD/EAMSGD/"
                "DOWNPOUR/Averaging/Ensemble), SingleTrainer, and "
                "LMTrainer")
        self.device_data = device_data
        exchange = ExchangeConfig(
            merge_rule=merge_rule, sync_every=sync_every,
            compress=compress, topk_frac=topk_frac,
            **({} if zero_bucket_mb is None
               else {"bucket_mb": zero_bucket_mb}))
        self.exchange = exchange
        self.probe_metrics = probe_metrics
        self.probe_history: list[dict] = []
        self.residual_norm = None
        if (not exchange.is_default or probe_metrics) \
                and not self._supports_exchange:
            raise ValueError(
                f"{type(self).__name__} does not support the gradient-"
                "exchange options (merge_rule/sync_every/compress/"
                "probe_metrics); they are implemented for ADAG/DynSGD "
                "(and LMTrainer) — the replica family already has its "
                "own communication cadence")
        if not exchange.is_default:
            if device_data:
                raise ValueError(
                    "merge_rule/sync_every/compress do not compose with "
                    "device_data=True: the exchange layer computes "
                    "per-replica gradients in a shard_map the indexed "
                    "data plane does not route through")
            if plan is not None:
                raise ValueError(
                    "merge_rule/sync_every/compress build their own "
                    "placement plan; they do not compose with fsdp=True "
                    "or an explicit plan=")
            if self.adapter.ntv_paths:
                raise ValueError(
                    "gradient-exchange options need a model without "
                    "non-trainable training state (BatchNorm running "
                    "stats, seeded Dropout): per-replica local updates "
                    "would diverge it — train such models with the "
                    "default synchronous exchange")
            if zero and not (zero == 1 and exchange.compress == "int8"
                             and exchange.sync_every == 1):
                raise ValueError(
                    "the ZeRO stages compose with zero=1 + "
                    "compress='int8' only (the chunked codec compresses "
                    "the reduce-scatter leg); adasum, local-SGD, codec "
                    "rules and stages 2/3 replace the exchange the "
                    "sharded update rides")
        if probe_metrics and exchange.sync_every > 1:
            raise ValueError(
                "probe_metrics with sync_every > 1 is not supported: "
                "the local-SGD period has no single per-step global "
                "gradient to probe")
        if probe_metrics and device_data:
            raise ValueError(
                "probe_metrics does not compose with device_data=True "
                "(the indexed data plane's scanned step has no probe "
                "output slot)")
        if zero and plan is not None:
            raise ValueError(
                "pass only one of plan=, fsdp=True, zero=/zero1=True — "
                "they are alternative placement policies for the same "
                "state")
        if zero_bucket_mb is not None and not zero:
            raise ValueError(
                "zero_bucket_mb/zero1_bucket_mb only apply with a ZeRO "
                "stage (the plan=zero1_plan(...)/zero3_plan(...) "
                "spellings carry their own bucket_mb)")
        if not exchange.is_default:
            self.plan = ExchangePlan(exchange, zero1=zero1)
        else:
            self.plan = plan or (zero1_plan(zero_bucket_mb) if zero == 1
                                 else Zero1Plan(zero_bucket_mb) if zero == 2
                                 else zero3_plan(zero_bucket_mb)
                                 if zero == 3 else dp_plan())
            if not zero and self.plan.zero:
                zero = int(self.plan.zero)
                zero1 = zero == 1
        self.mesh = mesh if mesh is not None else make_mesh()
        check_axes(self.mesh.shape)
        world = self.mesh.size
        n = num_workers or world
        if n > world:
            raise ValueError(
                f"num_workers={n} exceeds visible devices ({world}, the "
                "world size of the process group); oversubscription is "
                "not supported — start one process per device "
                "(deploy.Job)")
        if n < world:
            raise ValueError(
                f"num_workers={n} but the process group has {world} "
                "ranks: each rank trains one replica, so num_workers is "
                "the world size")
        self.num_workers = n
        if self.mesh.backend == "nccl" and self.device.type != "cuda":
            raise ValueError(
                f"the process group runs NCCL but the trainer's device is "
                f"{self.device}; CPU ranks join with gloo (device='cpu')")
        if n > 1 and self.adapter.ntv_paths:
            raise ValueError(
                f"num_workers={n} with non-trainable state (BatchNorm "
                "running stats): each rank would normalize over its own "
                "rows — a synchronized batch norm is not ported yet "
                "(ROADMAP A6)")
        self.zero = zero
        self.zero1 = zero1
        self._zero_bucket_mb = getattr(self.plan, "bucket_mb", None)
        inner = self.adapter.optimizer
        perms = self.adapter.ref_perms()
        if zero == 1 and exchange.compress == "int8":
            zero_validate(self.mesh, worker_optimizer, stage=zero)
            self.adapter.optimizer = ExchangeOptimizer(
                inner, self.mesh, exchange, zero1=True,
                names=self.adapter.tv_paths, perms=perms)
        elif zero:
            self.adapter.optimizer = zero1_enable(
                inner, self.mesh, spec=worker_optimizer,
                bucket_mb=self._zero_bucket_mb, stage=zero, perms=perms)
        elif exchange.needs_grad_exchange:
            self.adapter.optimizer = ExchangeOptimizer(
                inner, self.mesh, exchange, names=self.adapter.tv_paths,
                perms=perms)
        elif (self._supports_exchange and exchange.sync_every == 1
              and self.mesh.group is not None):
            # The replica family exchanges parameters in its own rules.
            self.adapter.optimizer = DataParallel(inner, self.mesh)

    # ------------------------------------------------------------ helpers

    def _init_state(self):
        """A fresh state; under stage 3 ``tv`` is this rank's shards."""
        state = self.adapter.init_state()
        if self.zero >= 3:
            state.tv = state.opt_state.shards
        return state

    def _full_tv(self, state) -> list:
        if self.zero >= 3:
            zs = state.opt_state
            return gather_tree(zs.layout, zs.shards, self.mesh)
        return state.tv

    def _state_tree(self, state) -> dict:
        """The checkpoint tree with ``tv`` whole (under stage 3 the
        shards gathered) and the optimizer state gathered."""
        tree = super()._state_tree(state)
        if state.opt_state is not None:  # (AsyncDP's final center: whole)
            tree["tv"] = list(self._full_tv(state))
        return tree

    def _load_state(self, state, tree) -> None:
        """Load a checkpoint tree: ``tv`` whole, each rank's ZeRO shards
        (of the parameters under stage 3, of the optimizer state under
        every stage) cut back out of it by this rank's layout."""
        full = {str(i): t for i, t in enumerate(tree["tv"])}
        if self.zero < 3:
            copy_leaves(state.tv, tree["tv"])
        copy_leaves(state.ntv, tree["ntv"])
        load_opt_tree(state.opt_state, state.tv, tree["opt"], self.mesh,
                      full_params=full)
        state.step = tree["step"]

    def _eval_state_view(self, pytree):
        if self.zero >= 3 and not isinstance(pytree, dict):
            return self._full_tv(pytree), pytree.ntv
        return super()._eval_state_view(pytree)

    def _export(self, state):
        if self.zero >= 3:
            state = state.replace(tv=self._full_tv(state))
        return super()._export(state)

    def _rank_rows(self, arr, axis: int):
        """This rank's rows of a stream block (split in order along the
        batch ``axis``)."""
        return global_batch(arr, self.mesh, axis)

    def _record(self, losses) -> None:
        """The global mean losses: this rank's, averaged over the group
        in one all-reduce at the end of the run."""
        if losses and self.mesh.group is not None:
            flat = torch.cat([torch.as_tensor(l).reshape(-1).float()
                              for l in losses])
            flat = true_div(all_reduce(flat, self.mesh), self.mesh.size)
            losses = [flat]
        super()._record(losses)


class ADAG(DistributedTrainer):
    """Asynchronous Distributed Adaptive Gradients, synchronously.

    Reference parity: distkeras/trainers.py::ADAG.
    ``communication_window`` is the accumulation depth per global step.
    """

    _supports_device_data = True
    _supports_exchange = True

    def __init__(self, keras_model, communication_window: int = 12, **kw):
        super().__init__(keras_model, **kw)
        self.communication_window = communication_window

    def _accum_step_fn(self):
        """The round step of this configuration: local SGD, the ZeRO
        stage-2/3 step, or the accumulation step (whose optimizer
        carries the exchange)."""
        ex, w = self.exchange, self.communication_window
        if ex.sync_every > 1:
            return self.adapter.make_localsgd_accum_step(
                w, ex.sync_every, self.mesh, ex)
        if self.zero >= 2:
            return self.adapter.make_zero_accum_step(
                w, self.mesh, self.adapter.optimizer, stage=self.zero,
                probe=self.probe_metrics)
        return self.adapter.make_accum_train_step(w, probe=self.probe_metrics)

    def _fit(self, dataset: Dataset):
        if self.device_data:
            return self._fit_device_data(dataset)
        w = self.communication_window
        H = self.exchange.sync_every
        feed_bs = self.batch_size * self.num_workers
        state = self._init_state()
        step = self._accum_step_fn()

        def stream():
            for _ in range(self.num_epoch):
                for xs, ys in dataset.batches(
                        feed_bs, features_col=self.features_col,
                        label_col=self.label_col, window=w * H):
                    axis = 1
                    if H > 1:
                        # [H*w, feed, ...] -> [H, w, feed, ...]: the first
                        # w microbatches are local round 1.
                        xs = xs.reshape((H, w) + xs.shape[1:])
                        ys = ys.reshape((H, w) + ys.shape[1:])
                        axis = 2
                    with self.step_timer.phase("h2d"):
                        args = (torch.as_tensor(self._rank_rows(xs, axis),
                                                device=self.device),
                                torch.as_tensor(self._rank_rows(ys, axis),
                                                device=self.device))
                    yield args

        return self._run_rounds(state, step, stream(), feed_bs * w * H,
                                dataset)

    def _fit_device_data(self, dataset: Dataset):
        """This rank's rows staged on its device once, in consumption
        order (the reference's multi-process data plane, one device per
        process: round ``c`` microbatch ``k`` of rank ``r`` is global row
        ``(c w + k) n b + r b + j``); each round then makes only a
        ``[window, batch]`` index block there.  The same rows, in the
        same order, as the streaming path."""
        w, bs, n = self.communication_window, self.batch_size, \
            self.num_workers
        feed_bs = bs * n
        usable = len(dataset) - len(dataset) % (feed_bs * w)
        if usable == 0:
            raise ValueError(
                f"dataset has {len(dataset)} rows but one training step "
                f"needs {feed_bs * w} (batch_size x num_workers x window);"
                " reduce batch_size/communication_window/num_workers or "
                "provide more data")
        chunks = usable // feed_bs
        rank = self.mesh.rank

        def stage(col):
            a = np.asarray(col[:usable])
            a = a.reshape((chunks, n, bs) + a.shape[1:])[:, rank]
            return torch.as_tensor(np.ascontiguousarray(
                a.reshape((chunks * bs,) + a.shape[2:])), device=self.device)

        X, Y = stage(dataset[self.features_col]), stage(
            dataset[self.label_col])
        state = self._init_state()
        accum = self._accum_step_fn() if self.zero >= 2 else None
        step = self.adapter.make_indexed_accum_train_step(w, accum=accum)

        def index_blocks():
            for _ in range(self.num_epoch):
                for r in range(chunks // w):
                    with self.step_timer.phase("h2d"):
                        idx = torch.arange(r * w * bs, (r + 1) * w * bs,
                                           device=self.device
                                           ).reshape(w, bs)
                    yield X, Y, idx

        return self._run_rounds(state, step, index_blocks(), feed_bs * w,
                                dataset)

    def _run_rounds(self, state, step, rounds, rows_per_round, dataset):
        """The one round loop of both data paths: resume skipping,
        losses, probes, checkpoints and the eval hook."""
        losses, probes, rnd = [], [], 0
        tree, start = self._restore_or()
        if start:
            self._load_state(state, tree)
        for rnd, args in enumerate(rounds, 1):
            if rnd <= start:
                continue
            with self.step_timer.phase("step"):
                state, out = step(state, *args)
            if self.probe_metrics:
                loss, aux = out
                probes.append(aux)
            else:
                loss = out
            losses.append(loss)
            self._checkpoint(lambda: self._state_tree(state), rnd)
            self._eval_hook(state, rnd)
        if start and not losses:  # resumed past the end
            return state
        self._require_steps(losses, rows_per_round, len(dataset))
        self._record(losses)
        if probes:  # one device-to-host copy, at the end of the run
            self.probe_history = [{k: float(v) for k, v in p.items()}
                                  for p in probes]
        if self.exchange.compress is not None:
            # The error-feedback diagnostic, under the reference's name.
            self.residual_norm = residual_norm_of(state.opt_state)
            obs.gauge("exchange.residual_norm", self.residual_norm)
        self._checkpoint(lambda: self._state_tree(state), rnd, final=True)
        return state


class DynSGD(ADAG):
    """Dynamic SGD.  Reference parity: distkeras/trainers.py::DynSGD —
    ``lr / (tau + 1)`` with staleness ``tau == 0`` synchronously, so
    DynSGD == ADAG; a distinct class for API parity."""

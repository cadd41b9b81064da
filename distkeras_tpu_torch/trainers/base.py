"""Trainer base + SingleTrainer of the Keras family, on one device.

Counterpart of ``distkeras_tpu/trainers/base.py`` (reference parity:
distkeras/trainers.py): construct with a model (an ``nn.Module`` of
``models.zoo``), a loss, an optimizer and knobs; ``train(dataset)``
returns a new module with the learned weights; ``training_time`` is the
run's wall clock, ``history`` the per-step losses and ``eval_history``
the ``eval_every`` hook's ``(round, {"loss", metric...})`` records
(round -1: the end of training).  The data order is the reference's bit
for bit (``Dataset.shuffle(seed)``, the same batch streams).

Runs on the card unless ``device="cpu"``.  Every trainer checkpoints
and resumes through :class:`CheckpointingBase` (``checkpoint_dir`` /
``checkpoint_every`` / ``max_checkpoints`` / ``resume`` /
``checkpoint_backend``, the reference's knobs and refusals); a resumed
run replays the uninterrupted one bit for bit.  The data-parallel
trainers (``trainers/distributed.py``, ``trainers/elastic.py``) run one
replica per process of a ``torch.distributed`` group.
"""

from __future__ import annotations

import time
import warnings

import torch
import torch.distributed as dist

from distkeras_tpu_torch import obs
from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.models.adapter import ModelAdapter, TrainState
from distkeras_tpu_torch.resilience import chaos
from distkeras_tpu_torch.resilience.chaos import Preempted
from distkeras_tpu_torch.trainers.carry import (copy_leaves, load_opt_tree,
                                                opt_tree)
from distkeras_tpu_torch.utils.profiling import StepTimer, synchronize


def normalize_zero_args(zero, zero1: bool, zero_bucket_mb,
                        zero1_bucket_mb):
    """Reconcile the ``zero=`` stage knob with its deprecated aliases
    (one definition for ``DistributedTrainer`` and ``LMTrainer``, as in
    the reference).  Returns ``(zero, zero1, zero_bucket_mb)`` with
    ``zero1 == (zero == 1)``."""
    if zero is None:
        zero = 1 if zero1 else 0
    elif zero1 and zero != 1:
        raise ValueError(
            f"zero1=True is the deprecated alias of zero=1 and "
            f"cannot combine with zero={zero}; pass zero= alone")
    if zero not in (0, 1, 2, 3):
        raise ValueError(
            f"zero must be 0 (off), 1, 2 or 3, got {zero!r}")
    if zero_bucket_mb is not None and zero1_bucket_mb is not None:
        raise ValueError(
            "pass only one of zero_bucket_mb / zero1_bucket_mb "
            "(the latter is the deprecated alias)")
    if zero_bucket_mb is None:
        zero_bucket_mb = zero1_bucket_mb
    return zero, zero == 1, zero_bucket_mb


class CheckpointingBase:
    """Checkpoint / resume plumbing shared across the whole trainer
    family (``distkeras_tpu/trainers/base.py::CheckpointingBase``): the
    Keras trainers and ``LMTrainer`` take the same ``checkpoint_dir`` /
    ``checkpoint_every`` / ``max_checkpoints`` / ``resume`` contract.

    A round's state reaches :meth:`_checkpoint` as a function building
    its tree, called only when a save is due: ``tree_fn()`` the gathered
    tree (in a process group a collective every rank runs),
    ``tree_fn(local=True)`` the local-shard tree of the sharded backend
    (``trainers/carry.py``: this rank's pieces, nothing gathered).  It
    comes back from :meth:`_restore_or` as a tree of CPU tensors, or of
    lazily read leaves from a sharded step, which the trainer loads into
    its live state.
    """

    def _setup_checkpointing(self, *, checkpoint_dir: str | None,
                             checkpoint_every: int, max_checkpoints: int,
                             resume: bool, shuffle: bool,
                             seed: int | None,
                             backend: str = "auto") -> None:
        self.checkpoint_every = checkpoint_every
        self.resume = resume
        self.checkpoint_dir = checkpoint_dir
        self.max_checkpoints = max_checkpoints
        self.checkpoint_backend = backend
        # Set by a resilience.Supervisor (or any orchestrator): when
        # this Event is set, the next round boundary forces a final
        # synchronous checkpoint and raises Preempted — the graceful
        # half of a preemption.
        self.preempt_event = None
        self._ckpt = None
        self._last_saved_round = 0
        if resume and shuffle and seed is None:
            raise ValueError(
                "resume=True with shuffle=True needs a fixed seed: resume "
                "skips the first N rounds of the stream, which only lands on "
                "the right data if the permutation is reproducible")
        if (resume or checkpoint_every) and not checkpoint_dir:
            raise ValueError(
                "resume/checkpoint_every need a checkpoint_dir — without one "
                "nothing is restored or written")

    def _open_checkpoints(self) -> None:
        """Open the per-run checkpoint manager (closed by
        :meth:`_close_checkpoints`); fail fast on a populated directory
        unless resuming."""
        self._last_saved_round = 0
        if not self.checkpoint_dir:
            return
        from distkeras_tpu_torch.checkpoint import CheckpointManager

        self._ckpt = CheckpointManager(
            self.checkpoint_dir, max_to_keep=self.max_checkpoints,
            backend=self.checkpoint_backend)
        if not self.resume and self._ckpt.latest_step() is not None:
            self._ckpt.close()
            self._ckpt = None
            raise ValueError(
                f"checkpoint_dir {self.checkpoint_dir!r} already holds "
                "checkpoints; pass resume=True to continue from them or "
                "point at a fresh directory (a committed step is never "
                "overwritten)")

    def _close_checkpoints(self) -> None:
        if self._ckpt is not None:
            self._ckpt.close()
            self._ckpt = None

    def _restore_or(self):
        """``(tree, start_round)``: the latest valid checkpoint's tree
        when resuming; ``(None, 0)`` otherwise.

        Resume semantics: deterministic data order; the first
        ``start_round`` rounds of the batch stream are skipped so the
        restored state continues exactly where the checkpoint left off.
        In a process group every rank selects the same step (a barrier
        before the directory is read and one before rank 0 trims it).
        """
        if not (self._ckpt and self.resume):
            return None, 0
        from distkeras_tpu_torch.checkpoint import group_rank

        rank, world = group_rank()
        group = world > 1
        if group:
            dist.barrier()
        step = self._ckpt.latest_step()
        valid = self._ckpt.latest_valid_step()
        if group:
            dist.barrier()
        if step is None:
            return None, 0
        if valid != step:
            # Torn latest (died mid-save on a store without atomic
            # rename): resume from the newest step that passes the
            # integrity check, and drop the torn steps — the resumed
            # run passes their rounds again, and a committed step is
            # never overwritten.  One trimming rule, shared with the
            # cluster driver's pre-epoch trim.
            from distkeras_tpu_torch.resilience.cluster import (
                trim_to_consistent)

            warnings.warn(
                f"checkpoint step {step} under "
                f"{self.checkpoint_dir!r} is torn/partial; resuming "
                f"from the latest valid step {valid} instead",
                stacklevel=2)
            obs.event("checkpoint.torn", step=step, fallback=valid)
            if rank == 0:
                trim_to_consistent([self._ckpt.directory])
            if valid is None:
                return None, 0
            step = valid
        with obs.span("checkpoint.restore", step=step):
            # A sharded step's leaves are read as each rank loads its part.
            restored = self._ckpt.restore(step=step, lazy=True)
        return restored, step

    def attach_publisher(self, publisher, every: int = 1):
        """Wire a :class:`~distkeras_tpu_torch.serving.publish.
        SnapshotPublisher` into the round loop: every ``every`` rounds
        (and on the final round) the trainer publishes its current
        weights as snapshot version ``round_idx`` — the trainer side of
        the live train -> serve weight push.  Independent of
        checkpointing (a trainer without ``checkpoint_dir`` publishes
        too).  In a process group rank 0 writes.  Returns ``self``."""
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self._publisher = publisher
        self._publish_every = int(every)
        self._last_published = 0
        return self

    def _publish_tree(self, tree_fn):
        """The weights to publish, out of the round-loop state
        (``tree_fn()`` builds the checkpoint tree).  Subclasses override
        to publish their parameter leaves; the base publishes the tree
        as-is."""
        return tree_fn()

    def _maybe_publish(self, tree_fn, round_idx: int,
                       final: bool = False) -> None:
        pub = getattr(self, "_publisher", None)
        if pub is None or round_idx == self._last_published:
            return
        if final or round_idx % self._publish_every == 0:
            with obs.span("publish.snapshot", step=round_idx):
                # Every rank builds the tree (it may gather across the
                # group); rank 0 writes it.
                tree = self._publish_tree(tree_fn)
                if not (dist.is_available() and dist.is_initialized()
                        and dist.get_rank() != 0):
                    pub.publish(tree, round_idx)
            self._last_published = round_idx

    def _checkpoint(self, tree_fn, round_idx: int,
                    final: bool = False) -> None:
        """Persist training state after round ``round_idx`` (1-based), and
        publish the weights (:meth:`_publish_tree`) when a publisher is
        attached.

        ``tree_fn`` builds the tree to save (see the class docstring).
        The save is complete when this returns: the round loop updates
        the state in place next round.  Every
        call passes the ``"train.round"`` chaos probe; a set
        ``preempt_event`` forces a save of this round and raises
        :class:`Preempted`.
        """
        chaos.probe("train.round", step=round_idx)
        self._maybe_publish(tree_fn, round_idx, final)
        if self.preempt_event is not None and self.preempt_event.is_set():
            # Graceful preemption (SIGTERM via a Supervisor, or any
            # orchestrator flipping the event): persist THIS round's
            # state synchronously, then stop.  The resumed run replays
            # from here bit for bit — data order is round-indexed and
            # the dropout generator's state rides the checkpoint.
            if self._ckpt is not None and round_idx != self._last_saved_round:
                self._save(tree_fn, round_idx, preempt=True)
            obs.event("train.preempted", round=round_idx,
                      checkpointed=self._ckpt is not None)
            raise Preempted(
                f"preempted at round {round_idx}"
                + (" (state checkpointed)" if self._ckpt is not None
                   else " (no checkpoint_dir: round lost)"))
        if self._ckpt is None or round_idx == self._last_saved_round:
            return  # (final save right after a periodic one: already durable)
        periodic = self.checkpoint_every and round_idx % self.checkpoint_every == 0
        if final or periodic:
            self._save(tree_fn, round_idx)

    def _save(self, tree_fn, round_idx: int, preempt: bool = False) -> None:
        span = (obs.span("checkpoint.save", step=round_idx, preempt=True)
                if preempt else obs.span("checkpoint.save", step=round_idx))
        with span:
            local = self._ckpt.backend == "orbax"
            self._ckpt.save(tree_fn(local=local), round_idx, force=True)
            self._ckpt.wait_until_finished()
        self._last_saved_round = round_idx

    def _record_run_metrics(self) -> None:
        """End-of-run telemetry (the reference's names): loss and timing
        gauges from values the run already holds on the host — no
        device read of its own."""
        if obs.active() is None:
            return
        name = type(self).__name__
        obs.gauge("train.training_time_s", self.training_time,
                  trainer=name)
        hist = getattr(self, "history", None)
        if hist:
            obs.gauge("train.loss", hist[-1], trainer=name)
            obs.gauge("train.loss_mean", sum(hist) / len(hist),
                      trainer=name)
            obs.count("train.rounds", len(hist), trainer=name)
        timer = getattr(self, "step_timer", None)
        for phase, st in (timer.phase_stats().items() if timer else ()):
            obs.gauge("train.phase_total_s", st["total_s"],
                      trainer=name, phase=phase)


class Trainer(CheckpointingBase):
    """Base trainer: owns the adapter and the train() bookkeeping."""

    def __init__(self, keras_model, loss="categorical_crossentropy",
                 worker_optimizer="sgd", learning_rate=None,
                 batch_size: int = 32, num_epoch: int = 1,
                 features_col: str = "features", label_col: str = "label",
                 shuffle: bool = False, seed: int | None = None,
                 checkpoint_dir: str | None = None, checkpoint_every: int = 0,
                 max_checkpoints: int = 3, resume: bool = False,
                 checkpoint_backend: str = "auto",
                 preprocess=None, metrics=(), eval_every: int = 0,
                 device=None):
        self.adapter = ModelAdapter(
            keras_model, loss=loss, optimizer=worker_optimizer,
            learning_rate=learning_rate, preprocess=preprocess,
            metrics=metrics, device=device)
        self.device = self.adapter.device
        self.eval_every = eval_every
        self.eval_history: list[tuple[int, dict]] = []
        self._eval_batch = None
        self._eval_fn = None
        self.batch_size = batch_size
        self.num_epoch = num_epoch
        self.features_col = features_col
        self.label_col = label_col
        self.shuffle = shuffle
        self.seed = seed
        self.training_time: float = 0.0
        self.history: list[float] = []
        self.step_timer = StepTimer()
        self._setup_checkpointing(
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            max_checkpoints=max_checkpoints, resume=resume, shuffle=shuffle,
            seed=seed, backend=checkpoint_backend)

    # -- subclass hook -----------------------------------------------------
    def _fit(self, dataset: Dataset):  # pragma: no cover
        raise NotImplementedError

    def train(self, dataset: Dataset, features_col: str | None = None,
              label_col: str | None = None,
              eval_dataset: Dataset | None = None):
        """Train and return a new module with the learned weights.

        (EnsembleTrainer returns a list of modules.)  ``eval_dataset``
        feeds the ``eval_every`` hook; passing one without
        ``eval_every`` evaluates once, at the end.
        """
        if features_col:
            self.features_col = features_col
        if label_col:
            self.label_col = label_col
        if self.shuffle:
            dataset = dataset.shuffle(self.seed)
        self.eval_history = []
        self._eval_batch = None
        if eval_dataset is not None:
            if len(eval_dataset) == 0:
                raise ValueError("eval_dataset is empty")
            self._eval_batch = (eval_dataset[self.features_col],
                                eval_dataset[self.label_col])
            self._eval_fn = self.adapter.make_eval_fn()
        elif self.eval_every:
            raise ValueError(
                "eval_every is set but train() got no eval_dataset")
        self.step_timer.reset()
        t0 = time.perf_counter()
        self._open_checkpoints()
        try:
            with obs.span("train.run", trainer=type(self).__name__):
                state = self._fit(dataset)
                self._eval_hook(state, rnd=None, final=True)
                synchronize(state.tv)
        finally:
            self._close_checkpoints()
        self.training_time = time.perf_counter() - t0
        self._record_run_metrics()
        return self._export(state)

    # -- checkpoint trees --------------------------------------------------
    def _publish_tree(self, tree_fn):
        """Live weight push: the parameter leaves (``tv`` / ``ntv``)."""
        tree = tree_fn()
        return {"tv": tree["tv"], "ntv": tree["ntv"]}

    def _state_tree(self, state: TrainState, local: bool = False) -> dict:
        """The checkpoint tree of a TrainState (``tv`` full, the
        optimizer state gathered, or ``local``: its pieces; see
        ``trainers/carry.py``)."""
        return {"tv": list(state.tv), "ntv": list(state.ntv),
                "opt": opt_tree(state.opt_state, state.tv,
                                getattr(self, "mesh", None),
                                getattr(self, "layout", None), local),
                "step": state.step}

    def _load_state(self, state: TrainState, tree) -> None:
        """Load :meth:`_state_tree`'s tree into the fresh ``state``."""
        copy_leaves(state.tv, tree["tv"])
        copy_leaves(state.ntv, tree["ntv"])
        load_opt_tree(state.opt_state, state.tv, tree["opt"],
                      getattr(self, "mesh", None))
        state.step = tree["step"]

    # -- evaluation hook ---------------------------------------------------
    def _eval_state_view(self, pytree):
        """(tv, ntv) of the evaluable model inside a fit-loop state."""
        return pytree.tv, pytree.ntv

    def _eval_hook(self, pytree, rnd, final: bool = False) -> None:
        """Record eval metrics at round ``rnd``; the end-of-training
        call records round -1 (always runs when an eval set exists)."""
        if self._eval_batch is None:
            return
        if not final and not (self.eval_every and rnd % self.eval_every == 0):
            return
        tv, ntv = self._eval_state_view(pytree)
        x, y = self._eval_batch
        # Mini-batch the eval set at the training batch size, weighting
        # each chunk by its rows.
        sums, n = {}, 0
        bs = min(self.batch_size, len(x))
        for i in range(0, len(x), bs):
            xb, yb = x[i:i + bs], y[i:i + bs]
            part = self._eval_fn(tv, ntv,
                                 torch.as_tensor(xb, device=self.device),
                                 torch.as_tensor(yb, device=self.device))
            for k, v in part.items():
                sums[k] = sums.get(k, 0.0) + float(v) * len(xb)
            n += len(xb)
        self.eval_history.append((-1 if final else rnd,
                                  {k: v / n for k, v in sums.items()}))

    def _export(self, state):
        return self.adapter.export_model(state)

    # -- helpers -----------------------------------------------------------
    def _epoch_stream(self, dataset: Dataset, window: int | None = None):
        """Yield (x, y) batches across all epochs, on the device."""
        for _ in range(self.num_epoch):
            for xb, yb in dataset.batches(
                    self.batch_size, features_col=self.features_col,
                    label_col=self.label_col, drop_remainder=True,
                    window=window):
                yield (torch.as_tensor(xb, device=self.device),
                       torch.as_tensor(yb, device=self.device))

    def _record(self, losses) -> None:
        """Retire the run's device losses (scalars, or ``[n]`` per call)
        into ``history``: one device-to-host copy, at the end."""
        if losses:
            flat = torch.cat([torch.as_tensor(l).reshape(-1).float()
                              for l in losses])
            self.history.extend(flat.cpu().tolist())

    def _require_steps(self, losses, rows_needed: int, n_rows: int) -> None:
        """Refuse to silently return an untrained model."""
        if not losses:
            raise ValueError(
                f"dataset has {n_rows} rows but one training step needs "
                f"{rows_needed} (batch_size x num_workers x window); "
                "reduce batch_size/communication_window/num_workers or "
                "provide more data")


class SingleTrainer(Trainer):
    """Single-device training: one step per batch, a Python loop over
    batches that retires the device losses only at the end.

    ``steps_per_call`` > 1 runs that many optimizer updates per call
    (``adapter.make_multi_train_step``); each epoch then drops its tail
    remainder of up to ``steps_per_call * batch_size - 1`` rows, as the
    reference does.  ``device_data=True`` stages the dataset columns on
    the device once and feeds each call an index block
    (``adapter.make_indexed_train_step``): the same math and data order
    as the streaming path.
    """

    def __init__(self, keras_model, loss="categorical_crossentropy", *,
                 steps_per_call: int = 1, device_data: bool = False, **kw):
        super().__init__(keras_model, loss=loss, **kw)
        if steps_per_call < 1:
            raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
        self.steps_per_call = steps_per_call
        self.device_data = device_data

    def _fit(self, dataset: Dataset):
        spc = self.steps_per_call
        state = self.adapter.init_state()
        tree, start = self._restore_or()
        if start:
            if tree["step"] != start * spc:
                raise ValueError(
                    f"checkpoint at round {start} holds optimizer step "
                    f"{tree['step']}, but steps_per_call={spc} implies "
                    f"{start * spc}: the checkpoint was written under a "
                    "different steps_per_call — resume with the original "
                    "value (data skipping is counted in rounds)")
            self._load_state(state, tree)
        if self.device_data:
            step = self.adapter.make_indexed_train_step(spc)
            X = torch.as_tensor(dataset[self.features_col], device=self.device)
            Y = torch.as_tensor(dataset[self.label_col], device=self.device)
            n = len(dataset)
            rows = self.batch_size * spc

            def stream():
                for _ in range(self.num_epoch):
                    for i in range(0, n - (n % rows), rows):
                        yield (X, Y, torch.arange(
                            i, i + rows, device=self.device).reshape(
                                spc, self.batch_size))
            stream = stream()
        elif spc == 1:
            step = self.adapter.make_train_step()
            stream = self._epoch_stream(dataset)
        else:
            step = self.adapter.make_multi_train_step(spc)
            stream = self._epoch_stream(dataset, window=spc)
        losses, rnd = [], start
        for rnd, args in enumerate(stream, 1):
            if rnd <= start:
                continue
            state, loss = step(state, *args)
            losses.append(loss)     # a device tensor: no sync here
            self._checkpoint(
                lambda local=False: self._state_tree(state, local), rnd)
            self._eval_hook(state, rnd)
        if start and not losses:  # resumed past the end: nothing left to do
            return state
        self._require_steps(losses, self.batch_size * spc, len(dataset))
        self._record(losses)
        self._checkpoint(lambda local=False: self._state_tree(state, local),
                         rnd, final=True)
        return state

"""Trainer base + SingleTrainer of the Keras family, on one device.

Counterpart of ``distkeras_tpu/trainers/base.py`` (reference parity:
distkeras/trainers.py): construct with a model (an ``nn.Module`` of
``models.zoo``), a loss, an optimizer and knobs; ``train(dataset)``
returns a new module with the learned weights; ``training_time`` is the
run's wall clock, ``history`` the per-step losses and ``eval_history``
the ``eval_every`` hook's ``(round, {"loss", metric...})`` records
(round -1: the end of training).  The data order is the reference's bit
for bit (``Dataset.shuffle(seed)``, the same batch streams).

Runs on the card unless ``device="cpu"``.  The checkpoint knobs of the
reference raise ``NotImplementedError`` (ROADMAP A8).  The data-parallel
trainers (``trainers/distributed.py``, ``trainers/elastic.py``) run one
replica per process of a ``torch.distributed`` group.
"""

from __future__ import annotations

import time

import torch

from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.models.adapter import ModelAdapter
from distkeras_tpu_torch.utils.profiling import StepTimer, synchronize

# Reference knobs not ported yet: name -> (default, ROADMAP item).
_UNPORTED = {
    "checkpoint_dir": (None, "A8"), "checkpoint_every": (0, "A8"),
    "max_checkpoints": (3, "A8"), "resume": (False, "A8"),
    "checkpoint_backend": ("auto", "A8"),
}


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


def reject_unported(owner: str, unported: dict, table: dict) -> None:
    """Raise for a knob of the reference that the port does not have yet
    (``table``: name -> (default, ROADMAP item)), unless it is left at
    its default; an unknown name is a TypeError."""
    for name, value in unported.items():
        if name not in table:
            raise TypeError(f"{owner} got an unexpected keyword argument "
                            f"{name!r}")
        default, item = table[name]
        if value != default:
            raise NotImplementedError(
                f"{owner}({name}=...) is not ported yet (ROADMAP {item}); "
                "the port trains without checkpoints")


class Trainer:
    """Base trainer: owns the adapter and the train() bookkeeping."""

    _unported = _UNPORTED

    def __init__(self, keras_model, loss="categorical_crossentropy",
                 worker_optimizer="sgd", learning_rate=None,
                 batch_size: int = 32, num_epoch: int = 1,
                 features_col: str = "features", label_col: str = "label",
                 shuffle: bool = False, seed: int | None = None,
                 preprocess=None, metrics=(), eval_every: int = 0,
                 device=None, **unported):
        reject_unported(type(self).__name__, unported, self._unported)
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
        state = self._fit(dataset)
        self._eval_hook(state, rnd=None, final=True)
        synchronize(state.tv)
        self.training_time = time.perf_counter() - t0
        return self._export(state)

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
        losses = []
        for rnd, args in enumerate(stream, 1):
            state, loss = step(state, *args)
            losses.append(loss)     # a device tensor: no sync here
            self._eval_hook(state, rnd)
        self._require_steps(losses, self.batch_size * spc, len(dataset))
        self._record(losses)
        return state

"""Synchronous data-parallel trainers: ADAG and DynSGD, one device.

Counterpart of ``distkeras_tpu/trainers/distributed.py`` (reference
parity: distkeras/trainers.py::ADAG / DynSGD).  ``communication_window``
is the gradient-accumulation depth of one global step: each round takes
``window`` microbatches of ``batch_size * num_workers`` rows, sums their
gradients and applies one optimizer update on the mean.  DynSGD's
staleness-scaled rate is ``lr / (tau + 1)`` with ``tau == 0`` under
synchronous execution, so it is ADAG (kept for API parity).

The port trains on one device per process: ``num_workers`` defaults to
it and more raises, as in the reference when it exceeds the visible
devices.  The mesh, sharding and gradient-exchange knobs raise
``NotImplementedError`` (ROADMAP A7).
"""

from __future__ import annotations

import torch

from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.trainers.base import _UNPORTED, Trainer

_UNPORTED_DP = {
    **_UNPORTED,
    "mesh": (None, "A7"), "plan": (None, "A7"), "fsdp": (False, "A7"),
    "zero": (None, "A7"), "zero1": (False, "A7"),
    "zero1_bucket_mb": (None, "A7"), "zero_bucket_mb": (None, "A7"),
    "merge_rule": ("mean", "A7"), "sync_every": (1, "A7"),
    "compress": (None, "A7"), "topk_frac": (0.01, "A7"),
}

# Devices one process of the port trains on (multi-GPU is ROADMAP A7).
VISIBLE_DEVICES = 1


class DistributedTrainer(Trainer):
    """Base of the data-parallel trainers: ``num_workers`` replicas.

    ``device_data=True`` (where ``_supports_device_data``) stages the
    dataset on the device once and feeds index blocks;
    ``probe_metrics=True`` (ADAG/DynSGD) records the global gradient
    norm per step in ``probe_history``.
    """

    _supports_device_data = False
    _supports_probe = False
    _unported = _UNPORTED_DP

    def __init__(self, keras_model, loss="categorical_crossentropy",
                 worker_optimizer="sgd", learning_rate=None,
                 batch_size: int = 32, num_epoch: int = 1,
                 num_workers: int | None = None, device_data: bool = False,
                 probe_metrics: bool = False, **kw):
        super().__init__(keras_model, loss=loss,
                         worker_optimizer=worker_optimizer,
                         learning_rate=learning_rate, batch_size=batch_size,
                         num_epoch=num_epoch, **kw)
        if device_data and not self._supports_device_data:
            raise ValueError(
                f"device_data=True is not supported by "
                f"{type(self).__name__}")
        if probe_metrics and not self._supports_probe:
            raise ValueError(
                f"{type(self).__name__} does not support probe_metrics; it "
                "is implemented for ADAG/DynSGD (and LMTrainer)")
        if probe_metrics and device_data:
            raise ValueError(
                "probe_metrics does not compose with device_data=True "
                "(the indexed data plane's step has no probe output)")
        self.device_data = device_data
        self.probe_metrics = probe_metrics
        self.probe_history: list[dict] = []
        n = num_workers or VISIBLE_DEVICES
        if n > VISIBLE_DEVICES:
            raise ValueError(
                f"num_workers={n} exceeds visible devices "
                f"({VISIBLE_DEVICES}); oversubscription is not supported — "
                "the port trains on one device per process (multi-GPU is "
                "ROADMAP A7)")
        self.num_workers = n


class ADAG(DistributedTrainer):
    """Asynchronous Distributed Adaptive Gradients, synchronously.

    Reference parity: distkeras/trainers.py::ADAG.
    ``communication_window`` is the accumulation depth per global step.
    """

    _supports_device_data = True
    _supports_probe = True

    def __init__(self, keras_model, communication_window: int = 12, **kw):
        super().__init__(keras_model, **kw)
        self.communication_window = communication_window

    def _fit(self, dataset: Dataset):
        if self.device_data:
            return self._fit_device_data(dataset)
        w = self.communication_window
        feed_bs = self.batch_size * self.num_workers
        step = self.adapter.make_accum_train_step(w, probe=self.probe_metrics)

        def stream():
            for _ in range(self.num_epoch):
                for xs, ys in dataset.batches(
                        feed_bs, features_col=self.features_col,
                        label_col=self.label_col, window=w):
                    with self.step_timer.phase("h2d"):
                        args = (torch.as_tensor(xs, device=self.device),
                                torch.as_tensor(ys, device=self.device))
                    yield args

        return self._run_rounds(self.adapter.init_state(), step, stream(),
                                feed_bs * w, dataset)

    def _fit_device_data(self, dataset: Dataset):
        """The dataset staged on the device once; each round creates
        only a ``[window, global_batch]`` index block there.  The same
        rows, in the same order, as the streaming path."""
        w = self.communication_window
        step = self.adapter.make_indexed_accum_train_step(w)
        X = torch.as_tensor(dataset[self.features_col], device=self.device)
        Y = torch.as_tensor(dataset[self.label_col], device=self.device)
        global_bs = self.batch_size * self.num_workers
        rows = global_bs * w
        n = len(dataset)

        def index_blocks():
            for _ in range(self.num_epoch):
                for i in range(0, n - (n % rows), rows):
                    with self.step_timer.phase("h2d"):
                        idx = torch.arange(i, i + rows, device=self.device
                                           ).reshape(w, global_bs)
                    yield X, Y, idx

        return self._run_rounds(self.adapter.init_state(), step,
                                index_blocks(), rows, dataset)

    def _run_rounds(self, state, step, rounds, rows_per_round, dataset):
        """The one round loop of both data paths: losses, probes and the
        eval hook."""
        losses, probes = [], []
        for rnd, args in enumerate(rounds, 1):
            with self.step_timer.phase("step"):
                state, out = step(state, *args)
            if self.probe_metrics:
                loss, aux = out
                probes.append(aux)
            else:
                loss = out
            losses.append(loss)
            self._eval_hook(state, rnd)
        self._require_steps(losses, rows_per_round, len(dataset))
        self._record(losses)
        if probes:  # one device-to-host copy, at the end of the run
            self.probe_history = [{k: float(v) for k, v in p.items()}
                                  for p in probes]
        return state


class DynSGD(ADAG):
    """Dynamic SGD.  Reference parity: distkeras/trainers.py::DynSGD —
    ``lr / (tau + 1)`` with staleness ``tau == 0`` synchronously, so
    DynSGD == ADAG; a distinct class for API parity."""

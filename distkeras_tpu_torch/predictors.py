"""Batched inference into a Dataset column.

Counterpart of ``distkeras_tpu/predictors.py`` (reference parity:
distkeras/predictors.py::ModelPredictor): the model's predict function
runs over ``batch_size`` rows at a time on the device, the tail batch
padded to the full batch and cut after, and the outputs land as a new
column.  bf16 outputs (``mixed_bfloat16`` models) come back as float32
(numpy has no bfloat16).
"""

from __future__ import annotations

import numpy as np
import torch

from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.models.adapter import ModelAdapter


class Predictor:
    def predict(self, dataset: Dataset) -> Dataset:  # pragma: no cover
        raise NotImplementedError


class ModelPredictor(Predictor):
    """Append ``output_col`` = model(features) to a Dataset.

    The weights are copied to ``device`` (the card unless
    ``device="cpu"``) once, at construction, and reused by every
    ``predict`` call.
    """

    def __init__(self, keras_model, features_col: str = "features",
                 output_col: str = "prediction", batch_size: int = 1024,
                 device=None):
        self.adapter = ModelAdapter(keras_model, loss="mse", device=device)
        self.features_col = features_col
        self.output_col = output_col
        self.batch_size = batch_size
        self._predict_fn = self.adapter.make_predict_fn()
        self._tv = self.adapter.initial_tv()
        self._ntv = [b.detach().to(self.adapter.device, copy=True)
                     for b in keras_model.buffers()]

    def _run(self, xb: np.ndarray) -> np.ndarray:
        out = self._predict_fn(self._tv, self._ntv,
                               torch.as_tensor(xb, device=self.adapter.device))
        if out.dtype == torch.bfloat16:
            out = out.float()
        return out.cpu().numpy()

    def _predict_array(self, x: np.ndarray) -> np.ndarray:
        bs = self.batch_size
        if len(x) == 0:
            # Empty poll: one padded batch gives the output shape.
            return self._run(np.zeros((bs,) + x.shape[1:], x.dtype))[:0]
        outs = []
        for i in range(0, len(x), bs):
            xb = x[i:i + bs]
            pad = bs - len(xb)
            if pad:
                xb = np.concatenate(
                    [xb, np.zeros((pad,) + xb.shape[1:], xb.dtype)])
            outs.append(self._run(xb)[:bs - pad])
        return np.concatenate(outs)

    def predict(self, dataset: Dataset) -> Dataset:
        return dataset.with_column(
            self.output_col, self._predict_array(dataset[self.features_col]))

    def predict_stream(self, batches):
        """Yield the predictions of each feature array of a stream."""
        for xb in batches:
            yield self._predict_array(np.asarray(xb))

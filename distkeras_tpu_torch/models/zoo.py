"""Model zoo: the reference's Keras workloads as ``torch.nn`` modules.

Counterpart of ``distkeras_tpu/models/zoo.py``: the same builder names,
arguments and widths, each model ending in logits.  The layouts follow
Keras so that weights carry across exactly
(``utils.serialization.module_from_keras_numpy``):

- inputs are NHWC (as the Dataset holds images); the convolutions run on
  the NCHW view of that tensor, which is channels_last in memory;
- ``Conv2D(k=3, padding="same")`` is padding 1, ``MaxPooling2D()`` is a
  2 x 2 window at stride 2 (valid);
- ``Flatten`` flattens in Keras' H, W, C order (a C, H, W flatten would
  silently permute the first Dense layer's weights);
- the module's parameters are Keras' ``trainable_variables`` in order
  (each layer's kernel, then bias).

``policy`` replaces Keras' global mixed-precision policy with a
constructor argument: ``"float32"``, or ``"mixed_bfloat16"`` (f32
weights, the layers computing in bf16 under ``torch.autocast``, bf16
logits out).  Weights start as Keras' do (glorot-uniform kernels, zero
biases), drawn from ``np.random.default_rng(seed)``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from distkeras_tpu_torch.utils.serialization import (keras_numpy_from_module,
                                                     module_from_keras_numpy)

POLICIES = ("float32", "mixed_bfloat16")


class _KerasModule(nn.Module):
    """Base: the policy, and Keras' initialization."""

    def __init__(self, name: str, policy: str):
        super().__init__()
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; known: "
                             f"{list(POLICIES)}")
        self.name = name
        self.policy = policy

    def _compute(self, x):
        """The layers' compute dtype: autocast to bf16 under the mixed
        policy, nothing under float32."""
        if self.policy == "mixed_bfloat16":
            return torch.autocast(x.device.type, dtype=torch.bfloat16)
        return contextlib.nullcontext()

    def _init_weights(self, seed):
        rng = np.random.default_rng(seed)
        tv, ntv = keras_numpy_from_module(self)
        out = []
        for w in tv:
            if w.ndim >= 2:  # Keras kernel: receptive field x in x out
                rf = int(np.prod(w.shape[:-2]))
                fan_in, fan_out = rf * w.shape[-2], rf * w.shape[-1]
                limit = np.sqrt(6.0 / (fan_in + fan_out))
                out.append(rng.uniform(-limit, limit, w.shape)
                           .astype(np.float32))
            else:
                out.append(np.zeros_like(w))
        module_from_keras_numpy(self, out, ntv)


class MLP(_KerasModule):
    """Dense layers with ReLU between them, logits out."""

    def __init__(self, input_dim: int, hidden, num_classes: int,
                 name: str = "mlp", policy: str = "float32", seed=None):
        super().__init__(name, policy)
        widths = [input_dim, *hidden, num_classes]
        self.dense = nn.ModuleList(nn.Linear(a, b)
                                   for a, b in zip(widths, widths[1:]))
        self._init_weights(seed)

    def forward(self, x):
        with self._compute(x):
            for layer in self.dense[:-1]:
                x = torch.relu(layer(x))
            return self.dense[-1](x)


class CifarCNN(_KerasModule):
    """Conv 32, 32, pool, conv 64, 64, pool, Dense 512, logits."""

    def __init__(self, num_classes: int = 10, input_shape=(32, 32, 3),
                 name: str = "cifar_cnn", policy: str = "float32",
                 seed=None):
        super().__init__(name, policy)
        h, w, c = input_shape
        self.conv = nn.ModuleList(
            nn.Conv2d(a, b, 3, padding=1)
            for a, b in ((c, 32), (32, 32), (32, 64), (64, 64)))
        self.dense = nn.ModuleList([nn.Linear((h // 4) * (w // 4) * 64, 512),
                                    nn.Linear(512, num_classes)])
        self._init_weights(seed)

    def forward(self, x):
        with self._compute(x):
            x = x.permute(0, 3, 1, 2)          # NHWC -> NCHW view
            for i, conv in enumerate(self.conv):
                x = torch.relu(conv(x))
                if i % 2:
                    x = F.max_pool2d(x, 2)
            x = x.permute(0, 2, 3, 1).flatten(1)  # Keras Flatten: H, W, C
            x = torch.relu(self.dense[0](x))
            return self.dense[1](x)


def mnist_mlp(hidden=(500, 300), num_classes: int = 10, input_dim: int = 784,
              seed: int | None = None, policy: str = "float32"):
    """3-layer MLP, the reference's canonical MNIST architecture."""
    return MLP(input_dim, hidden, num_classes, "mnist_mlp", policy, seed)


def cifar_cnn(num_classes: int = 10, input_shape=(32, 32, 3),
              seed: int | None = None, policy: str = "float32"):
    """Small CNN for CIFAR-10 (BASELINE.json config #2)."""
    return CifarCNN(num_classes, input_shape, "cifar_cnn", policy, seed)


def higgs_mlp(input_dim: int = 28, num_classes: int = 2,
              hidden=(600, 600, 600), seed: int | None = None,
              policy: str = "float32"):
    """Tabular MLP for the ATLAS Higgs task."""
    return MLP(input_dim, hidden, num_classes, "higgs_mlp", policy, seed)


def imdb_lstm(*args, **kwargs):
    raise NotImplementedError(
        "imdb_lstm is not ported yet (ROADMAP A6): it needs the port of "
        "models/rnn.py::FusedLSTM")


def resnet50(*args, **kwargs):
    raise NotImplementedError(
        "resnet50 is not ported yet (ROADMAP A6): it needs a BatchNorm "
        "with the semantics of keras.applications.ResNet50's (Keras "
        "momentum 0.99, i.e. torch momentum 0.01, and epsilon=1.001e-5)")


ZOO = {
    "mnist_mlp": mnist_mlp,
    "cifar_cnn": cifar_cnn,
    "higgs_mlp": higgs_mlp,
    "imdb_lstm": imdb_lstm,
    "resnet50": resnet50,
}

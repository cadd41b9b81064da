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

Every model takes ``policy`` and ``seed`` as ``models/base.py``
describes (Keras' mixed-precision policy and Keras' initializers).

``imdb_lstm`` is ``Embedding -> LSTM -> Dense(1)`` over int32 tokens
(``models/rnn.py``; ``fused=False`` is the stock Keras LSTM on torch's
fused kernel) and ``resnet50`` is ``keras.applications.ResNet50``
(``models/resnet.py``).  Each builder records its name and arguments in
``module.zoo_config``, which ``serialize_keras_model`` writes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from distkeras_tpu_torch.models.base import KerasModule
from distkeras_tpu_torch.models.resnet import ResNet50
from distkeras_tpu_torch.models.rnn import LSTM, FusedLSTM


def _zoo(module, builder: str, **kwargs):
    """Record the builder and its arguments (``serialize_keras_model``'s
    JSON) on ``module``."""
    module.zoo_config = {"builder": builder, "kwargs": kwargs}
    return module


class MLP(KerasModule):
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


class CifarCNN(KerasModule):
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


class ImdbLSTM(KerasModule):
    """Embedding, LSTM (fused or cuDNN), Dense(1): one binary logit."""

    def __init__(self, vocab_size: int, embed_dim: int, lstm_units: int,
                 fused: bool = True, name: str = "imdb_lstm",
                 policy: str = "float32", seed=None):
        super().__init__(name, policy)
        self.embedding = nn.Embedding(vocab_size, embed_dim)
        self.lstm = (FusedLSTM if fused else LSTM)(lstm_units,
                                                   input_dim=embed_dim)
        self.dense = nn.Linear(lstm_units, 1)
        self._init_weights(seed)

    def forward(self, x):
        with self._compute(x):
            return self.dense(self.lstm(self.embedding(x)))


def mnist_mlp(hidden=(500, 300), num_classes: int = 10, input_dim: int = 784,
              seed: int | None = None, policy: str = "float32"):
    """3-layer MLP, the reference's canonical MNIST architecture."""
    return _zoo(MLP(input_dim, hidden, num_classes, "mnist_mlp", policy,
                    seed), "mnist_mlp", hidden=list(hidden),
                num_classes=num_classes, input_dim=input_dim, policy=policy)


def cifar_cnn(num_classes: int = 10, input_shape=(32, 32, 3),
              seed: int | None = None, policy: str = "float32"):
    """Small CNN for CIFAR-10 (BASELINE.json config #2)."""
    return _zoo(CifarCNN(num_classes, input_shape, "cifar_cnn", policy, seed),
                "cifar_cnn", num_classes=num_classes,
                input_shape=list(input_shape), policy=policy)


def higgs_mlp(input_dim: int = 28, num_classes: int = 2,
              hidden=(600, 600, 600), seed: int | None = None,
              policy: str = "float32"):
    """Tabular MLP for the ATLAS Higgs task."""
    return _zoo(MLP(input_dim, hidden, num_classes, "higgs_mlp", policy,
                    seed), "higgs_mlp", input_dim=input_dim,
                num_classes=num_classes, hidden=list(hidden), policy=policy)


def imdb_lstm(vocab_size: int = 20000, embed_dim: int = 128,
              lstm_units: int = 128, maxlen: int = 128,
              seed: int | None = None, fused: bool = True,
              policy: str = "float32"):
    """LSTM sentiment classifier (BASELINE.json config #4): int32 tokens
    ``[B, maxlen]`` in (the module takes any length; ``maxlen`` is
    recorded for serialization), one binary logit out
    (``binary_crossentropy``).
    ``fused=True`` is :class:`~distkeras_tpu_torch.models.rnn.FusedLSTM`,
    ``fused=False`` the stock Keras LSTM's counterpart."""
    return _zoo(ImdbLSTM(vocab_size, embed_dim, lstm_units, fused,
                         "imdb_lstm", policy, seed), "imdb_lstm",
                vocab_size=vocab_size, embed_dim=embed_dim,
                lstm_units=lstm_units, maxlen=maxlen, fused=fused,
                policy=policy)


def resnet50(num_classes: int = 1000, input_shape=(224, 224, 3),
             seed: int | None = None, policy: str = "float32"):
    """ResNet-50 (BASELINE.json stretch config), random init, logits out."""
    return _zoo(ResNet50(num_classes, input_shape, "resnet50", policy, seed),
                "resnet50", num_classes=num_classes,
                input_shape=list(input_shape), policy=policy)


ZOO = {
    "mnist_mlp": mnist_mlp,
    "cifar_cnn": cifar_cnn,
    "higgs_mlp": higgs_mlp,
    "imdb_lstm": imdb_lstm,
    "resnet50": resnet50,
}

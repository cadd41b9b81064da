"""ResNet-50 v1 as ``keras.applications.ResNet50(weights=None)`` builds
it, as a ``torch.nn`` module.

Counterpart of ``keras/src/applications/resnet.py`` (``ResNet50``,
``stack_residual_blocks_v1``, ``residual_block_v1``), which the
reference's ``zoo.resnet50`` calls:

- ``conv1_pad`` (3) and the 7 x 7 / 2 ``conv1_conv`` (with bias), BN,
  ReLU, ``pool1_pad`` (1) and a 3 x 3 / 2 max pool;
- stacks ``conv2``..``conv5`` of 3, 4, 6 and 3 bottleneck blocks with
  64, 128, 256 and 512 filters (x 4 out); the first block of a stack
  has the ``_0_conv`` / ``_0_bn`` projection shortcut, and in stacks
  3-5 its stride 2 sits on ``_1_conv`` and ``_0_conv``;
- every BN is :class:`~distkeras_tpu_torch.models.batchnorm.
  KerasBatchNorm` with epsilon 1.001e-5 and Keras' momentum 0.99;
- global average pool, then the ``predictions`` Dense head (logits).

Each layer is a submodule of :class:`ResNet50` named by its Keras name, registered in the
order Keras lists the model's variables, which is topological, not the
order of construction: a block with a shortcut lists ``_1_conv``,
``_1_bn``, ``_2_conv``, ``_2_bn``, ``_0_conv``, ``_3_conv``, ``_0_bn``,
``_3_bn``.  So the parameters are Keras' 214 trainable variables and the
buffers its 106 non-trainable ones, in order, and the paths map one to
one (``conv1_conv.weight`` is ``conv1_conv/kernel``).

Inputs are NHWC; the convolutions run on the NCHW view of that tensor,
which is channels_last in memory.  The max pool pads with -inf where
Keras pads with zeros; after the ReLU every input is >= 0, so the two
agree.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from distkeras_tpu_torch.models.base import KerasModule
from distkeras_tpu_torch.models.batchnorm import KerasBatchNorm

EPSILON = 1.001e-5
STACKS = (("conv2", 64, 3, 1), ("conv3", 128, 4, 2), ("conv4", 256, 6, 2),
          ("conv5", 512, 3, 2))


def _bn(channels):
    return KerasBatchNorm(channels, axis=1, epsilon=EPSILON)


def _layers(in_channels: int, num_classes: int):
    """``(keras_name, module)`` of every layer with variables, in Keras'
    variable order."""
    out = [("conv1_conv", nn.Conv2d(in_channels, 64, 7, 2, padding=3)),
           ("conv1_bn", _bn(64))]
    cin = 64
    for stack, f, blocks, stride1 in STACKS:
        for i in range(1, blocks + 1):
            name, stride = f"{stack}_block{i}", stride1 if i == 1 else 1
            main = [(f"{name}_1_conv", nn.Conv2d(cin, f, 1, stride)),
                    (f"{name}_1_bn", _bn(f)),
                    (f"{name}_2_conv", nn.Conv2d(f, f, 3, padding=1)),
                    (f"{name}_2_bn", _bn(f))]
            if i == 1:
                main += [(f"{name}_0_conv", nn.Conv2d(cin, 4 * f, 1, stride)),
                         (f"{name}_3_conv", nn.Conv2d(f, 4 * f, 1)),
                         (f"{name}_0_bn", _bn(4 * f)),
                         (f"{name}_3_bn", _bn(4 * f))]
            else:
                main += [(f"{name}_3_conv", nn.Conv2d(f, 4 * f, 1)),
                         (f"{name}_3_bn", _bn(4 * f))]
            out += main
            cin = 4 * f
    out.append(("predictions", nn.Linear(cin, num_classes)))
    return out


class ResNet50(KerasModule):
    """``keras.applications.ResNet50(weights=None,
    classifier_activation=None)``: NHWC images in, logits out."""

    def __init__(self, num_classes: int = 1000, input_shape=(224, 224, 3),
                 name: str = "resnet50", policy: str = "float32", seed=None):
        super().__init__(name, policy)
        for key, layer in _layers(input_shape[-1], num_classes):
            self.add_module(key, layer)
        self.blocks = [(f"{stack}_block{i}", i == 1)
                       for stack, _, n, _ in STACKS for i in range(1, n + 1)]
        self._init_weights(seed)

    def forward(self, x):
        with self._compute(x):
            x = x.permute(0, 3, 1, 2)                  # NHWC -> NCHW view
            x = torch.relu(self.conv1_bn(self.conv1_conv(x)))
            x = F.max_pool2d(x, 3, 2, padding=1)
            for name, projection in self.blocks:
                layer = lambda s: getattr(self, f"{name}_{s}")  # noqa: E731
                shortcut = (layer("0_bn")(layer("0_conv")(x)) if projection
                            else x)
                y = torch.relu(layer("1_bn")(layer("1_conv")(x)))
                y = torch.relu(layer("2_bn")(layer("2_conv")(y)))
                y = layer("3_bn")(layer("3_conv")(y))
                x = torch.relu(shortcut + y)
            return self.predictions(x.mean((2, 3)))

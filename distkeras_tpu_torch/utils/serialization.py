"""Load the JAX package's LM artifacts into the port.

``load_lm`` reads the ``.npz`` that ``distkeras_tpu.utils.serialization.
save_lm`` writes (a ``__config__`` JSON entry plus one array per
``/``-joined key path) with plain ``np.load``; ``params_from_numpy``
carries a nested dict of arrays across as tensors.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from distkeras_tpu_torch.models.transformer import TransformerConfig
from distkeras_tpu_torch.utils.device import resolve_device


def params_from_numpy(tree, device, dtype=None):
    """Nested dict of arrays (numpy, or anything ``np.asarray`` takes)
    -> the same dict of tensors on ``device`` (``None``: the card).
    Floating leaves are cast to ``dtype`` when given."""
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        t = torch.from_numpy(np.array(node))  # a writable host copy
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return conv(tree)


def load_lm(path: str, device=None, dtype=None):
    """Load a ``save_lm`` artifact; returns ``(params, cfg)`` with the
    params on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as data:
        cfg = TransformerConfig(**json.loads(str(data["__config__"])))
        tree: dict = {}
        for name in data.files:
            if name == "__config__":
                continue
            node = tree
            parts = name.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[name]
    return params_from_numpy(tree, device, dtype), cfg

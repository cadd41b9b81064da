"""Carry weights between the JAX package and the port.

Keras models: ``module_from_keras_numpy`` loads Keras' own variable
lists (``trainable_variables`` / ``non_trainable_variables`` as numpy,
which is the JAX adapter's ``tv`` / ``ntv``) into a zoo module, and
``keras_numpy_from_module`` gives them back, exactly.

The LM: ``save_lm`` writes, and ``load_lm`` reads, the ``.npz`` of
``distkeras_tpu.utils.serialization.save_lm`` (a ``__config__`` JSON
entry plus one array per ``/``-joined key path), so an artefact of
either package loads in the other; ``params_from_numpy`` carries a
nested dict of arrays across as tensors (MoE leaves and int8
``QTensor`` leaves included), ``lora_from_numpy`` an adapter tree, and
``params_to_numpy`` back.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from distkeras_tpu_torch.models.quant import QTensor
from distkeras_tpu_torch.models.transformer import (TransformerConfig,
                                                    named_leaves)
from distkeras_tpu_torch.utils.device import resolve_device


def _host(node):
    return torch.from_numpy(np.array(node))  # a writable host copy


def params_from_numpy(tree, device, dtype=None):
    """Nested dict of arrays (numpy, or anything ``np.asarray`` takes)
    -> the same dict of tensors on ``device`` (``None``: the card).
    Floating leaves are cast to ``dtype`` when given.  A quantized leaf —
    a ``(q, s)`` pair, or an object with ``.q`` / ``.s`` (the reference's
    ``QTensor`` with numpy children) — becomes a :class:`QTensor` with
    ``q`` int8 and ``s`` f32 whatever ``dtype`` says."""
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, tuple) or hasattr(node, "q"):
            q, s = node if isinstance(node, tuple) else (node.q, node.s)
            return QTensor(q=_host(q).to(device, torch.int8),
                           s=_host(s).to(device, torch.float32))
        t = _host(node)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return conv(tree)


def lora_from_numpy(tree, device):
    """An adapter tree ``{"attn" / "ffn": {name: {"a", "b"}}}`` of arrays
    (e.g. the reference's ``lora_init``) -> f32 tensors on ``device``."""
    for group, sub in tree.items():
        if group not in ("attn", "ffn") or any(
                set(ab) != {"a", "b"} for ab in sub.values()):
            raise ValueError(
                "an adapter tree is {'attn' / 'ffn': {target: {'a', "
                f"'b'}}}}, got group {group!r} with {sub.keys()}")
    return params_from_numpy(tree, device, torch.float32)


def params_to_numpy(tree):
    """The inverse of :func:`params_from_numpy`: a nested dict of
    tensors (any device, with or without grad) -> the same dict of numpy
    arrays on the host, dtypes kept (bf16 leaves become f32, which numpy
    lacks); a :class:`QTensor` becomes its ``(q, s)`` pair."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return params_to_numpy(tree.q), params_to_numpy(tree.s)
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _keras_layout(p: torch.Tensor) -> np.ndarray:
    """A module parameter as a new array in Keras' layout: Conv2D kernels
    HWIO (torch OIHW), Dense kernels ``[in, out]`` (``Linear.weight`` is
    ``[out, in]``), anything else as it is."""
    a = p.detach().cpu().numpy()
    if a.ndim == 4:
        a = a.transpose(2, 3, 1, 0)
    elif a.ndim == 2:
        a = a.T
    return np.array(a, order="C")


def _torch_layout(a) -> np.ndarray:
    a = np.asarray(a)
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    return a.T if a.ndim == 2 else a


def keras_numpy_from_module(module) -> tuple[list, list]:
    """``(tv, ntv)``: the module's parameters and buffers, in order, as
    numpy arrays in Keras' layout (the inverse of
    :func:`module_from_keras_numpy`)."""
    return ([_keras_layout(p) for p in module.parameters()],
            [_keras_layout(b) for b in module.buffers()])


def module_from_keras_numpy(module, tv, ntv=()):
    """Load Keras' variable lists (numpy, in ``trainable_variables`` /
    ``non_trainable_variables`` order) into ``module`` in place: Conv2D
    kernels HWIO -> OIHW, Dense kernels ``[in, out]`` -> ``[out, in]``.
    The counts and every converted shape must match.  Returns the
    module."""
    for what, named, src in (
            ("trainable", list(module.named_parameters()), list(tv)),
            ("non-trainable", list(module.named_buffers()), list(ntv))):
        if len(named) != len(src):
            raise ValueError(f"{what} variables: the module holds "
                             f"{len(named)}, got {len(src)}")
        for (name, t), a in zip(named, src):
            a = _torch_layout(a)
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(
                    f"{name}: Keras variable of shape {a.shape} (torch "
                    f"layout) does not fit {tuple(t.shape)}")
            with torch.no_grad():
                t.copy_(torch.tensor(a))
    return module


def save_lm(path: str, params, cfg: TransformerConfig) -> None:
    """Write a transformer LM (params dict + config) to one ``.npz``: the
    config as ``__config__`` JSON and one array per leaf under its
    ``/``-joined key path — the layout of the reference's ``save_lm``, so
    ``distkeras_tpu.utils.serialization.load_lm`` reads it.  Leaves are
    written in their dtype, except bf16 ones, which are written as f32
    (numpy has no bfloat16; the values are exact and ``load_lm(...,
    dtype=torch.bfloat16)`` restores them)."""
    arrays = {name: a for name, a in named_leaves(params_to_numpy(params))}
    np.savez(path, __config__=json.dumps(dataclasses.asdict(cfg)),
             **arrays)


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

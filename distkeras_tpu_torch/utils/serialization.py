"""Carry weights between the JAX package and the port.

Keras models: ``module_from_keras_numpy`` loads Keras' own variable
lists (``trainable_variables`` / ``non_trainable_variables`` as numpy,
which is the JAX adapter's ``tv`` / ``ntv``) into a zoo module, and
``keras_numpy_from_module`` gives them back, exactly.  The layout
follows the layer kind, not the rank of the array: a ``Linear`` weight
is a Dense kernel transposed, a ``Conv2d`` weight an HWIO kernel in
OIHW, and everything else (an ``Embedding`` table, the LSTM's and
BatchNorm's variables) is held in Keras' layout already.
``get_weights`` / ``set_weights`` are Keras' per-layer order (each
layer's trainable variables, then its non-trainable ones), and
``serialize_keras_model`` / ``deserialize_keras_model`` keep the
reference's ``{"model": json, "weights": [np.ndarray]}`` dict for a zoo
model (the JSON names the zoo builder and its arguments).

The LM: ``save_lm`` writes, and ``load_lm`` reads, the ``.npz`` of
``distkeras_tpu.utils.serialization.save_lm`` (a ``__config__`` JSON
entry plus one array per ``/``-joined key path), so an artefact of
either package loads in the other; ``params_from_numpy`` carries a
nested dict of arrays across as tensors (MoE leaves and int8
``QTensor`` leaves included), ``lora_from_numpy`` an adapter tree, and
``params_to_numpy`` back.  Under a plan and a mesh,
``sharded_params_from_numpy`` carries the reference's tree across as
this rank's slices (a ``parallel.layout.Sharded`` tree), and
``params_to_numpy`` of such a tree gathers the full leaves (a collective
every rank of the mesh calls).

Raw bytes across the host: ``host_words`` / ``from_words`` carry a tensor
as a numpy array and back bit for bit, a bfloat16 tensor (which numpy
cannot spell) as its raw 16-bit words, and ``dtype_name`` gives numpy's
name of a torch dtype (``"bfloat16"`` included) — the spelling of the
block shipments' headers and the weight snapshots' manifests.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch
from torch import nn

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


def sharded_params_from_numpy(tree, plan, mesh, device, dtype=None):
    """The reference's nested dict of arrays -> this rank's slices of it
    under ``plan`` over ``mesh`` (``parallel.layout.Sharded``, tensors
    on ``device``), each the slice the reference's placement puts on
    this rank's device.  Only the slices are copied off the host."""
    from distkeras_tpu_torch.parallel.layout import Layout, Sharded

    layout = Layout(plan, mesh, tree)
    local = layout.shard(tree)
    return Sharded(params_from_numpy(dict(local), device, dtype), layout)


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


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype (``torch.bfloat16`` ->
    ``"bfloat16"``)."""
    return str(dtype).removeprefix("torch.")


def words_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype :func:`host_words` carries a ``dtype`` tensor in:
    the dtype itself, or ``uint16`` words for bfloat16."""
    return np.dtype(np.uint16 if dtype == torch.bfloat16
                    else dtype_name(dtype))


def host_words(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes as a contiguous numpy array on the host (a
    synchronous copy off a device), bfloat16 as its raw 16-bit words."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def from_words(a, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of :func:`host_words`: a host tensor of ``dtype``
    holding a COPY of ``a`` (which may be a read-only buffer, or one its
    producer reuses)."""
    a = np.asarray(a)
    if dtype == torch.bfloat16:
        return torch.tensor(a.view(np.int16)).view(torch.bfloat16)
    return torch.tensor(a)


def params_to_numpy(tree):
    """The inverse of :func:`params_from_numpy`: a nested dict of
    tensors (any device, with or without grad) -> the same dict of numpy
    arrays on the host, dtypes kept (bf16 leaves become f32, which numpy
    lacks); a :class:`QTensor` becomes its ``(q, s)`` pair.  A sharded
    tree (``parallel.layout.Sharded``) is gathered whole first, a
    collective over the mesh."""
    from distkeras_tpu_torch.parallel.layout import Sharded

    if isinstance(tree, Sharded):
        tree = tree.layout.gather(tree)
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return params_to_numpy(tree.q), params_to_numpy(tree.s)
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _layer_perm(layer, name: str):
    """The permutation of ``layer``'s own variable ``name`` from its
    torch layout into Keras', or None where the two agree."""
    if name == "weight" and isinstance(layer, nn.Conv2d):
        return (2, 3, 1, 0)   # OIHW -> HWIO
    if name == "weight" and isinstance(layer, nn.Linear):
        return (1, 0)         # [out, in] -> [in, out]
    return None


def _own(module, buffers: bool):
    """``(perm, tensor)`` of the module's parameters (or buffers), in
    ``parameters()`` / ``buffers()`` order."""
    out = []
    for layer in module.modules():
        own = layer._buffers if buffers else layer._parameters
        out += [(_layer_perm(layer, n), t) for n, t in own.items()
                if t is not None]
    return out


def keras_perms(module) -> list:
    """Per parameter of ``module`` (in order), the permutation of its
    torch layout into Keras', or None."""
    return [perm for perm, _ in _own(module, buffers=False)]


def _to_keras(perm, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return np.array(a if perm is None else a.transpose(perm), order="C")


def _to_torch(perm, a) -> np.ndarray:
    a = np.asarray(a)
    return a if perm is None else a.transpose(np.argsort(perm))


def keras_numpy_from_module(module) -> tuple[list, list]:
    """``(tv, ntv)``: the module's parameters and buffers, in order, as
    numpy arrays in Keras' layout (the inverse of
    :func:`module_from_keras_numpy`)."""
    return ([_to_keras(p, t) for p, t in _own(module, buffers=False)],
            [_to_keras(p, t) for p, t in _own(module, buffers=True)])


def _load(pairs, src, what: str) -> None:
    if len(pairs) != len(src):
        raise ValueError(f"{what} variables: the module holds "
                         f"{len(pairs)}, got {len(src)}")
    for (name, perm, t), a in zip(pairs, src):
        a = _to_torch(perm, a)
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(
                f"{name}: Keras variable of shape {a.shape} (torch "
                f"layout) does not fit {tuple(t.shape)}")
        with torch.no_grad():
            t.copy_(torch.tensor(a))


def module_from_keras_numpy(module, tv, ntv=()):
    """Load Keras' variable lists (numpy, in ``trainable_variables`` /
    ``non_trainable_variables`` order) into ``module`` in place: Conv2D
    kernels HWIO -> OIHW, Dense kernels ``[in, out]`` -> ``[out, in]``,
    every other variable as it is.  The counts and every converted shape
    must match.  Returns the module."""
    for what, buffers, named, src in (
            ("trainable", False, module.named_parameters(), tv),
            ("non-trainable", True, module.named_buffers(), ntv)):
        pairs = [(n, p, t) for (n, _), (p, t) in
                 zip(named, _own(module, buffers))]
        _load(pairs, list(src), what)
    return module


def _layers(module):
    """``(name, perm, tensor)`` in Keras' ``get_weights`` order: layer by
    layer, each layer's parameters, then its buffers."""
    out = []
    for lname, layer in module.named_modules():
        for own in (layer._parameters, layer._buffers):
            out += [(f"{lname}.{n}" if lname else n, _layer_perm(layer, n),
                     t) for n, t in own.items() if t is not None]
    return out


def weight_paths(module) -> list:
    """The Keras path (``layer/variable``) of each :func:`get_weights`
    entry: a ``Linear`` / ``Conv2d`` weight is ``kernel``, every other
    variable keeps its name."""
    out = []
    for name, perm, _ in _layers(module):
        layer, var = name.rsplit(".", 1) if "." in name else ("", name)
        var = "kernel" if perm is not None else var
        out.append(f"{layer}/{var}" if layer else var)
    return out


def get_weights(module) -> list:
    """Keras' ``model.get_weights()`` of a zoo module: every variable as
    a numpy array in Keras' layout, in Keras' order (per layer: e.g. a
    BatchNorm's gamma, beta, moving_mean, moving_variance together)."""
    return [_to_keras(p, t) for _, p, t in _layers(module)]


def set_weights(module, weights) -> None:
    """Keras' ``model.set_weights``: the inverse of :func:`get_weights`."""
    _load(_layers(module), list(weights), "get_weights()")


def serialize_keras_model(model) -> dict:
    """A zoo module as the reference's picklable dict: ``"model"`` is a
    JSON string naming the zoo builder and its arguments, ``"weights"``
    the :func:`get_weights` list."""
    cfg = getattr(model, "zoo_config", None)
    if cfg is None:
        raise ValueError(
            "serialize_keras_model takes a model built by "
            "distkeras_tpu_torch.models.zoo (its JSON names the builder "
            f"and its arguments); got {type(model).__name__}")
    return {"model": json.dumps(cfg), "weights": get_weights(model)}


def deserialize_keras_model(blob: dict):
    """Rebuild a module from :func:`serialize_keras_model` output: the
    zoo builder with its arguments, then the weights."""
    from distkeras_tpu_torch.models.zoo import ZOO

    cfg = json.loads(blob["model"])
    model = ZOO[cfg["builder"]](**cfg["kwargs"])
    set_weights(model, blob["weights"])
    return model


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

"""Ring attention: sequence parallelism over the mesh ``seq`` axis.

Counterpart of ``distkeras_tpu/parallel/ring.py``.  The sequence is
split over the ``seq`` axis: each rank keeps its Q shard and runs the
reference's ``seq`` hops, each updating the online-softmax state with
``ops.attention.attention_chunk`` (plain torch, as the reference's hop
is plain jnp) against one rank's K/V block, in the ring's order and at
its global offsets.

Where the reference rotates the K/V shard with ``ppermute``, the port
gathers the blocks once with a differentiable all-gather
(:func:`~distkeras_tpu_torch.parallel.collectives.gather_on_use`; the
backward reduce-scatters their gradients): gloo, which joins ranks that
share one card, has no point-to-point transport for CUDA tensors, and a
rotation built on its all-gather would move every shard at each of the
``seq - 1`` hops.  The bytes a rank sends are the ring's at ``seq = 2``
and fewer above it; a rank holds the whole sequence's K/V while its
attention runs.

The reference wraps the body in a ``shard_map`` over global arrays; the
port runs one process per device, so :func:`make_ring_attention`'s
function takes and returns this rank's ``[B, L / seq, H, D]`` shard, and
the trunk (``models/transformer.py``) embeds its own positions of the
sequence (``ring_fn.seq_shard``).
"""

from __future__ import annotations

import functools

import torch

from distkeras_tpu_torch.ops.attention import (_check_window, _scale_for,
                                               attention_chunk,
                                               online_finish, online_init)
from distkeras_tpu_torch.parallel.collectives import (exchange_rows,
                                                      gather_on_use)
from distkeras_tpu_torch.parallel.rules import NamedSharding, P


def ring_attention(q, k, v, axis_name: str = "seq", causal: bool = False,
                   scale: float | None = None, window: int | None = None,
                   segment_ids=None, *, mesh):
    """The ring body over ``mesh``'s ``axis_name`` axis, on this rank's
    shards ``q / k / v: [B, L_local, H, D]`` of a sequence of global
    length ``L_local * axis size``; returns this rank's shard of the
    output.

    ``window`` masks on global positions through the per-hop offsets; a
    hop whose K/V block lies wholly outside the band contributes nothing
    but is still computed, as in the reference.  ``segment_ids [B,
    L_local]`` is this rank's shard of the packed-document ids: the
    query side stays, and each hop masks with the K/V side's block.

    K/V and the ids are gathered once over the axis (the module
    docstring says why), and hop ``h`` takes the block of rank ``(me -
    h) mod n``, the one the reference's ``h``-th rotation brings.  Every
    rank of the axis must call this with the same shapes (a collective).
    """
    _check_window(window, causal)
    ax = mesh.sub(axis_name)
    n, me = ax.size, ax.rank
    b, lq, h, d = q.shape
    lk = k.shape[1]
    s = _scale_for(q, scale)
    qf = q.float()
    seg_k = None
    if segment_ids is not None:
        seg_k = exchange_rows(segment_ids.to(torch.int32), ax)  # [n, B, L]
    m, l, o = online_init(b, h, lq, d, device=q.device)
    kv = gather_on_use(torch.cat([k, v], dim=-1), 1, ax)    # [B, n*lk, ..]
    for hop in range(n):
        src = (me - hop) % n
        kc, vc = kv[:, src * lk:(src + 1) * lk].split(d, dim=-1)
        m, l, o = attention_chunk(
            qf, kc.float(), vc.float(), m, l, o, causal, s,
            q_offset=me * lq, kv_offset=src * lk, window=window,
            seg_q=segment_ids, seg_k=None if seg_k is None else seg_k[src])
    return online_finish(m, l, o).to(q.dtype)


def make_ring_attention(mesh, axis_name: str = "seq",
                        batch_axis: str | None = "data",
                        causal: bool = False, scale: float | None = None,
                        window: int | None = None):
    """``ring_fn(q, k, v, segment_ids=None)`` over this rank's ``[B,
    L / seq, H, D]`` shard (the batch is this rank's ``batch_axis``
    rows, as the trainers feed it).  ``ring_fn.handles_window`` and
    ``ring_fn.handles_segments`` tell the trunk's guards what it
    implements, as the reference's attributes do; ``ring_fn.seq_shard``
    is ``(index, count)`` of this rank's block of the sequence, which the
    trunk offsets its positions by."""
    if axis_name not in mesh.shape or (batch_axis is not None
                                       and batch_axis not in mesh.shape):
        raise ValueError(f"mesh has no axis {axis_name!r} / {batch_axis!r}")
    fn = functools.partial(ring_attention, axis_name=axis_name,
                           causal=causal, scale=scale, window=window,
                           mesh=mesh)

    def ring_fn(q, k, v, segment_ids=None):
        return fn(q, k, v, segment_ids=segment_ids)

    ring_fn.handles_window = window
    ring_fn.handles_segments = True
    ax = mesh.sub(axis_name)
    ring_fn.seq_shard = (ax.rank, ax.size)
    return ring_fn


def sequence_sharding(mesh, batch_axis: str | None = "data",
                      axis_name: str = "seq") -> NamedSharding:
    """The placement of ``[B, L, ...]`` activations under ring attention:
    the batch over ``batch_axis``, the sequence over ``axis_name``
    (``.local(x)`` is this rank's block)."""
    return NamedSharding(mesh, P(batch_axis, axis_name))


__all__ = ["ring_attention", "make_ring_attention", "sequence_sharding"]

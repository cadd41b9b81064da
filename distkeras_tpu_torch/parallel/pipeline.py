"""Pipeline parallelism: the GPipe microbatch schedule over the mesh.

Counterpart of ``distkeras_tpu/parallel/pipeline.py``.  The reference
compiles the schedule into one program (a ``lax.scan`` over clock ticks
inside a ``shard_map`` manual over the ``pipeline`` axis); the port runs
one process per stage, and each process runs the same ticks: at tick
``t`` stage ``i`` applies itself to microbatch ``t - i`` and passes the
activation to stage ``i + 1`` with a differentiable
:func:`~distkeras_tpu_torch.parallel.collectives.ppermute`.  After
``microbatches + n_stages - 1`` ticks the last stage holds every
microbatch's output; autograd runs the reverse schedule.

Every rank makes every exchange in the same order, forward and
backward: a stage skips its compute on a bubble tick (it passes its
input on unchanged), never its send or receive, and stage 0 adds the
(zero) activation it receives to its input, so its backward posts the
same exchanges as its neighbours'.
"""

from __future__ import annotations

from typing import Callable

import torch

from distkeras_tpu_torch.parallel.collectives import (from_rank, ppermute,
                                                      reduce_from_group,
                                                      sum_over_group)
from distkeras_tpu_torch.parallel.rules import P, _axes_of
from distkeras_tpu_torch.parallel.tree import tree_leaves, tree_map


def _spec_axes(spec) -> set:
    return {a for dim in tuple(spec) for a in _axes_of(dim)}


def make_pipeline(stage_fn: Callable, mesh, microbatches: int,
                  axis_name: str = "pipeline", x_spec: P = P(),
                  extras_spec: P | None = None):
    """Build ``f(stage_params, x, extras=None) -> (y, aux)`` running
    ``stage_fn`` as a pipeline over ``mesh``'s ``axis_name`` axis.

    ``stage_params``: this rank's slice of a tree stacked ``[n_stages,
    ...]`` (leading axis 1: stage ``i`` holds slice ``i``).  This is
    where the port differs from the reference, which takes the whole
    stacked tree and lets ``P(axis_name)`` slice it: a rank here holds
    its own stage's parameters only.  ``x``: this rank's ``[B, ...]``
    rows (the same on every stage; stage 0 reads them), split into
    ``microbatches`` equal microbatches.  ``stage_fn(params, u) ->
    (u_out, aux)`` keeps ``u``'s shape and returns a scalar aux loss.

    ``extras`` (with ``extras_spec``): per-microbatch side data with
    leaves ``[microbatches, mb, ...]``, not piped: each stage indexes the
    microbatch it works on and gets ``stage_fn(params, u, extra)``.

    ``x_spec`` names the further mesh axes ``x`` is split over (``P(None,
    'seq')`` under sequence parallelism: ``x`` is then this rank's
    block, and ``stage_fn`` may run collectives over those axes); the
    aux loss, which differs over them, is averaged over them.

    Returns ``y`` (the last stage's outputs, the same on every stage)
    and ``aux`` (each stage's aux summed over stages and real
    microbatches, bubble ticks masked out, averaged over microbatches).
    """
    n_stages = int(mesh.shape[axis_name])
    extra_axes = _spec_axes(x_spec)
    if axis_name in extra_axes:
        raise ValueError(f"x_spec {x_spec} must not name the pipeline "
                         f"axis {axis_name!r}")
    if extras_spec is not None:
        extras_axes = _spec_axes(extras_spec)
        if axis_name in extras_axes:
            raise ValueError(
                f"extras_spec {extras_spec} must not name the pipeline "
                f"axis {axis_name!r} (extras are not piped stage to "
                "stage; every stage holds the whole array)")
        if not extras_axes <= extra_axes:
            raise ValueError(
                f"extras_spec {extras_spec} names axes "
                f"{sorted(extras_axes - extra_axes)} that x_spec "
                f"{x_spec} does not — activations must be manual over "
                "every axis the extras shard over")
    pipe = mesh.sub(axis_name)
    idx = pipe.rank
    last = n_stages - 1
    perm = [(i, i + 1) for i in range(n_stages - 1)]

    def apply(stage_params, x, extras=None):
        if (extras is not None) != (extras_spec is not None):
            raise ValueError(
                "extras and extras_spec must be provided together "
                f"(extras_spec={'set' if extras_spec is not None else None},"
                f" extras={'given' if extras is not None else None})")
        for leaf in tree_leaves(stage_params):
            if leaf.shape[0] != 1:
                raise ValueError(
                    f"stage_params leading axis must equal n_stages="
                    f"{n_stages} (got a shard of {leaf.shape[0]} — stack "
                    "exactly one param slice per pipeline stage)")
        local = tree_map(lambda a: a[0], stage_params)
        b = x.shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} not divisible into {microbatches} "
                             "microbatches")
        x_mb = x.reshape(microbatches, b // microbatches, *x.shape[1:])
        ticks = microbatches + n_stages - 1
        # Requiring grad, so that every tick's send is in the graph on
        # every stage (a bubble that passes these zeros on included), and
        # every rank's backward makes every exchange.
        recv = torch.zeros_like(x_mb[0]).requires_grad_(
            torch.is_grad_enabled())
        aux_acc = torch.zeros((), dtype=torch.float32, device=x.device)
        outputs = []
        for t in range(ticks):
            # Stage 0 receives from nobody: adding its zeros keeps its
            # receive in the graph, so its backward makes the exchange
            # its neighbour's does.
            inp = x_mb[min(t, microbatches - 1)] + recv if idx == 0 \
                else recv
            mb = t - idx
            if 0 <= mb < microbatches:
                if extras is not None:
                    extra = tree_map(lambda a: a[mb], extras)
                    out, aux = stage_fn(local, inp, extra)
                else:
                    out, aux = stage_fn(local, inp)
                aux_acc = aux_acc + aux.float()
            else:  # a bubble: no compute, the exchanges still run
                out = inp
            # The last stage finishes microbatch t - (n - 1) at tick t;
            # every stage collects the same ticks (the others' are not
            # read), so every rank's backward runs the same schedule.
            if t >= last:
                outputs.append(out)
            if t < ticks - 1:
                recv = ppermute(out, pipe, perm)
        for ax in sorted(extra_axes):
            sub = mesh.sub(ax)
            aux_acc = sum_over_group(aux_acc, sub) / sub.size
        y = from_rank(torch.cat(outputs), pipe, last)
        aux = reduce_from_group(aux_acc, pipe) / microbatches
        return y, aux

    return apply


__all__ = ["make_pipeline"]

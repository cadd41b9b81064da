"""The process group as a mesh: one process per device, one replica each.

Counterpart of ``distkeras_tpu/parallel/mesh.py``.  The reference builds
a ``jax.sharding.Mesh`` over every device the (multi-host) runtime sees
and lets XLA insert the collectives; the port runs one process per
device, joined by ``torch.distributed``.  The processes form a grid in
the reference's mesh order (``data`` major, then ``model``): rank ``r``
sits at ``np.unravel_index(r, shape)``, and each axis above 1 has one
sub-group per line of the grid (``dist.new_group``).  A :class:`Mesh`
keeps the data-parallel view the trainers were written against —
``group`` / ``rank`` / ``size`` are the ``data`` axis's — and
:meth:`Mesh.sub` gives the same view of any other axis, so the explicit
collectives (``parallel/collectives.py``) run over whichever axis a
caller names.

:func:`initialize_multihost` joins the group from the environment a
launcher sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``
/ ``MASTER_PORT``, or a ``file://`` ``init_method``).  The backend
follows the device: NCCL on ``cuda:LOCAL_RANK`` (the default), gloo when
the caller passes ``device="cpu"``; there is no silent switch from one
to the other, and no card without ``device="cpu"`` raises.

Every axis may exceed 1: ``model`` splits attention heads and FFN
columns (``parallel/layout.py``), ``pipeline`` the stacked layers into
stages (``parallel/pipeline.py``), ``seq`` the sequence for ring
attention (``parallel/ring.py``) and ``expert`` the MoE experts.  The
batch is split over ``data`` only, as ``P("data")`` places it in the
reference; the other axes' ranks hold the same rows.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

# Canonical axis names, in mesh order (the reference's).
AXES = ("data", "model", "pipeline", "seq", "expert")

# The timeout initialize_multihost gave the group; the axes' sub-groups
# take it too, so a mismatched exchange fails instead of hanging.
_GROUP_TIMEOUT = None

@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape; ``-1`` on ``data`` means every process."""

    data: int = -1
    model: int = 1
    pipeline: int = 1
    seq: int = 1
    expert: int = 1

    def resolve(self, n_devices: int) -> tuple[int, ...]:
        fixed = self.model * self.pipeline * self.seq * self.expert
        if n_devices % fixed:
            raise ValueError(
                f"{n_devices} devices not divisible by "
                f"model*pipeline*seq*expert={fixed}")
        data = self.data if self.data != -1 else n_devices // fixed
        total = data * fixed
        if total != n_devices:
            raise ValueError(
                f"MeshSpec {self} needs {total} devices, have {n_devices}")
        return (data, self.model, self.pipeline, self.seq, self.expert)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This process's place in the mesh: ``shape`` (every axis of
    :data:`AXES`), ``coords`` (its coordinate on each), ``groups`` (the
    sub-group of each axis above 1 that holds this process; None for a
    single process) and ``world`` (the whole grid's group).  ``group``
    / ``rank`` / ``size`` are the ``data`` axis's: the data-parallel
    exchange, the batch split and the per-rank state run over it."""

    shape: dict
    group: object = None
    rank: int = 0
    coords: dict = None
    groups: dict = None
    world: object = None

    @property
    def size(self) -> int:
        return int(self.shape["data"])

    @property
    def backend(self) -> str | None:
        return None if self.group is None else dist.get_backend(self.group)

    @property
    def world_size(self) -> int:
        return int(np.prod([int(v) for v in self.shape.values()]))

    def sub(self, axis: str) -> "Mesh":
        """The one-axis view of ``axis``: a mesh whose data axis is
        ``axis`` (its size, this process's coordinate, its sub-group),
        so every collective of ``parallel/collectives.py`` runs over
        it."""
        if axis == "data":
            return self
        n = int(self.shape[axis])
        return Mesh(shape=dict({a: 1 for a in AXES}, data=n),
                    group=(self.groups or {}).get(axis),
                    rank=int((self.coords or {}).get(axis, 0)))


    def whole(self) -> "Mesh":
        """The one-axis view of the whole grid (the world group)."""
        return Mesh(shape=dict({a: 1 for a in AXES}, data=self.world_size),
                    group=self.world if self.world_size > 1 else None,
                    rank=0 if self.world is None
                    else dist.get_rank(self.world))


def make_mesh(spec: MeshSpec | None = None, group=None) -> Mesh:
    """The mesh over ``group`` (default: the initialized default group,
    else this process alone).  Every process of the group must call it with the same ``spec``: an
    axis whose lines are not the whole group gets its sub-groups from
    ``dist.new_group``, a collective call."""
    spec = spec or MeshSpec()
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        world, rank = 1, 0
    else:
        world, rank = dist.get_world_size(group), dist.get_rank(group)
    dims = spec.resolve(world)
    shape = dict(zip(AXES, dims))
    coords = dict(zip(AXES, (int(c) for c in np.unravel_index(rank, dims))))
    groups = {}
    grid = np.arange(world).reshape(dims)
    for i, ax in enumerate(AXES):
        if dims[i] == 1 or group is None:
            continue
        if dims[i] == world:  # the whole group is this axis's one line
            groups[ax] = group
            continue
        lines = np.moveaxis(grid, i, -1).reshape(-1, dims[i])
        ranks = dist.get_process_group_ranks(group) \
            if group is not dist.group.WORLD else list(range(world))
        for line in lines:  # every process creates every line's group
            g = dist.new_group([ranks[int(r)] for r in line],
                               timeout=_GROUP_TIMEOUT)
            if rank in line:
                groups[ax] = g
    return Mesh(shape=shape, group=groups.get("data"), rank=coords["data"],
                coords=coords, groups=groups, world=group)


def mesh_axis_size(mesh, axis: str) -> int:
    return int(mesh.shape[axis])


def local_device_count() -> int:
    """Devices a process of the port trains on: one."""
    return 1


def initialize_multihost(init_method: str | None = None,
                         world_size: int | None = None,
                         rank: int | None = None,
                         local_rank: int | None = None, device=None,
                         backend: str | None = None,
                         timeout: float = 600.0) -> torch.device:
    """Join the process group; returns this process's device.

    ``world_size`` / ``rank`` / ``local_rank`` default to ``WORLD_SIZE``
    / ``RANK`` / ``LOCAL_RANK``; ``init_method`` to ``env://`` (which
    reads ``MASTER_ADDR`` / ``MASTER_PORT``).  ``device`` defaults to
    ``cuda:LOCAL_RANK`` (made the current device), with NCCL; with
    ``device="cpu"`` the backend is gloo.  ``backend="gloo"`` with a
    CUDA device is an explicit choice (ranks sharing one card, where
    NCCL refuses them); ``backend="nccl"`` with the CPU raises.
    """
    env = os.environ
    world_size = int(env.get("WORLD_SIZE", 1) if world_size is None
                     else world_size)
    rank = int(env.get("RANK", 0) if rank is None else rank)
    local_rank = int(env.get("LOCAL_RANK", rank) if local_rank is None
                     else local_rank)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: the port's ranks run on the "
                "GPU by default — pass device='cpu' (gloo) to run them on "
                "the CPU")
        device = torch.device("cuda", local_rank)
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("backend='nccl' needs a CUDA device; the CPU "
                         "ranks take gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    global _GROUP_TIMEOUT
    _GROUP_TIMEOUT = datetime.timedelta(seconds=timeout)
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=world_size, rank=rank,
        timeout=_GROUP_TIMEOUT)
    return device


def _world() -> tuple[object, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD, dist.get_world_size()
    return None, 1


def _backend_device(group):
    """Where a collective's host-side integers live for ``group``."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def equal_across_hosts(local_count: int, what: str) -> int:
    """Assert every process computed the same ``local_count``; returns
    it.  A process that would run more collective rounds than its peers
    deadlocks the group, so the imbalance raises on every process,
    before the loop.  No collective for a single process."""
    group, world = _world()
    if world == 1:
        return local_count
    dev = _backend_device(group)
    mine = torch.tensor([int(local_count)], dtype=torch.int64, device=dev)
    lo, hi = mine.clone(), mine.clone()
    dist.all_reduce(lo, dist.ReduceOp.MIN, group=group)
    dist.all_reduce(hi, dist.ReduceOp.MAX, group=group)
    if int(lo) != int(hi):
        raise ValueError(
            f"unequal {what} across processes: {int(lo)}..{int(hi)} — "
            "every process must contribute the same count or the "
            "collectives deadlock; pad or trim the per-process shards")
    return local_count


def per_host_rows(global_bs: int, what: str = "global batch") -> int:
    """Rows each process feeds per global batch: ``global_bs /
    world size``, validated to divide evenly."""
    _, world = _world()
    if global_bs % world:
        raise ValueError(
            f"{what} {global_bs} (batch_size x num_workers) must divide "
            f"by the process count ({world})")
    return global_bs // world


def global_batch(arr, mesh: Mesh, axis: int = 0):
    """This rank's rows of a global batch: ``arr`` split in order along
    ``axis`` into ``mesh.size`` equal blocks, block ``rank`` — where
    ``P("data")`` places the rows in the reference."""
    n = mesh.size
    if n == 1:
        return arr
    rows = arr.shape[axis]
    if rows % n:
        raise ValueError(f"global batch of {rows} rows does not split "
                         f"over {n} data-parallel ranks")
    b = rows // n
    idx = [slice(None)] * arr.ndim
    idx[axis] = slice(mesh.rank * b, (mesh.rank + 1) * b)
    return arr[tuple(idx)]


__all__ = ["AXES", "MeshSpec", "Mesh", "make_mesh", "mesh_axis_size",
           "local_device_count",
           "initialize_multihost", "equal_across_hosts", "per_host_rows",
           "global_batch"]

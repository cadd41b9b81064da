"""Checkpoint / resume for the port's trainers.

Counterpart of ``distkeras_tpu/checkpoint.py``.  The whole training
state (parameters, optimizer state, step counters, the dropout
generator's state — any tree of dicts, lists and tuples over tensors,
numpy arrays and Python values) is written under an integer step and
restored onto the template's devices and dtypes.

One backend, the reference's ``"pickle"`` layout:

- integer-named step directories, each holding ``state.pkl``, committed
  atomically (written into a hidden tmp dir, then ``os.replace``: a
  crash mid-write leaves no integer-named dir);
- a committed step is never overwritten, and ``max_to_keep`` garbage-
  collects the oldest steps;
- leaves are numpy host arrays (a bfloat16 tensor is written as float32,
  which holds it exactly), so ``resilience.cluster.step_is_valid`` — the
  ``pickletools.genops`` scan — is the same rule in both packages.

``backend="auto"`` means pickle.  ``"orbax"`` is a JAX library the port
never has; asking for it raises an ImportError that says so.

**Multi-process.**  In an initialized ``torch.distributed`` group every
rank calls ``save`` with the same full tree (the trainers gather their
ZeRO shards and per-rank state first, a collective on every rank); each
rank checks that the step is new, the ranks meet at a barrier, rank 0
writes, and a second barrier follows before any rank goes on: a step
that one rank sees committed is committed for all.  Every rank reads the
step back on ``restore`` and takes its own part of it.  The directory
must be shared by the ranks (one host, or a shared filesystem).

Every save passes the ``"checkpoint.save"`` chaos probe
(``resilience/chaos.py``), so a fault plan can make persistence fail the
way a flaky filesystem would.
"""

from __future__ import annotations

import os
import pickle
import shutil
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from distkeras_tpu_torch.resilience import chaos

BACKENDS = ("auto", "orbax", "pickle")


def group_rank() -> tuple[int, int]:
    """(rank, world size) of the initialized default group, or (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def to_host(tree):
    """The tree with every tensor as a numpy host array (bfloat16, which
    numpy lacks, as float32: exactly); containers keep their kind, other
    values pass through."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return tree


def place(template, loaded):
    """``loaded`` (host arrays) as tensors: each on its template leaf's
    device and dtype where the template holds a tensor there, else a
    CPU tensor of the stored dtype.  Containers follow ``loaded``."""
    if isinstance(loaded, dict):
        sub = template if isinstance(template, dict) else {}
        return {k: place(sub.get(k), v) for k, v in loaded.items()}
    if isinstance(loaded, (list, tuple)):
        sub = (template if isinstance(template, (list, tuple))
               and len(template) == len(loaded) else [None] * len(loaded))
        return type(loaded)(place(t, v) for t, v in zip(sub, loaded))
    if isinstance(loaded, np.ndarray):
        t = torch.from_numpy(np.array(loaded, copy=True))
        if isinstance(template, torch.Tensor):
            t = t.to(device=template.device, dtype=template.dtype)
        return t
    return loaded


class CheckpointManager:
    """Save / restore training-state trees under integer step numbers.

    ``restore`` takes a *template* tree — the live state, or ``None`` —
    and puts each restored leaf on the template leaf's device and dtype.
    ``backend``: ``"auto"`` / ``"pickle"`` (``"orbax"`` raises); the
    resolved choice is ``self.backend``.

    ``async_save`` is accepted in the reference's position, but every
    save is synchronous for now (ROADMAP A13): ``save`` returns once the
    step is committed, as the reference's own pickle backend does with
    either value.  ``self.async_save`` records what was asked.
    """

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1, async_save: bool = True,
                 backend: str = "auto"):
        if backend not in BACKENDS:
            raise ValueError(
                f"unknown checkpoint backend {backend!r}; known: {BACKENDS}")
        if backend == "orbax":
            raise ImportError(
                "checkpoint backend 'orbax' needs the orbax-checkpoint "
                "package, a JAX library the PyTorch port does not use; "
                "pass backend='pickle' (or leave backend='auto'), whose "
                "multi-process saves gather to rank 0")
        self.directory = os.path.abspath(directory)
        self.async_save = async_save
        self._impl = _PickleBackend(self.directory, max_to_keep=max_to_keep,
                                    save_interval_steps=save_interval_steps)
        self.backend = "pickle"

    # ------------------------------------------------------------------ ops

    def save(self, state: Any, step: int, force: bool = False) -> bool:
        """Persist ``state`` under ``step`` (synchronously).  Respects
        ``save_interval_steps`` unless ``force``.  Returns whether a
        save was made."""
        chaos.probe("checkpoint.save", step=step)
        return self._impl.save(state, step, force)

    def restore(self, template: Any = None, step: int | None = None) -> Any:
        """The checkpoint at ``step`` (default: latest), placed by
        ``template`` (see :func:`place`)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint found under {self.directory}")
        return self._impl.restore(template, step)

    def latest_step(self) -> int | None:
        return self._impl.latest_step()

    def all_steps(self) -> list[int]:
        return sorted(self._impl.all_steps())

    def valid_steps(self) -> list[int]:
        """Committed steps that pass
        :func:`~distkeras_tpu_torch.resilience.cluster.step_is_valid` (a
        host that died mid-save on a filesystem without atomic rename
        leaves a torn step that lists as committed); the trainers'
        restore and the cluster-consistent rule select from this set."""
        from distkeras_tpu_torch.resilience.cluster import valid_steps

        return valid_steps(self.directory)

    def latest_valid_step(self) -> int | None:
        """Newest valid step, scanning newest-first (the common case
        validates one payload)."""
        from distkeras_tpu_torch.resilience.cluster import latest_valid_step

        return latest_valid_step(self.directory)

    def wait_until_finished(self) -> None:
        """Saves are synchronous: nothing is outstanding."""

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _PickleBackend:
    """The reference's pickle layout (see the module docstring); in a
    process group rank 0 writes and every rank meets at a barrier."""

    def __init__(self, directory, *, max_to_keep, save_interval_steps):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        os.makedirs(directory, exist_ok=True)

    def save(self, state, step, force):
        if not force and self.save_interval_steps > 1 \
                and step % self.save_interval_steps:
            return False
        final = os.path.join(self.directory, str(step))
        if os.path.isdir(final):
            raise ValueError(
                f"checkpoint step {step} already exists under "
                f"{self.directory} (steps are immutable once committed)")
        rank, world = group_rank()
        if world > 1:
            # Rank 0 commits only once every rank has checked that the
            # step is new, so the refusal above is the same on every rank.
            dist.barrier()
        if rank == 0:
            host = to_host(state)
            tmp = os.path.join(self.directory, f".tmp.{step}.{os.getpid()}")
            os.makedirs(tmp, exist_ok=True)
            try:
                with open(os.path.join(tmp, "state.pkl"), "wb") as f:
                    pickle.dump(host, f, protocol=pickle.HIGHEST_PROTOCOL)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, final)  # the commit point
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            self._gc()
        if world > 1:
            dist.barrier()
        return True

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:max(0, len(steps) - self.max_to_keep)]:
            shutil.rmtree(os.path.join(self.directory, str(s)),
                          ignore_errors=True)

    def restore(self, template, step):
        path = os.path.join(self.directory, str(step), "state.pkl")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no checkpoint for step {step} under {self.directory}")
        with open(path, "rb") as f:
            loaded = pickle.load(f)
        return place(template, loaded)

    def latest_step(self):
        steps = self.all_steps()
        return max(steps) if steps else None

    def all_steps(self):
        if not os.path.isdir(self.directory):
            return []
        return [int(e) for e in os.listdir(self.directory) if e.isdigit()]


__all__ = ["CheckpointManager", "BACKENDS", "to_host", "place"]

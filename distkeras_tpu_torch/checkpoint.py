"""Checkpoint / resume for the port's trainers.

Counterpart of ``distkeras_tpu/checkpoint.py``.  The whole training
state (parameters, optimizer state, step counters, the dropout
generator's state — any tree of dicts, lists and tuples over tensors,
numpy arrays and Python values) is written under an integer step and
restored onto the template's devices and dtypes.

Two backends behind one :class:`CheckpointManager`, under the
reference's names:

- ``"orbax"`` (what ``"auto"``, the default, picks) — the reference's
  production role: sharded, asynchronous saves, in **the port's own
  format**.  The port has no orbax: it cannot read orbax's directories,
  and orbax cannot read these.  A step is a directory ``<step>/`` that
  holds one data file per rank, ``rank{r}.bin`` (raw little-endian
  bytes, the rank's pieces one after another; a bfloat16 leaf as its
  16-bit words under the name ``"bfloat16"``, so it restores bit-exact),
  and ``manifest.json``, written last by rank 0: the tree's structure
  and its Python values, and per tensor leaf its global shape and dtype
  and, for each piece, the rank, the slice of the leaf it covers and its
  bytes in that rank's file.  Each rank writes only its own pieces (a
  :class:`Piece` in the tree: a ZeRO shard, its slice of a placed leaf,
  its row of per-rank state); a tensor is a replicated leaf.  Every
  element is written once, by the lowest rank that holds it.  ``restore``
  assembles each leaf from its pieces; with ``lazy=True`` (the trainers'
  path) the leaves come back as :class:`StoredLeaf` handles, which read
  only the piece a rank asks for when the layout is the one saved.

  A save runs in two halves.  On the caller's thread: the interval check
  and the refusal of a committed step (on every rank), rank 0 clears a
  leftover ``.tmp.<step>/`` of a killed attempt, the ranks meet (an
  ``all_gather_object`` of their piece tables), and each rank copies its
  pieces to the host — so the next step may update the tensors in place
  as soon as ``save`` returns.  On the manager's writer thread: each rank
  writes its file, fsyncs it and renames it into ``.tmp.<step>/``;
  rank 0 waits until every rank's file is there, writes the manifest,
  fsyncs it and commits with one ``os.replace(".tmp.<step>", "<step>")``
  (then drops old steps down to ``max_to_keep``); the other ranks wait
  until ``<step>/`` exists, so a step that one rank sees committed is
  committed for all.  The writer makes no collective call: it coordinates
  through the directory alone, with a deadline (``COMMIT_TIMEOUT_S``).
  ``async_save=False`` runs the second half on the caller's thread.  A
  save made while an earlier one is in flight first waits for it;
  ``wait_until_finished`` (and ``close``) joins the writer and re-raises
  its error.  A failed write leaves no committed step.  The save rules
  are orbax's: the first save and ``force`` always save, a step at or
  below the latest is skipped, others on ``save_interval_steps``; a
  forced save of a committed step raises.
- ``"pickle"`` — the reference's single-file layout: integer-named step
  directories, each holding ``state.pkl`` (numpy host arrays; bfloat16
  as float32, which holds it exactly), committed atomically (a hidden tmp
  dir, then ``os.replace``), never overwritten, ``max_to_keep``
  collected.  Saves are synchronous.  In a process group every rank
  calls ``save`` with the same full tree (the trainers gather their ZeRO
  shards and per-rank state first, a collective), rank 0 writes between
  two barriers, and every rank reads the whole step back.

The directory must be shared by the ranks (one host, or a shared
filesystem).  Every save passes the ``"checkpoint.save"`` chaos probe
(``resilience/chaos.py``), so a fault plan can make persistence fail the
way a flaky filesystem would.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import shutil
import sys
import threading
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from distkeras_tpu_torch.resilience import chaos
from distkeras_tpu_torch.utils.locks import TracedLock

BACKENDS = ("auto", "orbax", "pickle")
# How long a writer waits for the other ranks' files (rank 0) or for the
# commit (the others) before it gives the save up.
COMMIT_TIMEOUT_S = 600.0
MANIFEST = "manifest.json"
_FORMAT = "distkeras_tpu_torch.sharded/1"
_DTYPES = {str(d).split(".")[1]: d for d in (
    torch.float64, torch.float32, torch.float16, torch.bfloat16,
    torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
    torch.bool)}


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


# ------------------------------------------------------ pieces and leaves


@dataclasses.dataclass(frozen=True)
class Piece:
    """This rank's piece of one leaf of the global state, for the
    sharded backend.  ``data`` holds, in row-major order, the part of a
    leaf of ``shape`` that ``index`` covers (a ``(start, stop)`` per
    dimension), or that ``flat`` covers: a ``(start, stop)`` range of the
    leaf permuted by ``perm`` and flattened (a ZeRO ``[cols]`` shard with
    its padding dropped)."""

    data: torch.Tensor
    shape: tuple
    index: tuple | None = None
    flat: tuple | None = None
    perm: tuple | None = None

    @classmethod
    def whole(cls, t: torch.Tensor) -> "Piece":
        return cls(t, tuple(t.shape), index=_full_index(t.shape))

    @classmethod
    def row(cls, t: torch.Tensor, rank: int, n: int) -> "Piece":
        """``t`` as row ``rank`` of an ``[n, *t.shape]`` leaf."""
        return cls(t[None], (n, *t.shape),
                   index=((rank, rank + 1),) + _full_index(t.shape))

    @property
    def where(self) -> dict:
        """The slice this piece covers, as the manifest records it."""
        if self.flat is not None:
            return {"flat": list(self.flat)}
        return {"index": [list(ab) for ab in self.index]}


def _full_index(shape) -> tuple:
    return tuple((0, int(s)) for s in shape)


def _cut(full: torch.Tensor, where: dict, perm) -> torch.Tensor:
    """The part of the whole leaf ``full`` that ``where`` covers."""
    if "flat" in where:
        a, b = where["flat"]
        src = full.permute(*perm) if perm else full
        return src.reshape(-1)[a:b]
    return full[tuple(slice(a, b) for a, b in where["index"])]


class StoredLeaf:
    """A tensor leaf of a committed sharded step, read on demand.

    ``full()`` assembles the whole leaf from its pieces (cached);
    ``read(where, perm)`` returns the part ``where`` covers — the one
    stored piece alone when a piece covers exactly that (the layout is
    the one saved), else cut out of the whole leaf."""

    def __init__(self, step_dir: str, spec: dict):
        self.step_dir = step_dir
        self.shape = tuple(spec["shape"])
        self.dtype = _DTYPES[spec["dtype"]]
        self.perm = tuple(spec["perm"]) if spec.get("perm") else None
        self.pieces = spec["pieces"]
        self._full = None

    def _load(self, p: dict) -> torch.Tensor:
        path = os.path.join(self.step_dir, f"rank{p['rank']}.bin")
        raw = np.fromfile(path, dtype=np.uint8, count=p["nbytes"],
                          offset=p["offset"])
        if raw.size != p["nbytes"]:
            raise ValueError(f"{path} is short: a torn checkpoint")
        t = torch.from_numpy(raw).view(self.dtype)
        if "flat" in p:
            return t
        return t.reshape([b - a for a, b in p["index"]])

    def full(self) -> torch.Tensor:
        if self._full is None:
            self._full = self._assemble()
        return self._full

    def _assemble(self) -> torch.Tensor:
        whole = [list(ab) for ab in _full_index(self.shape)]
        if len(self.pieces) == 1 and self.pieces[0].get("index") == whole:
            return self._load(self.pieces[0])
        if self.perm is None and all("index" in p for p in self.pieces):
            out = torch.zeros(self.shape, dtype=self.dtype)
            for p in self.pieces:
                out[tuple(slice(a, b) for a, b in p["index"])] = \
                    self._load(p)
            return out
        shape = (tuple(self.shape[d] for d in self.perm) if self.perm
                 else self.shape)
        flat = torch.zeros(int(np.prod(shape)), dtype=self.dtype)
        for p in self.pieces:
            a, b = p["flat"]
            flat[a:b] = self._load(p)
        out = flat.reshape(shape)
        if self.perm:
            out = out.permute(*np.argsort(self.perm).tolist()).contiguous()
        return out

    def read(self, where: dict, perm=None) -> torch.Tensor:
        if tuple(perm or ()) == tuple(self.perm or ()):
            for p in self.pieces:
                if p.get("flat") == where.get("flat") \
                        and p.get("index") == where.get("index"):
                    return self._load(p)
        return _cut(self.full(), where, perm)

    def row(self, rank: int) -> torch.Tensor:
        """Row ``rank`` of a stacked ``[n, ...]`` leaf."""
        where = {"index": [[rank, rank + 1]]
                 + [list(ab) for ab in _full_index(self.shape[1:])]}
        return self.read(where)[0]


# ------------------------------------------------------- the tree format


def _encode(tree, leaves: list):
    """The JSON skeleton of ``tree``; its tensor leaves (as pieces) are
    appended to ``leaves`` and named by position."""
    if isinstance(tree, dict):
        for k in tree:
            if isinstance(k, bool) or not isinstance(k, (str, int)):
                raise TypeError(f"checkpoint tree key {k!r}: only str and "
                                "int keys are stored")
        return {"dict": [[k, _encode(v, leaves)] for k, v in tree.items()]}
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return {kind: [_encode(v, leaves) for v in tree]}
    if isinstance(tree, (np.ndarray, np.generic)):
        tree = torch.from_numpy(np.asarray(tree))
    if isinstance(tree, torch.Tensor):
        tree = Piece.whole(tree.detach())
    if isinstance(tree, Piece):
        if str(tree.data.dtype).split(".")[1] not in _DTYPES:
            raise TypeError(f"checkpoint leaf dtype {tree.data.dtype} is "
                            "not stored")
        leaves.append(tree)
        return {"leaf": len(leaves) - 1}
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {"value": tree}
    raise TypeError(f"checkpoint leaf of type {type(tree).__name__} is "
                    "not stored")


def _decode(node, template, leaf):
    if "dict" in node:
        sub = template if isinstance(template, dict) else {}
        return {k: _decode(v, sub.get(k), leaf) for k, v in node["dict"]}
    for kind, cls in (("list", list), ("tuple", tuple)):
        if kind in node:
            items = node[kind]
            sub = (template if isinstance(template, (list, tuple))
                   and len(template) == len(items) else [None] * len(items))
            return cls(_decode(v, t, leaf) for v, t in zip(items, sub))
    if "leaf" in node:
        return leaf(node["leaf"], template)
    return node["value"]


def _describe(p: Piece) -> dict:
    return {"shape": [int(s) for s in p.shape],
            "dtype": str(p.data.dtype).split(".")[1],
            "perm": None if p.perm is None else [int(d) for d in p.perm],
            "where": p.where,
            "nbytes": p.data.numel() * p.data.element_size()}


def _assign(tables: list) -> tuple[list, list, list]:
    """Who writes what: each distinct piece of a leaf by the lowest rank
    holding it (a replicated leaf by rank 0), empty pieces by nobody.
    Returns (per rank the leaves it writes, per leaf its manifest pieces,
    per rank its file's bytes)."""
    n = len(tables[0])
    if any(len(t) != n for t in tables):
        raise ValueError("the ranks passed checkpoint trees of different "
                         f"sizes: {[len(t) for t in tables]} tensor leaves")
    writes = [[] for _ in tables]
    pieces = [[] for _ in range(n)]
    offsets = [0] * len(tables)
    for i in range(n):
        ref, seen = tables[0][i], set()
        for r, table in enumerate(tables):
            e = table[i]
            if (e["shape"], e["dtype"], e["perm"]) != (
                    ref["shape"], ref["dtype"], ref["perm"]):
                raise ValueError(
                    f"checkpoint leaf {i}: rank {r} holds {e['dtype']} "
                    f"{e['shape']}, rank 0 {ref['dtype']} {ref['shape']}")
            key = json.dumps(e["where"])
            if key in seen or not e["nbytes"]:
                continue
            seen.add(key)
            pieces[i].append(dict(e["where"], rank=r, offset=offsets[r],
                                  nbytes=e["nbytes"]))
            offsets[r] += e["nbytes"]
            writes[r].append(i)
    return writes, pieces, offsets


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` that a later in-place update cannot reach
    (from the card: a synchronous device-to-host copy)."""
    return t.detach().to("cpu", copy=True).contiguous()


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _await(ready, what: str, timeout: float) -> None:
    """Poll ``ready()`` until it holds; TimeoutError after ``timeout``."""
    deadline = time.monotonic() + timeout
    delay = 0.001
    while not ready():
        if time.monotonic() > deadline:
            raise TimeoutError(f"checkpoint: {what} within {timeout} s")
        time.sleep(delay)
        delay = min(2 * delay, 0.01)


def _failed(tmp: str) -> list:
    try:
        return [e for e in os.listdir(tmp) if e.startswith("FAILED.")]
    except OSError:
        return []


def read_manifest(step_dir: str) -> dict:
    """The parsed ``manifest.json`` of a sharded step."""
    with open(os.path.join(step_dir, MANIFEST), encoding="utf-8") as f:
        return json.load(f)


# ------------------------------------------------------------ the manager


class CheckpointManager:
    """Save / restore training-state trees under integer step numbers.

    ``restore`` takes a *template* tree — the live state, or ``None`` —
    and puts each restored leaf on the template leaf's device and dtype.
    ``backend``: ``"auto"`` / ``"orbax"`` (the sharded, asynchronous
    backend) or ``"pickle"`` (see the module docstring); the resolved
    choice is ``self.backend``.  ``async_save`` (the sharded backend's):
    ``save`` returns once this rank's pieces are on the host, and the
    write finishes on the manager's writer thread.
    """

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1, async_save: bool = True,
                 backend: str = "auto"):
        if backend not in BACKENDS:
            raise ValueError(
                f"unknown checkpoint backend {backend!r}; known: {BACKENDS}")
        self.directory = os.path.abspath(directory)
        self.async_save = async_save
        if backend == "pickle":
            self._impl = _PickleBackend(
                self.directory, max_to_keep=max_to_keep,
                save_interval_steps=save_interval_steps)
            self.backend = "pickle"
        else:
            self._impl = _ShardedBackend(
                self.directory, max_to_keep=max_to_keep,
                save_interval_steps=save_interval_steps,
                async_save=async_save)
            self.backend = "orbax"

    # ------------------------------------------------------------------ ops

    def save(self, state: Any, step: int, force: bool = False) -> bool:
        """Persist ``state`` under ``step``: synchronously (pickle), or
        returning once this rank's pieces are on the host (sharded,
        ``async_save``).  Respects ``save_interval_steps`` unless
        ``force``.  Returns whether a save was made."""
        chaos.probe("checkpoint.save", step=step)
        return self._impl.save(state, step, force)

    def restore(self, template: Any = None, step: int | None = None,
                lazy: bool = False) -> Any:
        """The checkpoint at ``step`` (default: latest), placed by
        ``template`` (see :func:`place`).  ``lazy`` (sharded steps): the
        tensor leaves as :class:`StoredLeaf` handles, read on demand."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint found under {self.directory}")
        return self._impl.restore(template, step, lazy)

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
        """Block until the save in flight is committed; re-raise its
        error."""
        self._impl.wait_until_finished()

    def close(self) -> None:
        self._impl.wait_until_finished()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _StepDirs:
    """Integer-named step directories under one root, and ``max_to_keep``."""

    def __init__(self, directory, *, max_to_keep, save_interval_steps):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        os.makedirs(directory, exist_ok=True)

    def _refuse_committed(self, step):
        final = os.path.join(self.directory, str(step))
        if os.path.isdir(final):
            raise ValueError(
                f"checkpoint step {step} already exists under "
                f"{self.directory} (steps are immutable once committed)")
        return final

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:max(0, len(steps) - self.max_to_keep)]:
            shutil.rmtree(os.path.join(self.directory, str(s)),
                          ignore_errors=True)

    def latest_step(self):
        steps = self.all_steps()
        return max(steps) if steps else None

    def all_steps(self):
        if not os.path.isdir(self.directory):
            return []
        return [int(e) for e in os.listdir(self.directory) if e.isdigit()]

    def wait_until_finished(self):
        pass


class _ShardedBackend(_StepDirs):
    """The sharded, asynchronous layout (see the module docstring)."""

    def __init__(self, directory, *, max_to_keep, save_interval_steps,
                 async_save):
        if sys.byteorder != "little":  # pragma: no cover
            raise RuntimeError("the sharded checkpoint layout is "
                               "little-endian; this host is not")
        super().__init__(directory, max_to_keep=max_to_keep,
                         save_interval_steps=save_interval_steps)
        self.async_save = async_save
        self._lock = TracedLock("checkpoint.writer")
        self._thread = None
        self._error = None

    def _should_save(self, step, force):
        if force:
            return True
        latest = self.latest_step()
        if latest is None:
            return True
        return step > latest and step % self.save_interval_steps == 0

    def save(self, state, step, force):
        self.wait_until_finished()  # one save in flight at a time
        if not self._should_save(step, force):
            return False
        final = self._refuse_committed(step)
        rank, world = group_rank()
        leaves: list = []
        skeleton = _encode(state, leaves)
        table = [_describe(p) for p in leaves]
        tmp = os.path.join(self.directory, f".tmp.{step}")
        if rank == 0:  # what a killed attempt left
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        tables = [table]
        if world > 1:
            # The barrier: every rank has refused or not alike, and the
            # tmp dir exists before any rank writes into it.
            tables = [None] * world
            dist.all_gather_object(tables, table)
        writes, pieces, sizes = _assign(tables)
        host = [_host_copy(leaves[i].data) for i in writes[rank]]
        manifest = None
        if rank == 0:
            manifest = {
                "format": _FORMAT, "step": step, "tree": skeleton,
                "leaves": [{"shape": e["shape"], "dtype": e["dtype"],
                            "perm": e["perm"], "pieces": ps}
                           for e, ps in zip(table, pieces)],
                "files": [{"name": f"rank{r}.bin", "nbytes": n}
                          for r, n in enumerate(sizes)]}
        args = (tmp, final, rank, world, host, manifest)
        if not self.async_save:
            self._write(*args)
            return True
        thread = threading.Thread(target=self._run, args=args,
                                  name="dkt-ckpt-writer", daemon=True)
        with self._lock:
            self._thread = thread
        thread.start()
        return True

    def _run(self, *args):
        try:
            self._write(*args)
        except BaseException as e:  # noqa: BLE001 — re-raised on wait
            with self._lock:
                self._error = e

    def _write(self, tmp, final, rank, world, host, manifest):
        """The second half of a save (see the module docstring)."""
        try:
            part = os.path.join(tmp, f"rank{rank}.bin.part")
            with open(part, "wb") as f:
                for t in host:
                    f.write(t.reshape(-1).view(torch.uint8).numpy())
                f.flush()
                os.fsync(f.fileno())
            os.replace(part, os.path.join(tmp, f"rank{rank}.bin"))
            if rank == 0:
                names = [os.path.join(tmp, f"rank{r}.bin")
                         for r in range(world)]
                _await(lambda: _failed(tmp) or all(
                    os.path.exists(n) for n in names),
                    "every rank's file", COMMIT_TIMEOUT_S)
                if _failed(tmp):
                    raise RuntimeError(f"checkpoint {final}: a rank failed "
                                       f"its write ({_failed(tmp)})")
                with open(os.path.join(tmp, MANIFEST), "w",
                          encoding="utf-8") as f:
                    json.dump(manifest, f)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, final)  # the commit point
                _fsync_dir(self.directory)
                self._gc()
            else:
                _await(lambda: os.path.isdir(final)
                       or not os.path.isdir(tmp) or _failed(tmp),
                       "rank 0's commit", COMMIT_TIMEOUT_S)
                if not os.path.isdir(final):
                    raise RuntimeError(f"checkpoint {final} was not "
                                       "committed: another rank failed")
        except BaseException:
            if rank == 0:
                shutil.rmtree(tmp, ignore_errors=True)
            else:  # tell rank 0, which removes the tmp dir
                try:
                    open(os.path.join(tmp, f"FAILED.rank{rank}"), "w").close()
                except OSError:
                    pass
            raise

    def wait_until_finished(self):
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join()
        with self._lock:
            error, self._error = self._error, None
        if error is not None:
            raise error

    def restore(self, template, step, lazy):
        return _restore_step(self.directory, template, step, lazy)


class _PickleBackend(_StepDirs):
    """The reference's pickle layout (see the module docstring); in a
    process group rank 0 writes and every rank meets at a barrier."""

    def save(self, state, step, force):
        if not force and self.save_interval_steps > 1 \
                and step % self.save_interval_steps:
            return False
        final = self._refuse_committed(step)
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

    def restore(self, template, step, lazy):
        return _restore_step(self.directory, template, step, lazy)


def _restore_step(directory, template, step, lazy):
    """Step ``step`` under ``directory``, in whichever layout it was
    written (either backend reads both)."""
    step_dir = os.path.join(directory, str(step))
    pkl = os.path.join(step_dir, "state.pkl")
    if os.path.exists(pkl):
        with open(pkl, "rb") as f:
            return place(template, pickle.load(f))
    if not os.path.exists(os.path.join(step_dir, MANIFEST)):
        raise FileNotFoundError(
            f"no checkpoint for step {step} under {directory}")
    manifest = read_manifest(step_dir)
    stored = [StoredLeaf(step_dir, s) for s in manifest["leaves"]]

    def leaf(i, t):
        if lazy:
            return stored[i]
        x = stored[i].full()
        if isinstance(t, torch.Tensor):
            x = x.to(device=t.device, dtype=t.dtype)
        return x

    return _decode(manifest["tree"], template, leaf)


__all__ = ["CheckpointManager", "BACKENDS", "Piece", "StoredLeaf",
           "read_manifest", "to_host", "place"]

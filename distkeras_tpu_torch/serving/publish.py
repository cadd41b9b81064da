"""Versioned weight snapshots: the trainer -> serving-fleet transport.

The port's copy of ``distkeras_tpu/serving/publish.py``, file for file
the reference's format: a snapshot written by either package loads in
the other.  ``serving/canary.py`` is the rollout policy on top.

* **Snapshots are fusion buckets.**  The parameter tree packs through
  the dtype-grouped bucket layout of the gradient exchange
  (:class:`~distkeras_tpu_torch.parallel.collectives.Zero1Layout` with
  ``n=1``), leaves in JAX's order (sorted dict keys), so the optional
  ``int8`` coding is the exchange layer's symmetric per-row
  quantization.  Packing runs on host copies of the leaves.
* **A reader never adopts a partial publish.**  Bucket files land first;
  the manifest (per-bucket CRCs and a SHA-256 over its own body) is
  written last via tmp + ``os.replace``, and the ``LATEST`` pointer after
  that (``chaos.probe("publish.commit")`` sits right before the manifest
  rename).  A torn version directory raises :class:`SnapshotCorrupt`.
* **Versions are monotone.**  A reader declines anything at or below the
  version it last adopted (:class:`StaleSnapshot`).

bfloat16 without ``ml_dtypes``: a bf16 bucket is written as its raw
16-bit words (the bytes the reference writes) and named ``"bfloat16"``
in the manifest; the reader views the words back as ``torch.bfloat16``.

Locking: ``serving.publish`` (a leaf lock) serializes one publisher's
publishes.
"""

from __future__ import annotations

import hashlib
import json
import os
import zipfile
import zlib

import numpy as np
import torch

from distkeras_tpu_torch import obs
from distkeras_tpu_torch.parallel.collectives import (DEFAULT_BUCKET_MB,
                                                      Zero1Layout)
from distkeras_tpu_torch.parallel.tree import tree_flatten, tree_unflatten
from distkeras_tpu_torch.resilience import chaos
from distkeras_tpu_torch.utils.locks import TracedLock
from distkeras_tpu_torch.utils.serialization import (dtype_name, from_words,
                                                     host_words, words_dtype)

__all__ = [
    "SnapshotPublisher", "SnapshotReader",
    "SnapshotError", "SnapshotCorrupt", "StaleSnapshot",
]

_MANIFEST = "MANIFEST.json"
_LATEST = "LATEST"
# Matches parallel/exchange.py's int8 zero-scale guard.
_EPS = np.float32(1.1754944e-38)


class SnapshotError(RuntimeError):
    """Base error for snapshot publish/load failures."""


class SnapshotCorrupt(SnapshotError):
    """Torn or corrupt snapshot: missing manifest, manifest-hash
    mismatch, or a bucket whose checksum does not match.  Never
    adopted — the reader stays on its current version."""


class StaleSnapshot(SnapshotError):
    """Snapshot version ≤ the reader's adopted version."""


def _version_dir(root: str, version: int) -> str:
    return os.path.join(root, f"v{int(version):08d}")


def _torch_dtype(name: str) -> torch.dtype:
    """The torch dtype a manifest names (``"bfloat16"`` included)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"unknown snapshot dtype {name!r}")
    return dt


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def _manifest_hash(body: dict) -> str:
    blob = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def _int8_encode(x: np.ndarray):
    """Numpy spelling of ``parallel.exchange.int8_encode``: symmetric
    per-row quantization over the last axis."""
    xf = np.asarray(x, dtype=np.float32)
    scale = np.max(np.abs(xf), axis=-1, keepdims=True) / 127.0
    scale = np.maximum(scale, _EPS).astype(np.float32)
    q = np.clip(np.rint(xf / scale), -127, 127).astype(np.int8)
    return q, scale


class SnapshotPublisher:
    """Trainer-side writer of versioned parameter snapshots.

    ``root`` is the snapshot directory (one subdirectory per version);
    ``coding`` is ``None`` (raw buckets) or ``"int8"`` (the exchange
    layer's symmetric per-row int8 on floating buckets — lossy, the
    serving-side weights are the dequantized values); ``bucket_mb``
    must match what readers rebuild, so it is recorded in the manifest.
    """

    def __init__(self, root: str, coding: str | None = None,
                 bucket_mb: float = DEFAULT_BUCKET_MB):
        if coding not in (None, "int8"):
            raise ValueError(
                f"unknown snapshot coding {coding!r}; known: None, 'int8'")
        self.root = str(root)
        self.coding = coding
        self.bucket_mb = float(bucket_mb)
        self._lock = TracedLock("serving.publish")
        self._layout: Zero1Layout | None = None
        self.published = 0
        os.makedirs(self.root, exist_ok=True)

    # ------------------------------------------------------------ pack

    def _layout_for(self, leaves, spec) -> Zero1Layout:
        # Layout is geometry-only; cache it across rounds (every round
        # publishes the same tree geometry).
        lay = self._layout
        if (lay is None or lay.spec != spec
                or any(tuple(x.shape) != s.shape or x.dtype != s.dtype
                       for s, x in zip(lay.slots, leaves))):
            lay = Zero1Layout.for_tree(list(leaves), n=1,
                                       bucket_mb=self.bucket_mb)
            self._layout = lay
        return lay

    @staticmethod
    def _pack(layout: Zero1Layout, leaves) -> list[torch.Tensor]:
        """``Zero1Layout.pack`` for ``n=1`` (cols == size, zero pad) into
        host buckets; each leaf crosses to the host once."""
        buckets = [torch.zeros((1, c), dtype=d)
                   for c, d in zip(layout.bucket_cols,
                                   layout.bucket_dtypes)]
        for slot, leaf in zip(layout.slots, leaves):
            flat = leaf.detach().reshape(-1).cpu()
            buckets[slot.bucket][0, slot.offset:slot.offset + slot.cols] \
                = flat
        return buckets

    # --------------------------------------------------------- publish

    def publish(self, tree, version: int) -> str:
        """Write ``tree`` as snapshot ``version``; returns the snapshot
        directory.  Atomic from any reader's point of view: bucket
        files first, manifest via tmp + ``os.replace`` second, the
        ``LATEST`` pointer last."""
        version = int(version)
        with obs.held(self._lock):
            leaves, spec = tree_flatten(tree)
            leaves = [_tensor(x) for x in leaves]
            layout = self._layout_for(leaves, spec)
            buckets = self._pack(layout, leaves)
            vdir = _version_dir(self.root, version)
            os.makedirs(vdir, exist_ok=True)
            entries, total = [], 0
            for i, bucket in enumerate(buckets):
                fname = f"bucket_{i:04d}.npz"
                coded = (self.coding
                         if self.coding and bucket.dtype.is_floating_point
                         else None)
                if coded == "int8":
                    q, scale = _int8_encode(bucket.float().numpy())
                    payload = {"q": q, "scale": scale}
                    crc = zlib.crc32(scale.tobytes(),
                                     zlib.crc32(q.tobytes()))
                    nbytes = q.nbytes + scale.nbytes
                else:
                    raw = np.frombuffer(host_words(bucket).tobytes(),
                                        dtype=np.uint8)
                    payload = {"raw": raw}
                    crc = zlib.crc32(raw.tobytes())
                    nbytes = raw.nbytes
                np.savez(os.path.join(vdir, fname), **payload)
                entries.append({
                    "file": fname, "crc": int(crc),
                    "dtype": dtype_name(bucket.dtype),
                    "cols": int(bucket.shape[1]), "coding": coded,
                })
                total += nbytes
            body = {"version": version, "bucket_mb": self.bucket_mb,
                    "n_leaves": len(leaves), "buckets": entries}
            manifest = dict(body, manifest_hash=_manifest_hash(body))
            # The commit point: everything before this line is
            # invisible to readers; everything after is atomic.  A
            # publisher killed here leaves a torn version directory:
            # buckets but no manifest.
            chaos.probe("publish.commit", step=version)
            tmp = os.path.join(vdir, _MANIFEST + ".tmp")
            with open(tmp, "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(vdir, _MANIFEST))
            ltmp = os.path.join(self.root, _LATEST + ".tmp")
            with open(ltmp, "w") as f:
                f.write(str(version))
                f.flush()
                os.fsync(f.fileno())
            os.replace(ltmp, os.path.join(self.root, _LATEST))
            self.published += 1
            obs.count("publish.snapshots")
            obs.event("publish.commit", version=version,
                      buckets=len(entries), bytes=total,
                      coding=self.coding)
            return vdir


class SnapshotReader:
    """Engine-side loader of published snapshots.

    Tracks the last *adopted* version; :meth:`poll` surfaces only a
    strictly newer, fully verified snapshot.  Verification order:
    manifest present -> manifest hash -> per-bucket CRC -> geometry
    against the caller's template pytree.  Any failure raises
    :class:`SnapshotCorrupt` (counted as ``publish.torn``) and leaves
    the adopted version untouched.
    """

    def __init__(self, root: str):
        self.root = str(root)
        self.version = 0  # last adopted version; 0 = none yet

    # ----------------------------------------------------------- state

    def latest_version(self) -> int | None:
        """The publisher's ``LATEST`` pointer, or ``None`` before the
        first complete publish."""
        try:
            with open(os.path.join(self.root, _LATEST)) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return None

    def adopt(self, version: int) -> None:
        """Record ``version`` as adopted (the caller swapped it into
        an engine); later polls only surface strictly newer ones."""
        self.version = max(self.version, int(version))
        obs.event("publish.adopt", version=int(version))

    # ------------------------------------------------------------ load

    def _manifest(self, version: int) -> dict:
        path = os.path.join(_version_dir(self.root, version), _MANIFEST)
        try:
            with open(path) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            obs.count("publish.torn")
            raise SnapshotCorrupt(
                f"snapshot v{version}: no readable manifest at {path} "
                f"({e}) — torn publish, not adopting") from e
        body = {k: v for k, v in manifest.items() if k != "manifest_hash"}
        if manifest.get("manifest_hash") != _manifest_hash(body):
            obs.count("publish.torn")
            raise SnapshotCorrupt(
                f"snapshot v{version}: manifest hash mismatch — torn or "
                "tampered publish, not adopting")
        return manifest

    def load(self, version: int, template):
        """Verify and decode snapshot ``version`` into the geometry of
        ``template`` (a tree of tensors, or of anything with ``shape``,
        ``dtype`` and ``device``); returns a tree of tensors on the
        template's device.  Does NOT mark the version adopted — callers
        adopt only after the swap lands (see ``CanaryController``)."""
        version = int(version)
        if version <= self.version:
            obs.count("publish.stale")
            raise StaleSnapshot(
                f"snapshot v{version} ≤ adopted v{self.version}")
        manifest = self._manifest(version)
        leaves, spec = tree_flatten(template)
        device = leaves[0].device if leaves else torch.device("cpu")
        layout = Zero1Layout.for_tree(
            list(leaves), n=1,
            bucket_mb=float(manifest.get("bucket_mb", DEFAULT_BUCKET_MB)))
        entries = manifest["buckets"]
        if (len(entries) != len(layout.bucket_cols)
                or manifest.get("n_leaves") != len(leaves)):
            obs.count("publish.torn")
            raise SnapshotCorrupt(
                f"snapshot v{version}: {len(entries)} buckets /"
                f" {manifest.get('n_leaves')} leaves do not match the"
                f" template layout ({len(layout.bucket_cols)} buckets /"
                f" {len(leaves)} leaves)")
        vdir = _version_dir(self.root, version)
        buckets: list[torch.Tensor] = []
        for i, ent in enumerate(entries):
            cols = int(ent["cols"])
            try:
                dtype = _torch_dtype(ent["dtype"])
            except TypeError as e:
                obs.count("publish.torn")
                raise SnapshotCorrupt(
                    f"snapshot v{version} bucket {i}: {e}") from e
            if (cols != layout.bucket_cols[i]
                    or dtype != layout.bucket_dtypes[i]):
                obs.count("publish.torn")
                raise SnapshotCorrupt(
                    f"snapshot v{version} bucket {i}: "
                    f"[{ent['dtype']} x {cols}] does not match template "
                    f"[{dtype_name(layout.bucket_dtypes[i])} x "
                    f"{layout.bucket_cols[i]}]")
            try:
                with np.load(os.path.join(vdir, ent["file"])) as z:
                    payload = {k: z[k] for k in z.files}
            except (OSError, ValueError, KeyError, zlib.error,
                    zipfile.BadZipFile) as e:
                obs.count("publish.torn")
                raise SnapshotCorrupt(
                    f"snapshot v{version}: bucket file {ent['file']} "
                    f"unreadable ({e})") from e
            if ent.get("coding") == "int8":
                q, scale = payload["q"], payload["scale"]
                crc = zlib.crc32(scale.tobytes(),
                                 zlib.crc32(q.tobytes()))
                bucket = torch.from_numpy(
                    q.astype(np.float32) * scale).to(dtype)
            else:
                raw = payload["raw"]
                crc = zlib.crc32(raw.tobytes())
                try:
                    bucket = from_words(np.frombuffer(
                        raw.tobytes(), words_dtype(dtype)), dtype).reshape(
                            1, cols)
                except (ValueError, RuntimeError) as e:
                    obs.count("publish.torn")
                    raise SnapshotCorrupt(
                        f"snapshot v{version} bucket {i}: payload of "
                        f"{raw.nbytes} bytes is not [{ent['dtype']} x "
                        f"{cols}]") from e
            if int(crc) != int(ent["crc"]):
                obs.count("publish.torn")
                raise SnapshotCorrupt(
                    f"snapshot v{version} bucket {i} ({ent['file']}): "
                    f"checksum mismatch (manifest {ent['crc']}, "
                    f"payload {crc}) — not adopting")
            buckets.append(bucket.to(device))
        out = []
        for s in layout.slots:
            flat = buckets[s.bucket][0, s.offset:s.offset + s.cols]
            out.append(flat[:s.size].reshape(s.shape))
        return tree_unflatten(spec, out)

    def poll(self, template):
        """``(version, tree)`` for the newest fully-verified snapshot
        strictly above the adopted version, else ``None``.  Raises
        :class:`SnapshotCorrupt` if the newest snapshot is torn — the
        caller decides whether to abort or retry."""
        latest = self.latest_version()
        if latest is None or latest <= self.version:
            return None
        return latest, self.load(latest, template)

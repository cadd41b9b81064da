"""Disaggregated prefill/decode: the block-shipping wire format.

The port's copy of ``distkeras_tpu/serving/disagg.py``.  A
prefill-specialized replica builds a prompt's KV as paged BLOCKS on its
slab and SHIPS them to a decode-specialized replica, which adopts them by
page-table splice (:meth:`~distkeras_tpu_torch.serving.paged.PagedBatcher.
import_blocks` pins the run through the ordinary :class:`PinnedStems`
refcount path).  A shipped block carries the chain digest the residency
digest advertises, so the decode side hash-hits blocks it already holds
and the router skips transfers for warm stems entirely.

This module is the WIRE half: plain numpy and the stdlib, no torch (the
router imports it).  Wire format (version 1), byte for byte the
reference's::

    [4-byte LE header length][JSON header][raw leaf payload]

The JSON header carries the block size, the chain digests (hex), and one
(dtype NAME, shape) spec per slab leaf; the payload is the blocks' leaf
buffers concatenated blocks-major, leaves-minor, in JAX's leaf order of
the slab (sorted cache keys: ``k``, ``k_scale``, ``v``, ``v_scale``).
int8 (``kv_int8``) blocks ride as they are: quantized values and their
scale leaves are just more leaves.

bfloat16 without ``ml_dtypes``: numpy cannot spell it, so a bf16 leaf
travels as its raw 16-bit words (a ``uint16`` array) and the shipment
names it ``"bfloat16"`` in :attr:`BlockShipment.dtypes`; the importer
views the words back as ``torch.bfloat16``.  The header says
``"bfloat16"`` exactly as the reference's does.
"""

from __future__ import annotations

import dataclasses
import json
import struct

import numpy as np

_MAGIC = "dkt-blocks"
_VERSION = 1


# Dtype names numpy cannot spell, and the raw words that carry them.
_RAW_WORDS = {"bfloat16": np.dtype(np.uint16)}


def _np_dtype(name: str) -> np.dtype:
    """The numpy dtype a leaf named ``name`` is carried in: the dtype
    itself, or the raw words of one numpy cannot spell (bfloat16)."""
    if name in _RAW_WORDS:
        return _RAW_WORDS[name]
    return np.dtype(name)


@dataclasses.dataclass(frozen=True)
class BlockShipment:
    """A host-side run of exported KV blocks, ready to ship.

    ``block``: positions per block (must match the importer's slab).
    ``hashes``: the chain digest of each block — position-dependent
    content identity, in stem order (block k's digest covers tokens
    ``[0, (k+1)*block)``).  ``blocks[k]`` is block k's slab content:
    one numpy array per slab leaf (JAX's leaf order), each shaped like
    the leaf with the block axis sliced to 1.  ``dtypes``: the leaves'
    dtype names when an array's own dtype does not say it (a bf16 leaf
    carried as ``uint16`` words); empty means "read them off the
    arrays".
    """

    block: int
    hashes: tuple
    blocks: tuple
    dtypes: tuple = ()

    def __post_init__(self):
        if len(self.hashes) != len(self.blocks):
            raise ValueError(
                f"shipment carries {len(self.hashes)} digests but "
                f"{len(self.blocks)} block payloads")

    def __len__(self) -> int:
        return len(self.blocks)

    @property
    def span(self) -> int:
        """Token positions the shipment covers (always full blocks)."""
        return len(self.blocks) * self.block

    @property
    def nbytes(self) -> int:
        """Payload bytes (the transfer-budget number the obs counters
        report — header overhead excluded on purpose: it is O(leaves),
        not O(tokens))."""
        return sum(a.nbytes for leaves in self.blocks for a in leaves)

    def hexes(self) -> list:
        """Digests in the JSON-safe hex spelling the router's affinity
        table stores."""
        return [h.hex() for h in self.hashes]


def leaf_dtype_names(shipment) -> tuple:
    """A shipment's leaf dtype names: its ``dtypes`` when it carries them,
    else the arrays' own (any object with ``blocks`` encodes, the
    reference's shipments included)."""
    names = getattr(shipment, "dtypes", ())
    if names:
        return tuple(names)
    return tuple(a.dtype.name for a in shipment.blocks[0])


def encode_shipment(shipment: BlockShipment) -> bytes:
    """Serialize a shipment for the ``/blocks`` POST body."""
    if not shipment.blocks:
        raise ValueError("refusing to encode an empty shipment")
    leaves0 = shipment.blocks[0]
    header = {
        "magic": _MAGIC,
        "version": _VERSION,
        "block": int(shipment.block),
        "hashes": shipment.hexes(),
        "leaves": [{"dtype": name, "shape": list(a.shape)}
                   for name, a in zip(leaf_dtype_names(shipment), leaves0)],
    }
    payload = []
    for leaves in shipment.blocks:
        if len(leaves) != len(leaves0):
            raise ValueError("ragged shipment: blocks disagree on "
                             "leaf count")
        for a, spec in zip(leaves, leaves0):
            if a.shape != spec.shape or a.dtype != spec.dtype:
                raise ValueError("ragged shipment: blocks disagree "
                                 "on leaf avals")
            payload.append(np.ascontiguousarray(a).tobytes())
    hb = json.dumps(header).encode()
    return struct.pack("<I", len(hb)) + hb + b"".join(payload)


def decode_shipment(data: bytes) -> BlockShipment:
    """Parse :func:`encode_shipment` output back into a
    :class:`BlockShipment`.  Raises ``ValueError`` on anything
    malformed — truncation, bad magic, payload/spec size mismatch —
    so a torn transfer can never half-adopt."""
    if len(data) < 4:
        raise ValueError("shipment truncated before header length")
    (hlen,) = struct.unpack_from("<I", data)
    if len(data) < 4 + hlen:
        raise ValueError("shipment truncated inside header")
    try:
        header = json.loads(data[4:4 + hlen].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"shipment header is not JSON: {e}") from e
    if header.get("magic") != _MAGIC:
        raise ValueError("not a block shipment (bad magic)")
    if header.get("version") != _VERSION:
        raise ValueError(
            f"unsupported shipment version {header.get('version')!r}")
    names = tuple(str(s["dtype"]) for s in header["leaves"])
    try:
        specs = [(_np_dtype(name), tuple(s["shape"]))
                 for name, s in zip(names, header["leaves"])]
    except TypeError as e:
        raise ValueError(f"shipment names an unknown dtype: {e}") from e
    hashes = tuple(bytes.fromhex(h) for h in header["hashes"])
    per_block = sum(dt.itemsize * int(np.prod(shape, dtype=np.int64))
                    for dt, shape in specs)
    off = 4 + hlen
    if len(data) - off != per_block * len(hashes):
        raise ValueError(
            f"shipment payload is {len(data) - off} bytes; header "
            f"promises {per_block * len(hashes)}")
    blocks = []
    for _ in hashes:
        leaves = []
        for dt, shape in specs:
            n = dt.itemsize * int(np.prod(shape, dtype=np.int64))
            leaves.append(np.frombuffer(data[off:off + n], dtype=dt)
                          .reshape(shape))
            off += n
        blocks.append(tuple(leaves))
    return BlockShipment(block=int(header["block"]), hashes=hashes,
                         blocks=tuple(blocks), dtypes=names)


__all__ = ["BlockShipment", "encode_shipment", "decode_shipment"]

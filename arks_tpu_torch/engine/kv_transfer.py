"""The AKV1 wire format of prefill/decode disaggregation and of prefix
blocks (the port's copy of ``arks_tpu/engine/kv_transfer.py``).

Layout: ``AKV1 | u32 header_len | header JSON | tensor bytes...``; the
header is ``{"meta": ..., "tensors": [{"dtype", "shape"}]}`` and the
tensor bytes are the raw buffers, concatenated in header order.  The bytes
equal the reference's for the same inputs (the header is ``json.dumps``
with its default separators, the dtype strings are numpy's names), so a
reference peer and a port peer read each other's messages:

- a decode server pulls a prompt's K/V from its prefill server;
- a replica serves a prefix block to a peer (``GET /v1/cache/blocks/``);
- the disk prefix tier keeps one block a file.

Tensors are CPU ``torch`` tensors; ``pack`` also takes numpy arrays.  The
card's machine has no ``ml_dtypes``, so bfloat16 is spelled here rather
than through numpy, and ``unpack`` builds tensors from the raw bytes with
``torch.frombuffer`` over a copy (the received buffer is read-only).
"""

from __future__ import annotations

import json
import struct
from typing import Any

import numpy as np
import torch

MAGIC = b"AKV1"

# torch dtype <-> the dtype string numpy prints for it.
_NAMES = {torch.float32: "float32", torch.float16: "float16",
          torch.bfloat16: "bfloat16", torch.float64: "float64",
          torch.int8: "int8", torch.uint8: "uint8", torch.int16: "int16",
          torch.int32: "int32", torch.int64: "int64", torch.bool: "bool"}
_DTYPES = {name: dt for dt, name in _NAMES.items()}


def _spec_bytes(t) -> tuple[str, list[int], bytes]:
    """(dtype string, shape, raw bytes) of a CPU tensor or numpy array."""
    if isinstance(t, torch.Tensor):
        if t.device.type != "cpu":
            raise ValueError("kv_transfer packs host tensors only")
        c = t.contiguous()
        raw = (c.reshape(-1).view(torch.uint8).numpy().tobytes()
               if c.numel() else b"")
        return _NAMES[c.dtype], list(c.shape), raw
    a = np.ascontiguousarray(t)
    return str(a.dtype), list(a.shape), a.tobytes()


def pack(meta: dict[str, Any], tensors: list) -> bytes:
    specs = [_spec_bytes(t) for t in tensors]
    header = {"meta": meta,
              "tensors": [{"dtype": d, "shape": s} for d, s, _ in specs]}
    hbytes = json.dumps(header).encode()
    return b"".join([MAGIC, struct.pack("<I", len(hbytes)), hbytes]
                    + [raw for _, _, raw in specs])


# Canonical field order of one pool-native prefix page block.  Disk files
# and the peer-fetch wire both go through pack_block/unpack_block, so a
# spill -> disk -> peer -> restore round trip keeps the pool's bytes.
BLOCK_FIELDS = ("k", "v", "k_scale", "v_scale")


def pack_block(digest: bytes, epoch: str, block: dict) -> bytes:
    """One prefix page block as an AKV1 message.  ``epoch`` is the pool
    layout signature: a reader on another layout (model, page size, KV
    dtype) must refuse the block, not reinterpret it."""
    fields = [f for f in BLOCK_FIELDS if block.get(f) is not None]
    return pack({"digest": digest.hex(), "epoch": epoch, "fields": fields},
                [block[f] for f in fields])


def unpack_block(buf: bytes, digest: bytes, epoch: str) -> dict:
    """Validate and decode one ``pack_block`` message.  Any mismatch of
    digest (content), epoch (pool layout), field set or length raises
    ValueError: a stale or cross-layout block is never served as a hit."""
    meta, tensors = unpack(buf)
    if meta.get("digest") != digest.hex():
        raise ValueError(f"block digest mismatch: {meta.get('digest')!r}")
    if meta.get("epoch") != epoch:
        raise ValueError(f"block epoch mismatch: {meta.get('epoch')!r} "
                         f"!= {epoch!r}")
    fields = meta.get("fields") or []
    if len(fields) != len(tensors) or any(f not in BLOCK_FIELDS
                                          for f in fields):
        raise ValueError(f"bad block fields: {fields!r}")
    return dict(zip(fields, tensors))


def unpack(buf: bytes) -> tuple[dict[str, Any], list[torch.Tensor]]:
    """(meta, CPU tensors) of one AKV1 message; a bad magic, an unknown
    dtype or a length that disagrees with the header raises ValueError."""
    if bytes(buf[:4]) != MAGIC:
        raise ValueError("bad KV transfer magic")
    (hlen,) = struct.unpack_from("<I", buf, 4)
    header = json.loads(bytes(buf[8:8 + hlen]).decode())
    view = memoryview(buf)
    tensors = []
    off = 8 + hlen
    for spec in header["tensors"]:
        dtype = _DTYPES.get(spec["dtype"])
        if dtype is None:
            raise ValueError(f"unknown KV transfer dtype {spec['dtype']!r}")
        shape = tuple(int(x) for x in spec["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        n = count * torch.empty((), dtype=dtype).element_size()
        if off + n > len(buf):
            raise ValueError(f"KV transfer length mismatch: {off + n} > "
                             f"{len(buf)}")
        if n:
            t = torch.frombuffer(bytearray(view[off:off + n]), dtype=dtype)
        else:
            t = torch.empty((0,), dtype=dtype)
        tensors.append(t.reshape(shape))
        off += n
    if off != len(buf):
        raise ValueError(f"KV transfer length mismatch: {off} != {len(buf)}")
    return header["meta"], tensors

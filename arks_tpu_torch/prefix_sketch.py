"""Chained prompt digests — the hash chain that keys the page allocator's
prefix index (copy of the chain half of ``arks_tpu/prefix_sketch.py``; the
routing sketch itself is a later slice).  Digest j covers
``ids[: (j + 1) * page]``, so the same prompt prefix keys the same pages
in both packages."""

from __future__ import annotations

import hashlib

import numpy as np


def iter_chain_digests(ids, page: int):
    """Lazily yield chained content digests: digest j covers
    ids[: (j+1)*page] (a matcher can stop at the first missing block)."""
    h = hashlib.sha1()
    arr = np.asarray(ids, np.int32)
    for j in range(len(arr) // page):
        h.update(arr[j * page:(j + 1) * page].tobytes())
        yield h.digest()


def chain_digests(ids, page: int, nblocks: int) -> list[bytes]:
    """First ``nblocks`` chained digests as a list."""
    out = []
    for j, d in enumerate(iter_chain_digests(ids, page)):
        if j >= nblocks:
            break
        out.append(d)
    return out

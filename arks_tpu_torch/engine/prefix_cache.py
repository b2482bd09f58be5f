"""Host-RAM prefix KV stores — the port's copy of
``arks_tpu/engine/prefix_cache.py``'s ``PrefixKVCache`` and
``HostPrefixTier``.

Both key blocks of ``block``/``page`` tokens by the chained content digest
of the whole prompt prefix up to the block's end (``prefix_sketch``), so two
prompts share entries exactly as far as their tokens agree, and both evict
least-recently-used blocks past a byte budget.  Values are CPU tensors (the
reference keeps numpy arrays; numpy has no bfloat16).

- ``PrefixKVCache`` serves the slot-contiguous cache: time-major K/V
  ``[L, 1, C, Hkv, D]`` in the engine dtype, what ``transformer.insert``
  takes, harvested from one-shot prefills and chunk-prefilled slots.
- ``HostPrefixTier`` is tier 1 behind the paged pool's device index: raw
  pool pages (``{"k", "v"[, "k_scale", "v_scale"]}``, each ``[L, Hkv, P(/2),
  D]`` — int8 and packed int4 pages with their f32 scales), spilled when
  the index evicts them and scattered back at a later admission, so a
  restore reproduces the pool's bytes exactly.

- ``SwapStore`` holds preempted requests' decode state (``ARKS_PREEMPT``):
  their raw pool pages and sampler row, keyed by request id, never
  evicted, its bytes reserved out of the host tier's budget.

Not copied yet: the disk tier behind the host tier (``DiskPrefixTier``)
and the host tier's eviction hook and membership snapshot, which serve it
and the routing sketch.  Thread-safety: engine thread only (the
reference's locks guard its disaggregated-prefill and peer-serving
threads, which the port does not have).
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from arks_tpu_torch.prefix_sketch import chain_digests, iter_chain_digests


def _nbytes(block) -> int:
    return sum(a.nbytes for a in block if a is not None)


class PrefixKVCache:
    def __init__(self, block_tokens: int, capacity_bytes: int) -> None:
        if block_tokens <= 0:
            raise ValueError("block_tokens must be positive")
        self.block = block_tokens
        self.capacity = capacity_bytes
        # digest -> (k_block, v_block), LRU order (oldest first).
        self._blocks: "OrderedDict[bytes, tuple]" = OrderedDict()
        self._bytes = 0
        self.hit_tokens = 0
        self.query_tokens = 0

    def _keys(self, ids, nblocks: int) -> list[bytes]:
        return chain_digests(ids, self.block, nblocks)

    def match(self, ids) -> int:
        """Longest cached prefix of ``ids`` in tokens (a multiple of the
        block; 0 = miss).  Touches neither LRU order nor stats; digests
        lazily and stops at the first missing block."""
        plen = 0
        for key in iter_chain_digests(ids, self.block):
            if key not in self._blocks:
                break
            plen += self.block
        return plen

    def get(self, ids, plen: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The cached KV of ids[:plen] as one time-major pair
        ``[L, 1, plen, Hkv, D]``; ``plen`` must be a ``match`` result."""
        ks, vs = [], []
        for key in self._keys(ids, plen // self.block):
            k, v = self._blocks[key]
            self._blocks.move_to_end(key)
            ks.append(k)
            vs.append(v)
        return torch.cat(ks, dim=2), torch.cat(vs, dim=2)

    def missing_blocks(self, ids, length: int) -> list[int]:
        """Indices of the full blocks of ids[:length] not cached yet (the
        engine skips the device-to-host copy on a full hit)."""
        keys = self._keys(ids, length // self.block)
        return [j for j, key in enumerate(keys) if key not in self._blocks]

    def put(self, ids, k: torch.Tensor, v: torch.Tensor, length: int) -> None:
        """Store every full block of ids[:length] from time-major KV
        ``[L, 1, T, Hkv, D]`` (T >= length), then evict past the budget."""
        nblocks = length // self.block
        if nblocks == 0:
            return
        for j, key in enumerate(self._keys(ids, nblocks)):
            if key in self._blocks:
                self._blocks.move_to_end(key)
                continue
            rows = slice(j * self.block, (j + 1) * self.block)
            # Copies: a view would keep the whole harvested prompt alive.
            kb, vb = k[:, :, rows].clone(), v[:, :, rows].clone()
            self._blocks[key] = (kb, vb)
            self._bytes += _nbytes((kb, vb))
        while self._bytes > self.capacity and self._blocks:
            _, old = self._blocks.popitem(last=False)
            self._bytes -= _nbytes(old)

    def clear(self) -> None:
        self._blocks.clear()
        self._bytes = 0

    def record_query(self, num_tokens: int, hit: int) -> None:
        self.query_tokens += num_tokens
        self.hit_tokens += hit

    @property
    def bytes_used(self) -> int:
        return self._bytes

    @property
    def hit_rate(self) -> float:
        return self.hit_tokens / self.query_tokens if self.query_tokens else 0.0


class HostPrefixTier:
    """Tier 1 of a paged engine's prefix cache: spilled pool pages keyed by
    the digest that keyed them in the device index, LRU by bytes
    (``ARKS_PREFIX_HOST_MB``).  ``reserved`` bytes of the budget belong to
    the ``SwapStore``: prefix blocks evict down to ``capacity -
    reserved``."""

    def __init__(self, page_tokens: int, capacity_bytes: int) -> None:
        if page_tokens <= 0:
            raise ValueError("page_tokens must be positive")
        self.page = page_tokens
        self.capacity = capacity_bytes
        # digest -> block {"k", "v"[, "k_scale", "v_scale"]}, LRU order.
        self._blocks: "OrderedDict[bytes, dict]" = OrderedDict()
        self._bytes = 0
        self.reserved = 0
        self.spilled_blocks = 0
        self.restored_blocks = 0

    def has(self, digest: bytes) -> bool:
        return digest in self._blocks

    def put(self, digest: bytes, block: dict) -> bool:
        """Store one pool page block (an LRU touch if present).  Returns
        True when the block was newly stored and survived the budget."""
        block = {k: v for k, v in block.items() if v is not None}
        if digest in self._blocks:
            self._blocks.move_to_end(digest)
            return False
        self._blocks[digest] = block
        self._bytes += _nbytes(block.values())
        self.spilled_blocks += 1
        self._evict_to_budget()
        return digest in self._blocks

    def _evict_to_budget(self) -> None:
        """LRU-evict prefix blocks past ``capacity - reserved``."""
        budget = max(self.capacity - self.reserved, 0)
        while self._bytes > budget and self._blocks:
            _, old = self._blocks.popitem(last=False)
            self._bytes -= _nbytes(old.values())

    def match_blocks(self, digests: list[bytes], start: int) -> list[dict]:
        """The longest run of consecutively stored blocks for
        ``digests[start:]``, LRU-touched.  Callers must not mutate them."""
        out: list[dict] = []
        for d in digests[start:]:
            blk = self._blocks.get(d)
            if blk is None:
                break
            self._blocks.move_to_end(d)
            out.append(blk)
        return out

    def peek(self, digest: bytes) -> dict | None:
        """The stored block without an LRU touch."""
        return self._blocks.get(digest)

    def clear(self) -> None:
        self._blocks.clear()
        self._bytes = 0

    @property
    def bytes_used(self) -> int:
        return self._bytes

    @property
    def num_blocks(self) -> int:
        return len(self._blocks)


class SwapStore:
    """Host-RAM store of PREEMPTED requests' decode state
    (``ARKS_PREEMPT``), keyed by request id: the victim's raw pool page
    blocks and its sampler row.  Entries are never evicted (a swapped-out
    request stays resumable until it resumes or aborts); instead their
    bytes are reserved out of the host tier's budget (``tier.reserved``),
    prefix blocks evict around them, and ``put`` refuses an entry that the
    whole budget cannot hold on top of the reservations (the engine then
    preempts in replay mode).

    Entry layout (written and read back by the engine)::

        {"blocks": [page block dicts], "key": np.uint32[2],
         "counts": int32[V], "guide_row": int}
    """

    def __init__(self, tier: HostPrefixTier) -> None:
        self._tier = tier
        # rid -> (entry, reserved bytes)
        self._entries: dict[str, tuple[dict, int]] = {}

    @staticmethod
    def _entry_bytes(entry: dict) -> int:
        n = sum(_nbytes(blk.values()) for blk in entry.get("blocks", ()))
        for key in ("key", "counts"):
            a = entry.get(key)
            if a is not None and hasattr(a, "nbytes"):
                n += a.nbytes
        return n

    def put(self, rid: str, entry: dict) -> bool:
        """Reserve the entry's bytes and store it.  Returns False (storing
        nothing) when the reservations and this entry exceed the tier's
        whole capacity."""
        need = self._entry_bytes(entry)
        t = self._tier
        if rid in self._entries:
            return True
        if t.reserved + need > t.capacity:
            return False
        t.reserved += need
        t._evict_to_budget()
        self._entries[rid] = (entry, need)
        return True

    def pop(self, rid: str) -> dict | None:
        """Remove and return an entry, releasing its reserved bytes."""
        rec = self._entries.pop(rid, None)
        if rec is None:
            return None
        entry, need = rec
        self._tier.reserved = max(self._tier.reserved - need, 0)
        return entry

    def discard(self, rid: str) -> bool:
        """Drop an entry if present (an abort while swapped out: the host
        bytes come back).  Returns True when something was freed."""
        return self.pop(rid) is not None

    def clear(self) -> None:
        for rid in list(self._entries):
            self.pop(rid)

    @property
    def bytes_used(self) -> int:
        return sum(need for _, need in self._entries.values())

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, rid: str) -> bool:
        return rid in self._entries

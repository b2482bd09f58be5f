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

Not copied yet: the disk tier behind the host tier (``DiskPrefixTier``),
the swap store (``SwapStore``) and the host tier's eviction hook, reserved
bytes and membership snapshot, which serve them and the routing sketch.
Thread-safety: engine thread only (the reference's locks guard its
disaggregated-prefill and peer-serving threads, which the port does not
have).
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
    (``ARKS_PREFIX_HOST_MB``)."""

    def __init__(self, page_tokens: int, capacity_bytes: int) -> None:
        if page_tokens <= 0:
            raise ValueError("page_tokens must be positive")
        self.page = page_tokens
        self.capacity = capacity_bytes
        # digest -> block {"k", "v"[, "k_scale", "v_scale"]}, LRU order.
        self._blocks: "OrderedDict[bytes, dict]" = OrderedDict()
        self._bytes = 0
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
        while self._bytes > self.capacity and self._blocks:
            _, old = self._blocks.popitem(last=False)
            self._bytes -= _nbytes(old.values())
        return digest in self._blocks

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

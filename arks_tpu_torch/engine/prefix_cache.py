"""Host-RAM and disk prefix KV stores — the port's copy of
``arks_tpu/engine/prefix_cache.py``'s ``PrefixKVCache``, ``HostPrefixTier``,
``DiskPrefixTier`` and ``SwapStore``.

Each keys blocks of ``block``/``page`` tokens by the chained content digest
of the whole prompt prefix up to the block's end (``prefix_sketch``), so two
prompts share entries exactly as far as their tokens agree, and each evicts
least-recently-used blocks past a byte budget.  Values are CPU tensors (the
reference keeps numpy arrays; numpy has no bfloat16).

- ``PrefixKVCache`` serves the slot-contiguous cache: time-major K/V
  ``[L, 1, C, Hkv, D]`` in the engine dtype, what ``transformer.insert``
  takes, harvested from one-shot prefills and chunk-prefilled slots.
- ``HostPrefixTier`` is tier 1 behind the paged pool's device index: raw
  pool pages (``{"k", "v"[, "k_scale", "v_scale"]}``, each ``[L, Hkv, P(/2),
  D]`` — int8 and packed int4 pages with their f32 scales), spilled when
  the index evicts them and scattered back at a later admission, so a
  restore reproduces the pool's bytes exactly.  Its blocks evicted past
  the budget go to ``on_evict`` (the disk tier's spill queue), and
  ``snapshot`` gives the routing sketch its membership.
- ``DiskPrefixTier`` is tier 2: the same blocks, one AKV1 file each
  (``kv_transfer.pack_block``), so warm prefixes survive a restart and can
  be served verbatim to a fetching peer.
- ``SwapStore`` holds preempted requests' decode state (``ARKS_PREEMPT``):
  their raw pool pages and sampler row, keyed by request id, never
  evicted, its bytes reserved out of the host tier's budget.

Thread-safety: the host tier's map is guarded by a lock (the engine thread
spills and restores; server threads export blocks to peers, the fetch
worker stages blocks from disk and peers, and the sketch reads its
membership); the disk tier's index likewise, its file IO running on the
writer, fetch and server threads.  ``PrefixKVCache`` and ``SwapStore``'s
map are the engine thread's.
"""

from __future__ import annotations

import json
import os
import threading
from collections import OrderedDict

import torch

from arks_tpu_torch.engine import kv_transfer
from arks_tpu_torch.prefix_sketch import chain_digests, iter_chain_digests
from arks_tpu_torch.utils.swallow import swallowed


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
        # Eviction sink: on_evict(digest, block) for every block evicted
        # past the budget (the disk tier's spill queue), called after the
        # lock is released.
        self.on_evict = None
        self.reserved = 0
        self._lock = threading.Lock()
        # digest -> block {"k", "v"[, "k_scale", "v_scale"]}, LRU order.
        self._blocks: "OrderedDict[bytes, dict]" = OrderedDict()
        self._bytes = 0
        # Membership version for the routing sketch: moves on every insert,
        # eviction and clear (not on LRU touches).
        self.version = 0
        self.spilled_blocks = 0
        self.restored_blocks = 0

    def has(self, digest: bytes) -> bool:
        with self._lock:
            return digest in self._blocks

    def put(self, digest: bytes, block: dict) -> bool:
        """Store one pool page block (an LRU touch if present).  Returns
        True when the block was newly stored and survived the budget."""
        block = {k: v for k, v in block.items() if v is not None}
        with self._lock:
            if digest in self._blocks:
                self._blocks.move_to_end(digest)
                return False
            self._blocks[digest] = block
            self._bytes += _nbytes(block.values())
            self.spilled_blocks += 1
            self.version += 1
            evicted = self._evict_to_budget()
            stored = digest in self._blocks
        self._notify_evicted(evicted)
        return stored

    def _evict_to_budget(self) -> list:
        """LRU-evict prefix blocks past ``capacity - reserved`` (the lock
        held); returns the evicted (digest, block) pairs for
        ``on_evict``."""
        budget = max(self.capacity - self.reserved, 0)
        evicted = []
        while self._bytes > budget and self._blocks:
            d, old = self._blocks.popitem(last=False)
            self._bytes -= _nbytes(old.values())
            self.version += 1
            evicted.append((d, old))
        return evicted

    def _notify_evicted(self, evicted: list) -> None:
        cb = self.on_evict
        if cb is not None:
            for d, blk in evicted:
                cb(d, blk)

    def match_blocks(self, digests: list[bytes], start: int) -> list[dict]:
        """The longest run of consecutively stored blocks for
        ``digests[start:]``, LRU-touched under one lock hold.  Callers
        must not mutate them."""
        out: list[dict] = []
        with self._lock:
            for d in digests[start:]:
                blk = self._blocks.get(d)
                if blk is None:
                    break
                self._blocks.move_to_end(d)
                out.append(blk)
        return out

    def peek(self, digest: bytes) -> dict | None:
        """The stored block without an LRU touch (a peer's fetch must not
        reorder this replica's recency)."""
        with self._lock:
            return self._blocks.get(digest)

    def clear(self) -> None:
        with self._lock:
            self._blocks.clear()
            self._bytes = 0
            self.version += 1

    def snapshot(self) -> tuple[list[bytes], int]:
        """Stored digests (LRU order, oldest first) and the membership
        version: the routing sketch's tier 1."""
        with self._lock:
            return list(self._blocks), self.version

    @property
    def bytes_used(self) -> int:
        return self._bytes

    @property
    def num_blocks(self) -> int:
        with self._lock:
            return len(self._blocks)


class DiskPrefixTier:
    """Tier 2 behind the host tier: the same digest keys and pool-native
    blocks, one AKV1 file each (``kv_transfer.pack_block``), LRU by bytes
    (``ARKS_PREFIX_DISK_MB``).  The directory is re-indexed at boot, so
    warm prefixes survive a restart.

    Layout safety: digests are content-only, so every file carries the
    pool layout signature (``epoch``) and a ``manifest.json`` stamps the
    directory; a boot under another layout wipes it, and a file of another
    epoch is refused on read.  Crash safety: writes go tmp + fsync +
    rename (a torn write leaves a ``.tmp`` orphan, removed at boot); a
    corrupt, truncated or stale file is deleted on read and counted in
    ``corrupt_blocks``, and the caller sees a miss.

    The index (digest -> file size) is lock-guarded and cheap; the file
    IO (``get``/``put``) runs on the writer, fetch and server threads."""

    SUFFIX = ".akv"
    MANIFEST = "manifest.json"
    FORMAT = 1

    def __init__(self, page_tokens: int, capacity_bytes: int,
                 directory: str, epoch: str) -> None:
        if page_tokens <= 0:
            raise ValueError("page_tokens must be positive")
        self.page = page_tokens
        self.capacity = capacity_bytes
        self.epoch = epoch
        self.dir = directory
        self._lock = threading.Lock()
        # digest -> file size in bytes, LRU order (oldest first).
        self._index: "OrderedDict[bytes, int]" = OrderedDict()
        self._bytes = 0
        self.version = 0
        self.spilled_blocks = 0
        self.restored_blocks = 0
        self.evicted_blocks = 0
        self.corrupt_blocks = 0
        os.makedirs(self.dir, exist_ok=True)
        self._boot_scan()

    def _path(self, digest: bytes) -> str:
        return os.path.join(self.dir, digest.hex() + self.SUFFIX)

    def _boot_scan(self) -> None:
        """Adopt, or wipe, what an earlier process left: a manifest of
        another layout means every block there has other bytes per page."""
        mpath = os.path.join(self.dir, self.MANIFEST)
        try:
            with open(mpath, encoding="utf-8") as f:
                m = json.load(f)
            stale = (m.get("epoch") != self.epoch
                     or m.get("format") != self.FORMAT)
        except FileNotFoundError:
            stale = False
        except (OSError, ValueError, AttributeError) as e:
            swallowed("disk_tier.manifest", e)
            stale = True
        for name in sorted(os.listdir(self.dir)):
            path = os.path.join(self.dir, name)
            if name.endswith(".tmp"):
                self._unlink(path)        # a torn write: never adopted
                continue
            if not name.endswith(self.SUFFIX):
                continue
            if stale:
                self._unlink(path)
                continue
            try:
                digest = bytes.fromhex(name[:-len(self.SUFFIX)])
                size = os.path.getsize(path)
            except (ValueError, OSError) as e:
                swallowed("disk_tier.scan", e)
                self._unlink(path)
                continue
            self._index[digest] = size
            self._bytes += size
        tmp = mpath + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"epoch": self.epoch, "format": self.FORMAT}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, mpath)
        with self._lock:
            for d in self._evict_to_budget():
                self._unlink(self._path(d))

    @staticmethod
    def _unlink(path: str) -> None:
        try:
            os.unlink(path)
        except OSError as e:
            swallowed("disk_tier.unlink", e)

    def has(self, digest: bytes) -> bool:
        with self._lock:
            return digest in self._index

    def match_digests(self, digests: list[bytes], start: int) -> list[bytes]:
        """The longest run of indexed digests from ``digests[start:]``,
        LRU-touched: an in-memory probe (the engine thread's admission;
        the file reads happen later, off that thread)."""
        out: list[bytes] = []
        with self._lock:
            for d in digests[start:]:
                if d not in self._index:
                    break
                self._index.move_to_end(d)
                out.append(d)
        return out

    def snapshot(self) -> tuple[list[bytes], int]:
        """Indexed digests and the membership version (the sketch's
        tier 2)."""
        with self._lock:
            return list(self._index), self.version

    def put(self, digest: bytes, block: dict) -> bool:
        """Persist one block (tmp + fsync + rename).  Returns True when
        newly stored; an IO failure is swallowed and leaves it absent."""
        with self._lock:
            if digest in self._index:
                self._index.move_to_end(digest)
                return False
        buf = kv_transfer.pack_block(digest, self.epoch, block)
        path = self._path(digest)
        tmp = path + f".{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(buf)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError as e:
            swallowed("disk_tier.put", e)
            self._unlink(tmp)
            return False
        with self._lock:
            if digest in self._index:       # another writer won the race
                return False
            self._index[digest] = len(buf)
            self._bytes += len(buf)
            self.spilled_blocks += 1
            self.version += 1
            evicted = self._evict_to_budget()
        for d in evicted:
            self._unlink(self._path(d))
        return True

    def get(self, digest: bytes) -> dict | None:
        """Read and validate one block; a missing, corrupt, truncated or
        cross-epoch file is a miss (and, but for a missing one, deleted
        and counted)."""
        path = self._path(digest)
        try:
            with open(path, "rb") as f:
                buf = f.read()
        except FileNotFoundError:
            self._drop(digest)
            return None
        except OSError as e:
            swallowed("disk_tier.read", e)
            self._drop(digest)
            return None
        try:
            blk = kv_transfer.unpack_block(buf, digest, self.epoch)
        except Exception as e:   # any malformed file is a miss
            swallowed("disk_tier.get", e)
            self._unlink(path)
            with self._lock:
                self.corrupt_blocks += 1
            self._drop(digest)
            return None
        with self._lock:
            if digest in self._index:
                self._index.move_to_end(digest)
            self.restored_blocks += 1
        return blk

    def _drop(self, digest: bytes) -> None:
        with self._lock:
            size = self._index.pop(digest, None)
            if size is not None:
                self._bytes -= size
                self.version += 1

    def _evict_to_budget(self) -> list[bytes]:
        """LRU-evict past the byte budget (the lock held); returns the
        evicted digests, whose files the caller deletes outside it."""
        evicted: list[bytes] = []
        while self._bytes > self.capacity and self._index:
            d, size = self._index.popitem(last=False)
            self._bytes -= size
            self.version += 1
            self.evicted_blocks += 1
            evicted.append(d)
        return evicted

    def clear(self) -> None:
        """Drop every block, index and files (the blanket abort's deep
        clean: a poisoned tier must not come back at the next boot)."""
        with self._lock:
            digests = list(self._index)
            self._index.clear()
            self._bytes = 0
            self.version += 1
        for d in digests:
            self._unlink(self._path(d))

    @property
    def bytes_used(self) -> int:
        return self._bytes

    @property
    def num_blocks(self) -> int:
        with self._lock:
            return len(self._index)


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
        with t._lock:
            if t.reserved + need > t.capacity:
                return False
            t.reserved += need
            evicted = t._evict_to_budget()
        t._notify_evicted(evicted)
        self._entries[rid] = (entry, need)
        return True

    def pop(self, rid: str) -> dict | None:
        """Remove and return an entry, releasing its reserved bytes."""
        rec = self._entries.pop(rid, None)
        if rec is None:
            return None
        entry, need = rec
        with self._tier._lock:
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

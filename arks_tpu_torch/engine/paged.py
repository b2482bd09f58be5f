"""Host-side page allocator for the paged device KV cache (copy of the
allocator half of ``arks_tpu/engine/paged.py``).

The device side is arks_tpu_torch.ops.paged_attention (pool + block
tables); this is the authority over which pool page holds what:

- **Free list + refcounts**: a page is free (refcount 0), private (held by
  one slot), or shared (held by several slots and/or the prefix index).
- **Prefix index** (tier 0 of the prefix cache): chained content digests
  (``prefix_sketch``) -> page id, LRU-ordered.  A prompt's full pages are
  registered once written; a later prompt with the same prefix points its
  block table at them and prefills only its tail.
- **Eviction**: allocation prefers the free list; under pressure it evicts
  LRU index-retained pages (refcount held only by the index), calling
  ``on_evict`` first so the engine can spill the page to the host tier.
- **Stats**: query and hit tokens (``record_query``, ``hit_rate``).
- **Grid counters**: ``mixed_grid_steps`` / ``mixed_kv_bytes``, the host
  mirrors of one mixed dispatch's page steps and KV bytes that feed the
  engine's ``mixed_grid_steps*`` / ``mixed_kv_bytes*`` counters.

- **Membership mirror** (``index_snapshot``): which digests the index
  holds, in registration order, with a version that moves only when the
  membership does: the tier-0 input of the routing sketch, read from
  server threads under its own lock.

Thread-safety: the engine thread only, except ``index_snapshot``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np

from arks_tpu_torch.prefix_sketch import chain_digests, iter_chain_digests

__all__ = ["OutOfPagesError", "iter_chain_digests", "chain_digests",
           "pages_needed", "mixed_grid_steps", "mixed_kv_bytes",
           "PageAllocator"]


class OutOfPagesError(RuntimeError):
    pass


def pages_needed(length: int, rows: int, page: int, max_pages: int) -> int:
    """Block-table entries a slot needs before a dispatch writing ``rows``
    rows from position ``length``, clamped to ``max_pages`` (growing the
    table beyond its row width would corrupt the neighbouring slot's
    row)."""
    return min((length + rows - 1) // page + 1, max_pages)


def mixed_grid_steps(pos_start, q_len, *, page: int, block_q: int,
                     num_qb: int, max_pages: int) -> tuple[int, int]:
    """(ideal, dense) page-compute step counts for one mixed dispatch —
    the host-side numpy mirror of ops.paged_attention.build_mixed_work_list.

    ``ideal`` is what the ragged work-list grid executes: each active
    (seq, q_block) item visits exactly its own causal page count, q_len=0
    lanes and padding items visit zero.  ``dense`` is the legacy grid's
    S * num_qb * max_pages (every lane pays the worst case).  The counter
    pair metrics these feed (mixed_grid_steps_total vs _ideal_total)
    describes the grid PLAN, so it is meaningful under either
    ARKS_MIXED_GRID mode and either attention impl.

    Inputs must already be host numpy arrays (the engine's issue path
    holds them that way) — no device fetches happen here."""
    pos = pos_start.astype(np.int64, copy=False)
    ql = q_len.astype(np.int64, copy=False)
    q_lo = (np.arange(num_qb, dtype=np.int64) * block_q)[None, :]
    active = q_lo < ql[:, None]
    kv_end = np.where(active, pos[:, None] + np.minimum(q_lo + block_q,
                                                        ql[:, None]), 0)
    pages = np.minimum(-(-kv_end // page), max_pages)
    ideal = int(pages.sum())
    dense = int(pos.shape[0]) * num_qb * max_pages
    return ideal, dense


def mixed_kv_bytes(pos_start, q_len, *, page: int, block_q: int,
                   num_qb: int, max_pages: int, hkv: int,
                   page_head_bytes: int) -> tuple[int, int]:
    """(actual, ideal) KV bytes one mixed dispatch streams from HBM — the
    host-side mirror of the ragged kernel's DMA schedule, feeding the
    mixed_kv_bytes_total / _ideal_total counter pair.

    ``actual``: every active (seq, q_block) item re-streams its own
    causal page prefix, and the head-group split is a pure partition of
    the head axis (n_groups x head_group == hkv), so the grouped and
    ungrouped schedules move the same bytes AT EQUAL block_q — the
    grouped win arrives entirely through the larger tuned block_q
    (fewer q-blocks, fewer prefix re-streams), which is why this mirror
    takes the PLAN's block_q/num_qb rather than a head-group count.

    ``ideal``: each distinct causal page crosses the wire exactly once
    per dispatch (what a perfect cross-q-block-sharing schedule would
    move).  actual/ideal is the waste ratio docs/monitoring.md alerts
    on.

    ``page_head_bytes``: bytes one (page, head) KV block moves — K + V
    (+ scale rows when quantized); the engine derives it from the pool
    dtypes so int4 packing halves it automatically."""
    pos = pos_start.astype(np.int64, copy=False)
    ql = q_len.astype(np.int64, copy=False)
    q_lo = (np.arange(num_qb, dtype=np.int64) * block_q)[None, :]
    active = q_lo < ql[:, None]
    kv_end = np.where(active, pos[:, None] + np.minimum(q_lo + block_q,
                                                        ql[:, None]), 0)
    pages = np.minimum(-(-kv_end // page), max_pages)
    actual = int(pages.sum()) * hkv * page_head_bytes
    seq_end = np.where(ql > 0, pos + ql, 0)
    seq_pages = np.minimum(-(-seq_end // page), max_pages)
    ideal = int(seq_pages.sum()) * hkv * page_head_bytes
    return actual, ideal


class PageAllocator:
    def __init__(self, num_pages: int, page: int, on_evict=None) -> None:
        self.page = page
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, -1, -1))
        self._ref = [0] * num_pages
        # digest -> page id; LRU order (oldest first).  The index holds ONE
        # reference on each registered page.
        self._index: "OrderedDict[bytes, int]" = OrderedDict()
        self._page_digest: dict[int, bytes] = {}
        # Spill hook: on_evict(digest, page) the moment an index-retained
        # page is evicted, BEFORE it can reach the free list, so the engine
        # can queue its spill while the content is still on the device.
        # Must not raise and must not call back into the allocator (it
        # runs mid-alloc).
        self.on_evict = on_evict
        # Membership mirror for the routing sketch: server threads read a
        # consistent view of WHICH digests are indexed while _index stays
        # engine-thread only.  It follows registrations and evictions, not
        # LRU touches, so a match never takes the lock.
        self._mirror_lock = threading.Lock()
        self._mirror: "OrderedDict[bytes, None]" = OrderedDict()
        self.index_version = 0
        self.hit_tokens = 0
        self.query_tokens = 0

    # -- allocation ----------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def retained_pages(self) -> int:
        return len(self._index)

    def alloc(self, n: int) -> list[int]:
        """n fresh pages (refcount 1 each).  Evicts LRU retained pages as
        needed; raises OutOfPagesError when even eviction cannot satisfy
        (pool mis-sized)."""
        while len(self._free) < n and self._index:
            self._evict_lru()
        if len(self._free) < n:
            raise OutOfPagesError(
                f"need {n} pages, {len(self._free)} free and nothing "
                "evictable — pool too small for the active slots")
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._ref[p] = 1
        return out

    def _evict_lru(self) -> None:
        digest, pg = self._index.popitem(last=False)
        del self._page_digest[pg]
        with self._mirror_lock:
            self._mirror.pop(digest, None)
            self.index_version += 1
        if self.on_evict is not None:
            self.on_evict(digest, pg)
        self._ref[pg] -= 1
        if self._ref[pg] == 0:
            self._free.append(pg)

    def incref(self, pages) -> None:
        for p in pages:
            self._ref[p] += 1

    def decref(self, pages) -> None:
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)
            elif self._ref[p] < 0:
                raise AssertionError(f"page {p} refcount underflow")

    # -- prefix index --------------------------------------------------

    def match(self, digests: list[bytes]) -> list[int]:
        """Pages for the longest indexed digest-chain prefix; each matched
        page gets a caller reference (incref) and an LRU touch."""
        pages = []
        for d in digests:
            pg = self._index.get(d)
            if pg is None:
                break
            self._index.move_to_end(d)
            self._ref[pg] += 1
            pages.append(pg)
        return pages

    def register(self, digests: list[bytes], pages: list[int]) -> None:
        """Put (digest, page) pairs into the index.  The index takes ONE
        reference per newly-registered page; already-indexed digests keep
        their existing page (the caller's duplicate page stays owned by the
        caller alone and is freed on its decref).  A page already indexed
        under a DIFFERENT digest is skipped: _page_digest is a one-to-one
        reverse map, and overwriting it would leave the old digest's index
        entry stale — evicting either digest would then delete the other's
        reverse entry and a later eviction would KeyError mid-alloc (and
        the refcount held for the old entry would leak)."""
        for d, pg in zip(digests, pages):
            if d in self._index:
                self._index.move_to_end(d)
                continue
            if self._page_digest.get(pg, d) != d:
                continue
            self._index[d] = pg
            self._page_digest[pg] = d
            self._ref[pg] += 1
            with self._mirror_lock:
                self._mirror[d] = None
                self._mirror.move_to_end(d)
                self.index_version += 1

    def index_snapshot(self) -> tuple[list[bytes], int]:
        """Indexed digests (registration order, oldest first) and the
        membership version: the routing sketch's tier 0.  Any thread."""
        with self._mirror_lock:
            return list(self._mirror), self.index_version

    # -- stats ---------------------------------------------------------

    def record_query(self, num_tokens: int, hit: int) -> None:
        self.query_tokens += num_tokens
        self.hit_tokens += hit

    @property
    def hit_rate(self) -> float:
        return self.hit_tokens / self.query_tokens if self.query_tokens else 0.0

"""Windowed-residency decode: contexts larger than the device page pool
(the port of ``arks_tpu/engine/residency.py``).

A slot whose context outgrows ``ARKS_RESIDENCY_WINDOW_PAGES`` *engages*:
all but its two newest KV pages spill to a host store (pool-native bytes,
gathered by the prefix host tier's ``gather_pool_pages`` into pinned
buffers), and from then on the slot decodes span by span on a host loop.
The engine's resident budget per slot is the window, while the slot's
logical block table keeps its full ``max_cache_len`` width.

Per decode token, per layer:

- the new token's q/k/v come from the same ``_block_qkv`` the mixed step
  runs, on the same rows: the slot's token in row ``slot`` of a
  ``num_slots``-row block, the other rows parked (the pipe step's form,
  which every decode lane's bits follow); its K/V row lands on the
  resident hot-tail page through the same ``paged_kv_update[_quant]``;
- attention walks the causal page prefix in SPANS: cold spans stream
  through two staging halves (layer by layer: the next span's pages of
  this layer go up while the current span attends, the prefetch overlap),
  the last span reads the resident tail in place;
- ``paged_mixed_attention`` chains its online-softmax state across spans
  (``page_lo``/``page_hi``/``carry_state``/``emit_state``).  Its pieces
  are pages and its fold a left fold, so the chain gives the single
  call's bytes, and an engaged slot's stream is byte-identical to the same
  request on a pool big enough never to engage.

The host store is written by device-to-host copies into pinned buffers and
read only by host-to-device copies from them, both queued on the engine's
stream: the stream orders each upload after its spill, so no step waits
on the host for either.  Engine thread only, like the rest of the
scheduler state.
"""

from __future__ import annotations

import logging
import weakref

import numpy as np
import torch

from arks_tpu_torch.engine.paged import pages_needed
from arks_tpu_torch.models import moe
from arks_tpu_torch.models import transformer as tf
from arks_tpu_torch.models.quant import embed_lookup
from arks_tpu_torch.ops.paged_attention import (_use_kernel, mixed_grid_mode,
                                                mixed_work,
                                                paged_kv_update,
                                                paged_kv_update_quant,
                                                paged_mixed_attention,
                                                paged_write_rows)
from arks_tpu_torch.ops.rope import rope_cos_sin

log = logging.getLogger("arks_tpu_torch.residency")

__all__ = ["ResidencyManager"]


class _WindowedSlot:
    """Host bookkeeping of one engaged slot.

    ``store`` maps a logical page to its pool-native blocks (k, v, k_scale,
    v_scale; scales None when unquantized), each ``[L, 1, Hkv, P(/2),
    (D)]``: raw pool bytes, so staging restores the pages bit for bit.
    Logical pages [0, cold) live ONLY in the store; ``tail`` holds the two
    resident hot pages (device ids, logical order) the decode writes into;
    ``staging`` the two halves (``chunk`` device pages each) the cold spans
    rotate through, and ``staged[half][layer]`` the span a half holds in
    that layer, so an unchanged span is not uploaded again."""

    __slots__ = ("cold", "tail", "staging", "staged", "store")

    def __init__(self, layers: int) -> None:
        self.cold = 0
        self.tail: list[int] = []
        self.staging: list[list[int]] = [[], []]
        self.staged = [[None] * layers, [None] * layers]
        self.store: dict[int, tuple] = {}


class _Span:
    """One attention span of a token: logical pages [lo, hi), the staging
    half it reads (None: the resident tail), its block tables and lane
    bounds on the device, and the kernel's work list for it (None on the
    CPU, whose plain version takes the bounds)."""

    __slots__ = ("lo", "hi", "half", "tables", "page_lo", "page_hi", "work")

    def __init__(self, lo, hi, half, tables, page_lo, page_hi, work):
        self.lo, self.hi, self.half = lo, hi, half
        self.tables, self.page_lo, self.page_hi = tables, page_lo, page_hi
        self.work = work


class ResidencyManager:
    """Span-by-span decode for the slots whose context exceeds the window:
    the engaged slots' windowed state and their per-token forward."""

    def __init__(self, eng, window: int) -> None:
        if window < 4:
            raise ValueError(
                f"ARKS_RESIDENCY_WINDOW_PAGES={window}: the window must "
                "cover 2 hot-tail pages + 2 staging halves (>= 4)")
        if mixed_grid_mode() != "ragged":
            raise ValueError(
                "ARKS_RESIDENCY_WINDOW_PAGES requires ARKS_MIXED_GRID="
                "ragged: the span chain carries online-softmax state "
                "through the work-list launch; the dense grid is one-shot")
        # A weak proxy: engine -> manager -> engine would be a cycle that
        # keeps the engine (and its weights) alive past ``del``.
        self.eng = weakref.proxy(eng)
        self.window = int(window)
        # Staging half width: two halves + two tail pages fit the window.
        self.chunk = max(1, (self.window - 2) // 2)
        self.slots: dict[int, _WindowedSlot] = {}

    # -- engagement ----------------------------------------------------

    def engage_pending(self) -> None:
        """Engage every decoding slot whose NEXT write would outgrow the
        window.  Driven by the host length mirror, never by allocator
        pressure, so a request engages at the same token on every run."""
        eng = self.eng
        for slot in list(eng._slots):
            if slot in self.slots:
                continue
            need = pages_needed(int(eng._lengths[slot]), 1, eng._page,
                                eng._max_pages)
            if need > self.window:
                self.engage(slot)

    def _spill(self, page: int) -> tuple:
        """One pool page's blocks on their way to the host: a gather on the
        device, then (on a card) a non-blocking copy into pinned memory
        that later uploads of the page queue behind on the stream."""
        eng = self.eng
        blocks = tf.gather_pool_pages(
            eng.cache, eng._upload(np.asarray([page], np.int64)))
        if eng.device.type != "cuda":
            return blocks
        out = []
        for x in blocks:
            if x is None:
                out.append(None)
                continue
            buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            buf.copy_(x, non_blocking=True)
            out.append(buf)
        return tuple(out)

    def engage(self, slot: int) -> None:
        """Spill the slot's cold page prefix to the host store, keep its two
        newest pages resident, and carve the staging halves out of the
        freed budget.  Shared prefix pages spill by COPY: the slot's
        reference drops, the allocator's index keeps them for other
        slots' hits."""
        eng = self.eng
        ws = _WindowedSlot(eng.cfg.num_layers)
        row = list(eng._slot_pages[slot])
        cold = max(len(row) - 2, 0)
        for j in range(cold):
            ws.store[j] = self._spill(row[j])
        eng._alloc.decref(row[:cold])
        ws.cold = cold
        ws.tail = row[cold:]
        half_ids = eng._alloc.alloc(2 * self.chunk)
        eng._spill_flush()
        ws.staging = [half_ids[: self.chunk], half_ids[self.chunk:]]
        eng._slot_pages[slot] = list(half_ids) + list(ws.tail)
        self.slots[slot] = ws
        eng.trace.evt("", "residency.engage", "I", slot)
        log.info("residency: slot %d engaged (%d cold pages spilled, "
                 "window=%d, staging=2x%d)", slot, cold, self.window,
                 self.chunk)

    def release(self, slot: int) -> None:
        """Drop the windowed state (the engine's slot release returns the
        device pages: ``_slot_pages`` lists staging + tail)."""
        self.slots.pop(slot, None)

    def store_bytes(self) -> int:
        """Host bytes held by every engaged slot's store."""
        return sum(x.numel() * x.element_size()
                   for ws in self.slots.values()
                   for blocks in ws.store.values()
                   for x in blocks if x is not None)

    # -- per-token forward ---------------------------------------------

    def _rotate_tail(self, slot: int, ws: _WindowedSlot,
                     p_total: int) -> None:
        """Grow the hot tail to cover logical page ``p_total - 1``: spill
        the oldest tail page (full: two newer pages exist) and allocate a
        fresh device page for the new logical tail."""
        eng = self.eng
        while ws.cold + len(ws.tail) < p_total:
            victim = ws.tail.pop(0)
            ws.store[ws.cold] = self._spill(victim)
            eng._alloc.decref([victim])
            ws.cold += 1
            # The span boundaries moved: every staged half is stale.
            ws.staged = [[None] * eng.cfg.num_layers
                         for _ in range(2)]
            new = eng._alloc.alloc(1)[0]
            eng._spill_flush()
            ws.tail.append(new)
            eng._tables[slot, ws.cold + len(ws.tail) - 1] = new
            eng._slot_pages[slot] = (ws.staging[0] + ws.staging[1]
                                     + list(ws.tail))

    def _ensure_staged(self, ws: _WindowedSlot, span: _Span,
                       layer: int) -> None:
        """Upload layer ``layer`` of cold span ``span``'s pages into its
        staging half unless the half already holds them.  Queued on the
        stream, so calling this for span i+1 right before span i attends
        is the prefetch overlap."""
        half = span.half
        key = (span.lo, span.hi)
        if ws.staged[half][layer] == key:
            return
        eng = self.eng
        cache = eng.cache
        pools = (cache.k, cache.v, cache.k_scale, cache.v_scale)
        eng.trace.evt("", "residency.prefetch", "B", key)
        for j, page in zip(range(span.lo, span.hi), ws.staging[half]):
            for pool, block in zip(pools, ws.store[j]):
                if pool is not None:
                    pool[layer, page].copy_(block[layer, 0],
                                            non_blocking=True)
        ws.staged[half][layer] = key
        if layer == 0:
            # A span's pages go up layer by layer: counted once, as pages.
            eng.metrics.residency_prefetch_pages_total.inc(span.hi - span.lo)
        eng.trace.evt("", "residency.prefetch", "E", key)

    def _spans(self, slot: int, ws: _WindowedSlot, p_total: int, lane):
        """This token's spans in page order: the cold ones through the
        staging halves, then the resident tail."""
        eng = self.eng
        n = eng.ecfg.num_slots
        cold = [(lo, min(lo + self.chunk, ws.cold), i % 2) for i, lo in
                enumerate(range(0, ws.cold, self.chunk))]
        out = []
        for lo, hi, half in cold + [(ws.cold, p_total, None)]:
            tbl = np.zeros_like(eng._tables)
            tbl[slot, lo:hi] = (ws.tail if half is None
                                else ws.staging[half])[: hi - lo]
            bounds = np.zeros((2, n), np.int32)
            bounds[:, slot] = (lo, hi)
            tables = eng._upload(tbl)
            plo, phi = eng._upload(bounds[0]), eng._upload(bounds[1])
            work = None
            if _use_kernel(tables, None):
                # The lanes' work list is the same in every layer.
                work = mixed_work(tables, *lane, page=eng._page,
                                  hkv=eng.cfg.num_kv_heads, qmax=1,
                                  page_lo=plo, page_hi=phi)
            out.append(_Span(lo, hi, half, tables, plo, phi, work))
        return out

    def _attend(self, q, span: _Span, lane, layer: int, carry, emit: bool):
        cache = self.eng.cache
        kw = dict(work=span.work) if span.work is not None else dict(
            page_lo=span.page_lo, page_hi=span.page_hi)
        out = paged_mixed_attention(
            q, cache.k, cache.v, span.tables, *lane, layer,
            k_scale=cache.k_scale, v_scale=cache.v_scale, qmax=1,
            carry_state=carry, emit_state=emit, **kw)
        self.eng.metrics.residency_spans_total.inc(1)
        return out

    def forward(self, slot: int) -> torch.Tensor:
        """One decode token of an engaged slot: the mixed step's layer
        stack on the pipe step's rows (its token in row ``slot`` of a
        ``num_slots``-row block), with the attend replaced by the span
        chain.  Returns the ``[num_slots, V]`` f32 logits (only the slot's
        row is meaningful); the engine runs the sampler tail."""
        eng = self.eng
        ws = self.slots[slot]
        cfg, params, cache = eng.cfg, eng.params, eng.cache
        page = eng._page
        n = eng.ecfg.num_slots
        length = int(eng._lengths[slot])
        p_total = length // page + 1
        self._rotate_tail(slot, ws, p_total)

        a = dict(tokens=np.zeros((n,), np.int32),
                 token_slot=np.full((n,), -1, np.int32),
                 token_pos=np.full((n,), eng._park_sentinel(), np.int32),
                 seq_q_start=np.zeros((n,), np.int32),
                 seq_q_len=np.zeros((n,), np.int32),
                 seq_pos_start=np.zeros((n,), np.int32))
        a["tokens"][slot] = eng._last_token[slot]
        a["token_slot"][slot] = slot
        a["token_pos"][slot] = length
        a["seq_q_start"][slot] = slot
        a["seq_q_len"][slot] = 1
        a["seq_pos_start"][slot] = length
        d = {k: eng._upload(v) for k, v in a.items()}
        lane = (d["seq_q_start"], d["seq_q_len"], d["seq_pos_start"])
        spans = self._spans(slot, ws, p_total, lane)

        # What mixed_step prepares once per step: the rope angles and the
        # per-token write view (padding rows routed past the coverage).
        tables = eng._upload(eng._tables)
        cover = tables.shape[1] * page
        rope = rope_cos_sin(torch.clamp(d["token_pos"], max=cover - 1),
                            cfg.head_dim, cfg.rope_theta)
        tables_tok = tables[d["token_slot"].clamp(min=0).long()]
        write_idx = torch.where(d["token_slot"] < 0,
                                torch.full_like(d["token_pos"], cover),
                                d["token_pos"])
        dst = paged_write_rows(write_idx, tables_tok, page,
                               cache.k.shape[1])
        grouped = moe.use_grouped(n)
        h = embed_lookup(params["embed"], d["tokens"],
                         params["layers"]["attn_norm"].dtype)
        for layer in range(cfg.num_layers):
            lp = tf._layer(params, layer)
            q, k, v = tf._block_qkv(h, lp, cfg, rope)
            if cache.quantized:
                paged_kv_update_quant(cache.k, cache.v, cache.k_scale,
                                      cache.v_scale, k, v, write_idx,
                                      tables_tok, layer, dst=dst)
            else:
                paged_kv_update(cache.k, cache.v, k, v, write_idx,
                                tables_tok, layer, dst=dst)
            carry = None
            for i, span in enumerate(spans):
                last = i + 1 == len(spans)
                if span.half is not None:
                    self._ensure_staged(ws, span, layer)
                    if i + 1 < len(spans) and spans[i + 1].half is not None:
                        # Prefetch the next cold span into the other half
                        # before this span's attend.
                        self._ensure_staged(ws, spans[i + 1], layer)
                eng.trace.evt("", "residency.attend", "B",
                              (span.lo, span.hi))
                carry = self._attend(q, span, lane, layer, carry,
                                     emit=not last)
                eng.trace.evt("", "residency.attend", "E")
            h = tf._block_tail(h, carry.reshape(n, cfg.q_dim), lp, cfg,
                               grouped=grouped)
        sample_src = torch.arange(n, device=h.device)
        return tf._unembed(h[sample_src], params, cfg)

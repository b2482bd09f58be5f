"""Attention ops on the served paths (port of the single-device branches of
``arks_tpu/ops/attention.py``): one-shot and chunked prefill attention, the
mixed scheduler's paged op, and the legacy scheduler's decode ops on the
slot cache and on the paged pool.

GQA everywhere: H = G * Hkv query heads, q reshaped to [.., Hkv, G, ..] so
K/V are never repeated.  Scores and softmax in float32.  Caches and pools
are updated IN PLACE (the reference returns new arrays).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from arks_tpu_torch.ops.pallas_attention import (
    kv_cache_update, kv_cache_update_plain, kv_cache_update_quant,
    kv_cache_update_quant_plain, ragged_decode_attention)
from arks_tpu_torch.ops.paged_attention import (
    MixedWork, _default_qmax, _use_kernel, gather_pool, is_int4_pool,
    mixed_work, paged_decode_attention, paged_gather_kv, paged_kv_update,
    paged_kv_update_quant, paged_mixed_attention, paged_update_xla,
    paged_write_rows, pool_page_tokens)

_NEG_INF = -1e30


def _softmax(scores: torch.Tensor, dim: int) -> torch.Tensor:
    scores = scores - scores.amax(dim=dim, keepdim=True)
    unnorm = torch.exp(scores)
    return unnorm / (unnorm.sum(dim=dim, keepdim=True) + 1e-9)


def prefill_attention(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, T, Hkv, D]
    v: torch.Tensor,  # [B, T, Hkv, D]
) -> torch.Tensor:
    """Causal self-attention over a full (padded) prompt.  Returns
    [B, T, H, D].  Plain math, as in the reference (XLA there): f32
    scores, softmax, probabilities cast to v's dtype, f32 accumulation.
    Padded positions sit at the end: no valid query attends them."""
    b, t, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, t, hkv, h // hkv, d).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg,
                          k.float()) * (1.0 / math.sqrt(d))
    causal = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, _NEG_INF)
    probs = _softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.float(), v.float())
    return out.reshape(b, t, h, d).to(q.dtype)


def decode_attention_xla(
    q: torch.Tensor,        # [B, Hkv, G, D] — one query token per row
    k_cache: torch.Tensor,  # [B, Hkv, S, D]
    v_cache: torch.Tensor,  # [B, Hkv, S, D]
    lengths: torch.Tensor,  # [B] — valid cache entries per row
) -> torch.Tensor:
    """Masked attention of one query per row against its cache (entry s is
    valid iff s < lengths[b]) — the reference's XLA oracle, and the plain
    path of ``paged_mixed_update_and_attend``.  Returns [B, Hkv, G, D]."""
    s = k_cache.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bkgd,bksd->bkgs", q.float(),
                          k_cache.float()) * scale
    valid = torch.arange(s, device=q.device)[None] < lengths[:, None]
    scores = scores.masked_fill(~valid[:, None, None], _NEG_INF)
    probs = _softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgs,bksd->bkgd", probs.float(), v_cache.float())
    return out.to(q.dtype)


def _decode_attention_xla_quant(
    q: torch.Tensor,        # [B, Hkv, G, D]
    k_cache: torch.Tensor,  # [B, Hkv, S, D] int8
    v_cache: torch.Tensor,
    k_scale: torch.Tensor,  # [B, Hkv, S] f32
    v_scale: torch.Tensor,
    lengths: torch.Tensor,  # [B]
) -> torch.Tensor:
    """The reference's int8 oracle: per-token scales applied to the scores
    (K) and to the normalised probabilities (V) — the kernel instead
    scales p before normalising, a by-design difference of rounding."""
    s = k_cache.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bkgd,bksd->bkgs", q.float(),
                          k_cache.to(q.dtype).float()) * scale
    scores = scores * k_scale[:, :, None, :]
    valid = torch.arange(s, device=q.device)[None] < lengths[:, None]
    scores = scores.masked_fill(~valid[:, None, None], _NEG_INF)
    probs = _softmax(scores, dim=-1) * v_scale[:, :, None, :]
    out = torch.einsum("bkgs,bksd->bkgd", probs.to(q.dtype).float(),
                       v_cache.to(q.dtype).float())
    return out.to(q.dtype)


def chunk_attention_xla(
    q: torch.Tensor,        # [Hkv, G, C, D] — a chunk of queries, ONE slot
    k_cache: torch.Tensor,  # [Hkv, S, D] — that slot's cache (chunk written)
    v_cache: torch.Tensor,
    start: int,             # global position of the chunk's first query
    k_scale: torch.Tensor | None = None,  # [Hkv, S] f32 — int8 caches
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Chunked-prefill attention: the query at chunk offset i (global
    position start + i) attends cache entries [0, start + i].  Returns
    [Hkv, G, C, D].  The reference's plain math: scales fold into the
    scores (K) and into the normalised probabilities (V)."""
    c, d = q.shape[2], q.shape[3]
    s = k_cache.shape[1]
    scores = torch.einsum("kgcd,ksd->kgcs", q.float(),
                          k_cache.to(q.dtype).float()) * (1.0 / math.sqrt(d))
    if k_scale is not None:
        scores = scores * k_scale[:, None, None, :]
    qpos = start + torch.arange(c, device=q.device)
    valid = torch.arange(s, device=q.device)[None] <= qpos[:, None]  # [C, S]
    scores = scores.masked_fill(~valid, _NEG_INF)
    probs = _softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale[:, None, None, :]
    out = torch.einsum("kgcs,ksd->kgcd", probs.to(q.dtype).float(),
                       v_cache.to(q.dtype).float())
    return out.to(q.dtype)


def decode_update_and_attend(
    q: torch.Tensor,        # [B, H, D] — this step's query per slot
    k_new: torch.Tensor,    # [B, Hkv, D] — this step's KV per slot
    v_new: torch.Tensor,
    k_cache: torch.Tensor,  # [L, B, Hkv, S, D] — updated IN PLACE
    v_cache: torch.Tensor,
    write_idx: torch.Tensor,  # [B] int32 — tokens already in cache per slot
    layer: int, *,
    impl: str | None = None,
    k_scale: torch.Tensor | None = None,  # [L, B, Hkv, S] f32 — int8 caches
    v_scale: torch.Tensor | None = None,
    lengths: torch.Tensor | None = None,  # [B] int32: write_idx + 1
) -> torch.Tensor:
    """Write this step's K/V row at ``write_idx`` of ``layer`` (dropped at
    or past S: a parked slot), then attend over the valid prefix, now
    ``write_idx + 1`` entries.  Returns out [B, H, D].  ``lengths`` is
    that ``write_idx + 1``, the same in every layer of a step: the caller
    makes it once per step, or it is made here.

    ``impl`` picks the path (the single-device branch of the reference):
    - None / "kernel": ``kv_cache_update`` (``kv_cache_update_quant`` for an
      int8 cache) then ``ragged_decode_attention``; on CUDA tensors they
      launch the CUDA kernels, on CPU tensors their plain versions run.
    - "plain": the reference's XLA oracle — the scatter (the update
      kernels' plain versions: rows past S drop, quantized for int8) and
      ``decode_attention_xla`` (``_decode_attention_xla_quant``) over the
      layer's cache."""
    b, h, d = q.shape
    hkv = k_cache.shape[2]
    if k_cache.shape[-1] != d:
        raise ValueError(f"cache head_dim {k_cache.shape[-1]} != q head_dim "
                         f"{d} (the port stores head_dim unpadded)")
    quantized = k_scale is not None
    qg = q.reshape(b, hkv, h // hkv, d)
    if lengths is None:
        lengths = write_idx + 1
    if impl == "plain":
        if quantized:
            kv_cache_update_quant_plain(k_cache, v_cache, k_scale, v_scale,
                                        k_new, v_new, write_idx, layer)
            out = _decode_attention_xla_quant(
                qg, k_cache[layer], v_cache[layer], k_scale[layer],
                v_scale[layer], lengths)
        else:
            kv_cache_update_plain(k_cache, v_cache, k_new, v_new, write_idx,
                                  layer)
            out = decode_attention_xla(qg, k_cache[layer], v_cache[layer],
                                       lengths)
        return out.reshape(b, h, d)
    if quantized:
        kv_cache_update_quant(k_cache, v_cache, k_scale, v_scale, k_new,
                              v_new, write_idx, layer, impl=impl)
    else:
        kv_cache_update(k_cache, v_cache, k_new, v_new, write_idx, layer,
                        impl=impl)
    out = ragged_decode_attention(qg, k_cache, v_cache, lengths, layer,
                                  k_scale, v_scale, impl=impl)
    return out.reshape(b, h, d)


def paged_decode_update_and_attend(
    q: torch.Tensor,        # [B, H, D]
    k_new: torch.Tensor,    # [B, Hkv, D]
    v_new: torch.Tensor,
    k_pool: torch.Tensor,   # [L, N, Hkv, P, D] — updated IN PLACE
    v_pool: torch.Tensor,
    tables: torch.Tensor,   # [B, MaxP] int32 block tables
    write_idx: torch.Tensor,  # [B] int32 (>= MaxP*P = inactive: dropped)
    layer: int, *,
    impl: str | None = None,
    k_scale: torch.Tensor | None = None,  # [L, N, Hkv, P] f32 — IN PLACE
    v_scale: torch.Tensor | None = None,
    work: MixedWork | None = None,  # int4: ``decode_mixed_work`` of the step
    dst: torch.Tensor | None = None,  # [B] ``paged_write_rows`` of the step
) -> torch.Tensor:
    """Paged counterpart of ``decode_update_and_attend``: the row lands in
    the slot's table-mapped page and attention reads only table pages.  A
    ``write_idx`` at or beyond the table's coverage marks an INACTIVE slot:
    its write is dropped and it attends nothing (its stale table may point
    at pages other slots now own).  Returns out [B, H, D].

    ``impl`` None / "kernel": ``paged_kv_update`` (``paged_kv_update_quant``
    for a quantized pool) then ``paged_decode_attention``; "plain": the
    reference's XLA oracle (the scatter, a gather of the slots' pages and
    ``decode_attention_xla`` / ``_decode_attention_xla_quant``).  An int4
    pool has no decode kernel (the reference's comment names the mixed
    kernel's fused nibble dequant as its decode path): its attention is
    ``paged_mixed_attention`` over one query per slot, on the
    ``decode_mixed_work`` view (``work``: built once per step by the
    caller, or here when None).  ``dst``: each slot's destination pool row,
    resolved once per step by the caller; the update kernel reads it
    instead of ``write_idx`` and ``tables``."""
    b, h, d = q.shape
    hkv = k_pool.shape[2]
    if k_pool.shape[-1] != d:
        raise ValueError(f"pool head_dim {k_pool.shape[-1]} != q head_dim "
                         f"{d} (the port stores head_dim unpadded)")
    quantized = k_scale is not None
    int4 = is_int4_pool(k_pool, k_scale)
    cover = tables.shape[1] * pool_page_tokens(k_pool, k_scale)
    attend_lens = torch.where(write_idx >= cover, torch.zeros_like(write_idx),
                              write_idx + 1)
    qg = q.reshape(b, hkv, h // hkv, d)
    if impl == "plain":
        paged_update_xla(k_pool, v_pool, k_scale, v_scale, k_new, v_new,
                         write_idx, tables, layer)
        kc = gather_pool(k_pool, tables, layer, int4)
        vc = gather_pool(v_pool, tables, layer, int4)
        if quantized:
            out = _decode_attention_xla_quant(
                qg, kc, vc, paged_gather_kv(k_scale, tables, layer),
                paged_gather_kv(v_scale, tables, layer), attend_lens)
        else:
            out = decode_attention_xla(qg, kc, vc, attend_lens)
        return out.reshape(b, h, d)
    if quantized:
        paged_kv_update_quant(k_pool, v_pool, k_scale, v_scale, k_new, v_new,
                              write_idx, tables, layer, impl=impl, dst=dst)
    else:
        paged_kv_update(k_pool, v_pool, k_new, v_new, write_idx, tables,
                        layer, impl=impl, dst=dst)
    if int4:
        if work is None:
            work = decode_mixed_work(tables, write_idx,
                                     page=pool_page_tokens(k_pool, k_scale),
                                     hkv=hkv)
        return paged_mixed_attention(
            q, k_pool, v_pool, work.tables, work.seq_q_start, work.q_len,
            work.pos_start, layer, k_scale=k_scale, v_scale=v_scale, qmax=1,
            impl=impl, work=work)
    out = paged_decode_attention(qg, k_pool, v_pool, tables, attend_lens,
                                 layer, k_scale, v_scale, impl=impl)
    return out.reshape(b, h, d)


def decode_mixed_work(tables: torch.Tensor, write_idx: torch.Tensor, *,
                      page: int, hkv: int) -> MixedWork:
    """The mixed attention kernel's view of one decode step over a paged
    pool: slot b is lane b with one query (flat token b) at position
    ``write_idx[b]``; an inactive slot (write index at or past the table's
    coverage) gets q_len 0 and a zero output.  Built on the device, once
    per step; every layer's launch reuses it."""
    b = write_idx.shape[0]
    widx = write_idx.to(torch.int32)
    active = (widx < tables.shape[1] * page).to(torch.int32)
    lanes = torch.arange(b, dtype=torch.int32, device=widx.device)
    return mixed_work(tables, lanes, active, widx, page=page, hkv=hkv,
                      qmax=1)


class MixedBatch(NamedTuple):
    """Layer-invariant inputs of one mixed dispatch, prepared once per step
    by ``prepare_mixed`` and reused by every layer: the per-token write view
    (each token's block-table row and write position, padding routed past
    the table's coverage), each token's destination pool row resolved from
    it (``paged_write_rows``: what every layer's update kernel reads) and,
    on the kernel path, the attention kernel's work list."""

    tables_tok: torch.Tensor   # [T, MaxP] int32
    write_idx: torch.Tensor    # [T] int32
    work: MixedWork | None
    dst: torch.Tensor | None   # [T] int32 page * P + offset, -1 dropped


def prepare_mixed(k_pool: torch.Tensor, tables: torch.Tensor,
                  token_slot: torch.Tensor, token_pos: torch.Tensor,
                  seq_q_start: torch.Tensor, seq_q_len: torch.Tensor,
                  seq_pos_start: torch.Tensor, *, impl: str | None = None,
                  qmax: int | None = None,
                  k_scale: torch.Tensor | None = None) -> MixedBatch:
    page = pool_page_tokens(k_pool, k_scale)
    cover = tables.shape[1] * page
    tables_tok = tables[token_slot.clamp(min=0).long()]
    write_idx = torch.where(token_slot < 0,
                            torch.full_like(token_pos, cover), token_pos)
    dst = paged_write_rows(write_idx, tables_tok, page, k_pool.shape[1])
    work = None
    if _use_kernel(k_pool, impl):
        qmax = qmax or _default_qmax(token_slot.shape[0],
                                     seq_q_len.shape[0])
        work = mixed_work(tables, seq_q_start, seq_q_len, seq_pos_start,
                          page=page, hkv=k_pool.shape[2], qmax=qmax)
    return MixedBatch(tables_tok, write_idx, work, dst)


def paged_mixed_update_and_attend(
    q: torch.Tensor,            # [T, H, D] — flat mixed token batch
    k_new: torch.Tensor,        # [T, Hkv, D]
    v_new: torch.Tensor,
    k_pool: torch.Tensor,       # [L, N, Hkv, P(/2), D] — updated IN PLACE
    v_pool: torch.Tensor,
    tables: torch.Tensor,       # [B, MaxP] int32 — lane b == slot b
    token_slot: torch.Tensor,   # [T] int32 slot per token (-1 = padding)
    token_pos: torch.Tensor,    # [T] int32 global position per token
    seq_q_start: torch.Tensor,  # [B] int32 — lane's first flat-token index
    seq_q_len: torch.Tensor,    # [B] int32 — lane's token count (0 inactive)
    seq_pos_start: torch.Tensor,  # [B] int32 — lane's first global position
    layer: int, *,
    impl: str | None = None,
    qmax: int | None = None,
    batch: MixedBatch | None = None,
    k_scale: torch.Tensor | None = None,  # [L, N, Hkv, P] f32 — IN PLACE
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Write every token's K/V row through its slot's block table (in
    place — the reference returned new pools), then attend token t over
    its slot's pages at positions [0, token_pos[t]].  Padding tokens
    (token_slot < 0) drop their writes.  Returns out [T, H, D].  With
    ``k_scale``/``v_scale`` the pools are int8 (or int4, packed): rows are
    quantized on the write and scales fold into the attention.

    ``impl`` picks the path (the single-device branch of the reference):
    - None / "kernel": the kernel wrappers — ``paged_kv_update`` (or
      ``paged_kv_update_quant``) then the ragged ``paged_mixed_attention``
      over the per-lane view (seq_q_start / seq_q_len / seq_pos_start).
      On CUDA tensors they launch the CUDA kernels; on CPU tensors their
      plain versions run.  Padding-token rows come out zero.
    - "plain": the reference's XLA oracle — the per-token scatter, a
      per-token gather of the pages (int4 pages unpacked) and
      ``decode_attention_xla`` (``_decode_attention_xla_quant`` for a
      quantized pool).  Its padding-token rows attend nothing and come
      out as garbage no one samples, exactly as in the reference.
    ``batch`` is this step's ``prepare_mixed`` (built here when None)."""
    t, h, d = q.shape
    hkv = k_pool.shape[2]
    if k_pool.shape[-1] != d:
        raise ValueError(f"pool head_dim {k_pool.shape[-1]} != q head_dim "
                         f"{d} (the port stores head_dim unpadded)")
    quantized = k_scale is not None
    if batch is None:
        batch = prepare_mixed(k_pool, tables, token_slot, token_pos,
                              seq_q_start, seq_q_len, seq_pos_start,
                              impl=impl, qmax=qmax, k_scale=k_scale)
    if impl == "plain":
        paged_update_xla(k_pool, v_pool, k_scale, v_scale, k_new, v_new,
                         batch.write_idx, batch.tables_tok, layer)
        int4 = is_int4_pool(k_pool, k_scale)
        kc = gather_pool(k_pool, batch.tables_tok, layer, int4)  # [T,Hkv,C,D]
        vc = gather_pool(v_pool, batch.tables_tok, layer, int4)
        attend_lens = torch.where(token_slot < 0,
                                  torch.zeros_like(token_pos), token_pos + 1)
        qg = q.reshape(t, hkv, h // hkv, d)
        if quantized:
            out = _decode_attention_xla_quant(
                qg, kc, vc, paged_gather_kv(k_scale, batch.tables_tok, layer),
                paged_gather_kv(v_scale, batch.tables_tok, layer),
                attend_lens)
        else:
            out = decode_attention_xla(qg, kc, vc, attend_lens)
        return out.reshape(t, h, d)
    if quantized:
        paged_kv_update_quant(k_pool, v_pool, k_scale, v_scale, k_new, v_new,
                              batch.write_idx, batch.tables_tok, layer,
                              impl=impl, dst=batch.dst)
    else:
        paged_kv_update(k_pool, v_pool, k_new, v_new, batch.write_idx,
                        batch.tables_tok, layer, impl=impl, dst=batch.dst)
    return paged_mixed_attention(q, k_pool, v_pool, tables, seq_q_start,
                                 seq_q_len, seq_pos_start, layer,
                                 k_scale=k_scale, v_scale=v_scale, qmax=qmax,
                                 impl=impl, work=batch.work)

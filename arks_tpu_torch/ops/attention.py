"""Attention ops on the served path (port of ``arks_tpu/ops/attention.py``).

GQA everywhere: H = G * Hkv query heads, q reshaped to [.., Hkv, G, ..] so
K/V are never repeated.  Scores and softmax in float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from arks_tpu_torch.ops.paged_attention import (
    MixedWork, _default_qmax, _use_kernel, gather_pool, is_int4_pool,
    mixed_work, paged_gather_kv, paged_kv_update, paged_kv_update_quant,
    paged_mixed_attention, paged_update_xla, pool_page_tokens)

_NEG_INF = -1e30


def _softmax(scores: torch.Tensor, dim: int) -> torch.Tensor:
    scores = scores - scores.amax(dim=dim, keepdim=True)
    unnorm = torch.exp(scores)
    return unnorm / (unnorm.sum(dim=dim, keepdim=True) + 1e-9)


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


class MixedBatch(NamedTuple):
    """Layer-invariant inputs of one mixed dispatch, prepared once per step
    by ``prepare_mixed`` and reused by every layer: the per-token write view
    (each token's block-table row and write position, padding routed past
    the table's coverage) and, on the kernel path, the attention kernel's
    work list."""

    tables_tok: torch.Tensor   # [T, MaxP] int32
    write_idx: torch.Tensor    # [T] int32
    work: MixedWork | None


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
    work = None
    if _use_kernel(k_pool, impl):
        qmax = qmax or _default_qmax(token_slot.shape[0],
                                     seq_q_len.shape[0])
        work = mixed_work(tables, seq_q_start, seq_q_len, seq_pos_start,
                          page=page, hkv=k_pool.shape[2], qmax=qmax)
    return MixedBatch(tables_tok, write_idx, work)


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
                              impl=impl)
    else:
        paged_kv_update(k_pool, v_pool, k_new, v_new, batch.write_idx,
                        batch.tables_tok, layer, impl=impl)
    return paged_mixed_attention(q, k_pool, v_pool, tables, seq_q_start,
                                 seq_q_len, seq_pos_start, layer,
                                 k_scale=k_scale, v_scale=v_scale, qmax=qmax,
                                 impl=impl, work=batch.work)

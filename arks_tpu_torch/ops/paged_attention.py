"""Paged KV cache ops: the pool formats, block-table work lists, the plain
PyTorch oracles, and the wrappers of the four CUDA kernels that replace
its Pallas kernels (port of ``arks_tpu/ops/paged_attention.py``).

- **Pool layout** ``[L, N_pages, Hkv, P, D]``; block tables ``[B, MaxP]``
  int32 map position p of lane b to pool page ``tables[b, p // P]``.  The
  head dim is stored unpadded (the reference's 128-lane padding works
  around a TPU Mosaic limit Hopper does not have).
- **Quantized pools** keep the reference's bytes.  An int8 pool is
  ``[L, N, Hkv, P, D]`` int8; an int4 pool packs token pairs along the page
  axis, ``[L, N, Hkv, P/2, D]`` int8 with token 2t in the low nibble and
  2t+1 in the high nibble.  Both carry per-token f32 scales
  ``[L, N, Hkv, P]``, and an int4 pool is detected by pool rows != scale
  page.  Values are symmetric per token over D (``quantize_kv``).
- **Pools are updated in place.**  The JAX functions return new arrays;
  here ``paged_update_xla``, ``paged_kv_update`` and
  ``paged_kv_update_quant`` write into the tensors they are given (and
  return them for symmetry).
- **Write destinations once per step.**  A token's pool row is the same
  in every layer of a step: ``paged_write_rows`` resolves it once (the
  reference reads its indices from scalar-prefetched SMEM), and both
  update kernels take it as ``dst``.
- **Kernels** (``csrc/paged_kv_update.cu``, ``csrc/paged_kv_update_quant.cu``,
  ``csrc/paged_mixed_attention.cu`` — a ragged and a dense launch, picked
  by ``ARKS_MIXED_GRID`` — and ``csrc/decode_attention.cu``) launch for CUDA tensors and raise on
  anything they do not take — a build or launch error, an unsupported
  dtype or shape; there is no fallback.  Tensors on the CPU take each
  kernel's plain version, which ``impl="plain"`` also selects on the card
  (for comparison only).  Each wrapper counts its launches in
  ``<wrapper>.launches``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from arks_tpu_torch import knobs
from arks_tpu_torch.ops import _kernels

_NEG_INF = -1e30

# Most query rows one attention work item holds (csrc kBQ): the reference's
# default block_q, min(qmax, 32).
MAX_BLOCK_Q = 32
# Most query heads per KV head the CUDA kernels take.
MAX_GROUP = 8
# Most positions per split-KV piece of the mixed-attention kernel (csrc
# kPiece): one page of the served pool; a larger page (a multiple of it)
# is cut into pieces of this size.
MIXED_PIECE = 256
# Positions per split-KV piece of the decode kernels (csrc kSplit): one
# 256-token page of the served pool, 256 rows of a slot stripe.
DECODE_SPLIT = 256
_KERNEL_HEAD_DIMS = (64, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The mixed-attention kernel's pool streams (csrc kSame .. kBf16Pool).
_KV_SAME, _KV_INT8, _KV_INT4, _KV_BF16 = 0, 1, 2, 3


def _use_kernel(x: torch.Tensor, impl: str | None) -> bool:
    """Kernel for CUDA tensors, the plain version for CPU tensors or when
    ``impl="plain"`` asks for it."""
    if impl not in (None, "kernel", "plain"):
        raise ValueError(f"impl={impl!r} (expected 'kernel' or 'plain')")
    return impl != "plain" and x.is_cuda


def _stream(index: int | None = None) -> int:
    """The current CUDA stream of device ``index`` (the current device when
    None) as the raw handle the C entry points take.  Read at every call,
    so a caller's ``torch.cuda.stream(...)`` context holds, without
    building a ``torch.cuda.Stream`` object."""
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)


def _check_operands(kernel: str, device: torch.device, operands, *,
                    aligned: bool = True) -> list[int]:
    """Raise unless every (name, tensor) lies on ``device`` and, with
    ``aligned``, is contiguous and 16-byte aligned; returns their data
    pointers."""
    ptrs = []
    for name, x in operands:
        if x.get_device() != device.index:          # -1 off the card
            raise ValueError(f"{kernel}: {name} is not on {device}")
        ptr = x.data_ptr()
        if aligned and (ptr % 16 or not x.is_contiguous()):
            raise ValueError(f"{kernel}: {name} must be contiguous and "
                             "16-byte aligned")
        ptrs.append(ptr)
    return ptrs


# ---------------------------------------------------------------------------
# Quantized pool formats
# ---------------------------------------------------------------------------


def is_int4_pool(k_pool: torch.Tensor, k_scale: torch.Tensor | None) -> bool:
    return k_scale is not None and k_pool.shape[3] != k_scale.shape[3]


def pool_page_tokens(k_pool: torch.Tensor,
                     k_scale: torch.Tensor | None) -> int:
    """Tokens per page — the position-arithmetic page size (2x the packed
    byte rows for int4 pools)."""
    return k_scale.shape[3] if is_int4_pool(k_pool, k_scale) \
        else k_pool.shape[3]


def pack_int4(vals: torch.Tensor, axis: int) -> torch.Tensor:
    """Pack int8 values in [-7, 7] into nibble pairs along ``axis`` (its
    extent must be even): out[.., t, ..] = lo(2t) | hi(2t+1) << 4."""
    axis = axis % vals.ndim
    pr = vals.unflatten(axis, (vals.shape[axis] // 2, 2))
    lo, hi = pr.select(axis + 1, 0), pr.select(axis + 1, 1)
    return ((lo & 15) | (hi << 4)).to(torch.int8)


def unpack_int4(packed: torch.Tensor, axis: int) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: int8 nibble pairs -> int8 values in
    [-7, 7], doubling ``axis``.  Sign extension is two arithmetic shifts
    (done in int32, so the left shift never overflows)."""
    axis = axis % packed.ndim
    w = packed.to(torch.int32)
    lo = (w << 28) >> 28
    hi = w >> 4
    return torch.stack([lo, hi], dim=axis + 1).flatten(
        axis, axis + 1).to(torch.int8)


def unpack_int4_pool(pool: torch.Tensor) -> torch.Tensor:
    """[L, N, Hkv, P//2, D] packed -> [L, N, Hkv, P, D] int8 — the oracle's
    view (every int8 oracle then applies unchanged)."""
    return unpack_int4(pool, axis=3)


def quantize_kv(x: torch.Tensor, axis: int = -1,
                qmax: int = 127) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-token quantization (the reference's
    ``pallas_attention.quantize_kv``): returns (q int8, scale f32) with the
    scale axis removed.  scale = max(amax / qmax, 1e-8) and q =
    clip(round_half_even(x / scale), -qmax, qmax).  Bit for bit what the
    reference computes, which always runs under ``jit``: there XLA turns
    the division by the constant qmax into a multiplication by its f32
    reciprocal, while x / scale stays an IEEE division."""
    xf = x.float()
    amax = xf.abs().amax(dim=axis)
    inv = torch.ones((), dtype=torch.float32, device=x.device) / qmax
    scale = torch.clamp(amax * inv, min=1e-8)
    q = torch.clamp(torch.round(xf / scale.unsqueeze(axis)), -qmax, qmax)
    return q.to(torch.int8), scale


# ---------------------------------------------------------------------------
# Mixed-grid planning and the ragged work list
# ---------------------------------------------------------------------------


def mixed_grid_mode() -> str:
    """``ARKS_MIXED_GRID``: "ragged" (the work-list launch, the default) or
    "dense" (one CTA per (sequence, KV head, q-block) of the whole grid,
    the reference's byte-identity reference)."""
    m = knobs.get_str("ARKS_MIXED_GRID").lower()
    if m not in ("ragged", "dense"):
        raise ValueError(f"ARKS_MIXED_GRID={m!r} (expected ragged|dense)")
    return m


def mixed_grid_plan(qmax: int) -> dict:
    """Static launch parameters of the ragged mixed attention, with fixed
    defaults (the reference's autotune table is a later slice): ``block_q``
    = min(qmax, MAX_BLOCK_Q).  A non-divisible qmax pads the q axis to the
    block, as in the reference.  Every work item holds one KV head (the
    reference's ``head_group=1``): the G query heads of that head share
    each K/V tile."""
    qmax = max(int(qmax), 1)
    block_q = min(MAX_BLOCK_Q, qmax)
    qpad = -(-qmax // block_q) * block_q
    return dict(block_q=block_q, qpad=qpad, num_qb=qpad // block_q)


def build_mixed_work_list(pos_start: torch.Tensor, q_len: torch.Tensor, *,
                          page: int, block_q: int, num_qb: int,
                          max_pages: int, head_groups: int = 1,
                          page_lo: torch.Tensor | None = None,
                          page_hi: torch.Tensor | None = None):
    """The ragged grid's work list, built on the tensors' device with torch
    ops (no host round trip).  One item per REAL (sequence, head_group,
    q_block), compacted to the front of a fixed-length
    [S * head_groups * num_qb] list by a stable argsort; returns
    (seq, hg, qb, plo, pages), each int32:

    - real items: pages = ceil(causal kv end / page) clamped to the table
      width and to ``page_hi[seq]``; plo = min(``page_lo[seq]``, pages)
      (0 without ``page_lo``) — the item streams pages [plo, pages);
    - padding items (q_len = 0 lanes, q-blocks past a lane's q_len):
      pages = 0, plo = 0 and (seq, hg, qb) aliased to the LAST real item.

    Bit-for-bit the reference's list (``paged_attention.py:172``)."""
    dev = q_len.device
    s = q_len.shape[0]
    n = s * head_groups * num_qb
    i32 = dict(dtype=torch.int32, device=dev)
    seq = torch.arange(s, **i32).repeat_interleave(head_groups * num_qb)
    hg = torch.arange(head_groups, **i32).repeat_interleave(num_qb).repeat(s)
    qb = torch.arange(num_qb, **i32).repeat(s * head_groups)
    seq_l = seq.long()
    qlen_i = q_len.to(torch.int32)[seq_l]
    q_lo = qb * block_q
    active = q_lo < qlen_i
    kv_end = torch.where(
        active, pos_start.to(torch.int32)[seq_l]
        + torch.minimum(q_lo + block_q, qlen_i), torch.zeros_like(q_lo))
    pages = torch.clamp(torch.div(kv_end + (page - 1), page,
                                  rounding_mode="floor"), max=max_pages)
    if page_hi is not None:
        pages = torch.minimum(pages, page_hi.to(torch.int32)[seq_l])
    if page_lo is not None:
        plo = torch.where(active, torch.minimum(
            page_lo.to(torch.int32)[seq_l], pages), torch.zeros_like(pages))
    else:
        plo = torch.zeros_like(pages)
    order = torch.argsort(torch.logical_not(active).to(torch.int32),
                          stable=True)
    seq, hg, qb, plo, pages = (seq[order], hg[order], qb[order], plo[order],
                               pages[order])
    n_real = active.to(torch.int32).sum()
    # A [1] index, not a 0-d one: indexing with a 0-d tensor reads its
    # value on the host (a sync).
    last = torch.clamp(n_real - 1, min=0).reshape(1).long()
    pad = torch.arange(n, **i32) >= n_real
    seq = torch.where(pad, seq[last], seq)
    hg = torch.where(pad, hg[last], hg)
    qb = torch.where(pad, qb[last], qb)
    plo = torch.where(pad, torch.zeros_like(plo), plo)
    pages = torch.where(pad, torch.zeros_like(pages), pages)
    return seq, hg, qb, plo, pages


def pieces_per_page(page: int) -> int:
    """Split-KV pieces of one pool page: 1 up to MIXED_PIECE positions,
    page / MIXED_PIECE above (the kernel takes multiples of it there)."""
    return max(1, page // MIXED_PIECE)


def mixed_pieces(q_len: torch.Tensor, seq: torch.Tensor, qb: torch.Tensor,
                 plo: torch.Tensor, pages: torch.Tensor, *, page: int,
                 block_q: int, max_pages: int):
    """The split-KV layout of a list of items (the work list, or the dense
    rectangle in its order), on the device with no host sync: item i
    streams pages [plo[i], pages[i]) as (pages - plo) * pieces_per_page
    pieces of at most MIXED_PIECE positions (none for padding items, whose
    pages are 0).  Returns (pcum, pbase, pitem), int32: the inclusive
    prefix sum of the piece counts [n_items]; the first partial row of each
    item [n_items] in units of its query rows (the kernel scales it by G),
    the sum of count x rows over the items before it; and the item of each
    piece [n_items * max_pages * pieces_per_page] (the grid's static
    bound; entries past the last piece are unused)."""
    rows = torch.clamp(torch.minimum(
        q_len.to(torch.int32)[seq.long()] - qb * block_q,
        torch.full_like(qb, block_q)), min=0)
    count = torch.clamp(pages - plo, min=0) * pieces_per_page(page)
    count = torch.where(rows > 0, count, torch.zeros_like(count))
    used = count * rows
    pcum = torch.cumsum(count, 0).to(torch.int32)
    pbase = (torch.cumsum(used, 0) - used).to(torch.int32)
    bound = pcum.shape[0] * max_pages * pieces_per_page(page)
    pitem = torch.clamp(torch.searchsorted(
        pcum, torch.arange(bound, dtype=torch.int32, device=pcum.device),
        right=True), max=pcum.shape[0] - 1).to(torch.int32)
    return pcum, pbase, pitem


def dense_items(pos_start: torch.Tensor, q_len: torch.Tensor, *, page: int,
                block_q: int, num_qb: int, hkv: int, max_pages: int):
    """The dense rectangle's items in its order, item (s * hkv + h) *
    num_qb + qb: (seq, qb, plo, pages) as the dense kernel derives them —
    an idle q-block has no pages."""
    s = q_len.shape[0]
    i32 = dict(dtype=torch.int32, device=q_len.device)
    seq = torch.arange(s, **i32).repeat_interleave(hkv * num_qb)
    qb = torch.arange(num_qb, **i32).repeat(s * hkv)
    qlen_i = q_len.to(torch.int32)[seq.long()]
    q_lo = qb * block_q
    active = q_lo < qlen_i
    end = pos_start.to(torch.int32)[seq.long()] + torch.minimum(
        q_lo + block_q, qlen_i)
    pages = torch.where(active, torch.clamp(torch.div(
        end + (page - 1), page, rounding_mode="floor"), max=max_pages),
        torch.zeros_like(end))
    return seq, qb, torch.zeros_like(pages), pages


# ---------------------------------------------------------------------------
# Oracles (plain PyTorch)
# ---------------------------------------------------------------------------


def paged_gather_kv(pool: torch.Tensor, tables: torch.Tensor,
                    layer: int) -> torch.Tensor:
    """Slot-contiguous [B, Hkv, MaxP*P, D] view of the paged pool (a copy) —
    the oracle path; the kernel never does this.  A 4-D scale pool
    [L, N, Hkv, P] gives [B, Hkv, MaxP*P]."""
    g = pool[layer][tables.long()]              # [B, MaxP, Hkv, P, (D)]
    b, mp, hkv, p = g.shape[:4]
    return g.transpose(1, 2).reshape(b, hkv, mp * p, *g.shape[4:])


def paged_write_rows(write_idx: torch.Tensor, tables: torch.Tensor,
                     page: int, n_pages: int) -> torch.Tensor:
    """Each token's destination row in a pool of ``n_pages`` pages of
    ``page`` tokens: ``tables[t, idx // page] * page + idx % page`` for
    idx = write_idx[t], or -1 where the write is dropped — idx < 0 or
    idx >= MaxP * page (the padding / inactive-lane sentinel), or a table
    entry outside [0, n_pages): the drop rules of ``paged_update_xla``.
    int32 [T], built with tensor ops on the tensors' device (no host sync).
    The destination is the same in every layer of a step, so a step
    resolves it once and every layer's write takes it as ``dst`` (the
    reference's kernels read these indices from scalar-prefetched SMEM)."""
    if n_pages * page >= 2 ** 31:
        raise ValueError(f"{n_pages} pages of {page} tokens do not fit "
                         "int32 pool rows")
    widx = write_idx.to(torch.int32)
    keep = (widx >= 0) & (widx < tables.shape[1] * page)
    safe = torch.where(keep, widx, torch.zeros_like(widx))
    pg = tables.to(torch.int32).gather(
        1, torch.div(safe, page, rounding_mode="floor").long()[:, None])[:, 0]
    keep = keep & (pg >= 0) & (pg < n_pages)
    return torch.where(keep, pg * page + safe % page,
                       torch.full_like(widx, -1))


def _dst_rows(dst: torch.Tensor, page: int, n_pages: int):
    """(tokens kept, their pages, their offsets) from ``paged_write_rows``
    rows; -1, or a row past the pool, is dropped (as the kernels do)."""
    sel = torch.nonzero((dst >= 0) & (dst < n_pages * page)).squeeze(1)
    rows = dst[sel].long()
    return sel, rows // page, rows % page


def paged_update_xla(k_pool, v_pool, k_scale, v_scale, k_new, v_new,
                     write_idx, tables, layer):
    """Scatter one KV row per token through its block-table row, IN PLACE
    (the reference's oracle scatter).  ``write_idx`` at or past the table's
    coverage (MaxP * P) is the inactive-token sentinel: that row is
    dropped, as is a table entry outside the pool.  Quantized pools
    (``k_scale`` given) store ``quantize_kv`` values and scales; int4 pools
    merge one nibble of the target byte, in two parity passes so that
    pair-mates 2t and 2t+1 of one dispatch keep each other's nibble.
    Returns (k_pool, v_pool, k_scale, v_scale)."""
    p = pool_page_tokens(k_pool, k_scale)
    keep = (write_idx < tables.shape[1] * p) & (write_idx >= 0)
    sel = torch.nonzero(keep).squeeze(1)
    idx = write_idx[sel].long()
    page = tables[sel].long().gather(1, (idx // p)[:, None])[:, 0]
    inside = (page >= 0) & (page < k_pool.shape[1])
    return _scatter_rows(k_pool, v_pool, k_scale, v_scale, k_new, v_new,
                         sel[inside], page[inside], idx[inside] % p, layer)


def paged_update_block_xla(k_pool, v_pool, k_scale, v_scale, k_new, v_new,
                           positions, tables, layer):
    """Scatter a K-row KV block per slot (the speculative-verify write)
    through the block table, IN PLACE: ``k_new``/``v_new`` [B, K, Hkv, D],
    row k of slot b at position ``positions[b, k]`` (a block may cross a
    page boundary).  Positions at or past the table's coverage are dropped,
    the inactive-slot sentinel.  The same row writes as
    ``paged_update_xla`` over the flattened block, each row through its
    slot's table row.  Returns (k_pool, v_pool, k_scale, v_scale)."""
    b, kk = positions.shape
    return paged_update_xla(
        k_pool, v_pool, k_scale, v_scale, k_new.reshape(b * kk, *k_new.shape[2:]),
        v_new.reshape(b * kk, *v_new.shape[2:]), positions.reshape(-1),
        tables.repeat_interleave(kk, dim=0), layer)


def _scatter_rows(k_pool, v_pool, k_scale, v_scale, k_new, v_new, sel, page,
                  off, layer):
    """Write token sel[i]'s K/V rows at (layer, page[i], :, off[i]), IN
    PLACE: cast to the pool dtype, or for a quantized pool its
    ``quantize_kv`` values (int4: one nibble merged, in two parity passes)
    and scales.  Returns (k_pool, v_pool, k_scale, v_scale)."""
    if k_scale is None:
        k_pool[layer][page, :, off] = k_new[sel].to(k_pool.dtype)
        v_pool[layer][page, :, off] = v_new[sel].to(v_pool.dtype)
        return k_pool, v_pool, k_scale, v_scale
    int4 = is_int4_pool(k_pool, k_scale)
    qmax = 7 if int4 else 127
    for pool, scales, new in ((k_pool, k_scale, k_new),
                              (v_pool, v_scale, v_new)):
        vals, sc = quantize_kv(new[sel], qmax=qmax)
        scales[layer][page, :, off] = sc
        if not int4:
            pool[layer][page, :, off] = vals
            continue
        for parity in (0, 1):
            m = (off % 2) == parity
            pg, row = page[m], off[m] // 2
            old = pool[layer][pg, :, row]
            if parity == 0:
                merged = (old & -16) | (vals[m] & 15)
            else:
                merged = (old & 15) | (vals[m] << 4)
            pool[layer][pg, :, row] = merged
    return k_pool, v_pool, k_scale, v_scale


def _dense(x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x`` in ``dtype`` (its own when None) and contiguous, with no op
    where it already is."""
    if dtype is not None and x.dtype != dtype:
        x = x.to(dtype)
    return x if x.is_contiguous() else x.contiguous()


def _write_index(kernel: str, device: torch.device, t: int, dst,
                 write_idx, tables):
    """The index operands of an update kernel: the pointers (dst,
    write_idx, tables), None where the kernel reads none, and the table
    width.  With ``dst`` the kernel reads only it."""
    if dst is not None:
        if dst.dtype != torch.int32 or dst.shape != (t,):
            raise ValueError(f"{kernel}: dst must be int32 [{t}], got "
                             f"{dst.dtype} {tuple(dst.shape)}")
        (ptr,) = _check_operands(kernel, device, (("dst", dst),))
        return (ptr, None, None), 0
    if write_idx is None or tables is None:
        raise ValueError(f"{kernel}: needs dst, or write_idx and tables")
    widx, tbl = _dense(write_idx, torch.int32), _dense(tables, torch.int32)
    if widx.shape != (t,) or tbl.dim() != 2 or tbl.shape[0] != t:
        raise ValueError(f"{kernel}: shape mismatch write_idx "
                         f"{tuple(widx.shape)} tables {tuple(tbl.shape)} "
                         f"for {t} tokens")
    ptrs = _check_operands(kernel, device, (("write_idx", widx),
                                            ("tables", tbl)))
    return (None, *ptrs), tbl.shape[1]


# ---------------------------------------------------------------------------
# Kernel #2: in-place paged KV row update
# ---------------------------------------------------------------------------


def paged_kv_update_plain(k_pool, v_pool, k_new, v_new, write_idx, tables,
                          layer, dst=None):
    """Plain version of the update kernel: the oracle scatter, in place;
    with ``dst``, the rows ``paged_write_rows`` resolved."""
    if dst is None:
        paged_update_xla(k_pool, v_pool, None, None, k_new, v_new,
                         write_idx, tables, layer)
    else:
        _scatter_rows(k_pool, v_pool, None, None, k_new, v_new,
                      *_dst_rows(dst, k_pool.shape[3], k_pool.shape[1]),
                      layer)
    return k_pool, v_pool


def _rows_for(pool: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor):
    """The new rows as an update kernel takes them: (k, v, narrow).  f32
    rows into a bf16 pool stay f32 and the kernel rounds them (narrow 1);
    other rows are cast to the pool dtype here."""
    if pool.dtype == torch.bfloat16 and k_new.dtype == torch.float32 and \
            v_new.dtype == torch.float32:
        return _dense(k_new), _dense(v_new), 1
    return _dense(k_new, pool.dtype), _dense(v_new, pool.dtype), 0


def paged_kv_update(k_pool: torch.Tensor,    # [L, N, Hkv, P, D]
                    v_pool: torch.Tensor,
                    k_new: torch.Tensor,     # [T, Hkv, D]
                    v_new: torch.Tensor,
                    write_idx: torch.Tensor | None,  # [T] int32 position
                    tables: torch.Tensor | None,     # [T, MaxP] int32
                    layer: int, *, impl: str | None = None,
                    dst: torch.Tensor | None = None):
    """Write one KV row per token at its table-mapped page, IN PLACE; rows
    with write_idx >= MaxP * P are dropped.  f32 rows into a bf16 pool are
    rounded to nearest even, as the reference's astype.  ``dst`` (int32
    [T], this step's ``paged_write_rows``) gives each token's pool row
    resolved once per step; then write_idx and tables are not read and may
    be None.  CUDA tensors launch ``csrc/paged_kv_update.cu`` (replaces the
    Pallas ``_paged_update_kernel``); CPU tensors take
    ``paged_kv_update_plain``."""
    if not _use_kernel(k_pool, impl):
        return paged_kv_update_plain(k_pool, v_pool, k_new, v_new, write_idx,
                                     tables, layer, dst)
    kernel = "paged_kv_update"
    _, n, hkv, page, d = k_pool.shape
    t = k_new.shape[0]
    if k_pool.dtype not in _KERNEL_DTYPES or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"paged_kv_update kernel takes bf16/f32 pools, got "
                        f"{k_pool.dtype}/{v_pool.dtype}")
    kn, vn, narrow = _rows_for(k_pool, k_new, v_new)
    row_bytes = d * k_pool.element_size()
    if row_bytes % 16:
        raise ValueError(f"paged_kv_update kernel needs D * itemsize % 16 == "
                         f"0, got {row_bytes}")
    if kn.shape != (t, hkv, d) or vn.shape != (t, hkv, d) or \
            v_pool.shape != k_pool.shape:
        raise ValueError("paged_kv_update: shape mismatch k_new "
                         f"{tuple(kn.shape)} v_new {tuple(vn.shape)} pools "
                         f"{tuple(k_pool.shape)} {tuple(v_pool.shape)}")
    if not 0 <= layer < k_pool.shape[0]:
        raise ValueError(f"layer {layer} out of range")
    dev = k_pool.device
    ptrs = _check_operands(kernel, dev, (
        ("k_pool", k_pool), ("v_pool", v_pool), ("k_new", kn),
        ("v_new", vn)))
    index, max_pages = _write_index(kernel, dev, t, dst, write_idx, tables)
    err = _kernels.entry("arks_paged_kv_update")(
        *ptrs, *index, t, hkv, max_pages, n, page, row_bytes, int(layer),
        narrow, _stream(dev.index))
    if err:
        _kernels.raise_launch_error("arks_paged_kv_update", err)
    paged_kv_update.launches += 1
    return k_pool, v_pool


paged_kv_update.launches = 0


# ---------------------------------------------------------------------------
# Kernel #3: in-place quantize-and-write into an int8/int4 pool
# ---------------------------------------------------------------------------

# Widest head the quantized update kernel holds in registers (csrc
# kWordsPerLane: 4 words of 4 elements a lane).
QUANT_UPDATE_MAX_HEAD_DIM = 512


def paged_kv_update_quant_plain(k_pool, v_pool, k_scale, v_scale, k_new,
                                v_new, write_idx, tables, layer, dst=None):
    """Plain version of the quantized update kernel: ``quantize_kv`` plus
    the oracle scatter (with its two-parity nibble merge), in place; with
    ``dst``, at the rows ``paged_write_rows`` resolved."""
    if dst is None:
        return paged_update_xla(k_pool, v_pool, k_scale, v_scale, k_new,
                                v_new, write_idx, tables, layer)
    rows = _dst_rows(dst, pool_page_tokens(k_pool, k_scale), k_pool.shape[1])
    return _scatter_rows(k_pool, v_pool, k_scale, v_scale, k_new, v_new,
                         *rows, layer)


def paged_kv_update_quant(k_pool: torch.Tensor,   # [L, N, Hkv, P(/2), D] i8
                          v_pool: torch.Tensor,
                          k_scale: torch.Tensor,  # [L, N, Hkv, P] f32
                          v_scale: torch.Tensor,
                          k_new: torch.Tensor,    # [T, Hkv, D] bf16/f32
                          v_new: torch.Tensor,
                          write_idx: torch.Tensor | None,  # [T] int32
                          tables: torch.Tensor | None,     # [T, MaxP] int32
                          layer: int, *, impl: str | None = None,
                          dst: torch.Tensor | None = None):
    """Quantize each token's K and V rows per token over D (qmax 127 for an
    int8 pool, 7 for int4) and write values and f32 scales at the
    table-mapped page, IN PLACE; rows with write_idx >= MaxP * P and table
    entries outside the pool are dropped.  ``dst`` (int32 [T], this step's
    ``paged_write_rows`` in token units) gives each token's pool row
    resolved once per step; then write_idx and tables are not read and may
    be None.  CUDA tensors launch ``csrc/paged_kv_update_quant.cu``
    (replaces the Pallas ``_paged_update_quant_kernel``); CPU tensors take
    ``paged_kv_update_quant_plain``."""
    if not _use_kernel(k_pool, impl):
        return paged_kv_update_quant_plain(k_pool, v_pool, k_scale, v_scale,
                                           k_new, v_new, write_idx, tables,
                                           layer, dst)
    kernel = "paged_kv_update_quant"
    _, n, hkv, rows, d = k_pool.shape
    page = k_scale.shape[3]
    int4 = rows != page
    t = k_new.shape[0]
    if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8 or \
            k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError("paged_kv_update_quant kernel takes int8 pools and "
                        f"f32 scales, got {k_pool.dtype}/{v_pool.dtype}/"
                        f"{k_scale.dtype}/{v_scale.dtype}")
    if k_new.dtype not in _KERNEL_DTYPES or v_new.dtype != k_new.dtype:
        raise TypeError("paged_kv_update_quant kernel takes bf16/f32 rows, "
                        f"got {k_new.dtype}/{v_new.dtype}")
    if v_pool.shape != k_pool.shape or k_scale.shape != v_scale.shape or \
            k_scale.shape != k_pool.shape[:3] + (page,) or \
            rows != (page // 2 if int4 else page) or d % 4 or \
            d > QUANT_UPDATE_MAX_HEAD_DIM:
        raise ValueError("paged_kv_update_quant: pools "
                         f"{tuple(k_pool.shape)} and scales "
                         f"{tuple(k_scale.shape)} are not an int8 or int4 "
                         "pool pair with D % 4 == 0 and D <= "
                         f"{QUANT_UPDATE_MAX_HEAD_DIM}")
    kn, vn = _dense(k_new), _dense(v_new)
    if kn.shape != (t, hkv, d) or vn.shape != (t, hkv, d):
        raise ValueError("paged_kv_update_quant: shape mismatch k_new "
                         f"{tuple(kn.shape)} v_new {tuple(vn.shape)} for a "
                         f"pool of {hkv} heads of {d}")
    if not 0 <= layer < k_pool.shape[0]:
        raise ValueError(f"layer {layer} out of range")
    dev = k_pool.device
    ptrs = _check_operands(kernel, dev, (
        ("k_pool", k_pool), ("v_pool", v_pool), ("k_scale", k_scale),
        ("v_scale", v_scale), ("k_new", kn), ("v_new", vn)))
    index, max_pages = _write_index(kernel, dev, t, dst, write_idx, tables)
    err = _kernels.entry("arks_paged_kv_update_quant")(
        *ptrs, *index, t, hkv, d, max_pages, n, page, int(int4), int(layer),
        _KERNEL_DTYPES[kn.dtype], _stream(dev.index))
    if err:
        _kernels.raise_launch_error("arks_paged_kv_update_quant", err)
    paged_kv_update_quant.launches += 1
    return k_pool, v_pool, k_scale, v_scale


paged_kv_update_quant.launches = 0


# ---------------------------------------------------------------------------
# Kernel #1: ragged mixed prefill+decode attention
# ---------------------------------------------------------------------------


def _default_qmax(t: int, s: int) -> int:
    """The reference's widest per-lane query span for a flat batch of T
    tokens over S lanes (``attention.py:430``)."""
    return max(t - s + 1, 1)


def gather_pool(pool, tables, layer, int4: bool) -> torch.Tensor:
    """``paged_gather_kv`` of a value pool; an int4 pool is seen through
    ``unpack_int4_pool``, one layer at a time."""
    if int4:
        pool, layer = unpack_int4_pool(pool[layer:layer + 1]), 0
    return paged_gather_kv(pool, tables, layer)


def _mixed_lanes(q, k_pool, v_pool, tables, seq_q_start, q_len, pos_start,
                 layer, k_scale, v_scale, qmax, page_lo, page_hi):
    """The plain versions' per-lane view: scores [S, Hkv, G, Q, C] (f32,
    scaled, k scale folded), the visible mask [S, 1, 1, Q, C] (causal, and
    inside the span [page_lo * P, page_hi * P)), V [S, Hkv, C, D] in q's
    dtype, the v scales [S, Hkv, 1, 1, C] or None, and the lane rows'
    flat token indices [S, Q] with their validity."""
    t, h, d = q.shape
    s = q_len.shape[0]
    hkv = k_pool.shape[2]
    g = h // hkv
    int4 = is_int4_pool(k_pool, k_scale)
    page = pool_page_tokens(k_pool, k_scale)
    cover = tables.shape[1] * page
    dev = q.device
    ar = torch.arange(qmax, device=dev)
    span = seq_q_start.long()[:, None] + ar                      # [S, Qmax]
    valid = ar[None, :] < q_len.long()[:, None]
    qs = q[span.clamp(max=t - 1)].reshape(s, qmax, hkv, g, d).float()
    kc = gather_pool(k_pool, tables, layer, int4).float()       # [S,Hkv,C,D]
    vc = gather_pool(v_pool, tables, layer, int4).to(q.dtype)
    scores = torch.einsum("sqkgd,skcd->skgqc", qs, kc) * (1.0 / math.sqrt(d))
    if k_scale is not None:
        scores = scores * paged_gather_kv(k_scale, tables,
                                          layer)[:, :, None, None, :]
    qpos = pos_start.long()[:, None] + ar                        # [S, Qmax]
    pos = torch.arange(cover, device=dev)
    seen = pos[None, None, :] <= qpos[:, :, None]                # [S, Q, C]
    if page_lo is not None:
        seen = seen & (pos >= page_lo.long()[:, None, None] * page)
    if page_hi is not None:
        seen = seen & (pos < page_hi.long()[:, None, None] * page)
    vsc = None
    if v_scale is not None:
        vsc = paged_gather_kv(v_scale, tables, layer)[:, :, None, None, :]
    return scores, seen[:, None, None], vc, vsc, span, valid


def _flat_to_lanes(x, span, hkv):
    """Flat rows [T, H(, D)] -> [S, Hkv, G, Q(, D)] of the lanes' rows."""
    t, h = x.shape[:2]
    y = x[span.clamp(max=t - 1)]                         # [S, Q, H(, D)]
    y = y.reshape(*span.shape, hkv, h // hkv, *x.shape[2:])
    return y.movedim(1, 3)


def _lanes_to_flat(x, span, valid, t):
    """[S, Hkv, G, Q(, D)] -> flat rows [T, H(, D)]; rows no lane owns are
    zero."""
    y = x.movedim(3, 1)                                  # [S, Q, Hkv, G(, D)]
    rows = y.reshape(span.numel(), y.shape[2] * y.shape[3], *y.shape[4:])
    out = torch.zeros((t + 1, *rows.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dst = torch.where(valid, span, torch.full_like(span, t)).reshape(-1)
    out.index_copy_(0, dst, rows)       # rows no lane owns land in row T
    return out[:t]


def _fold(state, piece):
    """The left fold of two online-softmax states (m, l, acc).  The
    rescale factors' exp runs in f64 and rounds to f32: a CPU f32 exp's
    bits depend on where the element falls in its vectorized loop, and a
    lane's fold must not depend on the other lanes of its batch."""
    m, l, acc = state
    mp, lp, accp = piece
    mx = torch.maximum(m, mp)
    a = torch.exp((m - mx).double()).float()
    b = torch.exp((mp - mx).double()).float()
    return mx, l * a + lp * b, acc * a[..., None] + accp * b[..., None]


def _mixed_pieces_plain(scores, seen, vc, vsc, p_dtype, plen: int, lo: int,
                        hi: int):
    """The split form's pieces over positions [lo, hi) (piece-aligned):
    each (m, l, acc) of its visible positions alone, from (-1e30, 0, 0):
    p = exp(s - m) there and 0 elsewhere, times the v scale, rounded to
    p_dtype before p.V.  The exp runs once over the whole [.., C] layout
    (as the one-pass form's), so a row's bits do not depend on the batch's
    other rows."""
    shape = scores.shape[:-1]
    n = scores.shape[-1] // plen
    sc = scores.reshape(*shape, n, plen)
    se = seen.reshape(*seen.shape[:-1], n, plen)
    m = torch.where(se, sc, _NEG_INF).amax(dim=-1)             # [.., n]
    p = torch.where(se, torch.exp(sc - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    if vsc is not None:
        p = p * vsc.reshape(*vsc.shape[:-1], n, plen)
    vf = vc.float()
    for i in range(lo // plen, -(-hi // plen)):
        sl = slice(i * plen, (i + 1) * plen)
        yield m[..., i], l[..., i], _pv(p[..., i, :].to(p_dtype).float(),
                                        vf[:, :, sl])


def _pv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p [S, Hkv, G, Q, C] . v [S, Hkv, C, D] -> [S, Hkv, G, Q, D].  On the
    CPU as products summed over a contiguous C, whose bits do not depend
    on Q (a CPU matmul's do, through its row count); on a card one batched
    product."""
    if p.is_cuda:
        return torch.einsum("skgqc,skcd->skgqd", p, v)
    return (p.unsqueeze(-2) * v.transpose(-1, -2)[:, :, None, None]).sum(-1)


def _visible_range(q_len, pos_start, page_lo, page_hi, page: int,
                   cover: int, plen: int) -> tuple[int, int]:
    """The positions [lo, hi) any lane sees, ``lo`` on a piece boundary:
    the split form folds only the pieces there (a piece no lane sees folds
    as the identity, bit for bit).  Read on the host for CPU tensors; a
    device tensor takes the whole coverage (no sync)."""
    if q_len.device.type != "cpu":
        return 0, cover
    act = q_len > 0
    if not bool(act.any()):
        return 0, 0
    end = (pos_start.long() + q_len.long())[act]
    if page_hi is not None:
        end = torch.minimum(end, page_hi.long()[act] * page)
    lo = 0 if page_lo is None else int(page_lo.long()[act].min()) * page
    return lo // plen * plen, min(int(end.max()), cover)


def paged_mixed_attention_plain(q, k_pool, v_pool, tables, seq_q_start,
                                q_len, pos_start, layer, *, k_scale=None,
                                v_scale=None, qmax=None, page_lo=None,
                                page_hi=None, carry_state=None,
                                emit_state=False, split=False):
    """Plain version of the attention kernel: gather each lane's queries
    into [S, Hkv, G, Qmax, D] and its pages into [S, Hkv, MaxP*P, D], do the
    masked softmax in f32, and scatter the valid rows back to [T, H, D].
    The kernel's folding: scores = (q.k) / sqrt(D), times the per-token k
    scale of a quantized pool; p = exp(s - m) on the visible positions
    (causal, inside [page_lo * P, page_hi * P)) and 0 elsewhere, times the
    per-token v scale, then rounded to q's dtype before p.V (the pool is
    read in q's dtype, a bf16 pool under f32 q widened); divide by
    l + 1e-9 after.  Rows no lane owns are zero.

    ``carry_state`` (m [T, H], l [T, H], acc [T, H, D], f32) starts the
    softmax from that state instead of (-1e30, 0, 0); ``emit_state``
    returns the raw f32 (m, l, acc) in that layout instead of the output.
    The state is one pass over the span — m its largest score, l and acc
    rescaled to it — or, with ``split``, the kernel's split-KV form: one
    state per piece of at most MIXED_PIECE positions, folded left in page
    order (the same function up to the rounding of p against each piece's
    m instead of the span's).  The split form is what
    ``paged_mixed_attention`` runs on CPU tensors: like the kernel's, its
    span chain gives the single call's bytes, since its pieces are pages
    and its fold a left fold."""
    t, h, d = q.shape
    hkv = k_pool.shape[2]
    qmax = qmax or _default_qmax(t, q_len.shape[0])
    if qmax * (h // hkv) < 2:
        # At least two query rows per (lane, KV head): a CPU product of one
        # row takes the matrix-vector path, whose bits differ from the
        # matrix path a step with longer spans takes, and a decode lane's
        # output must not depend on what else its step carries.  The
        # extra row is past every lane's span: masked, never written back.
        qmax = 2
    scores, seen, vc, vsc, span, valid = _mixed_lanes(
        q, k_pool, v_pool, tables, seq_q_start, q_len, pos_start, layer,
        k_scale, v_scale, qmax, page_lo, page_hi)
    if carry_state is None:
        zeros = torch.zeros(scores.shape[:4], dtype=torch.float32,
                            device=q.device)
        state = (zeros + _NEG_INF, zeros, zeros[..., None].expand(
            *zeros.shape, d))
    else:
        state = tuple(_flat_to_lanes(x.float(), span, hkv)
                      for x in carry_state)
    if split:
        page = pool_page_tokens(k_pool, k_scale)
        plen = min(page, MIXED_PIECE)
        if page % plen:
            plen = page
        for piece in _mixed_pieces_plain(scores, seen, vc, vsc, q.dtype,
                                         plen, *_visible_range(
                                             q_len, pos_start, page_lo,
                                             page_hi, page,
                                             scores.shape[-1], plen)):
            state = _fold(state, piece)
    else:
        m_c, l_c, acc_c = state
        m = torch.maximum(m_c, torch.where(seen, scores, _NEG_INF)
                          .amax(dim=-1))
        p = torch.where(seen, torch.exp(scores - m[..., None]), 0.0)
        a = torch.exp(m_c - m)
        l = l_c * a + p.sum(dim=-1)
        if vsc is not None:
            p = p * vsc
        acc = acc_c * a[..., None] + torch.einsum(
            "skgqc,skcd->skgqd", p.to(q.dtype).float(), vc.float())
        state = (m, l, acc)
    m, l, acc = state
    if emit_state:
        return tuple(_lanes_to_flat(x, span, valid, t) for x in state)
    o = (acc / (l + 1e-9)[..., None]).to(q.dtype)                # [S,Hkv,G,Q,D]
    return _lanes_to_flat(o, span, valid, t)


class MixedWork(NamedTuple):
    """Layer-invariant launch inputs of the attention kernel for one mixed
    dispatch: the lane view as contiguous int32 tensors, the grid mode,
    the ragged work list (seq, head, qb, plo, pages; None on the dense
    grid), block_q and num_qb, the split-KV layout of the grid's items
    (``mixed_pieces``: pcum, pbase, pitem) and the pool's page.
    ``mixed_work`` builds it once per step; every layer's launch reuses
    it."""

    tables: torch.Tensor
    seq_q_start: torch.Tensor
    q_len: torch.Tensor
    pos_start: torch.Tensor
    items: tuple | None
    block_q: int
    num_qb: int
    grid: str
    pieces: tuple
    page: int


def mixed_work(tables, seq_q_start, q_len, pos_start, *, page: int, hkv: int,
               qmax: int, grid: str | None = None,
               page_lo: torch.Tensor | None = None,
               page_hi: torch.Tensor | None = None) -> MixedWork:
    """One step's ``MixedWork`` on ``grid`` (``mixed_grid_mode()`` when
    None): the work list (cut to the spans ``page_lo``/``page_hi`` when
    given) on the ragged grid, the rectangle's items on the dense one, and
    their pieces.  The dense grid takes no spans."""
    grid = grid or mixed_grid_mode()
    if grid == "dense" and (page_lo is not None or page_hi is not None):
        raise ValueError("page spans need the ragged work-list grid "
                         "(ARKS_MIXED_GRID=ragged); the dense grid is the "
                         "byte-identity reference only")
    plan = mixed_grid_plan(qmax)
    bq, nqb = plan["block_q"], plan["num_qb"]
    tbl, qs, ql, ps = (x.to(torch.int32).contiguous()
                       for x in (tables, seq_q_start, q_len, pos_start))
    items = None
    if grid == "ragged":
        items = build_mixed_work_list(ps, ql, page=page, block_q=bq,
                                      num_qb=nqb, max_pages=tbl.shape[1],
                                      head_groups=hkv, page_lo=page_lo,
                                      page_hi=page_hi)
        seq, _, qb, plo, pages = items
    else:
        seq, qb, plo, pages = dense_items(ps, ql, page=page, block_q=bq,
                                          num_qb=nqb, hkv=hkv,
                                          max_pages=tbl.shape[1])
    pieces = mixed_pieces(ql, seq, qb, plo, pages, page=page, block_q=bq,
                          max_pages=tbl.shape[1])
    return MixedWork(tbl, qs, ql, ps, items, bq, nqb, grid, pieces, page)


def paged_mixed_attention(
    q: torch.Tensor,            # [T, H, D] flat mixed token batch
    k_pool: torch.Tensor,       # [L, N, Hkv, P, D] ([.., P/2, D] int4)
    v_pool: torch.Tensor,
    tables: torch.Tensor,       # [S, MaxP] int32 — lane s's block table
    seq_q_start: torch.Tensor,  # [S] int32 — lane's first flat-token index
    q_len: torch.Tensor,        # [S] int32 — lane's token count (0 inactive)
    pos_start: torch.Tensor,    # [S] int32 — global position of that token
    layer: int, *,
    k_scale: torch.Tensor | None = None,  # [L, N, Hkv, P] f32 (int8/int4)
    v_scale: torch.Tensor | None = None,
    qmax: int | None = None,
    impl: str | None = None,
    work: MixedWork | None = None,
    grid: str | None = None,
    page_lo: torch.Tensor | None = None,  # [S] int32 span start (pages)
    page_hi: torch.Tensor | None = None,  # [S] int32 span end bound (pages)
    carry_state: tuple | None = None,     # (m, l, acc) from emit_state
    emit_state: bool = False,
):
    """Ragged mixed attention over the flat token batch: token
    seq_q_start[s] + i (query i of lane s, global position pos_start[s] + i)
    attends lane s's table pages over positions [0, pos_start[s] + i].
    Returns [T, H, D]; rows no lane owns (padding tokens) are zero.  With
    ``k_scale``/``v_scale`` the pools are int8, or int4 when the pool has
    half the scale page's rows; an unquantized pool of another dtype than
    q (bf16 under f32 q) is read widened to q's dtype.

    The reference's ``paged_mixed_attention`` takes per-lane queries
    [S, Hkv, G, Q, D]; this wrapper takes the flat batch the kernel reads
    directly through ``seq_q_start``.  ``qmax`` (widest lane, default
    T - S + 1 as in the reference) sizes the work list; ``work`` passes one
    ``mixed_work`` prepared for every layer of a step.  ``grid`` ("ragged"
    or "dense"; default the work's, else ``ARKS_MIXED_GRID``) picks the
    launch: CUDA tensors launch ``csrc/paged_mixed_attention.cu`` over the
    work list (replaces the Pallas ``_paged_mixed_ragged_kernel``) or over
    the dense grid (``paged_mixed_attention_dense``); CPU tensors take
    ``paged_mixed_attention_plain`` in its split form (the kernel's pieces
    and left fold), the same function on either grid.

    The reference's span and state arguments: ``page_lo``/``page_hi`` bound
    lane s's pages to [page_lo[s], page_hi[s]) (pass them here, or to the
    ``mixed_work`` given as ``work``); ``carry_state`` (m [T, H], l [T, H],
    acc [T, H, D], f32 — the port's flat layout of the reference's
    [S, Hkv, G, qpad, 128] state) starts the softmax from that state;
    ``emit_state`` returns the raw f32 (m, l, acc) instead of the output,
    zero on rows no lane owns.  Chaining [0, k) with emit_state and
    [k, end) with its state as carry_state gives the single call's output
    bit for bit on the card.  The dense grid takes none of these, as in the
    reference."""
    t, h, d = q.shape
    s = q_len.shape[0]
    qmax = qmax or _default_qmax(t, s)
    spans = page_lo is not None or page_hi is not None
    stateful = carry_state is not None or emit_state
    if not _use_kernel(q, impl):
        return paged_mixed_attention_plain(
            q, k_pool, v_pool, tables, seq_q_start, q_len, pos_start, layer,
            k_scale=k_scale, v_scale=v_scale, qmax=qmax, page_lo=page_lo,
            page_hi=page_hi, carry_state=carry_state, emit_state=emit_state,
            split=True)
    grid = grid or (work.grid if work is not None else mixed_grid_mode())
    if grid == "dense" and (spans or stateful):
        raise ValueError("page spans and carried/emitted state need the "
                         "ragged work-list grid (ARKS_MIXED_GRID=ragged); "
                         "the dense grid is the byte-identity reference "
                         "only")
    if work is not None and spans:
        raise ValueError("pass page_lo/page_hi to mixed_work when giving a "
                         "prepared work")
    if work is None or work.grid != grid:
        work = mixed_work(tables, seq_q_start, q_len, pos_start,
                          page=pool_page_tokens(k_pool, k_scale),
                          hkv=k_pool.shape[2], qmax=qmax, grid=grid,
                          page_lo=page_lo, page_hi=page_hi)
    if grid == "dense":
        return paged_mixed_attention_dense(q, k_pool, v_pool, work, layer,
                                           k_scale=k_scale, v_scale=v_scale)
    qc, out, ptrs, dims = _mixed_launch_args(
        "paged_mixed_attention", q, k_pool, v_pool, k_scale, v_scale, work,
        layer)
    h, hkv, d, page, n, dtype_code, kv_mode = dims
    state_ptrs, state_mode, state = _mixed_state(
        "paged_mixed_attention", qc, carry_state, emit_state)
    ws = _mixed_workspace(qc, work)
    _kernels.launch("arks_paged_mixed_attention", *ptrs,
                    *(x.data_ptr() for x in work.items),
                    *(x.data_ptr() for x in work.pieces), ws.data_ptr(),
                    ws.shape[0], *state_ptrs, work.items[0].shape[0], h,
                    hkv, d, page, n, work.tables.shape[1], int(layer),
                    work.block_q, 1.0 / math.sqrt(d), dtype_code, kv_mode,
                    state_mode, _stream())
    paged_mixed_attention.launches += 1
    return state if emit_state else out


def _mixed_workspace(q: torch.Tensor, work: MixedWork) -> torch.Tensor:
    """The split-KV partials of a launch, one row (acc[D], m, l, 2 pad) of
    f32 per (piece, query row): [H * MaxP * pieces_per_page * T, D + 4].
    Static, from shapes: every token row of every KV head's items may
    have a piece on every page of its table."""
    t, h, d = q.shape
    rows = h * work.tables.shape[1] * pieces_per_page(work.page) * t
    return torch.empty((rows, d + 4), dtype=torch.float32, device=q.device)


def _mixed_state(kernel: str, q: torch.Tensor, carry_state, emit_state):
    """The six state pointers (carry m, l, acc; emit m, l, acc), the state
    mode (bit 0 carry, bit 1 emit) and the emitted (m, l, acc) tensors,
    zeroed (rows no lane owns stay zero), or None."""
    t, h, d = q.shape
    shapes = ((t, h), (t, h), (t, h, d))
    ptrs, mode = [None] * 6, 0
    if carry_state is not None:
        carry = tuple(x.to(torch.float32).contiguous() for x in carry_state)
        for name, x, shape in zip(("m", "l", "acc"), carry, shapes):
            if tuple(x.shape) != shape:
                raise ValueError(f"{kernel}: carry_state {name} "
                                 f"{tuple(x.shape)}, expected {shape}")
        _check_operands(kernel, q.device,
                        zip(("carry m", "carry l", "carry acc"), carry))
        ptrs[:3] = [x.data_ptr() for x in carry]
        mode |= 1
    state = None
    if emit_state:
        state = tuple(torch.zeros(shape, dtype=torch.float32,
                                  device=q.device) for shape in shapes)
        ptrs[3:] = [x.data_ptr() for x in state]
        mode |= 2
    return ptrs, mode, state


def _mixed_launch_args(kernel: str, q, k_pool, v_pool, k_scale, v_scale,
                       work: MixedWork, layer: int):
    """Check the operands of a mixed-attention launch (raising on what the
    kernel does not take) and return (q contiguous, the zeroed output,
    the ten leading pointers, (H, Hkv, D, page, N, dtype code, kv code)).
    The caller holds q contiguous until the launch is queued."""
    t, h, d = q.shape
    _, n, hkv, rows, dk = k_pool.shape
    quantized = k_scale is not None
    page = pool_page_tokens(k_pool, k_scale)
    if quantized:
        kv_mode, pool_dtypes = (_KV_INT4 if rows != page else _KV_INT8), \
            (torch.int8,)
    elif q.dtype == torch.float32 and k_pool.dtype == torch.bfloat16:
        kv_mode, pool_dtypes = _KV_BF16, (torch.bfloat16,)
    else:
        kv_mode, pool_dtypes = _KV_SAME, (q.dtype,)
    if q.dtype not in _KERNEL_DTYPES or k_pool.dtype not in pool_dtypes or \
            v_pool.dtype != k_pool.dtype or (v_scale is None) == quantized:
        raise TypeError(f"{kernel} kernel takes bf16/f32 q over "
                        "pools of q's dtype (or bf16 under f32 q), or "
                        "int8/int4 pools with both scales; got "
                        f"{q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if quantized:
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32 \
                or k_scale.shape != k_pool.shape[:3] + (page,) or \
                v_scale.shape != k_scale.shape or \
                v_pool.shape != k_pool.shape or page % 2:
            raise ValueError(f"{kernel}: scales "
                             f"{tuple(k_scale.shape)} {k_scale.dtype} do not "
                             f"match the pool {tuple(k_pool.shape)}")
    if dk != d or d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"{kernel} kernel takes head_dim in "
                         f"{_KERNEL_HEAD_DIMS} matching the pool, got q {d} "
                         f"pool {dk}")
    if h % hkv or h // hkv > MAX_GROUP:
        raise ValueError(f"{kernel} kernel takes H/Hkv <= "
                         f"{MAX_GROUP}, got {h}/{hkv}")
    if page > MIXED_PIECE and page % MIXED_PIECE:
        raise ValueError(f"{kernel} kernel takes pages of at most "
                         f"{MIXED_PIECE} positions or multiples of it, got "
                         f"{page}")
    if work.block_q > MAX_BLOCK_Q:
        raise ValueError(f"{kernel} kernel takes block_q <= {MAX_BLOCK_Q}, "
                         f"got {work.block_q}")
    if not 0 <= layer < k_pool.shape[0]:
        raise ValueError(f"layer {layer} out of range")
    qc = q.contiguous()
    scales = (("k_scale", k_scale), ("v_scale", v_scale)) if quantized \
        else ()
    _check_operands(kernel, q.device, (("q", qc), ("work", work.tables)),
                    aligned=False)
    _check_operands(kernel, q.device,
                    (("k_pool", k_pool), ("v_pool", v_pool), *scales))
    out = torch.zeros_like(qc)
    ptrs = (qc.data_ptr(), out.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            work.tables.data_ptr(), work.pos_start.data_ptr(),
            work.seq_q_start.data_ptr(), work.q_len.data_ptr())
    return qc, out, ptrs, (h, hkv, d, page, n, _KERNEL_DTYPES[q.dtype],
                           kv_mode)


def paged_mixed_attention_dense(q, k_pool, v_pool, work: MixedWork,
                                layer: int, *, k_scale=None, v_scale=None):
    """The dense launch of the mixed-attention kernel (``ARKS_MIXED_GRID=
    dense``; replaces the Pallas ``_paged_mixed_kernel``): the whole
    (S, Hkv, num_qb) rectangle cut into the same split-KV pieces and folded
    the same way as the ragged launch, no work list.  Valid rows are
    bit-identical to the ragged launch's, and rows no lane owns are zero.
    CUDA tensors only (``paged_mixed_attention`` sends CPU tensors to the
    plain version); counts its launches in
    ``paged_mixed_attention_dense.launches``."""
    if not q.is_cuda:
        raise ValueError("paged_mixed_attention_dense launches the CUDA "
                         "kernel; CPU tensors take "
                         "paged_mixed_attention_plain")
    if work.grid != "dense":
        raise ValueError("paged_mixed_attention_dense needs the dense "
                         "grid's work (mixed_work(grid='dense'))")
    qc, out, ptrs, dims = _mixed_launch_args(
        "paged_mixed_attention_dense", q, k_pool, v_pool, k_scale, v_scale,
        work, layer)
    h, hkv, d, page, n, dtype_code, kv_mode = dims
    ws = _mixed_workspace(qc, work)
    _kernels.launch("arks_paged_mixed_attention_dense", *ptrs,
                    *(x.data_ptr() for x in work.pieces), ws.data_ptr(),
                    ws.shape[0], work.q_len.shape[0], work.num_qb, h, hkv,
                    d, page, n, work.tables.shape[1], int(layer),
                    work.block_q, 1.0 / math.sqrt(d), dtype_code, kv_mode,
                    _stream())
    paged_mixed_attention_dense.launches += 1
    return out


paged_mixed_attention_dense.launches = 0


paged_mixed_attention.launches = 0


# ---------------------------------------------------------------------------
# Kernel #5: paged decode attention (one query per slot)
# ---------------------------------------------------------------------------


def decode_attention_plain(q, k_cache, v_cache, lengths, *, k_scale=None,
                           v_scale=None):
    """The decode attention kernels' arithmetic in one pass (the plain
    version of ``paged_decode_attention`` and of the slot cache's
    ``ragged_decode_attention``): q [B, Hkv, G, D] over the slot-contiguous
    view [B, Hkv, C, D] (int8 with [B, Hkv, C] scales when ``k_scale`` is
    given), positions [0, min(lengths[b], C)).  Scores = (q.k) / sqrt(D),
    times the k scale of an int8 cache; p times the v scale, then rounded
    to q's dtype before p.V (the cache is read in q's dtype, a bf16 cache
    under f32 q widened); divide by l + 1e-9 after.  V rows past the length never reach p.V, and a slot of length 0
    gets zeros, as in the kernels."""
    d = q.shape[-1]
    c = k_cache.shape[2]
    lens = lengths.long().clamp(max=c)
    valid = torch.arange(c, device=q.device)[None] < lens[:, None]   # [B, C]
    scores = torch.einsum("bkgd,bkcd->bkgc", q.float(),
                          k_cache.float()) * (1.0 / math.sqrt(d))
    if k_scale is not None:
        scores = scores * k_scale[:, :, None, :]
    scores = scores.masked_fill(~valid[:, None, None], _NEG_INF)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale[:, :, None, :]
    vf = torch.where(valid[:, None, :, None], v_cache.float(), 0.0)
    pv = torch.einsum("bkgc,bkcd->bkgd", p.to(q.dtype).float(), vf)
    out = torch.where(lens[:, None, None, None] > 0, pv / (l + 1e-9), 0.0)
    return out.to(q.dtype)


def decode_attention_split_plain(q, k_cache, v_cache, lengths, *,
                                 k_scale=None, v_scale=None,
                                 split: int = DECODE_SPLIT):
    """The split-KV form of ``decode_attention_plain``, as the CUDA kernel
    computes it: the context is cut into ``split``-token pieces; each
    piece whose start lies below the slot's length gives a partial
    (m = its largest score, l = the sum of exp(s - m), acc = the sum of
    p.V with p scaled and rounded as in ``decode_attention_plain``), and
    the combine rescales the pieces by exp(m_i - M) before
    acc / (l + 1e-9).  Pieces past the length are never formed and a slot
    of length 0 gets zeros.  The same function as ``decode_attention_plain``
    up to the rounding of p against m_i instead of M."""
    d = q.shape[-1]
    c = k_cache.shape[2]
    lens = lengths.long().clamp(max=c)
    ar = torch.arange(c, device=q.device)
    valid = ar[None] < lens[:, None]                                 # [B, C]
    scores = torch.einsum("bkgd,bkcd->bkgc", q.float(),
                          k_cache.float()) * (1.0 / math.sqrt(d))
    if k_scale is not None:
        scores = scores * k_scale[:, :, None, :]
    vf = torch.where(valid[:, None, :, None], v_cache.float(), 0.0)
    p_dtype = q.dtype
    ms, ls, accs = [], [], []
    for s0 in range(0, c, split):
        piece = slice(s0, min(s0 + split, c))
        ok = valid[:, None, None, piece]
        sc = scores[..., piece].masked_fill(~ok, _NEG_INF)
        m = sc.amax(dim=-1, keepdim=True)
        p = torch.where(ok, torch.exp(sc - m), 0.0)
        ls.append(p.sum(dim=-1, keepdim=True))
        if v_scale is not None:
            p = p * v_scale[:, :, None, piece]
        accs.append(torch.einsum("bkgc,bkcd->bkgd", p.to(p_dtype).float(),
                                 vf[:, :, piece]))
        # A piece past the length takes no part in the combine.
        ms.append(torch.where((lens > s0)[:, None, None, None], m, -math.inf))
    m = torch.stack(ms)                                   # [n, B, Hkv, G, 1]
    w = torch.exp(m - m.amax(dim=0))
    l = (torch.stack(ls) * w).sum(dim=0)
    acc = (torch.stack(accs) * w).sum(dim=0)
    out = torch.where(lens[:, None, None, None] > 0, acc / (l + 1e-9), 0.0)
    return out.to(q.dtype)


def decode_splits(cover: int) -> int:
    """Split-KV pieces of a decode launch over ``cover`` positions: the
    grid's static extent, from shapes alone (no host sync on lengths)."""
    return -(-cover // DECODE_SPLIT)


def decode_workspace(q: torch.Tensor, cover: int) -> torch.Tensor:
    """The decode kernel's f32 partials, one (m, l, acc[D]) per (slot, KV
    head, piece, query head): [B, Hkv, pieces, G, D + 2]."""
    b, hkv, g, d = q.shape
    return torch.empty((b, hkv, decode_splits(cover), g, d + 2),
                       dtype=torch.float32, device=q.device)


def _decode_kv_code(kernel: str, q, k_cache, v_cache, quantized: bool,
                    v_scale) -> int:
    """The decode kernels' cache code — 0 a cache of q's dtype, 1 int8
    (both scales given), 2 bf16 under f32 q (widened) — or raise."""
    if quantized:
        code, want = 1, torch.int8
    elif q.dtype == torch.float32 and k_cache.dtype == torch.bfloat16:
        code, want = 2, torch.bfloat16
    else:
        code, want = 0, q.dtype
    if q.dtype not in _KERNEL_DTYPES or k_cache.dtype != want or \
            v_cache.dtype != want or (v_scale is None) == quantized:
        raise TypeError(f"{kernel} kernel takes bf16/f32 q over a cache of "
                        "q's dtype (or bf16 under f32 q), or an int8 cache "
                        f"with both scales; got {q.dtype}/{k_cache.dtype}/"
                        f"{v_cache.dtype}")
    return code


def paged_decode_attention_plain(q, k_pool, v_pool, tables, lengths, layer,
                                 k_scale=None, v_scale=None):
    """Plain version of the paged decode kernel: ``decode_attention_plain``
    over each slot's gathered pages."""
    ks = vs = None
    if k_scale is not None:
        ks = paged_gather_kv(k_scale, tables, layer)
        vs = paged_gather_kv(v_scale, tables, layer)
    return decode_attention_plain(q, paged_gather_kv(k_pool, tables, layer),
                                  paged_gather_kv(v_pool, tables, layer),
                                  lengths, k_scale=ks, v_scale=vs)


def paged_decode_attention(
    q: torch.Tensor,          # [B, Hkv, G, D] — one query token per slot
    k_pool: torch.Tensor,     # [L, N, Hkv, P, D] page pool
    v_pool: torch.Tensor,
    tables: torch.Tensor,     # [B, MaxP] int32 block tables
    lengths: torch.Tensor,    # [B] int32 valid positions per slot
    layer: int,
    k_scale: torch.Tensor | None = None,  # [L, N, Hkv, P] f32 (int8 pools)
    v_scale: torch.Tensor | None = None,
    *, impl: str | None = None,
) -> torch.Tensor:
    """[B, Hkv, G, D] attention of each slot's query over positions
    [0, lengths[b]) through its block-table pages; pages past the length
    are never read and a slot of length 0 gets zeros.  bf16/f32 and int8
    pools; an int4 pool raises, as in the reference (its decode traffic
    rides the mixed kernel).  CUDA tensors launch
    ``csrc/decode_attention.cu`` (replaces the Pallas
    ``_paged_attn_kernel``); CPU tensors take
    ``paged_decode_attention_plain``."""
    if is_int4_pool(k_pool, k_scale):
        raise ValueError(
            "int4 pools route through the mixed kernel (fused nibble "
            "dequant) or the XLA oracle; the standalone decode kernel is "
            "bf16/int8 only")
    if not _use_kernel(q, impl):
        return paged_decode_attention_plain(q, k_pool, v_pool, tables,
                                            lengths, layer, k_scale, v_scale)
    b, hkv, g, d = q.shape
    _, n, phkv, page, dk = k_pool.shape
    quantized = k_scale is not None
    kv_code = _decode_kv_code("paged_decode_attention", q, k_pool, v_pool,
                              quantized, v_scale)
    if (phkv, dk) != (hkv, d) or v_pool.shape != k_pool.shape or \
            d not in _KERNEL_HEAD_DIMS or g > MAX_GROUP or \
            tuple(lengths.shape) != (b,) or tables.shape[0] != b:
        raise ValueError(f"paged_decode_attention kernel: q {tuple(q.shape)} "
                         f"pool {tuple(k_pool.shape)} tables "
                         f"{tuple(tables.shape)} lengths "
                         f"{tuple(lengths.shape)} (head_dim in "
                         f"{_KERNEL_HEAD_DIMS}, G <= {MAX_GROUP})")
    scales = ()
    if quantized:
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32 \
                or k_scale.shape != k_pool.shape[:4] or \
                v_scale.shape != k_scale.shape:
            raise ValueError("paged_decode_attention: scales "
                             f"{tuple(k_scale.shape)} {k_scale.dtype} do not "
                             f"match the pool {tuple(k_pool.shape)}")
        scales = (("k_scale", k_scale), ("v_scale", v_scale))
    if not 0 <= layer < k_pool.shape[0]:
        raise ValueError(f"layer {layer} out of range")
    qc = q.contiguous()
    tbl = tables.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    _check_operands("paged_decode_attention", q.device,
                    (("q", qc), ("tables", tbl), ("lengths", lens)),
                    aligned=False)
    _check_operands("paged_decode_attention", q.device,
                    (("k_pool", k_pool), ("v_pool", v_pool), *scales))
    out = torch.empty_like(qc)
    ws = decode_workspace(qc, tbl.shape[1] * page)
    _kernels.launch("arks_paged_decode_attention", qc.data_ptr(),
                    out.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                    k_scale.data_ptr() if quantized else None,
                    v_scale.data_ptr() if quantized else None,
                    tbl.data_ptr(), lens.data_ptr(), ws.data_ptr(), b,
                    hkv * g, hkv, d, page, n, tbl.shape[1], int(layer),
                    1.0 / math.sqrt(d), _KERNEL_DTYPES[q.dtype],
                    kv_code, _stream())
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


# ---------------------------------------------------------------------------
# Whole-page copies for the host prefix tier
# ---------------------------------------------------------------------------
# A spill gathers evicted pages into a contiguous staging block that is
# copied to the host; a restore scatters host blocks back into freshly
# allocated pool pages.  A page is already one dense (layer-major) stripe,
# so each is a plain page-axis copy: the reference leaves them to XLA
# (``paged_pool_gather``/``paged_pool_scatter``, "a Pallas formulation would
# buy nothing"), and here they are ``index_select``/``index_copy_``.  Both
# carry raw pool bytes (int8 and packed int4 pages, f32 scales), so a
# spill then a restore is bit-exact by construction.


def paged_pool_gather(pool: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """Whole pool pages as a contiguous staging block: ``[L, N, Hkv, P, ...]
    x [G] -> [L, G, Hkv, P, ...]``.  Duplicate page ids (the padding of a
    short spill group) are benign: the host drops the padded entries."""
    return pool.index_select(1, pages.long())


def paged_pool_scatter(pool: torch.Tensor, blocks: torch.Tensor,
                       pages: torch.Tensor, n_valid: int) -> torch.Tensor:
    """Write the first ``n_valid`` staged page blocks (``[L, G, Hkv, P,
    ...]``) into the pool pages listed in ``pages`` ([G], entries past
    n_valid ignored), IN PLACE; the inverse of ``paged_pool_gather``."""
    if n_valid:
        pool.index_copy_(1, pages[:n_valid].long(),
                         blocks[:, :n_valid].to(pool.dtype))
    return pool

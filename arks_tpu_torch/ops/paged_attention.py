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
import os
from typing import NamedTuple

import torch

from arks_tpu_torch.ops import _kernels

_NEG_INF = -1e30

# Most query rows one attention work item holds (csrc kBQ): the CUDA
# kernel keeps each row's online-softmax state in registers.
MAX_BLOCK_Q = 8
# Most query heads per KV head the CUDA kernel takes (one warp each).
MAX_GROUP = 8
# Positions per split-KV piece of the decode kernels (csrc kSplit): one
# 256-token page of the served pool, 256 rows of a slot stripe.
DECODE_SPLIT = 256
_KERNEL_HEAD_DIMS = (64, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _use_kernel(x: torch.Tensor, impl: str | None) -> bool:
    """Kernel for CUDA tensors, the plain version for CPU tensors or when
    ``impl="plain"`` asks for it."""
    if impl not in (None, "kernel", "plain"):
        raise ValueError(f"impl={impl!r} (expected 'kernel' or 'plain')")
    return impl != "plain" and x.is_cuda


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check_operands(kernel: str, device: torch.device, operands, *,
                    aligned: bool = True) -> None:
    """Raise unless every (name, tensor) lies on ``device`` and, with
    ``aligned``, is contiguous and 16-byte aligned."""
    for name, x in operands:
        if not x.is_cuda or x.device != device:
            raise ValueError(f"{kernel}: {name} is not on {device}")
        if aligned and (not x.is_contiguous() or x.data_ptr() % 16):
            raise ValueError(f"{kernel}: {name} must be contiguous and "
                             "16-byte aligned")


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
    m = (os.environ.get("ARKS_MIXED_GRID") or "ragged").lower()
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
                          max_pages: int, head_groups: int = 1):
    """The ragged grid's work list, built on the tensors' device with torch
    ops (no host round trip).  One item per REAL (sequence, head_group,
    q_block), compacted to the front of a fixed-length
    [S * head_groups * num_qb] list by a stable argsort; returns
    (seq, hg, qb, plo, pages), each int32:

    - real items: pages = ceil(causal kv end / page) clamped to the table
      width; plo = 0 (span bounds are a later slice);
    - padding items (q_len = 0 lanes, q-blocks past a lane's q_len):
      pages = 0 and (seq, hg, qb) aliased to the LAST real item.

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
    plo = torch.zeros_like(pages)
    order = torch.argsort(torch.logical_not(active).to(torch.int32),
                          stable=True)
    seq, hg, qb, plo, pages = (seq[order], hg[order], qb[order], plo[order],
                               pages[order])
    n_real = active.to(torch.int32).sum()
    last = torch.clamp(n_real - 1, min=0)
    pad = torch.arange(n, **i32) >= n_real
    seq = torch.where(pad, seq[last], seq)
    hg = torch.where(pad, hg[last], hg)
    qb = torch.where(pad, qb[last], qb)
    pages = torch.where(pad, torch.zeros_like(pages), pages)
    return seq, hg, qb, plo, pages


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
    int4 = is_int4_pool(k_pool, k_scale)
    p = pool_page_tokens(k_pool, k_scale)
    keep = (write_idx < tables.shape[1] * p) & (write_idx >= 0)
    sel = torch.nonzero(keep).squeeze(1)
    idx = write_idx[sel].long()
    page = tables[sel].long().gather(1, (idx // p)[:, None])[:, 0]
    inside = (page >= 0) & (page < k_pool.shape[1])
    sel, idx, page = sel[inside], idx[inside], page[inside]
    off = idx % p
    if k_scale is None:
        k_pool[layer][page, :, off] = k_new[sel].to(k_pool.dtype)
        v_pool[layer][page, :, off] = v_new[sel].to(v_pool.dtype)
        return k_pool, v_pool, k_scale, v_scale
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


# ---------------------------------------------------------------------------
# Kernel #2: in-place paged KV row update
# ---------------------------------------------------------------------------


def paged_kv_update_plain(k_pool, v_pool, k_new, v_new, write_idx, tables,
                          layer):
    """Plain version of the update kernel: the oracle scatter, in place."""
    paged_update_xla(k_pool, v_pool, None, None, k_new, v_new, write_idx,
                     tables, layer)
    return k_pool, v_pool


def paged_kv_update(k_pool: torch.Tensor,    # [L, N, Hkv, P, D]
                    v_pool: torch.Tensor,
                    k_new: torch.Tensor,     # [T, Hkv, D]
                    v_new: torch.Tensor,
                    write_idx: torch.Tensor,  # [T] int32 position per token
                    tables: torch.Tensor,     # [T, MaxP] int32
                    layer: int, *, impl: str | None = None):
    """Write one KV row per token at its table-mapped page, IN PLACE; rows
    with write_idx >= MaxP * P are dropped.  CUDA tensors launch
    ``csrc/paged_kv_update.cu`` (replaces the Pallas ``_paged_update_kernel``);
    CPU tensors take ``paged_kv_update_plain``."""
    if not _use_kernel(k_pool, impl):
        return paged_kv_update_plain(k_pool, v_pool, k_new, v_new, write_idx,
                                     tables, layer)
    _, n, hkv, page, d = k_pool.shape
    t = k_new.shape[0]
    if k_pool.dtype not in _KERNEL_DTYPES or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"paged_kv_update kernel takes bf16/f32 pools, got "
                        f"{k_pool.dtype}/{v_pool.dtype}")
    kn = k_new.to(k_pool.dtype).contiguous()
    vn = v_new.to(v_pool.dtype).contiguous()
    widx = write_idx.to(torch.int32).contiguous()
    tbl = tables.to(torch.int32).contiguous()
    row_bytes = d * k_pool.element_size()
    if row_bytes % 16:
        raise ValueError(f"paged_kv_update kernel needs D * itemsize % 16 == "
                         f"0, got {row_bytes}")
    _check_operands("paged_kv_update", k_pool.device, (
        ("k_pool", k_pool), ("v_pool", v_pool), ("k_new", kn),
        ("v_new", vn), ("write_idx", widx), ("tables", tbl)))
    if kn.shape != (t, hkv, d) or vn.shape != (t, hkv, d) or \
            widx.shape != (t,) or tbl.shape[0] != t:
        raise ValueError("paged_kv_update: shape mismatch "
                         f"k_new {tuple(kn.shape)} write_idx "
                         f"{tuple(widx.shape)} tables {tuple(tbl.shape)}")
    if not 0 <= layer < k_pool.shape[0]:
        raise ValueError(f"layer {layer} out of range")
    _kernels.launch("arks_paged_kv_update", k_pool.data_ptr(),
                    v_pool.data_ptr(), kn.data_ptr(), vn.data_ptr(),
                    widx.data_ptr(), tbl.data_ptr(), t, hkv, tbl.shape[1], n,
                    page, row_bytes, int(layer), _stream())
    paged_kv_update.launches += 1
    return k_pool, v_pool


paged_kv_update.launches = 0


# ---------------------------------------------------------------------------
# Kernel #3: in-place quantize-and-write into an int8/int4 pool
# ---------------------------------------------------------------------------


def paged_kv_update_quant_plain(k_pool, v_pool, k_scale, v_scale, k_new,
                                v_new, write_idx, tables, layer):
    """Plain version of the quantized update kernel: ``quantize_kv`` plus
    the oracle scatter (with its two-parity nibble merge), in place."""
    return paged_update_xla(k_pool, v_pool, k_scale, v_scale, k_new, v_new,
                            write_idx, tables, layer)


def paged_kv_update_quant(k_pool: torch.Tensor,   # [L, N, Hkv, P(/2), D] i8
                          v_pool: torch.Tensor,
                          k_scale: torch.Tensor,  # [L, N, Hkv, P] f32
                          v_scale: torch.Tensor,
                          k_new: torch.Tensor,    # [T, Hkv, D] bf16/f32
                          v_new: torch.Tensor,
                          write_idx: torch.Tensor,  # [T] int32
                          tables: torch.Tensor,     # [T, MaxP] int32
                          layer: int, *, impl: str | None = None):
    """Quantize each token's K and V rows per token over D (qmax 127 for an
    int8 pool, 7 for int4) and write values and f32 scales at the
    table-mapped page, IN PLACE; rows with write_idx >= MaxP * P and table
    entries outside the pool are dropped.  CUDA tensors launch
    ``csrc/paged_kv_update_quant.cu`` (replaces the Pallas
    ``_paged_update_quant_kernel``); CPU tensors take
    ``paged_kv_update_quant_plain``."""
    if not _use_kernel(k_pool, impl):
        return paged_kv_update_quant_plain(k_pool, v_pool, k_scale, v_scale,
                                           k_new, v_new, write_idx, tables,
                                           layer)
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
            rows != (page // 2 if int4 else page) or d % 4:
        raise ValueError("paged_kv_update_quant: pools "
                         f"{tuple(k_pool.shape)} and scales "
                         f"{tuple(k_scale.shape)} are not an int8 or int4 "
                         "pool pair with D % 4 == 0")
    kn, vn = k_new.contiguous(), v_new.contiguous()
    widx = write_idx.to(torch.int32).contiguous()
    tbl = tables.to(torch.int32).contiguous()
    _check_operands("paged_kv_update_quant", k_pool.device, (
        ("k_pool", k_pool), ("v_pool", v_pool), ("k_scale", k_scale),
        ("v_scale", v_scale), ("k_new", kn), ("v_new", vn),
        ("write_idx", widx), ("tables", tbl)))
    if kn.shape != (t, hkv, d) or vn.shape != (t, hkv, d) or \
            widx.shape != (t,) or tbl.shape[0] != t:
        raise ValueError("paged_kv_update_quant: shape mismatch "
                         f"k_new {tuple(kn.shape)} write_idx "
                         f"{tuple(widx.shape)} tables {tuple(tbl.shape)}")
    if not 0 <= layer < k_pool.shape[0]:
        raise ValueError(f"layer {layer} out of range")
    _kernels.launch("arks_paged_kv_update_quant", k_pool.data_ptr(),
                    v_pool.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
                    kn.data_ptr(), vn.data_ptr(), widx.data_ptr(),
                    tbl.data_ptr(), t, hkv, d, tbl.shape[1], n, page,
                    int(int4), int(layer), _KERNEL_DTYPES[kn.dtype],
                    _stream())
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


def paged_mixed_attention_plain(q, k_pool, v_pool, tables, seq_q_start,
                                q_len, pos_start, layer, *, k_scale=None,
                                v_scale=None, qmax=None):
    """Plain version of the attention kernel: gather each lane's queries
    into [S, Hkv, G, Qmax, D] and its pages into [S, Hkv, MaxP*P, D], do the
    masked softmax in f32 in one pass, and scatter the valid rows back to
    [T, H, D].  The kernel's folding: scores = (q.k) / sqrt(D), times the
    per-token k scale of a quantized pool; p times the per-token v scale,
    then rounded to the V dtype (q's dtype for a quantized pool) before
    p.V; divide by l + 1e-9 after.  Rows no lane owns are zero."""
    t, h, d = q.shape
    s = q_len.shape[0]
    hkv = k_pool.shape[2]
    g = h // hkv
    int4 = is_int4_pool(k_pool, k_scale)
    cover = tables.shape[1] * pool_page_tokens(k_pool, k_scale)
    qmax = qmax or _default_qmax(t, s)
    dev = q.device
    ar = torch.arange(qmax, device=dev)
    span = seq_q_start.long()[:, None] + ar                      # [S, Qmax]
    valid = ar[None, :] < q_len.long()[:, None]
    qs = q[span.clamp(max=t - 1)].reshape(s, qmax, hkv, g, d).float()
    kc = gather_pool(k_pool, tables, layer, int4).float()       # [S,Hkv,C,D]
    vc = gather_pool(v_pool, tables, layer, int4)
    scores = torch.einsum("sqkgd,skcd->skgqc", qs, kc) * (1.0 / math.sqrt(d))
    if k_scale is not None:
        scores = scores * paged_gather_kv(k_scale, tables,
                                          layer)[:, :, None, None, :]
    qpos = pos_start.long()[:, None] + ar                        # [S, Qmax]
    seen = torch.arange(cover, device=dev)[None, None, :] <= qpos[:, :, None]
    scores = scores.masked_fill(~seen[:, None, None], _NEG_INF)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    p_dtype = vc.dtype
    if v_scale is not None:
        p = p * paged_gather_kv(v_scale, tables, layer)[:, :, None, None, :]
        p_dtype = q.dtype
    pv = torch.einsum("skgqc,skcd->skgqd", p.to(p_dtype).float(), vc.float())
    o = (pv / (l + 1e-9)).to(q.dtype)                            # [S,Hkv,G,Q,D]
    rows = o.permute(0, 3, 1, 2, 4).reshape(s * qmax, h, d)
    out = torch.zeros((t + 1, h, d), dtype=q.dtype, device=dev)
    dst = torch.where(valid, span, torch.full_like(span, t)).reshape(-1)
    out.index_copy_(0, dst, rows)     # rows no lane owns land in row T
    return out[:t]


class MixedWork(NamedTuple):
    """Layer-invariant launch inputs of the attention kernel for one mixed
    dispatch: the lane view as contiguous int32 tensors, the grid mode,
    the ragged work list (seq, head, qb, plo, pages; None on the dense
    grid), block_q and num_qb.  ``mixed_work`` builds it once per step;
    every layer's launch reuses it."""

    tables: torch.Tensor
    seq_q_start: torch.Tensor
    q_len: torch.Tensor
    pos_start: torch.Tensor
    items: tuple | None
    block_q: int
    num_qb: int
    grid: str


def mixed_work(tables, seq_q_start, q_len, pos_start, *, page: int, hkv: int,
               qmax: int, grid: str | None = None) -> MixedWork:
    """One step's ``MixedWork`` on ``grid`` (``mixed_grid_mode()`` when
    None): the work list is built for the ragged grid only."""
    grid = grid or mixed_grid_mode()
    plan = mixed_grid_plan(qmax)
    tbl, qs, ql, ps = (x.to(torch.int32).contiguous()
                       for x in (tables, seq_q_start, q_len, pos_start))
    items = None
    if grid == "ragged":
        items = build_mixed_work_list(ps, ql, page=page,
                                      block_q=plan["block_q"],
                                      num_qb=plan["num_qb"],
                                      max_pages=tbl.shape[1], head_groups=hkv)
    return MixedWork(tbl, qs, ql, ps, items, plan["block_q"],
                     plan["num_qb"], grid)


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
) -> torch.Tensor:
    """Ragged mixed attention over the flat token batch: token
    seq_q_start[s] + i (query i of lane s, global position pos_start[s] + i)
    attends lane s's table pages over positions [0, pos_start[s] + i].
    Returns [T, H, D]; rows no lane owns (padding tokens) are zero.  With
    ``k_scale``/``v_scale`` the pools are int8, or int4 when the pool has
    half the scale page's rows.

    The reference's ``paged_mixed_attention`` takes per-lane queries
    [S, Hkv, G, Q, D]; this wrapper takes the flat batch the kernel reads
    directly through ``seq_q_start``.  ``qmax`` (widest lane, default
    T - S + 1 as in the reference) sizes the work list; ``work`` passes one
    ``mixed_work`` prepared for every layer of a step.  ``grid`` ("ragged"
    or "dense"; default the work's, else ``ARKS_MIXED_GRID``) picks the
    launch: CUDA tensors launch ``csrc/paged_mixed_attention.cu`` over the
    work list (replaces the Pallas ``_paged_mixed_ragged_kernel``) or over
    the dense grid (``paged_mixed_attention_dense``); CPU tensors take
    ``paged_mixed_attention_plain``, the same function on either grid."""
    t, h, d = q.shape
    s = q_len.shape[0]
    qmax = qmax or _default_qmax(t, s)
    if not _use_kernel(q, impl):
        return paged_mixed_attention_plain(q, k_pool, v_pool, tables,
                                           seq_q_start, q_len, pos_start,
                                           layer, k_scale=k_scale,
                                           v_scale=v_scale, qmax=qmax)
    grid = grid or (work.grid if work is not None else mixed_grid_mode())
    if work is None or work.grid != grid:
        work = mixed_work(tables, seq_q_start, q_len, pos_start,
                          page=pool_page_tokens(k_pool, k_scale),
                          hkv=k_pool.shape[2], qmax=qmax, grid=grid)
    if grid == "dense":
        return paged_mixed_attention_dense(q, k_pool, v_pool, work, layer,
                                           k_scale=k_scale, v_scale=v_scale)
    _, out, ptrs, (h, hkv, d, page, n, dtype_code, kv_mode) = \
        _mixed_launch_args("paged_mixed_attention", q, k_pool, v_pool,
                           k_scale, v_scale, work, layer)
    _kernels.launch("arks_paged_mixed_attention", *ptrs,
                    *(x.data_ptr() for x in work.items),
                    work.items[0].shape[0], h, hkv, d, page, n,
                    work.tables.shape[1], int(layer), work.block_q,
                    1.0 / math.sqrt(d), dtype_code, kv_mode, _stream())
    paged_mixed_attention.launches += 1
    return out


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
    kv_mode = (2 if rows != page else 1) if quantized else 0
    pool_dtype = torch.int8 if quantized else q.dtype
    if q.dtype not in _KERNEL_DTYPES or k_pool.dtype != pool_dtype or \
            v_pool.dtype != pool_dtype or (v_scale is None) == quantized:
        raise TypeError(f"{kernel} kernel takes bf16/f32 q over "
                        "pools of q's dtype, or int8/int4 pools with both "
                        f"scales; got {q.dtype}/{k_pool.dtype}/"
                        f"{v_pool.dtype}")
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
    dense``; replaces the Pallas ``_paged_mixed_kernel``): one CTA per
    (lane, KV head, q-block) of the whole (S, num_qb) grid, no work list.
    Valid rows are bit-identical to the ragged launch's, and rows no lane
    owns are zero.  CUDA tensors only (``paged_mixed_attention`` sends CPU
    tensors to the plain version); counts its launches in
    ``paged_mixed_attention_dense.launches``."""
    if not q.is_cuda:
        raise ValueError("paged_mixed_attention_dense launches the CUDA "
                         "kernel; CPU tensors take "
                         "paged_mixed_attention_plain")
    _, out, ptrs, (h, hkv, d, page, n, dtype_code, kv_mode) = \
        _mixed_launch_args("paged_mixed_attention_dense", q, k_pool, v_pool,
                           k_scale, v_scale, work, layer)
    _kernels.launch("arks_paged_mixed_attention_dense", *ptrs,
                    work.q_len.shape[0], work.num_qb, h, hkv, d, page, n,
                    work.tables.shape[1], int(layer), work.block_q,
                    1.0 / math.sqrt(d), dtype_code, kv_mode, _stream())
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
    to the V dtype (q's dtype for int8) before p.V; divide by l + 1e-9
    after.  V rows past the length never reach p.V, and a slot of length 0
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
    p_dtype = v_cache.dtype
    if v_scale is not None:
        p = p * v_scale[:, :, None, :]
        p_dtype = q.dtype
    vf = torch.where(valid[:, None, :, None], v_cache.float(), 0.0)
    pv = torch.einsum("bkgc,bkcd->bkgd", p.to(p_dtype).float(), vf)
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
    p_dtype = q.dtype if v_scale is not None else v_cache.dtype
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
    pool_dtype = torch.int8 if quantized else q.dtype
    if q.dtype not in _KERNEL_DTYPES or k_pool.dtype != pool_dtype or \
            v_pool.dtype != pool_dtype or (v_scale is None) == quantized:
        raise TypeError("paged_decode_attention kernel takes bf16/f32 q over "
                        "pools of q's dtype, or int8 pools with both scales; "
                        f"got {q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
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
                    int(quantized), _stream())
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0

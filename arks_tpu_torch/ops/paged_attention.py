"""Paged KV cache ops: block-table work lists, the plain PyTorch oracles, and
the wrappers of the two CUDA kernels on the served path (port of
``arks_tpu/ops/paged_attention.py``, bf16/f32 pools).

- **Pool layout** ``[L, N_pages, Hkv, P, D]``; block tables ``[B, MaxP]``
  int32 map position p of lane b to pool page ``tables[b, p // P]``.  The
  head dim is stored unpadded (the reference's 128-lane padding works
  around a TPU Mosaic limit Hopper does not have).
- **Pools are updated in place.**  The JAX functions return new arrays;
  here ``paged_update_xla`` and ``paged_kv_update`` write into the pool
  tensors they are given (and return them for symmetry).
- **Kernels** (``csrc/paged_kv_update.cu``, ``csrc/paged_mixed_attention.cu``)
  launch for CUDA tensors and raise on anything they do not take — a build
  or launch error, an unsupported dtype or shape; there is no fallback.
  Tensors on the CPU take each kernel's plain version, which
  ``impl="plain"`` also selects on the card (for comparison only).
  Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from arks_tpu_torch.ops import _kernels

_NEG_INF = -1e30

# Most query rows one attention work item holds (csrc kBQ): the CUDA
# kernel keeps each row's online-softmax state in registers.
MAX_BLOCK_Q = 8
# Most query heads per KV head the CUDA kernel takes (one warp each).
MAX_GROUP = 8
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


# ---------------------------------------------------------------------------
# Mixed-grid planning and the ragged work list
# ---------------------------------------------------------------------------


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
    the oracle path; the kernel never does this."""
    g = pool[layer][tables.long()]              # [B, MaxP, Hkv, P, D]
    b, mp, hkv, p, d = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(b, hkv, mp * p, d)


def paged_update_xla(k_pool, v_pool, k_scale, v_scale, k_new, v_new,
                     write_idx, tables, layer):
    """Scatter one KV row per token through its block-table row, IN PLACE
    (the reference's oracle scatter; bf16/f32 pools).  ``write_idx`` at or
    past the table's coverage (MaxP * P) is the inactive-token sentinel:
    that row is dropped.  Returns (k_pool, v_pool, k_scale, v_scale)."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "int8/int4 KV pools arrive with the quantized-pool slice")
    p = k_pool.shape[3]
    keep = (write_idx < tables.shape[1] * p) & (write_idx >= 0)
    sel = torch.nonzero(keep).squeeze(1)
    idx = write_idx[sel].long()
    page = tables[sel].long().gather(1, (idx // p)[:, None])[:, 0]
    off = idx % p
    k_pool[layer][page, :, off] = k_new[sel].to(k_pool.dtype)
    v_pool[layer][page, :, off] = v_new[sel].to(v_pool.dtype)
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
    for name, x in (("k_pool", k_pool), ("v_pool", v_pool), ("k_new", kn),
                    ("v_new", vn), ("write_idx", widx), ("tables", tbl)):
        if not x.is_cuda or x.device != k_pool.device:
            raise ValueError(f"paged_kv_update: {name} is not on "
                             f"{k_pool.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"paged_kv_update: {name} must be contiguous "
                             "and 16-byte aligned")
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
# Kernel #1: ragged mixed prefill+decode attention
# ---------------------------------------------------------------------------


def _default_qmax(t: int, s: int) -> int:
    """The reference's widest per-lane query span for a flat batch of T
    tokens over S lanes (``attention.py:430``)."""
    return max(t - s + 1, 1)


def paged_mixed_attention_plain(q, k_pool, v_pool, tables, seq_q_start,
                                q_len, pos_start, layer, *, qmax=None):
    """Plain version of the attention kernel: gather each lane's queries
    into [S, Hkv, G, Qmax, D] and its pages into [S, Hkv, MaxP*P, D], do the
    masked softmax in f32 in one pass (p rounded to the V dtype before p.V,
    divide by l + 1e-9 after, as the kernel does), and scatter the valid
    rows back to [T, H, D].  Rows no lane owns are zero."""
    t, h, d = q.shape
    s = q_len.shape[0]
    hkv = k_pool.shape[2]
    g = h // hkv
    cover = tables.shape[1] * k_pool.shape[3]
    qmax = qmax or _default_qmax(t, s)
    dev = q.device
    ar = torch.arange(qmax, device=dev)
    span = seq_q_start.long()[:, None] + ar                      # [S, Qmax]
    valid = ar[None, :] < q_len.long()[:, None]
    qs = q[span.clamp(max=t - 1)].reshape(s, qmax, hkv, g, d).float()
    kc = paged_gather_kv(k_pool, tables, layer).float()          # [S,Hkv,C,D]
    vc = paged_gather_kv(v_pool, tables, layer)
    scores = torch.einsum("sqkgd,skcd->skgqc", qs, kc) * (1.0 / math.sqrt(d))
    qpos = pos_start.long()[:, None] + ar                        # [S, Qmax]
    seen = torch.arange(cover, device=dev)[None, None, :] <= qpos[:, :, None]
    scores = scores.masked_fill(~seen[:, None, None], _NEG_INF)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("skgqc,skcd->skgqd", p.to(vc.dtype).float(), vc.float())
    o = (pv / (l + 1e-9)).to(q.dtype)                            # [S,Hkv,G,Q,D]
    rows = o.permute(0, 3, 1, 2, 4).reshape(s * qmax, h, d)
    out = torch.zeros((t + 1, h, d), dtype=q.dtype, device=dev)
    dst = torch.where(valid, span, torch.full_like(span, t)).reshape(-1)
    out.index_copy_(0, dst, rows)     # rows no lane owns land in row T
    return out[:t]


class MixedWork(NamedTuple):
    """Layer-invariant launch inputs of the attention kernel for one mixed
    dispatch: the lane view as contiguous int32 tensors, the ragged work
    list (seq, head, qb, plo, pages) and its block_q.  ``mixed_work`` builds
    it once per step; every layer's launch reuses it."""

    tables: torch.Tensor
    seq_q_start: torch.Tensor
    q_len: torch.Tensor
    pos_start: torch.Tensor
    items: tuple
    block_q: int


def mixed_work(tables, seq_q_start, q_len, pos_start, *, page: int, hkv: int,
               qmax: int) -> MixedWork:
    plan = mixed_grid_plan(qmax)
    tbl, qs, ql, ps = (x.to(torch.int32).contiguous()
                       for x in (tables, seq_q_start, q_len, pos_start))
    items = build_mixed_work_list(ps, ql, page=page, block_q=plan["block_q"],
                                  num_qb=plan["num_qb"],
                                  max_pages=tbl.shape[1], head_groups=hkv)
    return MixedWork(tbl, qs, ql, ps, items, plan["block_q"])


def paged_mixed_attention(
    q: torch.Tensor,            # [T, H, D] flat mixed token batch
    k_pool: torch.Tensor,       # [L, N, Hkv, P, D]
    v_pool: torch.Tensor,
    tables: torch.Tensor,       # [S, MaxP] int32 — lane s's block table
    seq_q_start: torch.Tensor,  # [S] int32 — lane's first flat-token index
    q_len: torch.Tensor,        # [S] int32 — lane's token count (0 inactive)
    pos_start: torch.Tensor,    # [S] int32 — global position of that token
    layer: int, *,
    qmax: int | None = None,
    impl: str | None = None,
    work: MixedWork | None = None,
) -> torch.Tensor:
    """Ragged mixed attention over the flat token batch: token
    seq_q_start[s] + i (query i of lane s, global position pos_start[s] + i)
    attends lane s's table pages over positions [0, pos_start[s] + i].
    Returns [T, H, D]; rows no lane owns (padding tokens) are zero.

    The reference's ``paged_mixed_attention`` takes per-lane queries
    [S, Hkv, G, Q, D]; this wrapper takes the flat batch the kernel reads
    directly through ``seq_q_start``.  ``qmax`` (widest lane, default
    T - S + 1 as in the reference) sizes the work list; ``work`` passes one
    ``mixed_work`` prepared for every layer of a step.  CUDA tensors launch
    ``csrc/paged_mixed_attention.cu`` (replaces the Pallas
    ``_paged_mixed_ragged_kernel``); CPU tensors take
    ``paged_mixed_attention_plain``."""
    t, h, d = q.shape
    s = q_len.shape[0]
    qmax = qmax or _default_qmax(t, s)
    if not _use_kernel(q, impl):
        return paged_mixed_attention_plain(q, k_pool, v_pool, tables,
                                           seq_q_start, q_len, pos_start,
                                           layer, qmax=qmax)
    _, n, hkv, page, dk = k_pool.shape
    if q.dtype not in _KERNEL_DTYPES or k_pool.dtype != q.dtype or \
            v_pool.dtype != q.dtype:
        raise TypeError("paged_mixed_attention kernel takes q and pools of "
                        f"one dtype (bf16/f32), got {q.dtype}/"
                        f"{k_pool.dtype}/{v_pool.dtype}")
    if dk != d or d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"paged_mixed_attention kernel takes head_dim in "
                         f"{_KERNEL_HEAD_DIMS} matching the pool, got q {d} "
                         f"pool {dk}")
    if h % hkv or h // hkv > MAX_GROUP:
        raise ValueError(f"paged_mixed_attention kernel takes H/Hkv <= "
                         f"{MAX_GROUP}, got {h}/{hkv}")
    if not 0 <= layer < k_pool.shape[0]:
        raise ValueError(f"layer {layer} out of range")
    if work is None:
        work = mixed_work(tables, seq_q_start, q_len, pos_start, page=page,
                          hkv=hkv, qmax=qmax)
    qc = q.contiguous()
    for name, x in (("q", qc), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("work", work.tables)):
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"paged_mixed_attention: {name} is not on "
                             f"{q.device}")
    for name, x in (("k_pool", k_pool), ("v_pool", v_pool)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"paged_mixed_attention: {name} must be "
                             "contiguous and 16-byte aligned")
    out = torch.zeros_like(qc)
    _kernels.launch("arks_paged_mixed_attention", qc.data_ptr(),
                    out.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                    work.tables.data_ptr(), work.pos_start.data_ptr(),
                    work.seq_q_start.data_ptr(), work.q_len.data_ptr(),
                    *(x.data_ptr() for x in work.items),
                    work.items[0].shape[0], h, hkv, d, page, n,
                    work.tables.shape[1], int(layer), work.block_q,
                    1.0 / math.sqrt(d), _KERNEL_DTYPES[q.dtype], _stream())
    paged_mixed_attention.launches += 1
    return out


paged_mixed_attention.launches = 0

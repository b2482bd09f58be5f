"""Block-sparse grouped matmul for the MoE experts — the port of
``arks_tpu/ops/moe_kernel.py``, whose Pallas ``_gm_kernel`` becomes the
CUDA kernel ``csrc/grouped_matmul.cu``.

Layout contract (prepared by ``pad_groups``, on the device, no host sync):
rows are sorted by expert and each expert's group is padded with zero rows
to a ``block_t`` multiple, so every [block_t, K] tile belongs to ONE expert
(``block_expert``: tile -> expert id).  The padded row count is the static
worst case Tp = (ceil(T / block_t) + X) * block_t.  Zero rows give zero
outputs whatever the expert and scales, so tiles past the last group may
name any expert — the kernel writes zeros there without a product when it
is told where the groups end (``rows_used``), and multiplies only the
first 64 rows of a tile with no more real rows (``tile_rows``).

The weights are raw (bf16/f32), int8 with per-channel scales folded into
the f32 accumulator, or packed int4 (``models/quant.py``'s layout) whose
tile is dequantized in the activation dtype before the product.

``ARKS_MOE_KERNEL`` picks the grouped route of ``models/moe.py``: ``auto``
resolves to ``xla`` (one ``matmul`` per expert over dequantized weights,
the reference's ``ragged_dot`` path), ``pallas`` to ``grouped_ffn``.
"""

from __future__ import annotations


import torch

from arks_tpu_torch import knobs
from arks_tpu_torch.models.quant import dequantize, is_quantized
from arks_tpu_torch.ops import _kernels
from arks_tpu_torch.ops.paged_attention import (_check_operands, _stream,
                                                _use_kernel)

BLOCK_T = 128
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Kernel constraints (csrc/grouped_matmul.cu): any K, a multiple of 8 for
# bf16 xs (TMA rows are 16-byte aligned); N in 16-byte vectors; an int4
# group dividing K, a multiple of 8 (bf16, even for f32) whose 64-wide K
# stages of the bf16 kernel span two groups at most.
_KERNEL_K_ALIGN = {torch.bfloat16: 8, torch.float32: 1}
_KERNEL_GROUP_ALIGN = {torch.bfloat16: 8, torch.float32: 2}
_KERNEL_N_STEP = 16
_KERNEL_STAGE = 64


def _stages_fit(k: int, group: int) -> bool:
    """Every 64-wide K stage of the bf16 kernel spans two int4 groups at
    most (the scale rows one stage carries)."""
    return all((min(k0 + _KERNEL_STAGE, k) - 1) // group - k0 // group <= 1
               for k0 in range(0, k, _KERNEL_STAGE))


def moe_impl() -> str:
    """``ARKS_MOE_KERNEL``: auto (-> xla), pallas or xla."""
    raw = knobs.get_enum("ARKS_MOE_KERNEL", ("auto", "pallas", "xla"))
    return "xla" if raw == "auto" else raw


def pad_groups(xs: torch.Tensor, sorted_expert: torch.Tensor,
               group_sizes: torch.Tensor, block_t: int = BLOCK_T):
    """Scatter expert-sorted rows into block-aligned group slots.  Returns
    (xs_padded [Tp, K] zero-filled, dest [T] int32 row positions — also
    the gather map of the outputs — and block_expert [Tp / block_t]
    int32), bit for bit the reference's."""
    t, k = xs.shape
    nx = group_sizes.shape[0]
    tp = (-(-t // block_t) + nx) * block_t      # static worst case
    sizes = group_sizes.long()
    padded_sizes = (sizes + block_t - 1) // block_t * block_t
    pad_starts = torch.cumsum(padded_sizes, 0) - padded_sizes
    starts = torch.cumsum(sizes, 0) - sizes
    se = sorted_expert.long()
    dest = (pad_starts[se] + (torch.arange(t, device=xs.device)
                              - starts[se])).to(torch.int32)
    xs_padded = torch.zeros((tp, k), dtype=xs.dtype, device=xs.device)
    xs_padded[dest.long()] = xs
    tile_starts = torch.arange(tp // block_t, device=xs.device) * block_t
    ends = torch.cumsum(padded_sizes, 0)
    block_expert = torch.clamp(
        torch.searchsorted(ends, tile_starts, right=True),
        max=nx - 1).to(torch.int32)
    return xs_padded, dest, block_expert


def rows_used(group_sizes: torch.Tensor, block_t: int = BLOCK_T
              ) -> torch.Tensor:
    """[1] int32 on the device: the padded groups' end (tiles at or past it
    hold only zero rows)."""
    sizes = group_sizes.long()
    return ((sizes + block_t - 1) // block_t * block_t).sum().reshape(1).to(
        torch.int32)


def tile_rows(group_sizes: torch.Tensor, num_tiles: int,
              block_t: int = BLOCK_T) -> torch.Tensor:
    """[num_tiles] int32 on the device: the real (routed) rows of each
    ``block_t``-row tile of ``pad_groups``' layout.  A group's rows fill its
    slot from the front, so tile i's real rows are its first tile_rows[i];
    tiles past the groups hold 0.  No host sync."""
    sizes = group_sizes.long()
    padded = (sizes + block_t - 1) // block_t * block_t
    ends = torch.cumsum(padded, 0)
    starts = torch.arange(num_tiles, device=sizes.device) * block_t
    e = torch.searchsorted(ends, starts, right=True)
    inside = e < sizes.shape[0]
    e = e.clamp(max=sizes.shape[0] - 1)
    real = (sizes[e] - (starts - (ends[e] - padded[e]))).clamp(0, block_t)
    return torch.where(inside, real, 0).to(torch.int32)


def _weight_mode(w: torch.Tensor, w_scale, w_group_scale):
    """(mode, K) of a weight operand: 0 raw (xs's dtype), 1 int8, 2 int4
    packed along K."""
    if w_scale is not None and w_group_scale is not None:
        raise ValueError("w_scale and w_group_scale are exclusive")
    if w_group_scale is not None:
        return 2, 2 * w.shape[1]
    if w_scale is not None:
        return 1, w.shape[1]
    return 0, w.shape[1]


def grouped_matmul_plain(xs, w, block_expert, w_scale=None,
                         w_group_scale=None, *, block_t: int = BLOCK_T):
    """Plain version of the kernel, a loop over tiles of the same
    arithmetic: the expert's weight in xs's dtype (int4: q times its
    group scale, rounded to xs's dtype), the product accumulated in f32,
    int8's per-channel scale on the f32 accumulator, the result cast to
    xs's dtype."""
    tp = xs.shape[0]
    mode = _weight_mode(w, w_scale, w_group_scale)[0]
    n = w.shape[-1]
    out = torch.empty((tp, n), dtype=xs.dtype, device=xs.device)
    for i, e in enumerate(block_expert.tolist()):
        rows = slice(i * block_t, (i + 1) * block_t)
        if mode == 2:
            we = dequantize({"q": w[e], "gs": w_group_scale[e]}, xs.dtype)
        else:
            we = w[e].to(xs.dtype)
        acc = xs[rows].float() @ we.float()
        if mode == 1:
            acc = acc * w_scale[e]
        out[rows] = acc.to(xs.dtype)
    return out


def grouped_matmul(
    xs: torch.Tensor,            # [Tp, K] expert-sorted, block-aligned groups
    w: torch.Tensor,             # [X, K, N]; int8 [X, K, N]; int4 [X, K/2, N]
    block_expert: torch.Tensor,  # [Tp / block_t] int32 tile -> expert
    w_scale: torch.Tensor | None = None,        # int8: [X, N] f32
    w_group_scale: torch.Tensor | None = None,  # int4: [X, K/G, N] f32
    *,
    block_t: int = BLOCK_T,
    rows_used: torch.Tensor | None = None,      # [1] int32 (see module doc)
    tile_rows: torch.Tensor | None = None,      # [Tp / block_t] int32
    impl: str | None = None,
) -> torch.Tensor:
    """[Tp, N] = per tile xs @ w[block_expert[tile]], scales fused, in xs's
    dtype.  CUDA tensors launch ``csrc/grouped_matmul.cu`` (replaces the
    Pallas ``_gm_kernel``); CPU tensors take ``grouped_matmul_plain``.
    ``tile_rows`` (``tile_rows()``: each tile's real rows) lets the bf16
    kernel multiply only a tile's first 64 rows when no more are real; the
    rows it skips are zero rows, so the output is the same.  The kernel
    takes block_t 128, any K (a multiple of 8 for bf16 xs), an int4 group
    dividing K (a multiple of 8 for bf16 — 32, or a multiple of 64, say —
    even for f32) and N a multiple of 16; it raises on anything else."""
    tp, k_x = xs.shape
    mode, k = _weight_mode(w, w_scale, w_group_scale)
    nx, n = w.shape[0], w.shape[-1]
    if k != k_x or tp % block_t or block_expert.shape[0] != tp // block_t:
        raise ValueError(f"grouped_matmul: xs {tuple(xs.shape)}, w "
                         f"{tuple(w.shape)} (K {k}), block_expert "
                         f"{tuple(block_expert.shape)}, block_t {block_t}")
    if not _use_kernel(xs, impl):
        return grouped_matmul_plain(xs, w, block_expert, w_scale,
                                    w_group_scale, block_t=block_t)
    want_w = {0: xs.dtype, 1: torch.int8, 2: torch.int8}[mode]
    if xs.dtype not in _KERNEL_DTYPES or w.dtype != want_w:
        raise TypeError(f"grouped_matmul kernel takes bf16/f32 xs and "
                        f"weights of xs's dtype, int8 or packed int4; got "
                        f"{xs.dtype}/{w.dtype} (mode {mode})")
    group = 0
    scale = None
    if mode == 1:
        scale = w_scale
        if w_scale.dtype != torch.float32 or \
                tuple(w_scale.shape) != (nx, n):
            raise ValueError(f"grouped_matmul: w_scale "
                             f"{tuple(w_scale.shape)} {w_scale.dtype} is not "
                             f"f32 [{nx}, {n}]")
    elif mode == 2:
        scale = w_group_scale
        ng = w_group_scale.shape[1]
        group = k // ng
        align = _KERNEL_GROUP_ALIGN[xs.dtype]
        if w_group_scale.dtype != torch.float32 or \
                tuple(w_group_scale.shape) != (nx, ng, n) or \
                group * ng != k or group % align or \
                (xs.dtype == torch.bfloat16 and not _stages_fit(k, group)):
            raise ValueError(f"grouped_matmul kernel: w_group_scale "
                             f"{tuple(w_group_scale.shape)} "
                             f"{w_group_scale.dtype} for K {k}: f32 "
                             f"[X, K/G, N] with G a multiple of {align}"
                             + (" whose 64-wide K stages span two groups "
                                "at most" if xs.dtype == torch.bfloat16
                                else ""))
    step = _KERNEL_K_ALIGN[xs.dtype]
    if block_t != BLOCK_T or k % step or n % _KERNEL_N_STEP:
        raise ValueError(f"grouped_matmul kernel takes block_t {BLOCK_T}, "
                         f"K % {step} == 0 and N % {_KERNEL_N_STEP} == 0; "
                         f"got {block_t}, {k}, {n}")
    if tile_rows is not None and tuple(tile_rows.shape) != (tp // block_t,):
        raise ValueError(f"grouped_matmul: tile_rows "
                         f"{tuple(tile_rows.shape)} for {tp // block_t} "
                         "tiles")
    xc = xs.contiguous()
    bexp = block_expert.to(torch.int32).contiguous()
    small = [("block_expert", bexp)]
    ptrs = []
    for name, x in (("rows_used", rows_used), ("tile_rows", tile_rows)):
        x = x.to(torch.int32).contiguous() if x is not None else None
        if x is not None:
            small.append((name, x))
        ptrs.append(x)
    operands = [("xs", xc), ("w", w)]
    if scale is not None:
        operands.append(("scale", scale))
    _check_operands("grouped_matmul", xs.device, operands)
    _check_operands("grouped_matmul", xs.device, small, aligned=False)
    out = torch.empty((tp, n), dtype=xs.dtype, device=xs.device)
    _kernels.launch("arks_grouped_matmul", xc.data_ptr(), w.data_ptr(),
                    scale.data_ptr() if scale is not None else None,
                    bexp.data_ptr(),
                    *(x.data_ptr() if x is not None else None for x in ptrs),
                    out.data_ptr(), tp, k, n, nx, group, mode,
                    _KERNEL_DTYPES[xs.dtype], _stream())
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0


def _weight_operand(wq):
    """(raw weight, grouped_matmul scale kwargs) of a possibly quantized
    expert leaf; int8 scales [X, 1, N] are squeezed to [X, N]."""
    if not is_quantized(wq):
        return wq, {}
    if "gs" in wq:
        return wq["q"], {"w_group_scale": wq["gs"].float()}
    s = wq["s"].float()
    if s.ndim == 3:
        s = s[:, 0, :]
    return wq["q"], {"w_scale": s}


def grouped_ffn(xs: torch.Tensor, sorted_expert: torch.Tensor,
                group_sizes: torch.Tensor, w_gate, w_up, w_down,
                act_dtype: torch.dtype, block_t: int = BLOCK_T, *,
                impl: str | None = None) -> torch.Tensor:
    """The gate/up/silu/down expert FFN over expert-sorted rows through
    three ``grouped_matmul`` launches.  Returns rows in the same sorted
    order as ``xs``."""
    wg, sg = _weight_operand(w_gate)
    wu, su = _weight_operand(w_up)
    wd, sd = _weight_operand(w_down)
    xs_p, dest, bexp = pad_groups(xs, sorted_expert, group_sizes, block_t)
    kw = dict(block_t=block_t, rows_used=rows_used(group_sizes, block_t),
              tile_rows=tile_rows(group_sizes, bexp.shape[0], block_t),
              impl=impl)
    gate = grouped_matmul(xs_p, wg, bexp, **sg, **kw)
    up = grouped_matmul(xs_p, wu, bexp, **su, **kw)
    act = (torch.nn.functional.silu(gate.float()).to(act_dtype)
           * up.to(act_dtype))
    down = grouped_matmul(act, wd, bexp, **sd, **kw)
    return down[dest.long()]

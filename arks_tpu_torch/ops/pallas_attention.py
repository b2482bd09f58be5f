"""Decode attention and in-place K/V row writes on the slot-contiguous
cache (port of ``arks_tpu/ops/pallas_attention.py``): the plain PyTorch
versions and the wrappers of the CUDA kernels that replace its three
Pallas kernels.

- **Cache layout** ``[L, B, Hkv, S, D]``: each (slot, KV head)'s sequence
  is one contiguous ``[S, D]`` stripe.  The wrappers take the FULL stacked
  cache and a layer index, as the reference does, and write it IN PLACE
  (the JAX functions return aliased arrays; these return the tensors they
  were given, for symmetry).
- **int8 caches** hold ``quantize_kv`` values (qmax 127) with per-token
  f32 scales ``[L, B, Hkv, S]``.
- **Kernels** (``csrc/decode_attention.cu``, ``csrc/kv_cache_update.cu``)
  launch for CUDA tensors and raise on anything they do not take; there is
  no fallback.  CPU tensors take each kernel's plain version, which
  ``impl="plain"`` also selects on the card (for comparison only).  Each
  wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import math
import struct

import torch

from arks_tpu_torch.ops import _kernels
from arks_tpu_torch.ops.paged_attention import (
    _KERNEL_DTYPES, _KERNEL_HEAD_DIMS, MAX_GROUP, QUANT_UPDATE_MAX_HEAD_DIM,
    _check_operands, _decode_kv_code, _dense, _rows_for, _stream,
    _use_kernel, decode_attention_plain, decode_workspace, quantize_kv)

__all__ = ["quantize_kv", "ragged_decode_attention",
           "ragged_decode_attention_plain", "kv_cache_update",
           "kv_cache_update_plain", "kv_cache_update_quant",
           "kv_cache_update_quant_plain"]


def _check_layer(layer: int, cache: torch.Tensor) -> None:
    if not 0 <= layer < cache.shape[0]:
        raise ValueError(f"layer {layer} out of range")


# ---------------------------------------------------------------------------
# Kernel #6: ragged decode attention over the slot cache
# ---------------------------------------------------------------------------


def ragged_decode_attention_plain(q, k_cache, v_cache, lengths, layer,
                                  k_scale=None, v_scale=None):
    """Plain version of the attention kernel: ``decode_attention_plain``
    over layer ``layer`` of the cache (lengths past S read all of S)."""
    ks = vs = None
    if k_scale is not None:
        ks, vs = k_scale[layer], v_scale[layer]
    return decode_attention_plain(q, k_cache[layer], v_cache[layer], lengths,
                                  k_scale=ks, v_scale=vs)


def ragged_decode_attention(
    q: torch.Tensor,          # [B, Hkv, G, D] — one query token per slot
    k_cache: torch.Tensor,    # [L, B, Hkv, S, D] — full stacked cache
    v_cache: torch.Tensor,
    lengths: torch.Tensor,    # [B] int32 — valid KV entries per slot
    layer: int,
    k_scale: torch.Tensor | None = None,  # [L, B, Hkv, S] f32 (int8 caches)
    v_scale: torch.Tensor | None = None,
    *, impl: str | None = None,
) -> torch.Tensor:
    """[B, Hkv, G, D] attention of each slot's query over positions
    [0, min(lengths[b], S)) of layer ``layer``; a slot of length 0 gets
    zeros.  With ``k_scale``/``v_scale`` the cache is int8.  CUDA tensors
    launch ``csrc/decode_attention.cu`` (replaces the Pallas
    ``_attn_kernel``); CPU tensors take ``ragged_decode_attention_plain``."""
    if not _use_kernel(q, impl):
        return ragged_decode_attention_plain(q, k_cache, v_cache, lengths,
                                             layer, k_scale, v_scale)
    b, hkv, g, d = q.shape
    _, nb, ckv, s, dk = k_cache.shape
    quantized = k_scale is not None
    kv_code = _decode_kv_code("ragged_decode_attention", q, k_cache, v_cache,
                              quantized, v_scale)
    if (nb, ckv, dk) != (b, hkv, d) or v_cache.shape != k_cache.shape or \
            d not in _KERNEL_HEAD_DIMS or g > MAX_GROUP or \
            tuple(lengths.shape) != (b,):
        raise ValueError(f"ragged_decode_attention kernel: q {tuple(q.shape)} "
                         f"cache {tuple(k_cache.shape)} lengths "
                         f"{tuple(lengths.shape)} (head_dim in "
                         f"{_KERNEL_HEAD_DIMS}, G <= {MAX_GROUP})")
    scales = ()
    if quantized:
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32 \
                or k_scale.shape != k_cache.shape[:4] or \
                v_scale.shape != k_scale.shape:
            raise ValueError("ragged_decode_attention: scales "
                             f"{tuple(k_scale.shape)} {k_scale.dtype} do not "
                             f"match the cache {tuple(k_cache.shape)}")
        scales = (("k_scale", k_scale), ("v_scale", v_scale))
    _check_layer(layer, k_cache)
    qc = q.contiguous()
    lens = _dense(lengths, torch.int32)
    _check_operands("ragged_decode_attention", q.device,
                    (("q", qc), ("lengths", lens)), aligned=False)
    _check_operands("ragged_decode_attention", q.device,
                    (("k_cache", k_cache), ("v_cache", v_cache), *scales))
    out = torch.empty_like(qc)
    ws = decode_workspace(qc, s)
    _kernels.launch("arks_ragged_decode_attention", qc.data_ptr(),
                    out.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                    k_scale.data_ptr() if quantized else None,
                    v_scale.data_ptr() if quantized else None,
                    lens.data_ptr(), ws.data_ptr(), b, hkv * g, hkv, d, s,
                    int(layer),
                    1.0 / math.sqrt(d), _KERNEL_DTYPES[q.dtype],
                    kv_code, _stream())
    ragged_decode_attention.launches += 1
    return out


ragged_decode_attention.launches = 0


# ---------------------------------------------------------------------------
# Kernels #7 and #8: in-place row writes (bf16/f32, and quantized int8)
# ---------------------------------------------------------------------------


def _kept(write_idx: torch.Tensor, s: int):
    """(slots whose write lands, their positions): idx >= S or < 0 drop."""
    sel = torch.nonzero((write_idx >= 0) & (write_idx < s)).squeeze(1)
    return sel, write_idx[sel].long()


def kv_cache_update_plain(k_cache, v_cache, k_new, v_new, write_idx, layer):
    """Plain version of the update kernel: an indexed store of the rows
    that land, in place."""
    sel, idx = _kept(write_idx, k_cache.shape[3])
    k_cache[layer][sel, :, idx] = k_new[sel].to(k_cache.dtype)
    v_cache[layer][sel, :, idx] = v_new[sel].to(v_cache.dtype)
    return k_cache, v_cache


def _check_rows(kernel, cache, k_new, v_new, write_idx) -> None:
    _, b, hkv, _, d = cache.shape
    if k_new.shape != (b, hkv, d) or v_new.shape != (b, hkv, d) or \
            write_idx.shape != (b,):
        raise ValueError(f"{kernel}: shape mismatch k_new "
                         f"{tuple(k_new.shape)} write_idx "
                         f"{tuple(write_idx.shape)} cache "
                         f"{tuple(cache.shape)}")


# The slot writes' launch arguments, packed as their C entry points read
# them (csrc/kv_cache_update.cu SlotWriteArgs, SlotQuantWriteArgs: every
# field an int64): one ctypes argument per launch instead of a dozen
# converted one by one.
_PACK_UPDATE = struct.Struct("12q").pack
_PACK_UPDATE_QUANT = struct.Struct("14q").pack


def kv_cache_update(k_cache: torch.Tensor,   # [L, B, Hkv, S, D]
                    v_cache: torch.Tensor,
                    k_new: torch.Tensor,     # [B, Hkv, D]
                    v_new: torch.Tensor,
                    write_idx: torch.Tensor,  # [B] int32
                    layer: int, *, impl: str | None = None):
    """Write one K and one V row per slot at ``write_idx`` of layer
    ``layer``, IN PLACE; a slot whose index is >= S (the parked-slot
    sentinel) or negative writes nothing.  f32 rows into a bf16 cache are
    rounded to nearest even, as the reference's astype.  CUDA tensors
    launch ``csrc/kv_cache_update.cu`` (replaces the Pallas
    ``_update_kernel``); CPU tensors take ``kv_cache_update_plain``."""
    if not _use_kernel(k_cache, impl):
        return kv_cache_update_plain(k_cache, v_cache, k_new, v_new,
                                     write_idx, layer)
    kernel = "kv_cache_update"
    _, b, hkv, s, d = k_cache.shape
    if k_cache.dtype not in _KERNEL_DTYPES or v_cache.dtype != k_cache.dtype \
            or v_cache.shape != k_cache.shape:
        raise TypeError(f"kv_cache_update kernel takes a bf16/f32 cache pair, "
                        f"got {k_cache.dtype}/{v_cache.dtype}")
    row_bytes = d * k_cache.element_size()
    if row_bytes % 16:
        raise ValueError(f"kv_cache_update kernel needs D * itemsize % 16 == "
                         f"0, got {row_bytes}")
    kn, vn, narrow = _rows_for(k_cache, k_new, v_new)
    widx = _dense(write_idx, torch.int32)
    _check_rows(kernel, k_cache, kn, vn, widx)
    _check_layer(layer, k_cache)
    dev = k_cache.device
    ptrs = _check_operands(kernel, dev, (
        ("k_cache", k_cache), ("v_cache", v_cache), ("k_new", kn),
        ("v_new", vn), ("write_idx", widx)))
    err = _kernels.entry("arks_kv_cache_update")(_PACK_UPDATE(
        *ptrs, b, hkv, s, row_bytes, layer, narrow, _stream(dev.index)))
    if err:
        _kernels.raise_launch_error("arks_kv_cache_update", err)
    kv_cache_update.launches += 1
    return k_cache, v_cache


kv_cache_update.launches = 0


def kv_cache_update_quant_plain(k_cache, v_cache, k_scale, v_scale, k_new,
                                v_new, write_idx, layer):
    """Plain version of the quantized update kernel: ``quantize_kv`` of the
    rows that land, then an indexed store of values and scales, in place."""
    sel, idx = _kept(write_idx, k_cache.shape[3])
    for cache, scales, new in ((k_cache, k_scale, k_new),
                               (v_cache, v_scale, v_new)):
        vals, sc = quantize_kv(new[sel])
        cache[layer][sel, :, idx] = vals
        scales[layer][sel, :, idx] = sc
    return k_cache, v_cache, k_scale, v_scale


def kv_cache_update_quant(k_cache: torch.Tensor,   # [L, B, Hkv, S, D] int8
                          v_cache: torch.Tensor,
                          k_scale: torch.Tensor,   # [L, B, Hkv, S] f32
                          v_scale: torch.Tensor,
                          k_new: torch.Tensor,     # [B, Hkv, D] bf16/f32
                          v_new: torch.Tensor,
                          write_idx: torch.Tensor,  # [B] int32
                          layer: int, *, impl: str | None = None):
    """Quantize each slot's K and V rows per token over D (qmax 127) and
    write values and f32 scales at ``write_idx`` of layer ``layer``, IN
    PLACE; indices >= S or negative write nothing.  CUDA tensors launch
    ``csrc/kv_cache_update.cu`` (replaces the Pallas
    ``_update_quant_kernel`` and the ``quantize_kv`` before it; D at most
    ``QUANT_UPDATE_MAX_HEAD_DIM``); CPU tensors take
    ``kv_cache_update_quant_plain``."""
    if not _use_kernel(k_cache, impl):
        return kv_cache_update_quant_plain(k_cache, v_cache, k_scale,
                                           v_scale, k_new, v_new, write_idx,
                                           layer)
    kernel = "kv_cache_update_quant"
    _, b, hkv, s, d = k_cache.shape
    if k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8 or \
            k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError("kv_cache_update_quant kernel takes int8 caches and "
                        f"f32 scales, got {k_cache.dtype}/{v_cache.dtype}/"
                        f"{k_scale.dtype}/{v_scale.dtype}")
    if k_new.dtype not in _KERNEL_DTYPES or v_new.dtype != k_new.dtype:
        raise TypeError("kv_cache_update_quant kernel takes bf16/f32 rows, "
                        f"got {k_new.dtype}/{v_new.dtype}")
    if v_cache.shape != k_cache.shape or k_scale.shape != k_cache.shape[:4] \
            or v_scale.shape != k_scale.shape or d % 4 or \
            d > QUANT_UPDATE_MAX_HEAD_DIM:
        raise ValueError("kv_cache_update_quant: caches "
                         f"{tuple(k_cache.shape)} and scales "
                         f"{tuple(k_scale.shape)} are not an int8 cache pair "
                         "with D % 4 == 0 and D <= "
                         f"{QUANT_UPDATE_MAX_HEAD_DIM}")
    kn, vn = _dense(k_new), _dense(v_new)
    widx = _dense(write_idx, torch.int32)
    _check_rows(kernel, k_cache, kn, vn, widx)
    _check_layer(layer, k_cache)
    dev = k_cache.device
    ptrs = _check_operands(kernel, dev, (
        ("k_cache", k_cache), ("v_cache", v_cache), ("k_scale", k_scale),
        ("v_scale", v_scale), ("k_new", kn), ("v_new", vn),
        ("write_idx", widx)))
    err = _kernels.entry("arks_kv_cache_update_quant")(_PACK_UPDATE_QUANT(
        *ptrs, b, hkv, d, s, layer, _KERNEL_DTYPES[kn.dtype],
        _stream(dev.index)))
    if err:
        _kernels.raise_launch_error("arks_kv_cache_update_quant", err)
    kv_cache_update_quant.launches += 1
    return k_cache, v_cache, k_scale, v_scale


kv_cache_update_quant.launches = 0

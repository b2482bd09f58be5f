"""Weight-only quantization for serving: int8 (w8a16) and int4 (w4a16) —
the port of ``arks_tpu/models/quant.py``.

Activations stay in the engine dtype in both modes.

- **int8**: symmetric, one f32 scale per output channel: a matmul weight
  [.., K, N] is ``{"q": int8 [.., K, N], "s": f32 [.., 1, N]}``; the
  embedding [V, E] carries ``s`` [V, 1] (one scale per row).  The scale
  applies to the product's OUTPUT (it is constant along the contraction).
- **int4**: symmetric, one f32 scale per (group of G contraction rows x
  output channel): ``{"q": packed [.., K/2, N] int8, "gs": f32
  [.., K/G, N]}``, G = 128 (``ARKS_INT4_GROUP``) clamped down to a divisor
  of K.  Values lie in [-7, 7] and are stored **two to a byte along K**:
  byte i of a column holds row 2i in its low nibble and row 2i+1 in its
  high nibble (``pack_int4`` / ``unpack_int4`` of ``ops/paged_attention``,
  the int4 KV pool's convention), so the bytes really are half of int8's.
  Dequantization is in the activation dtype: ``dtype(q) * dtype(gs)``,
  rounded to that dtype, as the reference's ``_dequant_int4``.  The
  embedding stays int8 in int4 mode.

Rounding: ``quantize_tensor`` divides by 127 (and the int4 path by 7) as
an IEEE division — bit for bit the reference's ``quantize_tensor`` run
eagerly, which is what its ``quantize_params`` (the engine's path for
bridged weights) runs.  Under ``jit`` (its ``init_params_quantized`` and
its checkpoint load's quantize-on-load) XLA multiplies by the f32
reciprocal instead: ``recip=True`` computes that scale (the values then
divide by it, as there), which ``models/weights.py`` uses.  The port's
random init draws from torch generators, so no bit comparison applies
there.

``qeinsum`` of a quantized leaf: the reference leaves these products to
XLA, which fuses the int8/int4 convert into the dot's operand read.  On a
CUDA tensor the port sends them through the grouped matmul kernel
(``csrc/grouped_matmul.cu``), which reads the raw int8 bytes or int4
nibbles and folds the scales into its f32 accumulator: a projection
(``"...a,ab->...b"``) is one group over the T rows, the dense MoE route's
products (``"...e,xef->...xf"``, ``"...xf,xfe->...xe"``) X groups of the
same T rows.  Any other quantized form raises there.  A CPU tensor takes
``qeinsum_plain``: the weight converted to the activation dtype, the
product, then int8's per-channel scale in that dtype (the grouped kernel
applies the same scale to its f32 accumulator before its one rounding,
so the two differ by a rounding of the product: within a bf16 step of
the output).
"""

from __future__ import annotations


import torch

from arks_tpu_torch import knobs
from arks_tpu_torch.ops.paged_attention import pack_int4, unpack_int4

INT4_GROUP = 128

# Weights quantized per output channel along the contraction dim -2.
MATMUL_KEYS = frozenset({
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head",
    "shared_gate_proj", "shared_up", "shared_down",
})
# The router feeds a softmax over experts (small and precision-sensitive),
# so it stays full width, as do norms, biases and the scalar shared gate.
SKIP_KEYS = frozenset({
    "attn_norm", "mlp_norm", "final_norm", "bq", "bk", "bv", "router",
    "shared_gate",
})


def _int4_group(group: int | None) -> int:
    """The int4 group size: explicit arg > ``ARKS_INT4_GROUP`` > 128."""
    if group is not None:
        return group
    return knobs.get_int("ARKS_INT4_GROUP", minimum=1)


def weight_bits(weight_dtype: str) -> int:
    """'bf16' -> 0 (no quantization), 'int8' -> 8, 'int4' -> 4."""
    try:
        return {"bf16": 0, "int8": 8, "int4": 4}[weight_dtype]
    except KeyError:
        raise ValueError(f"weight_dtype={weight_dtype!r}") from None


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "q" in w and ("s" in w or "gs" in w)


def _div(x: torch.Tensor, qmax: float) -> torch.Tensor:
    """x / qmax as an IEEE division on every device (a Python-scalar
    divisor lets CUDA multiply by its reciprocal instead)."""
    return x / torch.full((), qmax, dtype=x.dtype, device=x.device)


def _scale(amax: torch.Tensor, qmax: float, recip: bool) -> torch.Tensor:
    """max(amax, 1e-8) / qmax: an IEEE division, or with ``recip`` a
    multiply by the f32 reciprocal of qmax (the reference under jit)."""
    a = torch.clamp(amax, min=1e-8)
    if recip:
        return a * torch.full((), 1.0 / qmax, dtype=a.dtype, device=a.device)
    return _div(a, qmax)


def quantize_tensor(w: torch.Tensor, axis: int = -2,
                    recip: bool = False) -> dict:
    """Symmetric int8 with one scale shared along ``axis`` (kept as a size-1
    dim): s = max(amax, 1e-8) / 127, q = clip(round_half_even(w / s))."""
    w32 = w.float()
    amax = w32.abs().amax(dim=axis, keepdim=True)
    s = _scale(amax, 127.0, recip)
    q = torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def int4_group_for(k: int, group: int | None = None) -> int:
    """The group actually used for contraction dim ``k``: the requested one
    clamped to k, then down to a divisor of k."""
    g = min(_int4_group(group), k)
    while k % g:
        g -= 1
    return g


def quantize_tensor_int4(w: torch.Tensor, group: int | None = None,
                         recip: bool = False) -> dict:
    """Symmetric int4 of a matmul weight [.., K, N] (K even) with one scale
    per (G contraction rows x output channel): s = max(amax, 1e-8) / 7 per
    group, values clip(round_half_even(w / s)) packed two to a byte along
    K."""
    w32 = w.float()
    k, n = w32.shape[-2], w32.shape[-1]
    if k % 2:
        raise ValueError(f"int4 packing needs an even contraction dim, got "
                         f"{k}")
    g = int4_group_for(k, group)
    grp = w32.reshape(*w32.shape[:-2], k // g, g, n)
    amax = grp.abs().amax(dim=-2, keepdim=True)             # [.., K/G, 1, N]
    s = _scale(amax, 7.0, recip)
    q = torch.clamp(torch.round(grp / s), -7, 7).to(torch.int8)
    return {"q": pack_int4(q.reshape(w32.shape), axis=-2),
            "gs": s.squeeze(-2)}


def int4_values(w: dict) -> torch.Tensor:
    """The int8 values [.., K, N] of a packed int4 leaf."""
    return unpack_int4(w["q"], axis=-2)


def _dequant_int4(w: dict, dtype: torch.dtype) -> torch.Tensor:
    q = int4_values(w)
    gs = w["gs"]
    ngroups = gs.shape[-2]
    g = q.shape[-2] // ngroups
    grp = q.to(dtype).reshape(*q.shape[:-2], ngroups, g, q.shape[-1])
    return (grp * gs.unsqueeze(-2).to(dtype)).reshape(q.shape)


def dequantize(w, dtype: torch.dtype) -> torch.Tensor:
    """The full-width weight in ``dtype`` (int8: q * s in ``dtype``)."""
    if not is_quantized(w):
        return w
    if "gs" in w:
        return _dequant_int4(w, dtype)
    return w["q"].to(dtype) * w["s"].to(dtype)


def _plain_einsum(eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.einsum``; the projections' ``"...a,ab->...b"`` form is a
    plain ``x @ w``, taken directly (einsum's equation parsing costs host
    time on every call)."""
    lhs, rest = eq.split(",")
    rhs, out = rest.split("->")
    if (lhs.startswith("...") and out == "..." + rhs[1:] and len(rhs) == 2
            and lhs[3:] == rhs[0]):
        return x @ w
    return torch.einsum(eq, x, w)


def qeinsum(eq: str, x: torch.Tensor, w, impl: str | None = None
            ) -> torch.Tensor:
    """``einsum`` where ``w`` may be a quantized leaf: through the grouped
    matmul kernel on a CUDA tensor (``qeinsum_grouped``), else, or with
    ``impl="plain"``, ``qeinsum_plain``."""
    if not is_quantized(w):
        return _plain_einsum(eq, x, w)
    if x.is_cuda and impl != "plain":
        return qeinsum_grouped(eq, x, w)
    return qeinsum_plain(eq, x, w)


def qeinsum_plain(eq: str, x: torch.Tensor, w) -> torch.Tensor:
    """The plain form of a quantized ``qeinsum``.  int8: the product with
    the int8 values converted to x's dtype, then the per-channel scale
    (cast to the product's dtype) on the output.  int4: the product with
    the weight dequantized in x's dtype."""
    if not is_quantized(w):
        return _plain_einsum(eq, x, w)
    if "gs" in w:
        return _plain_einsum(eq, x, _dequant_int4(w, x.dtype))
    y = _plain_einsum(eq, x, w["q"].to(x.dtype))
    return y * w["s"].squeeze(-2).to(y.dtype)


def grouped_form(eq: str) -> str | None:
    """Which grouped-matmul layout a quantized product takes: "proj" for
    ``"...a,ab->...b"`` (one group), "experts" for ``"...e,xef->...xf"``
    (every expert over the same rows), "experts_out" for
    ``"...xf,xfe->...xe"`` (expert x over its own rows), else None."""
    lhs, rest = eq.split(",")
    rhs, out = rest.split("->")
    if not (lhs.startswith("...") and out.startswith("...")):
        return None
    a, o = lhs[3:], out[3:]
    if len(rhs) == 2 and len(a) == 1 and rhs == a + o:
        return "proj"
    if len(rhs) == 3 and len(a) == 1 and rhs[1] == a and o == rhs[0] + rhs[2]:
        return "experts"
    if len(rhs) == 3 and a == rhs[:2] and o == rhs[0] + rhs[2]:
        return "experts_out"
    return None


# Tile maps of the grouped layouts, per (device, T, X): built on the device
# once (no host sync), shared by every product of that shape.
_TILE_MAPS: dict = {}


def grouped_tiles(t: int, x: int, device: torch.device):
    """(block_expert, tile_rows) for X groups of the same ``t`` rows, each
    padded to a 128-row tile multiple: tile i of group e names expert e and
    holds min(128, t - i' * 128) real rows (i' its index in the group)."""
    from arks_tpu_torch.ops.moe_kernel import BLOCK_T
    key = (device, t, x)
    maps = _TILE_MAPS.get(key)
    if maps is None:
        n = -(-t // BLOCK_T)
        starts = torch.arange(n, device=device, dtype=torch.int32) * BLOCK_T
        rows = torch.clamp(t - starts, 0, BLOCK_T).repeat(x)
        bexp = torch.arange(x, device=device, dtype=torch.int32
                            ).repeat_interleave(n)
        maps = _TILE_MAPS[key] = (bexp, rows)
    return maps


def qeinsum_grouped(eq: str, x: torch.Tensor, w: dict) -> torch.Tensor:
    """A quantized ``qeinsum`` through ``moe_kernel.grouped_matmul``: the
    rows padded to 128-row tiles in one copy (X copies for the dense MoE
    route's first products), one launch that reads the raw weight, the
    output sliced back.  Raises on a form it does not take, and wherever
    the kernel refuses the shape (there is no convert fallback)."""
    from arks_tpu_torch.ops.moe_kernel import BLOCK_T, grouped_matmul
    form = grouped_form(eq)
    if form is None:
        raise ValueError(f"qeinsum {eq!r}: no grouped-matmul layout for "
                         "this quantized product")
    q = w["q"]
    if form == "proj":
        q = q[None]
    if "gs" in w:
        gs = w["gs"][None] if form == "proj" else w["gs"]
        kw = {"w_group_scale": gs}
    else:
        s = w["s"] if form == "proj" else w["s"][:, 0]     # [X, N]
        # The reference scales the product in its dtype (``y *
        # s.astype(y.dtype)``): the kernel takes the scale rounded to it,
        # so the two differ by one rounding of the product, not by a
        # per-channel bias.
        kw = {"w_scale": s.to(x.dtype).float()}
    nx, n = q.shape[0], q.shape[-1]
    if form == "experts_out":
        lead = x.shape[:-2]
        xs = x.reshape(-1, nx, x.shape[-1]).transpose(0, 1)   # [X, T, F]
    else:
        lead = x.shape[:-1]
        xs = x.reshape(-1, x.shape[-1])[None]                   # [1, T, K]
        if form == "experts":
            xs = xs.expand(nx, -1, -1)
    t = xs.shape[1]
    tp = -(-t // BLOCK_T) * BLOCK_T
    xs = torch.nn.functional.pad(xs, (0, 0, 0, tp - t)) if tp != t else         xs.contiguous()
    bexp, rows = grouped_tiles(t, nx, x.device)
    out = grouped_matmul(xs.reshape(nx * tp, -1), q, bexp, tile_rows=rows,
                         **kw).view(nx, tp, n)[:, :t]
    if form == "proj":
        return out[0].reshape(*lead, n)
    return out.transpose(0, 1).reshape(*lead, nx, n)


def embed_lookup(embed, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """Row gather from a possibly quantized [V, E] table: int8 rows and
    their scales are gathered, then multiplied in ``dtype``."""
    idx = tokens.long()
    if not is_quantized(embed):
        return embed[idx]
    return embed["q"][idx].to(dtype) * embed["s"][idx].to(dtype)


def unembed_logits(h: torch.Tensor, table, tied: bool) -> torch.Tensor:
    """[B, E] @ unembed table -> [B, V] float32: the product in the
    activation dtype, cast to f32, then an int8 table's scale in f32."""
    if not is_quantized(table):
        t = table.T if tied else table
        return torch.einsum("be,ev->bv", h, t).float()
    if "gs" in table:          # int4 lm_head [E, V] (the embedding is int8)
        return (h @ _dequant_int4(table, h.dtype)).float()
    if tied:                   # table [V, E], s [V, 1]
        logits = h @ table["q"].to(h.dtype).T
        return logits.float() * table["s"].squeeze(-1)
    logits = h @ table["q"].to(h.dtype)     # lm_head [E, V], s [1, V]
    return logits.float() * table["s"].squeeze(-2)


def quantize_params(params: dict, bits: int = 8,
                    group: int | None = None, recip: bool = False) -> dict:
    """Quantize a materialized params tree (the bridged-weights path; the
    full-width tree stays alive meanwhile).  ``bits=4`` stores matmul
    weights int4 groupwise; the embedding is int8 either way.  ``recip``:
    the scales of the reference's jitted quantize (its checkpoint load)."""
    if bits not in (4, 8):
        raise ValueError(f"bits={bits}")
    out: dict = {}
    for name, leaf in params.items():
        if isinstance(leaf, dict):
            out[name] = quantize_params(leaf, bits, group, recip)
        elif name == "embed":
            out[name] = quantize_tensor(leaf, axis=-1, recip=recip)
        elif name in MATMUL_KEYS:
            out[name] = (quantize_tensor_int4(leaf, group, recip) if bits == 4
                         else quantize_tensor(leaf, axis=-2, recip=recip))
        else:
            if name not in SKIP_KEYS:
                raise KeyError(
                    f"param leaf {name!r} is in neither MATMUL_KEYS nor "
                    "SKIP_KEYS: classify it")
            out[name] = leaf
    return out


def init_params_quantized(cfg, seed: int, dtype=None, bits: int = 8,
                          device: torch.device | str | None = None) -> dict:
    """Random weights from ``seed`` directly in quantized form: the same
    draws as ``transformer.init_params(cfg, seed, dtype)``, each slice
    rounded to ``dtype`` and quantized as it is drawn, so no more than one
    f32 slice ([E, N] of one layer and expert) exists at a time — a
    full-width Mixtral would not fit the card it is quantized for."""
    if bits not in (4, 8):
        raise ValueError(f"bits={bits}")
    from arks_tpu_torch.models import transformer as tf
    return tf.init_params(cfg, seed, dtype, device, bits=bits)

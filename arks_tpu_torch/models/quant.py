"""Weight access helpers (port of the unquantized half of
``arks_tpu/models/quant.py``).  A quantized leaf is a dict ({"q", "s"} int8
or {"q", "gs"} int4); those formats arrive with the weight-quantization
slice and raise here."""

from __future__ import annotations

import torch


def is_quantized(w) -> bool:
    return isinstance(w, dict)


def _reject(w) -> None:
    if is_quantized(w):
        raise NotImplementedError(
            "int8/int4 weights arrive with the weight-quantization slice; "
            "this slice serves bf16/f32 weights")


def qeinsum(eq: str, x: torch.Tensor, w) -> torch.Tensor:
    """``torch.einsum`` of an activation and an unquantized weight.  The
    projections' ``"...a,ab->...b"`` form is a plain ``x @ w``, taken
    directly (einsum's equation parsing costs host time on every call)."""
    _reject(w)
    lhs, rest = eq.split(",")
    rhs, out = rest.split("->")
    if (lhs.startswith("...") and out == "..." + rhs[1:] and len(rhs) == 2
            and lhs[3:] == rhs[0]):
        return x @ w
    return torch.einsum(eq, x, w)


def embed_lookup(embed, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """Row gather from the [V, E] table (``dtype`` matters only for the
    quantized tables of the later slice)."""
    del dtype
    _reject(embed)
    return embed[tokens.long()]


def unembed_logits(h: torch.Tensor, table, tied: bool) -> torch.Tensor:
    """[B, E] @ unembed table -> [B, V] float32: the product in the weight
    dtype, then cast, as the reference does."""
    _reject(table)
    t = table.T if tied else table
    return torch.einsum("be,ev->bv", h, t).float()

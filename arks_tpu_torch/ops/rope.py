"""Rotary position embeddings, rotate-half (port of ``arks_tpu/ops/rope.py``).

Angles are computed on the fly in float32 from the positions, so the same
code serves prefill chunks and decode tokens of one flat batch.  A forward
over many layers computes ``rope_cos_sin`` once and rotates each layer's
q and k with ``rotate``."""

from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float,
               device: torch.device | None = None) -> torch.Tensor:
    """Inverse frequencies, shape [head_dim // 2], float32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) of the angles, each [..., 1, head_dim // 2] float32."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    angles = positions.float()[..., None, None] * freqs
    return torch.cos(angles), torch.sin(angles)


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half of x [..., H, D] by precomputed (cos, sin)."""
    d = x.shape[-1]
    x1f, x2f = x[..., : d // 2].float(), x[..., d // 2:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., H, D] with leading dims matching ``positions``."""
    return rotate(x, *rope_cos_sin(positions, x.shape[-1], theta))

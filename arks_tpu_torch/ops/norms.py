"""Normalization ops (port of ``arks_tpu/ops/norms.py``): computed in
float32 and cast back to the input dtype, so bf16 activations keep the
variance sum."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * (1.0 / torch.sqrt(var + eps))
    return (y * weight.float()).to(dtype)

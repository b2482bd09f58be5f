"""Device resolution for the port's entry points.

CUDA by default; the CPU only when the caller asks for it (the CPU parity
tests pass ``device="cpu"``).  With no GPU and no explicit CPU request the
entry points raise instead of carrying on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> the current CUDA device, raising when there is none;
    an explicit ``"cpu"`` -> the CPU; an explicit CUDA device -> itself,
    raising when CUDA is unavailable."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "arks_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' (--device cpu) to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev

"""The weights bridge: a JAX param tree (after ``jax.tree.map(np.asarray,
...)``) to the port's tensors — same keys, same ``[L, ...]`` layouts, so
both packages compute the same function on the same weights.  Loading HF
safetensors is a later slice."""

from __future__ import annotations

import numpy as np
import torch

from arks_tpu_torch.device import resolve_device
from arks_tpu_torch.models.config import ModelConfig
from arks_tpu_torch.models.transformer import Params, torch_dtype


def _tensor(a) -> torch.Tensor:
    """numpy -> torch, bit for bit; bfloat16 arrays (numpy's ml_dtypes
    extension type) cross as their uint16 bit patterns."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _expected_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    l, e, f, v = (cfg.num_layers, cfg.hidden_size, cfg.intermediate_size,
                  cfg.vocab_size)
    qd, kvd = cfg.q_dim, cfg.kv_dim
    shapes = {"embed": (v, e), "final_norm": (e,), "layers/attn_norm": (l, e),
              "layers/wq": (l, e, qd), "layers/wk": (l, e, kvd),
              "layers/wv": (l, e, kvd), "layers/wo": (l, qd, e),
              "layers/mlp_norm": (l, e), "layers/w_gate": (l, e, f),
              "layers/w_up": (l, e, f), "layers/w_down": (l, f, e)}
    if cfg.qkv_bias:
        shapes.update({"layers/bq": (l, qd), "layers/bk": (l, kvd),
                       "layers/bv": (l, kvd)})
    if not cfg.tie_word_embeddings:
        shapes["lm_head"] = (e, v)
    return shapes


def params_from_numpy(tree: dict, cfg: ModelConfig,
                      device: torch.device | str | None = None,
                      dtype=None) -> Params:
    """Convert a numpy param tree with the reference's keys into the port's
    params on ``device`` (CUDA unless the caller passes "cpu"; cast to
    ``dtype`` when given).  Raises on a missing or mis-shaped leaf, and on
    quantized leaves (a later slice)."""
    if cfg.num_experts:
        raise NotImplementedError("MoE params arrive with the MoE slice")
    device = resolve_device(device)
    dtype = torch_dtype(dtype) if dtype is not None else None
    out: Params = {"layers": {}}
    for path, shape in _expected_shapes(cfg).items():
        node, dst = tree, out
        *parents, leaf = path.split("/")
        for key in parents:
            node, dst = node[key], dst[key]
        arr = node.get(leaf)
        if arr is None:
            raise KeyError(f"param tree has no {path!r}")
        if isinstance(arr, dict):
            raise NotImplementedError(
                f"{path}: quantized weights arrive with the "
                "weight-quantization slice")
        if tuple(np.shape(arr)) != shape:
            raise ValueError(f"{path}: shape {tuple(np.shape(arr))} != "
                             f"{shape} for {cfg.name}")
        t = _tensor(arr)
        dst[leaf] = t.to(device=device, dtype=dtype or t.dtype)
    return out

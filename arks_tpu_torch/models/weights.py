"""The weights bridge: a JAX param tree (after ``jax.tree.map(np.asarray,
...)``) to the port's tensors — same keys, same ``[L, ...]`` layouts, so
both packages compute the same function on the same weights.  MoE leaves
carry their expert axis; quantized leaves cross as they are (int8
``{"q", "s"}``) or packed (int4 ``{"q", "gs"}``: the reference's ``q`` is
an ml_dtypes int4 array, whose ``astype(np.int8)`` gives -7..7, and the
bridge packs two values a byte along K, ``models/quant.py``'s layout).
Loading HF safetensors is a later slice."""

from __future__ import annotations

import numpy as np
import torch

from arks_tpu_torch.device import resolve_device
from arks_tpu_torch.models import moe
from arks_tpu_torch.models.config import ModelConfig
from arks_tpu_torch.models.transformer import Params, torch_dtype
from arks_tpu_torch.ops.paged_attention import pack_int4


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
              "layers/mlp_norm": (l, e)}
    if cfg.num_experts:
        shapes.update({f"layers/{name}": shape for name, shape
                       in moe.moe_leaf_shapes(cfg).items()})
    else:
        shapes.update({"layers/w_gate": (l, e, f), "layers/w_up": (l, e, f),
                       "layers/w_down": (l, f, e)})
    if cfg.qkv_bias:
        shapes.update({"layers/bq": (l, qd), "layers/bk": (l, kvd),
                       "layers/bv": (l, kvd)})
    if not cfg.tie_word_embeddings:
        shapes["lm_head"] = (e, v)
    return shapes


def _quantized_leaf(path: str, arr: dict, shape: tuple, cfg: ModelConfig):
    """A quantized numpy leaf -> {"q", "s"} int8 / {"q", "gs"} packed int4
    tensors on the CPU, its shapes checked against the float ``shape``."""
    k, n = shape[-2], shape[-1]
    if "gs" in arr:
        q = np.asarray(arr["q"]).astype(np.int8)
        gs = np.asarray(arr["gs"], np.float32)
        ngroups = gs.shape[-2] if gs.ndim >= 2 else 0
        want_gs = shape[:-2] + (ngroups, n)
        if q.shape != shape or gs.shape != want_gs or not ngroups or \
                k % ngroups or k % 2:
            raise ValueError(f"{path}: int4 q {q.shape} / gs {gs.shape} != "
                             f"{shape} / {want_gs} for {cfg.name}")
        return {"q": pack_int4(torch.from_numpy(q), axis=-2),
                "gs": torch.from_numpy(gs.copy())}
    q = np.asarray(arr["q"])
    s = np.asarray(arr["s"], np.float32)
    want_s = shape[:-1] + (1,) if path == "embed" else shape[:-2] + (1, n)
    if q.dtype != np.int8 or q.shape != shape or s.shape != want_s:
        raise ValueError(f"{path}: int8 q {q.shape} {q.dtype} / s {s.shape} "
                         f"!= {shape} / {want_s} for {cfg.name}")
    return {"q": torch.from_numpy(q.copy()), "s": torch.from_numpy(s.copy())}


def params_from_numpy(tree: dict, cfg: ModelConfig,
                      device: torch.device | str | None = None,
                      dtype=None) -> Params:
    """Convert a numpy param tree with the reference's keys into the port's
    params on ``device`` (CUDA unless the caller passes "cpu"; float leaves
    cast to ``dtype`` when given, quantized leaves kept as they are).
    Raises on a missing or mis-shaped leaf."""
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
            dst[leaf] = {name: t.to(device) for name, t in
                         _quantized_leaf(path, arr, shape, cfg).items()}
            continue
        if tuple(np.shape(arr)) != shape:
            raise ValueError(f"{path}: shape {tuple(np.shape(arr))} != "
                             f"{shape} for {cfg.name}")
        t = _tensor(arr)
        dst[leaf] = t.to(device=device, dtype=dtype or t.dtype)
    return out

"""Decoder-only transformer (Qwen2 / Llama families) for serving — the port
of the mixed-step half of ``arks_tpu/models/transformer.py``.

Parameters keep the reference's layout: a dict of stacked ``[L, ...]``
per-layer weights in ``x @ w`` orientation, so ``models/weights.py`` can
bridge a JAX param tree leaf for leaf.  The forward is a Python loop over
layers (the reference's ``lax.scan``); the paged KV pool is updated in
place.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from arks_tpu_torch.device import resolve_device
from arks_tpu_torch.models.config import ModelConfig
from arks_tpu_torch.models.quant import embed_lookup, qeinsum, unembed_logits
from arks_tpu_torch.ops.attention import (paged_mixed_update_and_attend,
                                          prepare_mixed)
from arks_tpu_torch.ops.norms import rms_norm
from arks_tpu_torch.ops.rope import rope_cos_sin, rotate

Params = dict[str, Any]

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float32": torch.float32, "f32": torch.float32}


def torch_dtype(name: str | torch.dtype) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; expected bfloat16 or "
                         "float32")
    return _DTYPES[name]


class PagedKVCache(NamedTuple):
    """Paged KV pool [num_layers, num_pages, Hkv, page, head_dim].  A page
    is one (layer, kv-head)-major stripe of ``page`` consecutive positions
    of one sequence; the engine's block tables [B, MaxP] map position p of
    lane b to page tables[b, p // page].  The kernels write it in place.

    bf16/f32 pools hold the rows; int8 pools hold quantized rows with
    per-token scales [L, N, Hkv, page] f32; int4 pools pack token pairs
    into nibble bytes along the page axis ([L, N, Hkv, page // 2, D] int8)
    while the scales keep full token resolution — which is also how
    int4-ness is detected (pool page rows != scale page)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]

    @property
    def page(self) -> int:
        """Tokens per page (position math uses this; an int4 pool's byte
        rows are page // 2)."""
        if self.k_scale is not None:
            return self.k_scale.shape[3]
        return self.k.shape[3]

    @property
    def kv_bits(self) -> int:
        if self.k_scale is None:
            return self.k.element_size() * 8
        return 4 if self.k.shape[3] != self.k_scale.shape[3] else 8


def init_params(cfg: ModelConfig, seed: int, dtype=None,
                device: torch.device | str | None = None) -> Params:
    """Random weights from ``seed``, with the reference's distribution:
    normal x 0.02 for matrices, ones for norms, zeros for biases.  Drawn
    layer by layer from a ``torch.Generator`` on ``device`` (CUDA unless
    the caller passes "cpu"; a 7B init takes seconds on the card; the f32
    draw never holds more than one layer's leaf).  Not the reference's
    numbers: ``jax.random`` and torch generators differ — tests bridge JAX
    params with ``params_from_numpy``."""
    if cfg.num_experts:
        raise NotImplementedError("MoE models arrive with the MoE slice")
    dtype = torch_dtype(dtype or cfg.dtype)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    l, e, f, v = (cfg.num_layers, cfg.hidden_size, cfg.intermediate_size,
                  cfg.vocab_size)
    qd, kvd = cfg.q_dim, cfg.kv_dim

    def w(shape, stacked=True):
        out = torch.empty(shape, dtype=dtype, device=device)
        for part in (out if stacked else (out,)):
            part.copy_(torch.randn(part.shape, generator=gen, device=device,
                                   dtype=torch.float32).mul_(0.02))
        return out

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    layers: Params = {
        "attn_norm": full((l, e), 1.0),
        "wq": w((l, e, qd)),
        "wk": w((l, e, kvd)),
        "wv": w((l, e, kvd)),
        "wo": w((l, qd, e)),
        "mlp_norm": full((l, e), 1.0),
        "w_gate": w((l, e, f)),
        "w_up": w((l, e, f)),
        "w_down": w((l, f, e)),
    }
    if cfg.qkv_bias:
        layers["bq"] = full((l, qd), 0.0)
        layers["bk"] = full((l, kvd), 0.0)
        layers["bv"] = full((l, kvd), 0.0)
    params: Params = {"embed": w((v, e), stacked=False), "layers": layers,
                      "final_norm": full((e,), 1.0)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = w((e, v), stacked=False)
    return params


def init_paged_cache(cfg: ModelConfig, num_pages: int, page: int, dtype=None,
                     device: torch.device | str | None = None, *,
                     quantized: bool = False, kv_bits: int = 8
                     ) -> PagedKVCache:
    """A zeroed pool on ``device`` (CUDA unless the caller passes "cpu"):
    of ``dtype``, or with ``quantized`` an int8 (``kv_bits`` 8) or int4
    (``kv_bits`` 4, even ``page``) pool with f32 scales."""
    device = resolve_device(device)
    shape = (cfg.num_layers, num_pages, cfg.num_kv_heads, page, cfg.head_dim)
    if quantized:
        if kv_bits not in (4, 8):
            raise ValueError(f"quantized kv_bits must be 4 or 8, got "
                             f"{kv_bits}")
        if kv_bits == 4 and page % 2:
            raise ValueError(f"int4 page size {page} must be even")
        rows = page // 2 if kv_bits == 4 else page
        vshape = shape[:3] + (rows, shape[4])
        i8 = dict(dtype=torch.int8, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        return PagedKVCache(k=torch.zeros(vshape, **i8),
                            v=torch.zeros(vshape, **i8),
                            k_scale=torch.zeros(shape[:-1], **f32),
                            v_scale=torch.zeros(shape[:-1], **f32))
    dtype = torch_dtype(dtype or cfg.dtype)
    return PagedKVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                        v=torch.zeros(shape, dtype=dtype, device=device))


def _qkv(h: torch.Tensor, lp: Params, cfg: ModelConfig):
    q = qeinsum("...e,eq->...q", h, lp["wq"])
    k = qeinsum("...e,ek->...k", h, lp["wk"])
    v = qeinsum("...e,ek->...k", h, lp["wv"])
    if cfg.qkv_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    return q, k, v


def _block_qkv(h: torch.Tensor, lp: Params, cfg: ModelConfig, rope):
    """Pre-norm + qkv projection + head split + rope for [..., T, E].
    ``rope`` is the step's (cos, sin) from ``rope_cos_sin`` (the reference
    takes the positions; the angles are the same for every layer)."""
    lead = h.shape[:-1]
    x = rms_norm(h, lp["attn_norm"], cfg.rms_norm_eps)
    q, k, v = _qkv(x, lp, cfg)
    q = q.reshape(*lead, cfg.num_heads, cfg.head_dim)
    k = k.reshape(*lead, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(*lead, cfg.num_kv_heads, cfg.head_dim)
    return rotate(q, *rope), rotate(k, *rope), v


def _mlp(h: torch.Tensor, lp: Params, cfg: ModelConfig) -> torch.Tensor:
    """Dense SwiGLU; silu in f32 as the reference (``transformer.py:392``)."""
    x = rms_norm(h, lp["mlp_norm"], cfg.rms_norm_eps)
    gate = qeinsum("...e,ef->...f", x, lp["w_gate"])
    up = qeinsum("...e,ef->...f", x, lp["w_up"])
    act = torch.nn.functional.silu(gate.float()).to(gate.dtype) * up
    return qeinsum("...f,fe->...e", act, lp["w_down"])


def _block_tail(h: torch.Tensor, attn: torch.Tensor, lp: Params,
                cfg: ModelConfig) -> torch.Tensor:
    """Output projection residual + MLP residual."""
    h = h + qeinsum("...q,qe->...e", attn, lp["wo"])
    return h + _mlp(h, lp, cfg)


def _unembed(h_last: torch.Tensor, params: Params,
             cfg: ModelConfig) -> torch.Tensor:
    h_last = rms_norm(h_last, params["final_norm"], cfg.rms_norm_eps)
    tied = cfg.tie_word_embeddings
    table = params["embed"] if tied else params["lm_head"]
    return unembed_logits(h_last, table, tied)


def mixed_step(
    params: Params,
    cfg: ModelConfig,
    cache: PagedKVCache,
    tables: torch.Tensor,       # [B, MaxP] int32 — lane b == slot b
    tokens: torch.Tensor,       # [T] int32 flat mixed token batch
    token_slot: torch.Tensor,   # [T] int32 slot per token (-1 = padding)
    token_pos: torch.Tensor,    # [T] int32 global position per token
    sample_src: torch.Tensor,   # [B] int32 — flat index each lane samples
    seq_q_start: torch.Tensor,  # [B] int32 — lane's first flat-token index
    seq_q_len: torch.Tensor,    # [B] int32 — lane's token count (0 inactive)
    seq_pos_start: torch.Tensor,  # [B] int32 — lane's first global position
    *,
    impl: str | None = None,
    qmax: int | None = None,
) -> torch.Tensor:
    """One mixed prefill+decode forward over a flat ``[T]`` token batch:
    every decoding slot's next token plus prefill-chunk tokens run the
    model once, writing all K/V rows into the pool IN PLACE (write then
    attend, causal within each chunk).  Returns logits [B, V] f32 at
    ``sample_src``.  Padding tokens (token_slot < 0) drop their writes;
    their activations are garbage no sample_src points at.  ``impl`` and
    ``qmax`` go to ``paged_mixed_update_and_attend``.  What every layer
    shares — the rope angles, the per-token write view and the attention
    work list — is prepared once, before the layer loop."""
    t_flat = tokens.shape[0]
    cover = tables.shape[1] * cache.page
    # RoPE positions must be real for valid tokens; padding rows only need
    # a value the cache ops drop (their write_idx is routed past coverage).
    rope = rope_cos_sin(torch.clamp(token_pos, max=cover - 1), cfg.head_dim,
                        cfg.rope_theta)
    batch = prepare_mixed(cache.k, tables, token_slot, token_pos, seq_q_start,
                          seq_q_len, seq_pos_start, impl=impl, qmax=qmax,
                          k_scale=cache.k_scale)
    layers = params["layers"]
    h = embed_lookup(params["embed"], tokens, layers["attn_norm"].dtype)
    for layer in range(cfg.num_layers):
        lp = {name: w[layer] for name, w in layers.items()}
        q, k, v = _block_qkv(h, lp, cfg, rope)            # [T, H(kv), D]
        attn = paged_mixed_update_and_attend(
            q, k, v, cache.k, cache.v, tables, token_slot, token_pos,
            seq_q_start, seq_q_len, seq_pos_start, layer, impl=impl,
            qmax=qmax, batch=batch, k_scale=cache.k_scale,
            v_scale=cache.v_scale)
        h = _block_tail(h, attn.reshape(t_flat, cfg.q_dim), lp, cfg)
    h_sel = h[sample_src.long()]                            # [B, E]
    return _unembed(h_sel, params, cfg)

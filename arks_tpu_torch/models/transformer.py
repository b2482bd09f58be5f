"""Decoder-only transformer (Qwen2 / Llama / Mixtral / Qwen2-MoE families)
for serving — the port of the single-device serving half of
``arks_tpu/models/transformer.py``:
the mixed scheduler's ``mixed_step`` over the paged pool, and the legacy
scheduler's one-shot ``prefill``, chunked prefill, prompt inserts and
``decode_step`` over the slot-contiguous cache or the paged pool, with its
liveness-masked form ``decode_state_step`` for pipelined dispatch.

Parameters keep the reference's layout: a dict of stacked ``[L, ...]``
per-layer weights in ``x @ w`` orientation, so ``models/weights.py`` can
bridge a JAX param tree leaf for leaf.  The forward is a Python loop over
layers (the reference's ``lax.scan``); caches and pools are updated in
place (the reference returns new ones), and head_dim is stored unpadded.
Weights may be int8/int4 leaves (``models/quant.py``: on the card their
products run through the grouped matmul kernel); an MoE model's FFN is
``models/moe.py``, grouped or dense as each entry point decides with the
reference's rule (``moe.use_grouped``).  ``gather_pool_pages`` /
``scatter_pool_pages`` move whole pool pages for the host prefix tier, and
``extract`` reads a slot back out for the slot cache's prefix cache.
"""

from __future__ import annotations

import itertools
from typing import Any, NamedTuple

import torch

from arks_tpu_torch.device import resolve_device
from arks_tpu_torch.models.config import ModelConfig
from arks_tpu_torch.models import moe
from arks_tpu_torch.models import quant
from arks_tpu_torch.models.quant import embed_lookup, qeinsum, unembed_logits
from arks_tpu_torch.ops.attention import (chunk_attention_xla,
                                          decode_mixed_work,
                                          decode_update_and_attend,
                                          paged_decode_update_and_attend,
                                          paged_mixed_update_and_attend,
                                          prefill_attention, prepare_mixed)
from arks_tpu_torch.ops.paged_attention import (pack_int4, paged_gather_kv,
                                                paged_pool_gather,
                                                paged_pool_scatter,
                                                paged_write_rows, quantize_kv,
                                                unpack_int4)
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


class KVCache(NamedTuple):
    """Slot-contiguous decode cache [num_layers, num_slots, Hkv, max_len,
    head_dim]: each (slot, KV head)'s sequence is one contiguous [S, D]
    stripe.  int8 caches carry per-token scales [L, B, Hkv, S] f32;
    ``k_scale is None`` means full-width storage."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def num_slots(self) -> int:
        return self.k.shape[1]

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def kv_bits(self) -> int:
        return self.k.element_size() * 8


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


def _slices(shape: tuple, stacked: bool):
    """Index tuples of the slices ``init_params`` draws one at a time: a
    stacked leaf per layer (and per expert: every dim but the last two),
    an unstacked one whole."""
    if not stacked:
        return [()]
    lead = shape[:max(len(shape) - 2, 1)]
    return itertools.product(*(range(n) for n in lead))


def init_params(cfg: ModelConfig, seed: int, dtype=None,
                device: torch.device | str | None = None, *,
                bits: int = 0) -> Params:
    """Random weights from ``seed``, with the reference's distribution:
    normal x 0.02 for matrices, ones for norms, zeros for biases.  Drawn
    slice by slice (per layer, and per expert) from a ``torch.Generator``
    on ``device`` (CUDA unless the caller passes "cpu"; a 7B init takes
    seconds on the card), so the f32 draw never holds more than one slice.
    ``bits`` 8 or 4 quantizes each matmul slice as it is drawn (the
    embedding to int8): the same values ``quant.quantize_params`` gives
    for the unquantized init of the same seed, without a full-width tree
    (``quant.init_params_quantized``).  Not the reference's numbers:
    ``jax.random`` and torch generators differ — tests bridge JAX params
    with ``params_from_numpy``."""
    if bits not in (0, 4, 8):
        raise ValueError(f"bits={bits}")
    dtype = torch_dtype(dtype or cfg.dtype)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    l, e, f, v = (cfg.num_layers, cfg.hidden_size, cfg.intermediate_size,
                  cfg.vocab_size)
    qd, kvd = cfg.q_dim, cfg.kv_dim

    def draw(shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).mul_(0.02)

    def w(name, shape, stacked=True):
        axis = -1 if name == "embed" else (
            -2 if name in quant.MATMUL_KEYS else None)
        if not bits or axis is None:
            out = torch.empty(shape, dtype=dtype, device=device)
            for idx in _slices(shape, stacked):
                part = out[idx]
                part.copy_(draw(part.shape))
            return out
        int4 = bits == 4 and axis == -2
        k, n = shape[-2], shape[-1]
        if int4:
            q_shape = shape[:-2] + (k // 2, n)
            s_shape = shape[:-2] + (k // quant.int4_group_for(k), n)
        else:
            q_shape = shape
            s_shape = shape[:-1] + (1,) if axis == -1 else \
                shape[:-2] + (1, n)
        q = torch.empty(q_shape, dtype=torch.int8, device=device)
        sc = torch.empty(s_shape, dtype=torch.float32, device=device)
        for idx in _slices(shape, stacked):
            x = draw(shape[len(idx):]).to(dtype)
            leaf = quant.quantize_tensor_int4(x) if int4 else \
                quant.quantize_tensor(x, axis=axis)
            q[idx] = leaf["q"]
            sc[idx] = leaf["gs" if int4 else "s"]
            del x, leaf
        return {"q": q, "gs" if int4 else "s": sc}

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    layers: Params = {
        "attn_norm": full((l, e), 1.0),
        "wq": w("wq", (l, e, qd)),
        "wk": w("wk", (l, e, kvd)),
        "wv": w("wv", (l, e, kvd)),
        "wo": w("wo", (l, qd, e)),
        "mlp_norm": full((l, e), 1.0),
    }
    if cfg.num_experts:
        layers.update(moe.init_moe_params(cfg, w))
    else:
        layers.update({
            "w_gate": w("w_gate", (l, e, f)),
            "w_up": w("w_up", (l, e, f)),
            "w_down": w("w_down", (l, f, e)),
        })
    if cfg.qkv_bias:
        layers["bq"] = full((l, qd), 0.0)
        layers["bk"] = full((l, kvd), 0.0)
        layers["bv"] = full((l, kvd), 0.0)
    params: Params = {"embed": w("embed", (v, e), stacked=False),
                      "layers": layers, "final_norm": full((e,), 1.0)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = w("lm_head", (e, v), stacked=False)
    return params


def init_cache(cfg: ModelConfig, num_slots: int, max_len: int, dtype=None,
               device: torch.device | str | None = None, *,
               quantized: bool = False) -> KVCache:
    """A zeroed slot cache on ``device`` (CUDA unless the caller passes
    "cpu"): of ``dtype``, or with ``quantized`` int8 with f32 scales."""
    device = resolve_device(device)
    shape = (cfg.num_layers, num_slots, cfg.num_kv_heads, max_len,
             cfg.head_dim)
    if quantized:
        i8 = dict(dtype=torch.int8, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        return KVCache(k=torch.zeros(shape, **i8), v=torch.zeros(shape, **i8),
                       k_scale=torch.zeros(shape[:-1], **f32),
                       v_scale=torch.zeros(shape[:-1], **f32))
    dtype = torch_dtype(dtype or cfg.dtype)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


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


def _qkv(h: torch.Tensor, lp: Params, cfg: ModelConfig, impl=None):
    q = qeinsum("...e,eq->...q", h, lp["wq"], impl)
    k = qeinsum("...e,ek->...k", h, lp["wk"], impl)
    v = qeinsum("...e,ek->...k", h, lp["wv"], impl)
    if cfg.qkv_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    return q, k, v


def _block_qkv(h: torch.Tensor, lp: Params, cfg: ModelConfig, rope,
               impl: str | None = None):
    """Pre-norm + qkv projection + head split + rope for [..., T, E].
    ``rope`` is the step's (cos, sin) from ``rope_cos_sin`` (the reference
    takes the positions; the angles are the same for every layer);
    ``impl`` goes to a quantized projection's ``qeinsum``."""
    lead = h.shape[:-1]
    x = rms_norm(h, lp["attn_norm"], cfg.rms_norm_eps)
    q, k, v = _qkv(x, lp, cfg, impl)
    q = q.reshape(*lead, cfg.num_heads, cfg.head_dim)
    k = k.reshape(*lead, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(*lead, cfg.num_kv_heads, cfg.head_dim)
    return rotate(q, *rope), rotate(k, *rope), v


def _mlp(h: torch.Tensor, lp: Params, cfg: ModelConfig, *,
         grouped: bool = False, impl: str | None = None) -> torch.Tensor:
    """Dense SwiGLU, silu in f32 as the reference (``transformer.py:392``);
    an MoE model's FFN instead, grouped or dense as the caller decided
    (``impl`` goes to its grouped matmul and to ``qeinsum``)."""
    x = rms_norm(h, lp["mlp_norm"], cfg.rms_norm_eps)
    if cfg.num_experts:
        return moe.moe_ffn(x, lp, cfg, grouped=grouped, impl=impl)
    gate = qeinsum("...e,ef->...f", x, lp["w_gate"], impl)
    up = qeinsum("...e,ef->...f", x, lp["w_up"], impl)
    act = torch.nn.functional.silu(gate.float()).to(gate.dtype) * up
    return qeinsum("...f,fe->...e", act, lp["w_down"], impl)


def _block_tail(h: torch.Tensor, attn: torch.Tensor, lp: Params,
                cfg: ModelConfig, *, grouped: bool = False,
                impl: str | None = None) -> torch.Tensor:
    """Output projection residual + MLP residual."""
    h = h + qeinsum("...q,qe->...e", attn, lp["wo"], impl)
    return h + _mlp(h, lp, cfg, grouped=grouped, impl=impl)


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
    moe_grouped: bool | None = None,
) -> torch.Tensor:
    """One mixed prefill+decode forward over a flat ``[T]`` token batch:
    every decoding slot's next token plus prefill-chunk tokens run the
    model once, writing all K/V rows into the pool IN PLACE (write then
    attend, causal within each chunk).  Returns logits [B, V] f32 at
    ``sample_src``.  Padding tokens (token_slot < 0) drop their writes;
    their activations are garbage no sample_src points at.  ``impl`` and
    ``qmax`` go to ``paged_mixed_update_and_attend`` (``impl`` also to an
    MoE model's grouped matmul and to quantized weights' ``qeinsum``).  ``moe_grouped``: an MoE model's dispatch,
    by default the reference's rule on this batch's T (the engine passes
    the rule on its padded batch size, the T the reference runs).  What
    every layer shares — the rope angles, the per-token write view and the attention
    work list — is prepared once, before the layer loop."""
    t_flat = tokens.shape[0]
    if moe_grouped is None:
        moe_grouped = moe.use_grouped(t_flat)
    cover = tables.shape[1] * cache.page
    # RoPE positions must be real for valid tokens; padding rows only need
    # a value the cache ops drop (their write_idx is routed past coverage).
    rope = rope_cos_sin(torch.clamp(token_pos, max=cover - 1), cfg.head_dim,
                        cfg.rope_theta)
    batch = prepare_mixed(cache.k, tables, token_slot, token_pos, seq_q_start,
                          seq_q_len, seq_pos_start, impl=impl, qmax=qmax,
                          k_scale=cache.k_scale)
    h = embed_lookup(params["embed"], tokens,
                     params["layers"]["attn_norm"].dtype)
    for layer in range(cfg.num_layers):
        lp = _layer(params, layer)
        q, k, v = _block_qkv(h, lp, cfg, rope, impl)      # [T, H(kv), D]
        attn = paged_mixed_update_and_attend(
            q, k, v, cache.k, cache.v, tables, token_slot, token_pos,
            seq_q_start, seq_q_len, seq_pos_start, layer, impl=impl,
            qmax=qmax, batch=batch, k_scale=cache.k_scale,
            v_scale=cache.v_scale)
        h = _block_tail(h, attn.reshape(t_flat, cfg.q_dim), lp, cfg,
                        grouped=moe_grouped, impl=impl)
    h_sel = h[sample_src.long()]                            # [B, E]
    return _unembed(h_sel, params, cfg)


# ---------------------------------------------------------------------------
# The legacy scheduler: one-shot prefill, chunked prefill, inserts, decode
# ---------------------------------------------------------------------------


def _layer(params: Params, layer: int) -> Params:
    """Layer ``layer``'s weights (a quantized leaf's q and scales alike)."""
    return {name: ({k: x[layer] for k, x in w.items()}
                   if isinstance(w, dict) else w[layer])
            for name, w in params["layers"].items()}


def prefill_layer(h: torch.Tensor, lp: Params, cfg: ModelConfig, rope):
    """One transformer block over full sequences [B, T, E].  Returns
    (h, k, v), k/v [B, T, Hkv, D] after RoPE."""
    b, t = h.shape[:2]
    q, k, v = _block_qkv(h, lp, cfg, rope)
    attn = prefill_attention(q, k, v).reshape(b, t, cfg.q_dim)
    return _block_tail(h, attn, lp, cfg,
                       grouped=moe.use_grouped(b * t)), k, v


def prefill(params: Params, cfg: ModelConfig,
            tokens: torch.Tensor,    # [B, T] int32, padded to a bucket
            lengths: torch.Tensor,   # [B] int32 true lengths (<= T)
            ):
    """Run full prompts.  Returns (last-token logits [B, V] float32,
    k [L, B, T, Hkv, D], v [L, B, T, Hkv, D]) for the cache insert.
    Padded positions sit at the end, so no valid query attends them."""
    b, t = tokens.shape
    positions = torch.arange(t, device=tokens.device).expand(b, t)
    rope = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    h = embed_lookup(params["embed"], tokens, params["layers"]["attn_norm"].dtype)
    ks, vs = [], []
    for layer in range(cfg.num_layers):
        h, k, v = prefill_layer(h, _layer(params, layer), cfg, rope)
        ks.append(k)
        vs.append(v)
    last = (lengths.long() - 1).clamp(min=0)
    h_last = h[torch.arange(b, device=h.device), last]
    return _unembed(h_last, params, cfg), torch.stack(ks), torch.stack(vs)


def _chunk_qkv(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
               start: int):
    """Embedding and RoPE angles of one chunk at global positions
    start + [0, C)."""
    c = tokens.shape[0]
    positions = start + torch.arange(c, device=tokens.device)
    rope = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    h = embed_lookup(params["embed"], tokens, params["layers"]["attn_norm"].dtype)
    return h, rope


def _chunk_attend(q: torch.Tensor, cfg: ModelConfig, kc, vc, start, ks, vs):
    """Chunk queries [C, H, D] over one slot's [Hkv, S, D] cache view ->
    [C, q_dim]."""
    c = q.shape[0]
    g = cfg.num_heads // cfg.num_kv_heads
    qg = q.reshape(c, cfg.num_kv_heads, g, cfg.head_dim).permute(1, 2, 0, 3)
    attn = chunk_attention_xla(qg, kc, vc, start, ks, vs)
    return attn.permute(2, 0, 1, 3).reshape(c, cfg.q_dim)


def prefill_chunk(params: Params, cfg: ModelConfig, cache: KVCache,
                  slot: int,              # cache slot being filled
                  tokens: torch.Tensor,   # [C] int32 (padded on the last)
                  start: int,             # global position of tokens[0]
                  valid: int,             # true token count (<= C)
                  ) -> torch.Tensor:
    """One chunk of a chunked prefill for one slot of the slot cache:
    writes the chunk's K/V rows (quantized for an int8 cache) at
    [start, start + C) of every layer IN PLACE and attends each query over
    the slot's cached prefix [0, start + i].  Returns logits [1, V] f32 of
    the chunk's last valid token (meaningful on the final chunk).  Padding
    rows write garbage past the prompt that every read masks by position
    and decode overwrites.  The write starts at min(start, S - C), as the
    reference's dynamic_update_slice clamps it."""
    c = tokens.shape[0]
    w0 = max(0, min(start, cache.max_len - c))
    h, rope = _chunk_qkv(params, cfg, tokens, start)
    for layer in range(cfg.num_layers):
        lp = _layer(params, layer)
        q, k, v = _block_qkv(h, lp, cfg, rope)            # [C, H(kv), D]
        rows = slice(w0, w0 + c)
        kt, vt = k.transpose(0, 1), v.transpose(0, 1)     # [Hkv, C, D]
        if cache.quantized:
            for pool, scales, x in ((cache.k, cache.k_scale, kt),
                                    (cache.v, cache.v_scale, vt)):
                vals, sc = quantize_kv(x)
                pool[layer, slot, :, rows] = vals
                scales[layer, slot, :, rows] = sc
            ks, vs = cache.k_scale[layer, slot], cache.v_scale[layer, slot]
        else:
            cache.k[layer, slot, :, rows] = kt.to(cache.k.dtype)
            cache.v[layer, slot, :, rows] = vt.to(cache.v.dtype)
            ks = vs = None
        attn = _chunk_attend(q, cfg, cache.k[layer, slot],
                             cache.v[layer, slot], start, ks, vs)
        h = _block_tail(h, attn, lp, cfg, grouped=moe.use_grouped(c))
    return _unembed(h[valid - 1: valid], params, cfg)


def _time_major_rows(k_new: torch.Tensor, cache):
    """[L, M, T, Hkv, D] prefill K or V -> the cache's head-major
    [L, M, Hkv, T, D] storage: cast to the cache dtype, or quantized (int8
    values, [L, M, Hkv, T] f32 scales; int4 values in [-7, 7])."""
    x = k_new.transpose(2, 3)
    if not cache.quantized:
        return x.to(cache.k.dtype), None
    return quantize_kv(x, qmax=7 if cache.kv_bits == 4 else 127)


def insert(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
           slot: int) -> KVCache:
    """Insert prefill K/V ([L, 1, T, Hkv, D]) into ``slot`` of the slot
    cache at positions [0, T), IN PLACE (quantized for an int8 cache)."""
    return insert_batch(cache, k_new, v_new, [slot])


def insert_batch(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                 slots) -> KVCache:
    """Insert M prompts' prefill K/V ([L, M, T, Hkv, D]) into M slots at
    positions [0, T), IN PLACE; entries past a prompt's true length are
    masked by its length at decode time and overwritten as it decodes."""
    t = k_new.shape[2]
    idx = torch.as_tensor(slots, dtype=torch.long, device=cache.k.device)
    for pool, scales, new in ((cache.k, cache.k_scale, k_new),
                              (cache.v, cache.v_scale, v_new)):
        vals, sc = _time_major_rows(new, cache)
        pool[:, idx, :, :t] = vals
        if sc is not None:
            scales[:, idx, :, :t] = sc
    return cache


def insert_pages(cache: PagedKVCache, k_new: torch.Tensor,
                 v_new: torch.Tensor, pages, n_pages: int) -> PagedKVCache:
    """Insert one prompt's prefill K/V ([L, 1, T, Hkv, D]) into its first
    ``n_pages`` pool pages listed in ``pages``, IN PLACE: page j gets
    positions [j*P, (j+1)*P).  T is padded up to a page multiple with zero
    rows (garbage every read masks by length)."""
    return insert_pages_batch(cache, k_new, v_new,
                              torch.as_tensor(pages).reshape(1, -1),
                              [n_pages])


def insert_pages_batch(cache: PagedKVCache, k_new: torch.Tensor,
                       v_new: torch.Tensor, pages, n_pages) -> PagedKVCache:
    """Batched ``insert_pages``: M prompts ([L, M, T, Hkv, D]) into their
    page lists ([M, >= ceil(T/P)] int32, the first n_pages[i] valid) —
    int8 values and scales for an int8 pool, packed nibble pairs for
    int4."""
    page = cache.page
    int4 = cache.kv_bits == 4
    rows = page // 2 if int4 else page
    pad = (-k_new.shape[2]) % page
    if pad:
        width = (0, 0, 0, 0, 0, pad)
        k_new = torch.nn.functional.pad(k_new, width)
        v_new = torch.nn.functional.pad(v_new, width)
    pages = torch.as_tensor(pages, dtype=torch.long, device=cache.k.device)
    for pool, scales, new in ((cache.k, cache.k_scale, k_new),
                              (cache.v, cache.v_scale, v_new)):
        vals, sc = _time_major_rows(new, cache)        # [L, M, Hkv, T, D]
        if int4:
            vals = pack_int4(vals, axis=3)
        l, m, hkv, _, d = vals.shape
        blocks = vals.reshape(l, m, hkv, -1, rows, d).transpose(2, 3)
        if sc is not None:
            sblocks = sc.reshape(l, m, hkv, -1, page).transpose(2, 3)
        for i in range(m):
            n = int(n_pages[i])
            pool[:, pages[i, :n]] = blocks[:, i, :n]
            if sc is not None:
                scales[:, pages[i, :n]] = sblocks[:, i, :n]
    return cache


def gather_pool_pages(cache: PagedKVCache, pages: torch.Tensor):
    """Whole pool pages as contiguous pool-native staging blocks for the
    host prefix tier's spill: (k, v, k_scale, v_scale), each [L, G, Hkv,
    P(/2), D] (scales [L, G, Hkv, P]; None for an unquantized pool).  Raw
    pool bytes, so ``scatter_pool_pages`` restores them bit for bit."""
    k = paged_pool_gather(cache.k, pages)
    v = paged_pool_gather(cache.v, pages)
    if cache.quantized:
        return (k, v, paged_pool_gather(cache.k_scale, pages),
                paged_pool_gather(cache.v_scale, pages))
    return k, v, None, None


def scatter_pool_pages(cache: PagedKVCache, k_blocks: torch.Tensor,
                       v_blocks: torch.Tensor, pages: torch.Tensor,
                       n_valid: int, k_scale=None,
                       v_scale=None) -> PagedKVCache:
    """Restore pool-native page blocks (``gather_pool_pages``' output)
    into the first ``n_valid`` pages listed in ``pages``, IN PLACE: the
    host prefix tier's restore."""
    paged_pool_scatter(cache.k, k_blocks, pages, n_valid)
    paged_pool_scatter(cache.v, v_blocks, pages, n_valid)
    if cache.quantized:
        paged_pool_scatter(cache.k_scale, k_scale, pages, n_valid)
        paged_pool_scatter(cache.v_scale, v_scale, pages, n_valid)
    return cache


def extract(cache: KVCache, slot: int, dtype: torch.dtype | None = None):
    """One slot's KV read back out time-major ``[L, 1, S, Hkv, D]``, the
    inverse of ``insert`` (dequantized to ``dtype``, by default bf16, for an
    int8 cache): the prefix cache's harvest of a chunk-prefilled slot."""
    k = cache.k[:, slot: slot + 1]
    v = cache.v[:, slot: slot + 1]
    if cache.quantized:
        out = dtype or torch.bfloat16
        k = (k.float() * cache.k_scale[:, slot: slot + 1, ..., None]).to(out)
        v = (v.float() * cache.v_scale[:, slot: slot + 1, ..., None]).to(out)
    elif dtype is not None:
        k, v = k.to(dtype), v.to(dtype)
    return k.transpose(2, 3), v.transpose(2, 3)


def gather_pages(cache: PagedKVCache, tables_row: torch.Tensor, layer: int):
    """One slot's cache as contiguous views for ``layer``: (k [Hkv, S, D],
    v, k_scale [Hkv, S] | None, v_scale | None), gathered through its table
    row ([MaxP] int32); int4 pages unpacked after the gather."""
    int4 = cache.kv_bits == 4

    def per(pool, unpack=False):
        g = paged_gather_kv(pool, tables_row[None], layer)[0]
        return unpack_int4(g, axis=1) if unpack else g

    k, v = per(cache.k, int4), per(cache.v, int4)
    if cache.quantized:
        return k, v, per(cache.k_scale), per(cache.v_scale)
    return k, v, None, None


def prefill_chunk_paged(params: Params, cfg: ModelConfig,
                        cache: PagedKVCache,
                        tables_row: torch.Tensor,  # [MaxP] int32
                        tokens: torch.Tensor,      # [C] int32, C == page
                        start: int,                # global position of tokens[0]
                        valid: int,                # true token count (<= C)
                        ) -> torch.Tensor:
    """Chunked prefill against the paged pool: chunk == page, so each chunk
    fills exactly page ``tables_row[start // P]`` of every layer (IN PLACE)
    and attention reads the slot's pages.  Returns logits [1, V] f32 of the
    chunk's last valid token."""
    c = tokens.shape[0]
    page = cache.page
    if c != page:
        raise ValueError(f"paged chunk size {c} must equal the page size "
                         f"{page}")
    pg = tables_row[start // page].long().reshape(1)
    int4 = cache.kv_bits == 4
    h, rope = _chunk_qkv(params, cfg, tokens, start)
    for layer in range(cfg.num_layers):
        lp = _layer(params, layer)
        q, k, v = _block_qkv(h, lp, cfg, rope)
        for pool, scales, x in ((cache.k, cache.k_scale, k),
                                (cache.v, cache.v_scale, v)):
            x = x.transpose(0, 1)[None]                    # [1, Hkv, C, D]
            if cache.quantized:
                x, sc = quantize_kv(x, qmax=7 if int4 else 127)
                scales[layer].index_copy_(0, pg, sc)
                if int4:
                    x = pack_int4(x, axis=2)
            pool[layer].index_copy_(0, pg, x.to(pool.dtype))
        kc, vc, ks, vs = gather_pages(cache, tables_row, layer)
        h = _block_tail(h, _chunk_attend(q, cfg, kc, vc, start, ks, vs), lp,
                        cfg, grouped=moe.use_grouped(c))
    return _unembed(h[valid - 1: valid], params, cfg)


def decode_step(params: Params, cfg: ModelConfig,
                cache: KVCache | PagedKVCache,
                tokens: torch.Tensor,    # [B] int32 — current token per slot
                lengths: torch.Tensor,   # [B] int32 — tokens already cached
                tables: torch.Tensor | None = None,  # [B, MaxP] (paged only)
                *, impl: str | None = None) -> torch.Tensor:
    """Advance every slot one token: its K/V row is written at position
    ``lengths`` (IN PLACE) and it attends [0, lengths].  Returns logits
    [B, V] float32.  A slot cache drops writes at lengths >= S; a paged
    cache takes ``tables`` and treats lengths >= coverage as the inactive
    sentinel (write dropped, nothing attended).  ``impl`` goes to the
    attention op ("plain": the reference's XLA oracle) and to quantized
    weights' ``qeinsum``.  An MoE model's
    FFN is dense here whatever the batch, as in the reference."""
    paged = isinstance(cache, PagedKVCache)
    if paged and tables is None:
        raise ValueError("decode_step with a PagedKVCache requires tables")
    b = tokens.shape[0]
    write_idx = lengths.to(torch.int32)
    # RoPE positions must be real for active slots; the sentinel only
    # matters to the cache ops, which drop it.
    rope_idx = write_idx
    if paged:
        rope_idx = torch.clamp(write_idx, max=tables.shape[1] * cache.page - 1)
    rope = rope_cos_sin(rope_idx, cfg.head_dim, cfg.rope_theta)
    h = embed_lookup(params["embed"], tokens, params["layers"]["attn_norm"].dtype)
    # Per step, not per layer: the slot cache's attend lengths, an int4
    # pool's decode view, and each slot's destination pool row (what every
    # layer's update kernel reads).
    work = dst = attend = None
    if not paged:
        attend = write_idx + 1
    elif impl != "plain":
        dst = paged_write_rows(write_idx, tables, cache.page,
                               cache.num_pages)
        if cache.kv_bits == 4:
            work = decode_mixed_work(tables, write_idx, page=cache.page,
                                     hkv=cfg.num_kv_heads)
    for layer in range(cfg.num_layers):
        lp = _layer(params, layer)
        q, k, v = _block_qkv(h, lp, cfg, rope, impl)      # [B, H(kv), D]
        if paged:
            attn = paged_decode_update_and_attend(
                q, k, v, cache.k, cache.v, tables, write_idx, layer,
                impl=impl, k_scale=cache.k_scale, v_scale=cache.v_scale,
                work=work, dst=dst)
        else:
            attn = decode_update_and_attend(
                q, k, v, cache.k, cache.v, write_idx, layer, impl=impl,
                k_scale=cache.k_scale, v_scale=cache.v_scale,
                lengths=attend)
        h = _block_tail(h, attn.reshape(b, cfg.q_dim), lp, cfg, impl=impl)
    return _unembed(h, params, cfg)


def decode_state_step(params: Params, cfg: ModelConfig,
                      cache: KVCache | PagedKVCache,
                      tokens: torch.Tensor,   # [B] int32
                      lengths: torch.Tensor,  # [B] int32 — alive slots' lengths
                      alive: torch.Tensor,    # [B] bool
                      sentinel: int,          # the engine's write-drop length
                      tables: torch.Tensor | None = None,
                      *, impl: str | None = None) -> torch.Tensor:
    """Liveness-masked ``decode_step`` for device-state decoding: dead
    slots write at the engine's park sentinel (dropped) and attend nothing
    in a paged pool, the same arithmetic as a host that had already parked
    the slot, so live slots' logits equal the sequential path's."""
    eff = torch.where(alive, lengths, sentinel).to(torch.int32)
    return decode_step(params, cfg, cache, tokens, eff, tables, impl=impl)

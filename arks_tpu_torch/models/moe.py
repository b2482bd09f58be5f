"""Mixture-of-Experts FFN (Mixtral / Qwen2-MoE families) — the port of
``arks_tpu/models/moe.py``.

Two dispatches, as in the reference:
- **Dense** (``moe_ffn``): every expert's FFN runs over every token as one
  batched einsum over the expert dim; the router weights zero the
  unselected experts.  Decode reads every expert's weights once per step
  anyway, so at serving batch sizes this costs no extra bytes.  With
  quantized weights on the card its products are the grouped matmul
  kernel with every expert over the same rows (``quant.qeinsum``), which
  reads the int8/int4 bytes raw.
- **Grouped** (``moe_ffn_grouped``): the (token, slot) pairs are sorted by
  routed expert and each expert runs over its own rows only.  Route
  ``ARKS_MOE_KERNEL`` (``ops/moe_kernel.moe_impl``): ``xla`` (and ``auto``)
  is the reference's ``ragged_dot`` counterpart — one ``torch.matmul`` per
  expert over dequantized weights; ``pallas`` is ``grouped_ffn``, whose
  grouped matmul is the CUDA kernel ``csrc/grouped_matmul.cu`` (it reads
  int8/int4 expert tiles raw).

**The caller picks the dispatch** (``grouped=``): the reference infers it
from the activation's rank and token count, and the port's activations do
not keep the reference's ranks (``mixed_step`` carries ``[T, E]`` where the
reference carries ``[1, T, E]``).  ``use_grouped`` holds the reference's
rule per call site: ``mixed_step`` and one-shot / chunked prefill group iff
their token count is at least ``GROUPED_MIN_TOKENS``; ``decode_step`` is
always dense.

The router's math is f32; top-k ties go to the lower expert index, as
``lax.top_k``.  The grouped combine is deterministic (no float atomics):
each token sums its k expert outputs in sorted (expert) order, in the
output dtype, as the reference's scatter-add does.

Weight layout per layer (leading [L] from the stacked-layer convention):
  router      [L, E, X]
  w_gate/up   [L, X, E, Fm]     w_down [L, X, Fm, E]
  shared gate/up [L, E, Fs], shared down [L, Fs, E], shared_gate [L, E]
where X = num_experts, Fm = moe_intermediate_size.
"""

from __future__ import annotations

import torch

from arks_tpu_torch.models.quant import dequantize, qeinsum

Params = dict

# Below this many tokens the reference keeps the dense dispatch (the
# sort/gather dispatch costs more than it saves).
GROUPED_MIN_TOKENS = 64


def use_grouped(n_tokens: int) -> bool:
    """The reference's grouped-or-dense rule for a call site that carries
    ``n_tokens`` tokens in a rank-3 activation (``mixed_step``'s flat batch,
    one-shot prefill's B x T, a prefill chunk's C); ``decode_step``'s
    rank-2 activation never groups and does not call this."""
    return n_tokens >= GROUPED_MIN_TOKENS


def moe_leaf_shapes(cfg) -> dict[str, tuple]:
    """Per-leaf shapes of ``init_moe_params``, in its draw order."""
    l, e = cfg.num_layers, cfg.hidden_size
    x, fm = cfg.num_experts, cfg.moe_intermediate_size
    shapes = {"router": (l, e, x), "w_gate": (l, x, e, fm),
              "w_up": (l, x, e, fm), "w_down": (l, x, fm, e)}
    if cfg.shared_expert_intermediate_size:
        fs = cfg.shared_expert_intermediate_size
        shapes.update({"shared_gate_proj": (l, e, fs), "shared_up": (l, e, fs),
                       "shared_down": (l, fs, e), "shared_gate": (l, e)})
    return shapes


def init_moe_params(cfg, normal) -> Params:
    """MoE leaves drawn by ``normal(name, shape)`` (the transformer's
    normal x 0.02 draw, quantized for MATMUL_KEYS when it quantizes)."""
    return {name: normal(name, shape)
            for name, shape in moe_leaf_shapes(cfg).items()}


def router_topk(logits: torch.Tensor, cfg) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """[.., X] router logits -> ([.., k] combine weights, [.., k] expert
    ids): f32 softmax over all experts, the top k (ties to the lower
    index: a stable descending sort), renormalized when
    ``norm_topk_prob``."""
    probs = torch.softmax(logits.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.num_experts_per_tok
    vals, idx = vals[..., :k], idx[..., :k]
    if cfg.norm_topk_prob:
        vals = vals / (vals.sum(dim=-1, keepdim=True) + 1e-9)
    return vals, idx


def router_weights(logits: torch.Tensor, cfg) -> torch.Tensor:
    """[.., X] router logits -> [.., X] combine weights, zero for the
    unselected experts (the dense form of ``router_topk``)."""
    vals, idx = router_topk(logits, cfg)
    return torch.zeros(logits.shape, dtype=vals.dtype,
                       device=logits.device).scatter(-1, idx, vals)


def ragged_dot(xs: torch.Tensor, w: torch.Tensor,
               group_sizes: torch.Tensor) -> torch.Tensor:
    """``jax.lax.ragged_dot``'s counterpart: rows [start_e, end_e) of the
    expert-sorted ``xs`` [M, K] times ``w[e]`` [K, N], one ``matmul`` per
    non-empty group (the sizes are read on the host)."""
    out = torch.zeros((xs.shape[0], w.shape[-1]), dtype=xs.dtype,
                      device=xs.device)
    start = 0
    for e, size in enumerate(group_sizes.tolist()):
        if size:
            out[start:start + size] = xs[start:start + size] @ w[e]
        start += size
    return out


def _shared_expert(x: torch.Tensor, mp: Params,
                   impl: str | None = None) -> torch.Tensor:
    """The shared expert's SwiGLU output times its sigmoid gate."""
    sg = qeinsum("...e,ef->...f", x, mp["shared_gate_proj"], impl)
    su = qeinsum("...e,ef->...f", x, mp["shared_up"], impl)
    sact = torch.nn.functional.silu(sg.float()).to(sg.dtype) * su
    shared = qeinsum("...f,fe->...e", sact, mp["shared_down"], impl)
    gatev = torch.sigmoid((x @ mp["shared_gate"]).float())
    return shared * gatev[..., None].to(shared.dtype)


def moe_ffn_grouped(x: torch.Tensor, mp: Params, cfg, *,
                    impl: str | None = None) -> torch.Tensor:
    """Dropless grouped dispatch over [..., E] activations: sort the
    (token, slot) pairs by routed expert (stable), run the three expert
    products over each expert's rows, and add each token's k weighted
    outputs back.  ``impl`` goes to ``grouped_matmul`` on the ``pallas``
    route ("plain": its plain version)."""
    from arks_tpu_torch.ops.moe_kernel import grouped_ffn, moe_impl

    lead = x.shape[:-1]
    e = x.shape[-1]
    k, nx = cfg.num_experts_per_tok, cfg.num_experts
    x2 = x.reshape(-1, e)
    n = x2.shape[0]
    vals, idx = router_topk(x2 @ mp["router"], cfg)          # [T, k]
    flat_expert = idx.reshape(-1)                            # [T*k]
    order = torch.argsort(flat_expert, stable=True)
    token_of = order // k
    xs = x2[token_of]                                        # [T*k, E]
    group_sizes = torch.bincount(flat_expert, minlength=nx)
    if moe_impl() == "pallas":
        down = grouped_ffn(xs, flat_expert[order], group_sizes,
                           mp["w_gate"], mp["w_up"], mp["w_down"], x.dtype,
                           impl=impl)
    else:
        gate = ragged_dot(xs, dequantize(mp["w_gate"], x.dtype), group_sizes)
        up = ragged_dot(xs, dequantize(mp["w_up"], x.dtype), group_sizes)
        act = torch.nn.functional.silu(gate.float()).to(gate.dtype) * up
        down = ragged_dot(act, dequantize(mp["w_down"], x.dtype),
                          group_sizes)                       # [T*k, E]
    w = vals.reshape(-1)[order].to(down.dtype)
    contrib = down * w[:, None]
    # Each token's k sorted positions, ascending: its k outputs are added
    # in that order, one rounding per add, onto zeros.
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    pos = inv.reshape(n, k).sort(dim=1).values
    out = torch.zeros((n, e), dtype=down.dtype, device=down.device)
    for j in range(k):
        out = out + contrib[pos[:, j]]
    if cfg.shared_expert_intermediate_size:
        out = out + _shared_expert(x2, mp, impl)
    return out.reshape(*lead, e)


def moe_ffn(x: torch.Tensor, mp: Params, cfg, *, grouped: bool,
            impl: str | None = None) -> torch.Tensor:
    """MoE feed-forward on [..., E] activations, grouped or dense as the
    caller decides (``use_grouped``).  ``impl`` goes to the grouped matmul
    and to ``qeinsum`` ("plain": their plain versions)."""
    if grouped:
        return moe_ffn_grouped(x, mp, cfg, impl=impl)
    weights = router_weights(x @ mp["router"], cfg).to(x.dtype)   # [.., X]
    gate = qeinsum("...e,xef->...xf", x, mp["w_gate"], impl)
    up = qeinsum("...e,xef->...xf", x, mp["w_up"], impl)
    act = torch.nn.functional.silu(gate.float()).to(gate.dtype) * up
    down = qeinsum("...xf,xfe->...xe", act, mp["w_down"], impl)  # per expert
    out = torch.einsum("...xe,...x->...e", down, weights)
    if cfg.shared_expert_intermediate_size:
        out = out + _shared_expert(x, mp, impl)
    return out

"""Token sampling on the device (port of the sampling core of
``arks_tpu/engine/sampler.py``): greedy, and temperature + top-k + top-p
over the ``TOP_K_MAX`` highest logits.

Greedy is ``argmax`` (the first index wins ties, as ``jnp.argmax``).  A
sampled lane draws with Gumbel-max over its filtered window — what
``jax.random.categorical`` does — from noise the caller makes with the
lane's own ``torch.Generator``.  The draws are NOT the reference's:
torch generators are not threefry, so seeded streams match the reference
in distribution, not bit for bit.  Penalties, logit_bias, min_tokens,
logprobs and guides are later slices.
"""

from __future__ import annotations

import torch

TOP_K_MAX = 64


def window(vocab_size: int) -> int:
    return min(TOP_K_MAX, vocab_size)


def gumbel_noise(generators: list, width: int,
                 device: torch.device) -> torch.Tensor:
    """[B, width] Gumbel(0, 1) noise, row b drawn from generators[b]
    (zeros for rows with no generator: greedy lanes ignore it)."""
    rows = []
    for gen in generators:
        if gen is None:
            rows.append(torch.zeros(width, device=device))
            continue
        u = torch.rand(width, generator=gen, device=device)
        u = u.clamp(min=torch.finfo(torch.float32).tiny)
        rows.append(-torch.log(-torch.log(u)))
    return torch.stack(rows)


def _filtered_scaled(logits: torch.Tensor, temperature: torch.Tensor,
                     top_p: torch.Tensor, top_k: torch.Tensor):
    """(scaled logits [B, W] with filtered entries at -inf, vocab ids
    [B, W]) after temperature + top-k + top-p over the window."""
    w = window(logits.shape[-1])
    top_logits, top_idx = torch.topk(logits, w, dim=-1, sorted=True)
    scaled = top_logits / torch.clamp(temperature, min=1e-6)[:, None]
    k = torch.where(top_k <= 0, torch.full_like(top_k, w),
                    torch.clamp(top_k, max=w))
    rank = torch.arange(w, device=logits.device)[None, :]
    neg_inf = torch.full_like(scaled, float("-inf"))
    scaled = torch.where(rank < k[:, None], scaled, neg_inf)
    # Nucleus over the kept candidates (already sorted descending): keep
    # the smallest prefix with cumulative prob >= top_p; the first always.
    probs = torch.softmax(scaled, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_p[:, None]
    return torch.where(keep, scaled, neg_inf), top_idx


def sample(logits: torch.Tensor,        # [B, V] f32
           temperature: torch.Tensor,   # [B] f32; <= 0 means greedy
           top_p: torch.Tensor,         # [B] f32 in (0, 1]
           top_k: torch.Tensor,         # [B] int; 0 = whole window
           noise: torch.Tensor | None = None,  # [B, W] Gumbel noise
           ) -> torch.Tensor:
    """One token per lane -> ids [B] int32.  With ``noise`` None every lane
    is greedy."""
    greedy_ids = torch.argmax(logits, dim=-1).to(torch.int32)
    if noise is None:
        return greedy_ids
    scaled, top_idx = _filtered_scaled(logits, temperature, top_p, top_k)
    choice = torch.argmax(scaled + noise, dim=-1)
    sampled = top_idx.gather(1, choice[:, None])[:, 0].to(torch.int32)
    return torch.where(temperature <= 0, greedy_ids, sampled)

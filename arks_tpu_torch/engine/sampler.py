"""Token sampling on the device (port of the sampling core of
``arks_tpu/engine/sampler.py``): greedy, and temperature + top-k + top-p
over the ``TOP_K_MAX`` highest logits.

Greedy is ``argmax`` (the first index wins ties, as ``jnp.argmax``).  A
sampled lane splits its key into (step, carry) and draws
``categorical`` over its filtered window with the step key, through the
threefry port in ``engine/prng.py`` — the reference's draw, bit for bit in
its integer path.  ``SlotSampling`` is the per-slot state the legacy
scheduler's K-step decode loop carries.  Penalties, logit_bias,
min_tokens, logprobs and guides are later slices.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from arks_tpu_torch.engine import prng

TOP_K_MAX = 64


def window(vocab_size: int) -> int:
    return min(TOP_K_MAX, vocab_size)


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
           keys: torch.Tensor | None = None,    # [B, 2] threefry keys
           active: torch.Tensor | None = None,  # [B] bool
           ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One token per lane -> (ids [B] int32, carry keys [B, 2]).  With
    ``keys`` None every lane is greedy and no key is returned.  Every
    lane's key splits, greedy lanes' too (the reference's ``vmap``);
    ``active`` False freezes a lane's key, as in the reference."""
    greedy_ids = torch.argmax(logits, dim=-1).to(torch.int32)
    if keys is None:
        return greedy_ids, None
    scaled, top_idx = _filtered_scaled(logits, temperature, top_p, top_k)
    new_keys = prng.split(keys, 2)
    step_keys, carry = new_keys[:, 0], new_keys[:, 1]
    choice = prng.categorical(step_keys, scaled)
    sampled = top_idx.gather(1, choice[:, None])[:, 0].to(torch.int32)
    if active is not None:
        carry = torch.where(active[:, None], carry, keys)
    return torch.where(temperature <= 0, greedy_ids, sampled), carry


class SlotSampling(NamedTuple):
    """Per-slot sampling rows (the reference's ``SamplingState`` less the
    penalty, bias, suppression and guide columns), all indexed by slot.
    Admission writes a slot's row with ``set_slots``; each decode step
    splits every active slot's key and carries the second half."""

    temperature: torch.Tensor  # [B] f32; <= 0 means greedy
    top_p: torch.Tensor        # [B] f32
    top_k: torch.Tensor        # [B] int32; 0 = whole window
    key: torch.Tensor          # [B, 2] threefry keys (int64 words)


def init_slot_sampling(batch: int, device=None) -> SlotSampling:
    return SlotSampling(
        temperature=torch.zeros((batch,), dtype=torch.float32, device=device),
        top_p=torch.ones((batch,), dtype=torch.float32, device=device),
        top_k=torch.zeros((batch,), dtype=torch.int32, device=device),
        key=torch.zeros((batch, 2), dtype=torch.int64, device=device))


def set_slots(state: SlotSampling, slots, temperature, top_p, top_k,
              keys: torch.Tensor) -> SlotSampling:
    """Write M slots' rows (the reference's batched ``set_slots``):
    ``slots`` [M], the parameter columns [M] (tensors or numpy) and their
    decode keys [M, 2]."""
    dev = state.key.device
    idx = torch.as_tensor(slots, dtype=torch.long, device=dev)
    cols = (temperature, top_p, top_k, keys)
    return SlotSampling(*(
        old.index_copy(0, idx, torch.as_tensor(new, device=dev).to(old.dtype))
        for old, new in zip(state, cols)))

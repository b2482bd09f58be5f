"""Token sampling on the device (port of ``arks_tpu/engine/sampler.py``):
greedy, temperature + top-k + top-p over the ``TOP_K_MAX`` highest logits,
and the request-level shaping in front of it — presence/frequency
penalties, OpenAI ``logit_bias``, the ``min_tokens`` suppression of stop
ids, and the guided-decoding mask — plus the raw-distribution logprobs.

Greedy is ``argmax`` (the first index wins ties, as ``jnp.argmax``).  A
sampled lane splits its key into (step, carry) and draws ``categorical``
over its filtered window with the step key, through the threefry port in
``engine/prng.py`` — the reference's draw, bit for bit in its integer
path.  ``SamplingState`` is the per-slot state the decode loops carry.

The reference gates each shaping pass with ``lax.cond`` on a device
predicate.  In eager PyTorch such a predicate is a host sync, so here the
passes are gated by ``Gates``: host booleans the engine derives from the
requests it placed in the batch.  A batch in which no lane asks for a
feature runs none of its kernels.  ``gates_of`` evaluates the reference's
device predicates instead (one sync each), for callers without that
knowledge.

Arithmetic follows the reference operation for operation: the bias and
suppression passes ADD their columns with accumulation (duplicate ids add
up, padded columns add 0.0 to id 0), the guide mask SETS -1e30, and
``count_tokens``/``set_slots``/``clear_slot_penalties`` write their state
in place.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from arks_tpu_torch.engine import prng

TOP_K_MAX = 64
TOP_LOGPROBS_MAX = 8
LOGIT_BIAS_MAX = 300  # full OpenAI logit_bias key budget
SUPPRESS_MAX = 8      # eos + stop_token_ids suppressed under min_tokens
STOP_IDS_MAX = 32     # per-slot stop set mirrored onto the device for
                      # device-side liveness (pipelined dispatch); a
                      # request whose stop set exceeds it stays on the
                      # host-resolved path (never truncated).
_NEG = -1e30


def window(vocab_size: int) -> int:
    return min(TOP_K_MAX, vocab_size)


class SamplingState(NamedTuple):
    """Per-slot sampling rows, all indexed by slot ([B] unless noted)."""

    temperature: torch.Tensor  # f32; <= 0 means greedy
    top_p: torch.Tensor        # f32 in (0, 1]
    top_k: torch.Tensor        # int32; 0 = whole window
    key: torch.Tensor          # [B, 2] threefry keys (int64 words)
    # Presence/frequency penalties over OUTPUT tokens:
    # logits -= presence * 1[count > 0] + frequency * count.
    presence: torch.Tensor     # f32
    frequency: torch.Tensor    # f32
    counts: torch.Tensor       # int32 [B, V] generated-token counts
    # logit_bias: up to LOGIT_BIAS_MAX (id, bias) pairs; id < 0 = empty.
    bias_ids: torch.Tensor     # int32 [B, NB]
    bias_vals: torch.Tensor    # f32 [B, NB]
    # min_tokens: suppress_ids (< 0 empty) get -1e30 added while the
    # slot's length is below min_until (0 = off).
    suppress_ids: torch.Tensor  # int32 [B, NS]
    min_until: torch.Tensor     # int32
    # Guided decoding: guide id (-1 = none) and the slot's ABSOLUTE row
    # in the trans table (its DFA state).
    guide: torch.Tensor        # int32
    guide_row: torch.Tensor    # int32


class Gates(NamedTuple):
    """Which passes a batch runs, decided on the host.  ``sampled``: some
    lane draws (temperature > 0), so keys split and the window filter
    runs; the others: some lane has penalties, a logit_bias, a min_tokens
    suppression, a guide.  A pass whose gate is off is skipped; the
    result is the same as running it, since its rows are at their
    identity values."""

    sampled: bool = True
    penalties: bool = True
    bias: bool = True
    min_tokens: bool = True
    guide: bool = True


OFF = Gates(False, False, False, False, False)


def gates_of(state: SamplingState, guide_tables=None) -> Gates:
    """The reference's ``lax.cond`` predicates read on the device (one
    host sync each): for callers that do not know the batch's requests."""
    return Gates(
        sampled=True,
        penalties=bool(torch.any((state.presence != 0.0)
                                 | (state.frequency != 0.0))),
        bias=bool(torch.any(state.bias_ids >= 0)),
        min_tokens=bool(torch.any(state.min_until > 0)),
        guide=guide_tables is not None and bool(torch.any(state.guide >= 0)))


def top_logprobs(logits: torch.Tensor, chosen: torch.Tensor):
    """Logprob data for OpenAI ``logprobs`` responses over the RAW model
    distribution (full-vocab log-softmax, as ``jax.nn.log_softmax``):
    (chosen token's logprob [B], top-``TOP_LOGPROBS_MAX`` logprobs [B, L]
    descending, their vocab ids [B, L] int32)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    vals, ids = torch.topk(lp, min(TOP_LOGPROBS_MAX, lp.shape[-1]), dim=-1)
    chosen_lp = lp.gather(1, chosen.long()[:, None])[:, 0]
    return chosen_lp, vals, ids.to(torch.int32)


def np_stop_col(stop_ids) -> np.ndarray | None:
    """Host-side [STOP_IDS_MAX] stop column for device-side liveness; ids
    < 0 pad.  None on overflow: the caller must keep the slot on the
    host-resolved path (a dropped stop id would let the device keep a slot
    alive past its stop token)."""
    ids = list(dict.fromkeys(int(t) for t in stop_ids))
    if len(ids) > STOP_IDS_MAX:
        return None
    col = np.full((STOP_IDS_MAX,), -1, np.int32)
    col[: len(ids)] = ids
    return col


def advance_liveness(toks: torch.Tensor, alive: torch.Tensor,
                     lengths: torch.Tensor, stop_ids: torch.Tensor,
                     dead_len: torch.Tensor) -> torch.Tensor:
    """End-of-dispatch device liveness: ``toks`` [K, B] the dispatch's
    tokens, ``lengths`` [B] the post-dispatch lengths, ``stop_ids`` [B, S]
    the stop sets (< 0 pad), ``dead_len`` [B] the length at which the host
    would retire the slot.  A slot stays alive iff none of its K tokens is
    a stop token and its new length is below dead_len — the host's retire
    condition."""
    valid = stop_ids >= 0                                       # [B, S]
    hit = ((toks[:, :, None] == stop_ids[None, :, :])
           & valid[None, :, :]).any(dim=2).any(dim=0)           # [B]
    return alive & ~hit & (lengths < dead_len)


def init_sampling_state(batch: int, seed: int = 0, vocab_size: int = 1,
                        device=None) -> SamplingState:
    keys = prng.split(prng.key_tensor(prng.np_prng_key(seed), device), batch)
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return SamplingState(
        temperature=torch.zeros((batch,), **f32),
        top_p=torch.ones((batch,), **f32),
        top_k=torch.zeros((batch,), **i32),
        key=keys,
        presence=torch.zeros((batch,), **f32),
        frequency=torch.zeros((batch,), **f32),
        counts=torch.zeros((batch, vocab_size), **i32),
        bias_ids=torch.full((batch, LOGIT_BIAS_MAX), -1, **i32),
        bias_vals=torch.zeros((batch, LOGIT_BIAS_MAX), **f32),
        suppress_ids=torch.full((batch, SUPPRESS_MAX), -1, **i32),
        min_until=torch.zeros((batch,), **i32),
        guide=torch.full((batch,), -1, **i32),
        guide_row=torch.zeros((batch,), **i32))


def reset_sampling_state_(state: SamplingState, seed: int = 0) -> None:
    """Give ``state`` the values of ``init_sampling_state(B, seed, V)`` in
    place (fault recovery: no second [B, V] counts table is allocated)."""
    b = state.temperature.shape[0]
    state.key.copy_(prng.split(prng.key_tensor(prng.np_prng_key(seed),
                                               state.key.device), b))
    for t in (state.temperature, state.top_k, state.presence,
              state.frequency, state.counts, state.bias_vals,
              state.min_until, state.guide_row):
        t.zero_()
    state.top_p.fill_(1.0)
    for t in (state.bias_ids, state.suppress_ids, state.guide):
        t.fill_(-1)


def np_bias_cols(params, vocab_size: int):
    """Host-side [NB] bias columns (ids, vals) for one request's
    ``logit_bias``; ids < 0 pad empty entries."""
    ids = np.full((LOGIT_BIAS_MAX,), -1, np.int32)
    vals = np.zeros((LOGIT_BIAS_MAX,), np.float32)
    for i, (tid, b) in enumerate(params.logit_bias[:LOGIT_BIAS_MAX]):
        if 0 <= tid < vocab_size:
            ids[i] = tid
            vals[i] = b
    return ids, vals


def np_suppress_col(stop_ids) -> np.ndarray:
    """Host-side [NS] suppress column for min_tokens; ids < 0 pad.
    Overflow raises instead of truncating: a dropped id would let that
    token end the stream before min_tokens."""
    ids = list(dict.fromkeys(stop_ids))
    if len(ids) > SUPPRESS_MAX:
        raise ValueError(
            f"min_tokens suppress set has {len(ids)} ids; at most "
            f"{SUPPRESS_MAX} eos/stop token ids are supported")
    col = np.full((SUPPRESS_MAX,), -1, np.int32)
    for i, tid in enumerate(ids):
        col[i] = tid
    return col


def _col(x, like: torch.Tensor, shape) -> torch.Tensor:
    """``x`` (scalar, numpy or tensor) as a tensor of ``like``'s dtype and
    device, broadcast to ``shape``."""
    t = torch.as_tensor(x, device=like.device).to(like.dtype)
    return t.expand(shape) if t.shape != torch.Size(shape) else t


def set_slot(state: SamplingState, slot: int, temperature, top_p, top_k,
             key, presence=0.0, frequency=0.0, bias_ids=None, bias_vals=None,
             suppress_ids=None, min_until=0, guide=-1,
             guide_row=0) -> SamplingState:
    """Write one slot's row (``set_slots`` of one)."""
    def row(x):
        return None if x is None else torch.as_tensor(x)[None]

    return set_slots(state, [slot], [temperature], [top_p], [top_k],
                     torch.as_tensor(key)[None], [presence], [frequency],
                     row(bias_ids), row(bias_vals), row(suppress_ids),
                     [min_until], [guide], [guide_row])


def set_slots(state: SamplingState, slots, temperature, top_p, top_k, keys,
              presence=None, frequency=None, bias_ids=None, bias_vals=None,
              suppress_ids=None, min_until=None, guide=None, guide_row=None,
              *, shaping: bool = True) -> SamplingState:
    """Write M slots' rows in place: ``slots`` [M], the parameter columns
    [M] (tensors, numpy or lists), ``keys`` [M, 2], counts zeroed; a
    shaping column left None gets its identity value.  ``shaping=False``
    writes only temperature, top_p, top_k and key: for requests without
    penalties, bias, min_tokens or a guide, into slots whose shaping
    columns are at their identity values (the engine clears them when a
    slot that had any is released)."""
    dev = state.key.device
    idx = torch.as_tensor(slots, dtype=torch.long, device=dev)
    m = idx.shape[0]
    cols = [(state.temperature, temperature), (state.top_p, top_p),
            (state.top_k, top_k), (state.key, keys)]
    if shaping:
        nb, ns = state.bias_ids.shape[1], state.suppress_ids.shape[1]
        cols += [
            (state.presence, 0.0 if presence is None else presence),
            (state.frequency, 0.0 if frequency is None else frequency),
            (state.bias_ids, -1 if bias_ids is None else bias_ids),
            (state.bias_vals, 0.0 if bias_vals is None else bias_vals),
            (state.suppress_ids, -1 if suppress_ids is None
             else suppress_ids),
            (state.min_until, 0 if min_until is None else min_until),
            (state.guide, -1 if guide is None else guide),
            (state.guide_row, 0 if guide_row is None else guide_row)]
        state.counts.index_fill_(0, idx, 0)
    for old, new in cols:
        old.index_copy_(0, idx, _col(new, old, (m, *old.shape[1:])))
    return state


def clear_slot_penalties(state: SamplingState, slot) -> SamplingState:
    """Return a freed slot's penalties, bias, suppression and guide to
    their identity values, in place."""
    idx = torch.as_tensor(slot, dtype=torch.long,
                          device=state.key.device).reshape(-1)
    for col, val in ((state.presence, 0.0), (state.frequency, 0.0),
                     (state.bias_ids, -1), (state.bias_vals, 0.0),
                     (state.suppress_ids, -1), (state.min_until, 0),
                     (state.guide, -1), (state.guide_row, 0)):
        col.index_fill_(0, idx, val)
    return state


def transient_state_batch(temperature, top_p, top_k, keys, vocab_size: int,
                          bias_ids=None, bias_vals=None, suppress_ids=None,
                          min_first=None, guide=None,
                          guide_row=None) -> SamplingState:
    """M-row state for first-token sampling of M prompts at once (tensors
    [M], keys [M, 2]): penalties are identity there — the output is empty
    — and ``min_first`` (1 when min_tokens >= 1) is the suppression flag
    that ``sample``'s lengths=None reading takes."""
    m = temperature.shape[0]
    dev = temperature.device
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    return SamplingState(
        temperature=temperature, top_p=top_p, top_k=top_k, key=keys,
        presence=torch.zeros((m,), **f32),
        frequency=torch.zeros((m,), **f32),
        counts=torch.zeros((m, vocab_size), **i32),
        bias_ids=(torch.full((m, LOGIT_BIAS_MAX), -1, **i32)
                  if bias_ids is None else bias_ids),
        bias_vals=(torch.zeros((m, LOGIT_BIAS_MAX), **f32)
                   if bias_vals is None else bias_vals),
        suppress_ids=(torch.full((m, SUPPRESS_MAX), -1, **i32)
                      if suppress_ids is None else suppress_ids),
        min_until=(torch.zeros((m,), **i32)
                   if min_first is None else min_first),
        guide=torch.full((m,), -1, **i32) if guide is None else guide,
        guide_row=(torch.zeros((m,), **i32)
                   if guide_row is None else guide_row))


def transient_state(temperature, top_p, top_k, key, vocab_size: int,
                    bias_ids=None, bias_vals=None, suppress_ids=None,
                    min_first=None, guide=None,
                    guide_row=None) -> SamplingState:
    """One-row ``transient_state_batch``: scalar tensors, key [2]."""
    def row(x):
        return None if x is None else x[None]

    return transient_state_batch(
        temperature[None], top_p[None], top_k[None], key[None], vocab_size,
        row(bias_ids), row(bias_vals), row(suppress_ids), row(min_first),
        row(guide), row(guide_row))


def count_tokens(state: SamplingState, tokens: torch.Tensor,
                 active: torch.Tensor | None = None) -> SamplingState:
    """Record one emitted token per slot, in place (called on the tokens
    FED to a decode step — every generated token is fed exactly once).
    ``active`` (bool [B]) masks the update to live slots."""
    b = tokens.shape[0]
    rows = torch.arange(b, device=tokens.device)
    inc = (torch.ones((b,), dtype=torch.int32, device=tokens.device)
           if active is None else active.to(torch.int32))
    state.counts.index_put_((rows, tokens.long()), inc, accumulate=True)
    return state


def penalized(logits: torch.Tensor, state: SamplingState,
              on: bool | None = None) -> torch.Tensor:
    """Presence/frequency penalties (identity when both are 0).  ``on``:
    the host gate; None reads the reference's device predicate."""
    if on is None:
        on = bool(torch.any((state.presence != 0.0)
                            | (state.frequency != 0.0)))
    if not on:
        return logits
    cnt = state.counts.to(torch.float32)
    return (logits - state.presence[:, None] * (cnt > 0).to(torch.float32)
            - state.frequency[:, None] * cnt)


def _add_cols(logits: torch.Tensor, ids: torch.Tensor,
              vals: torch.Tensor) -> torch.Tensor:
    """``logits.at[arange[:, None], ids].add(vals)``: duplicate ids
    accumulate in column order."""
    rows = torch.arange(logits.shape[0], device=logits.device)[:, None]
    return logits.index_put((rows.expand_as(ids), ids.long()), vals,
                            accumulate=True)


def guide_mask(logits: torch.Tensor, state: SamplingState, guide_tables,
               on: bool | None = None) -> torch.Tensor:
    """Set tokens with dead guide transitions to -1e30.  guide_tables =
    (class_ids [G, V] int32, trans [R, C] int32)."""
    if on is None:
        on = bool(torch.any(state.guide >= 0))
    if not on:
        return logits
    class_ids, trans = guide_tables
    cls = class_ids[torch.clamp(state.guide, min=0).long()]        # [B, V]
    row = trans[torch.clamp(state.guide_row, min=0).long()]        # [B, C]
    nxt = torch.gather(row, 1, cls.long())                         # [B, V]
    bad = (nxt < 0) & (state.guide >= 0)[:, None]
    return torch.where(bad, _NEG, logits)


def guide_advance(state: SamplingState, ids: torch.Tensor, guide_tables,
                  active: torch.Tensor | None = None) -> SamplingState:
    """Advance each guided slot's DFA row by its sampled token.  A dead
    transition (reachable only when every token was masked) holds the
    row."""
    class_ids, trans = guide_tables
    g = torch.clamp(state.guide, min=0).long()
    cls = class_ids[g, ids.long()]                                  # [B]
    nxt = trans[torch.clamp(state.guide_row, min=0).long(), cls.long()]
    upd = state.guide >= 0
    if active is not None:
        upd = upd & active
    upd = upd & (nxt >= 0)
    return state._replace(guide_row=torch.where(upd, nxt, state.guide_row))


def shaped(logits: torch.Tensor, state: SamplingState,
           lengths: torch.Tensor | None = None, guide_tables=None,
           gates: Gates | None = None) -> torch.Tensor:
    """Penalties, then logit_bias, then the min_tokens suppression, then
    the guide mask LAST (a +100 bias must not resurrect a token the
    grammar forbids).  Suppression holds while ``lengths < min_until``;
    without ``lengths`` (first-token paths) min_until > 0 itself means
    "still under the minimum"."""
    if gates is None:
        gates = gates_of(state, guide_tables)
    logits = penalized(logits, state, gates.penalties)
    if gates.bias:
        valid = state.bias_ids >= 0
        logits = _add_cols(logits, torch.clamp(state.bias_ids, min=0),
                           torch.where(valid, state.bias_vals, 0.0))
    if gates.min_tokens:
        hold = (state.min_until > 0 if lengths is None
                else lengths < state.min_until)
        valid = (state.suppress_ids >= 0) & hold[:, None]
        logits = _add_cols(logits, torch.clamp(state.suppress_ids, min=0),
                           torch.where(valid, _NEG, 0.0).to(logits.dtype))
    if guide_tables is not None:
        logits = guide_mask(logits, state, guide_tables, gates.guide)
    return logits


def _filtered_scaled(logits: torch.Tensor, state: SamplingState):
    """(scaled logits [B, W] with filtered entries at -inf, vocab ids
    [B, W]) after temperature + top-k + top-p over the window."""
    w = window(logits.shape[-1])
    top_logits, top_idx = torch.topk(logits, w, dim=-1, sorted=True)
    scaled = top_logits / torch.clamp(state.temperature, min=1e-6)[:, None]
    top_k = state.top_k
    k = torch.where(top_k <= 0, torch.full_like(top_k, w),
                    torch.clamp(top_k, max=w))
    rank = torch.arange(w, device=logits.device)[None, :]
    neg_inf = torch.full_like(scaled, float("-inf"))
    scaled = torch.where(rank < k[:, None], scaled, neg_inf)
    # Nucleus over the kept candidates (already sorted descending): keep
    # the smallest prefix with cumulative prob >= top_p; the first always.
    probs = torch.softmax(scaled, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < state.top_p[:, None]
    return torch.where(keep, scaled, neg_inf), top_idx


def filtered_probs(logits: torch.Tensor, state: SamplingState):
    """(probs [B, W], vocab ids [B, W], scaled logits [B, W]): the exact
    distribution ``sample`` draws from, for speculative decoding's
    acceptance ratios."""
    scaled, idx = _filtered_scaled(logits, state)
    return torch.softmax(scaled, dim=-1), idx, scaled


def sample(logits: torch.Tensor, state: SamplingState,
           active: torch.Tensor | None = None,
           lengths: torch.Tensor | None = None, guide_tables=None,
           gates: Gates | None = None) -> tuple[torch.Tensor, SamplingState]:
    """One token per lane: logits [B, V] f32 -> (ids [B] int32, the state
    with advanced keys and guide rows).  The shaping passes apply before
    greedy and filtering.  ``active`` (bool [B]) freezes inactive lanes'
    keys and guide rows.  With ``gates.sampled`` off every lane is greedy
    and no key moves (no lane would read it)."""
    if gates is None:
        gates = gates_of(state, guide_tables)
    logits = shaped(logits, state, lengths, guide_tables, gates)
    ids = torch.argmax(logits, dim=-1).to(torch.int32)
    if gates.sampled:
        scaled, top_idx = _filtered_scaled(logits, state)
        new_keys = prng.split(state.key, 2)
        step_keys, carry = new_keys[:, 0], new_keys[:, 1]
        choice = prng.categorical(step_keys, scaled)
        drawn = top_idx.gather(1, choice[:, None])[:, 0].to(torch.int32)
        if active is not None:
            carry = torch.where(active[:, None], carry, state.key)
        ids = torch.where(state.temperature <= 0, ids, drawn)
        state = state._replace(key=carry)
    if guide_tables is not None and gates.guide:
        state = guide_advance(state, ids, guide_tables, active)
    return ids, state

"""Continuous-batching inference engine — the port of the reference's
single-device serving paths (``arks_tpu/engine/engine.py``) and its request
API (``add_request`` / ``step`` / ``start`` / ``stop``).  Two schedulers, as
in the reference:

- **Mixed** (a paged pool, ``ARKS_MIXED_STEP`` unset or 1 — the default):
  each step is ONE ``mixed_step`` plus ``sample``.  A flat token batch
  carries every decoding slot's next token and up to the mixed token budget
  (``ARKS_MIXED_CHUNK_TOKENS``, default the chunk) of prefill-chunk tokens,
  spread round-robin over every prefilling sequence.  A sequence whose
  prompt completes inside the batch samples its first token in the same
  step.  Every prompt rides the chunked path; page size == chunk size.
- **Legacy** (``kv_layout="slot"``, the slot-contiguous cache, or a paged
  pool with ``ARKS_MIXED_STEP=0``): each step admits waiting prompts of up
  to the largest prefill bucket in one-shot batches of one bucket
  (``prefill`` + insert + first-token sample), advances at most one chunk
  of one longer prompt, then runs ONE fused K-step decode dispatch
  (``steps_per_dispatch`` ``decode_step``s, each sampling every slot) and
  fans its tokens out.  On a CUDA device (``ARKS_OVERLAP_DECODE``, default
  ``auto``) the decode dispatch is issued first and admission and the
  chunk run while the card computes it; admission batches resolve their
  first tokens only once their copies have landed (deferred admissions).

Steady-state decoding (every live slot decoding, no admission possible, no
abort pending) leaves the host behind on both schedulers: the pipelined
path (``ARKS_PIPELINE_DEPTH``, default 2) keeps that many dispatches in
flight, each taking only the device-resident tokens, lengths and liveness
its predecessor returned plus the block tables, and resolves the oldest on
a lagged host view.  At depth 0 a mixed engine runs the same device
program and resolves it at once (``ARKS_SAMPLER_FUSE``, default on).

The KV cache is the engine dtype, bf16 (also under an f32 engine, whose
attention reads it widened) or int8; a paged pool may also be int4, on either scheduler (the legacy one sends its int4 decode through
the mixed attention kernel, one query per slot).  Weights are the engine
dtype or int8 / int4 (``weight_dtype``); dense and MoE models alike.  Seeded sampling
draws the reference's threefry keys.

Every sampling field of a request is served on both schedulers:
presence/frequency penalties, ``logit_bias``, ``min_tokens``, logprobs
(chosen and top-N over the raw distribution) and guided decoding (regex,
JSON mode, JSON schema, choice; compiled off the engine thread by
``guides.GuideCompiler`` — a request whose guide is still compiling is
parked, never waited for).  The passes run only for batches in which a
request asks for them, decided on the host (``sampler.Gates``), and a
step's logprob data crosses to the host in the same copy as its ids.

Prompts that repeat a prefix reuse its KV, as the reference's do.  A paged
pool (either scheduler) registers every full prompt page in the page
allocator's digest index once written (tier 0); a later prompt whose
chained page digests match points its block table at those pages and
chunk-prefills only its tail (at least one token, whose logits sample the
first token).  The pool holds ``prefix_cache_mb`` of retention pages beyond
every slot's full table.  Pages the index evicts under pressure are copied
to host RAM (tier 1, ``HostPrefixTier``, ``ARKS_PREFIX_HOST_MB``, default
256): a later hit there allocates fresh pages, scatters the blocks back and
parks the request until the copy has landed.  The slot cache keeps a host
prefix cache instead (``PrefixKVCache``, ``prefix_cache_mb``), harvested at
admission and inserted in front of the tail.

Admission is the reference's tenant-fair, bounded queue
(``engine/fairqueue.py``: weighted deficit round-robin across tenants
within each SLO tier, ``ARKS_FAIR``; ``ARKS_QUEUE_MAX`` /
``ARKS_QUEUE_TENANT_MAX`` bound the caller's puts, ``ARKS_QUEUE_AGING_S``
ages starved entries, ``ARKS_SHED_DEADLINE`` sheds a request whose wait
already spent its tier's TTFT budget).  ``metrics`` holds the reference's
metric families (``engine/metrics.py``), updated from host-side values
only.

What the reference does and this port does not — the disk prefix tier,
peer prefix fetch, the cache sketch, preemptive swap, speculative decoding,
fault recovery, parallelism — is rejected (``EngineConfig.validate``, and
``check_unserved_knobs`` for the environment) rather than silently
ignored.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import queue
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

from arks_tpu_torch import knobs, tenancy
from arks_tpu_torch import slo as slo_mod
from arks_tpu_torch.device import resolve_device
from arks_tpu_torch.engine import fairqueue, prng
from arks_tpu_torch.engine import sampler as sampler_mod
from arks_tpu_torch.engine.guides import Guide, GuideCompiler, GuideError
from arks_tpu_torch.engine.metrics import EngineMetrics
from arks_tpu_torch.engine.paged import (PageAllocator, chain_digests,
                                         mixed_grid_steps, mixed_kv_bytes,
                                         pages_needed)
from arks_tpu_torch.engine.prefix_cache import HostPrefixTier, PrefixKVCache
from arks_tpu_torch.engine.types import Request, RequestOutput
from arks_tpu_torch.models import moe
from arks_tpu_torch.models import quant
from arks_tpu_torch.models import transformer as tf
from arks_tpu_torch.models.config import ModelConfig
from arks_tpu_torch.ops.paged_attention import mixed_grid_mode, mixed_grid_plan

log = logging.getLogger("arks_tpu_torch.engine")


class ContextLengthExceededError(ValueError):
    """Prompt does not fit the serving window (HTTP 400
    ``context_length_exceeded`` — never silent truncation)."""


@dataclasses.dataclass
class EngineConfig:
    """The reference's engine fields that the port serves or rejects
    (speculative decoding, parallelism).  Values outside them raise in
    ``validate``."""

    model: str = "tiny"
    num_slots: int = 8
    max_cache_len: int = 1024
    # One-shot prompt buckets of the legacy scheduler (prompts beyond the
    # largest run chunked); the mixed scheduler chunks every prompt.
    prefill_buckets: tuple[int, ...] = (32, 64, 128, 256, 512, 1024)
    # Decode steps per legacy dispatch, and decode rows reserved per slot
    # past its prompt: bounds the largest prompt at max_cache_len - K - 1.
    steps_per_dispatch: int = 4
    prefill_chunk: int | None = 256
    tensor_parallel: int | None = None
    data_parallel: int = 1
    context_parallel: int = 1
    pipeline_parallel: int = 1
    draft_model: str | None = None
    dtype: str | None = None   # default: model config dtype
    # "auto" = the model config's preference, else the engine dtype;
    # "bf16", "int8" or "int4".
    kv_cache_dtype: str = "auto"
    # "bf16" (the engine dtype, unquantized), "int8" (per-channel scales)
    # or "int4" (groupwise scales, packed); the embedding is int8 in both
    # quantized modes.
    weight_dtype: str = "bf16"
    # "auto" = "paged" (the pool; the mixed scheduler unless
    # ARKS_MIXED_STEP=0), "paged", or "slot" (the slot-contiguous cache
    # [L, B, Hkv, max_cache_len, D], always the legacy scheduler).
    kv_layout: str = "auto"
    # Prefix reuse: a paged pool's retention pages beyond every slot's full
    # table (MB of pool, at most 4x the slots' pages), or the slot cache's
    # host prefix cache (MB of host RAM); 0 = none.
    prefix_cache_mb: int = 256
    seed: int = 0

    def validate(self) -> None:
        self.resolve_kv_cache_dtype()
        quant.weight_bits(self.weight_dtype)
        if self.kv_layout not in ("auto", "paged", "slot"):
            raise ValueError(f"kv_layout={self.kv_layout!r}")
        if self.kv_layout == "slot" and \
                self.resolve_kv_cache_dtype() == "int4":
            raise ValueError(
                "kv_cache_dtype=int4 requires the paged KV layout (packed "
                "pages + fused dequant live in the paged mixed kernel; "
                "there is no int4 slot cache)")
        if self.draft_model:
            raise NotImplementedError(
                "speculative decoding arrives with its own slice")
        for name in ("tensor_parallel", "data_parallel", "context_parallel",
                     "pipeline_parallel"):
            if (getattr(self, name) or 1) > 1:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)}: parallelism arrives "
                    "with the parallelism slice")
        if not self.prefill_chunk or self.prefill_chunk < 1:
            raise ValueError("prefill_chunk >= 1: both schedulers chunk "
                             "long prompts")
        if self.num_slots < 1 or self.max_cache_len < 2:
            raise ValueError("num_slots >= 1 and max_cache_len >= 2")
        if self.prefix_cache_mb < 0:
            raise ValueError(f"prefix_cache_mb={self.prefix_cache_mb}: must "
                             "be >= 0")

    def resolve_kv_cache_dtype(self) -> str:
        """'int8' | 'int4' | 'bf16' | 'engine' (= the engine dtype).
        "auto" resolves as the reference resolves it off its own
        accelerator: the engine dtype."""
        if self.kv_cache_dtype not in ("auto", "bf16", "int8", "int4"):
            raise ValueError(f"kv_cache_dtype={self.kv_cache_dtype!r}")
        if self.kv_cache_dtype == "auto":
            return "engine"
        return self.kv_cache_dtype

    @property
    def kv_quantized(self) -> bool:
        return self.resolve_kv_cache_dtype() in ("int8", "int4")

    def resolve_buckets(self) -> list[int]:
        """Prefill buckets clamped to the cache; never empty."""
        buckets = sorted(b for b in self.prefill_buckets
                         if b <= self.max_cache_len)
        if not buckets:
            buckets = [self.max_cache_len]
        elif buckets[-1] < self.max_cache_len and not self.prefill_chunk:
            # No chunked path: the one-shot buckets must cover full-cache
            # prompts.
            buckets.append(self.max_cache_len)
        return buckets


def admit_batch_sizes() -> tuple[int, ...]:
    """One-shot admission batch sizes, largest first (greedy fill):
    ``ARKS_ADMIT_BATCH_SIZES`` (comma-separated, default "8,4,2,1"); 1 is
    always present."""
    raw = knobs.get_str("ARKS_ADMIT_BATCH_SIZES")
    try:
        sizes = {int(x) for x in raw.split(",") if x.strip()}
    except ValueError as e:
        raise ValueError(
            f"ARKS_ADMIT_BATCH_SIZES={raw!r}: expected comma-separated "
            "integers (e.g. \"16,8,4,2,1\")") from e
    if any(x < 1 for x in sizes):
        raise ValueError(f"ARKS_ADMIT_BATCH_SIZES={raw!r}: sizes must be "
                         ">= 1")
    return tuple(sorted(sizes | {1}, reverse=True))


def mixed_step_knob() -> str:
    """``ARKS_MIXED_STEP``: "auto" (the default), "0" or "1"."""
    return knobs.get_enum("ARKS_MIXED_STEP", ("auto", "0", "1"))


def pipeline_depth_knob() -> int:
    """``ARKS_PIPELINE_DEPTH``: dispatches kept in flight by steady-state
    decoding (default 2); 0 is the unpipelined step."""
    return knobs.get_int("ARKS_PIPELINE_DEPTH", minimum=0)


def sampler_fuse_knob() -> bool:
    """``ARKS_SAMPLER_FUSE``: "1" (the default) runs steady-state depth-0
    mixed decoding through the pipe program resolved at once; "0" keeps
    the host-built mixed batch."""
    return knobs.get_enum("ARKS_SAMPLER_FUSE", ("0", "1")) != "0"


def prefix_host_mb_knob() -> int:
    """``ARKS_PREFIX_HOST_MB``: the host prefix tier's budget behind a
    paged pool's device index (default 256; 0 turns the tier off)."""
    return knobs.get_int("ARKS_PREFIX_HOST_MB", minimum=0)


def check_unserved_knobs() -> None:
    """Raise on a knob that asks for a reference subsystem the port does
    not have yet: the disk prefix tier (``ARKS_PREFIX_DISK_MB`` > 0), peer
    prefix fetch (``ARKS_PEER_FETCH``, ``ARKS_PEER_ADDRS``) and preemptive
    swap (``ARKS_PREEMPT``)."""
    on = ("1", "true", "yes", "on")
    disk = knobs.get_str("ARKS_PREFIX_DISK_MB").strip()
    asked = []
    if disk not in ("0", ""):
        asked.append(f"ARKS_PREFIX_DISK_MB={disk} (the disk prefix tier)")
    if knobs.get_str("ARKS_PEER_FETCH").strip().lower() in on:
        asked.append("ARKS_PEER_FETCH (peer prefix fetch)")
    if knobs.get_str("ARKS_PEER_ADDRS", "").strip():
        asked.append("ARKS_PEER_ADDRS (peer prefix fetch)")
    if knobs.get_str("ARKS_PREEMPT").strip().lower() in on:
        asked.append("ARKS_PREEMPT (preemptive swap)")
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)}: not served by this port yet")


def overlap_decode_knob(device: torch.device) -> bool:
    """``ARKS_OVERLAP_DECODE`` ("auto", "0", "1"): the legacy scheduler
    issues its decode dispatch before admission and resolves it after.
    "auto" is the reference's "on where the platform supports it", read
    here as on for a CUDA device, whose kernels run while the host admits,
    and off on the CPU, where the "device" is the host's own cores."""
    raw = knobs.get_enum("ARKS_OVERLAP_DECODE", ("auto", "0", "1"))
    return raw == "1" or (raw == "auto" and device.type == "cuda")


@dataclasses.dataclass
class _Slot:
    request: Request
    num_prompt: int
    generated: list[int] = dataclasses.field(default_factory=list)
    # One (chosen, [(id, logprob), ...]) entry per generated token when the
    # request asked for logprobs.
    logprobs: list = dataclasses.field(default_factory=list)
    num_emitted: int = 0
    # Device liveness data, frozen at registration: the stop set as a
    # [STOP_IDS_MAX] column (None when it does not fit: the slot keeps the
    # engine off the pipelined path) and the length at which the host
    # retires the slot (max_tokens, or the cache cap).
    stop_col: np.ndarray | None = None
    dead_len: int = 0


@dataclasses.dataclass
class _ChunkState:
    """A chunked prefill in progress (slot reserved, not yet decoding)."""

    request: Request
    ids: list[int]
    pos: int      # tokens already prefilled
    key: np.ndarray   # np_prng_key(seed): the first token's key
    # Paged pool: the prompt's chained page digests when its admission
    # computed them (a prefix hit), registered at promote.
    digests: list | None = None


@dataclasses.dataclass
class _RestoreState:
    """A host-tier prefix restore in flight: the request parks here while
    its scatter rides the stream; once ``done`` has passed it continues
    through the chunked path with ``shared + pages`` heading its table."""

    request: Request
    ids: list[int]
    digests: list        # the prompt's digest chain (computed at match)
    shared: list[int]    # device-index pages (caller references held)
    pages: list[int]     # fresh pages the scatter writes
    done: object         # a CUDA event after the last scatter, or None
    t0: float


def _penalized(p) -> bool:
    return bool(p.presence_penalty or p.frequency_penalty)


def _shapes(p) -> bool:
    """Whether a request writes any shaping column of its slot's row."""
    return bool(_penalized(p) or p.logit_bias or p.min_tokens
                or p.guide is not None)


def _lane_gates(params, decoding=()) -> sampler_mod.Gates:
    """The passes a batch runs: ``params`` of every lane that samples,
    ``decoding`` those of its decode lanes (penalties read the counts of
    generated tokens; a first token has none)."""
    return sampler_mod.Gates(
        sampled=any(p.temperature > 0 for p in params),
        penalties=any(_penalized(p) for p in decoding),
        bias=any(p.logit_bias for p in params),
        min_tokens=any(p.min_tokens > 0 for p in params),
        guide=any(p.guide is not None for p in params))


def _pack(ids: torch.Tensor, lp=None) -> torch.Tensor:
    """The sampled ids [..., B] and, with ``lp`` (chosen [..., B], top
    values and ids [..., B, L] from ``top_logprobs``), their logprob data
    as ONE int32 tensor (floats as their bits), so one copy takes both."""
    if lp is None:
        return ids
    clp, vals, lids = lp
    return torch.cat([ids[..., None], clp[..., None].view(torch.int32),
                      vals.view(torch.int32), lids], dim=-1)


def _unpack(packed: np.ndarray, with_lp: bool):
    """``_pack``'s result on the host: (ids, None | (chosen, vals, lids))."""
    if not with_lp:
        return packed, None
    n = (packed.shape[-1] - 2) // 2
    return packed[..., 0], (packed[..., 1].view(np.float32),
                            packed[..., 2: 2 + n].view(np.float32),
                            packed[..., 2 + n:])


def _to_host(ids: torch.Tensor, lp=None):
    """The sampled ids on the host, with their logprob data: one blocking
    device-to-host copy (the host sync point of the sequential paths)."""
    return _unpack(_pack(ids, lp).cpu().numpy(), lp is not None)


class _PinnedCopy:
    """Device tensors on their way to the host: on a CUDA device
    non-blocking copies into pinned buffers taken from ``pool``, with one
    event recorded after them on the current stream (the copies run when
    the kernels queued before them are done, and the host reads them only
    once the event has passed); on the CPU the values themselves, always
    ready.  ``pool`` maps (shape, dtype) to the free pinned buffers of that
    shape: a buffer goes back only when its copy has been read, so none is
    reused while a copy into it may still run."""

    def __init__(self, tensors, pool: dict) -> None:
        self.pool = pool
        self.event = None
        if tensors[0].device.type != "cuda":
            self.bufs = [t.clone() for t in tensors]
            return
        self.bufs = []
        for t in tensors:
            free = pool.setdefault((tuple(t.shape), t.dtype), [])
            buf = free.pop() if free else torch.empty(
                t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            self.bufs.append(buf)
        self.event = torch.cuda.Event()
        self.event.record()

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def tensors(self) -> list[torch.Tensor]:
        """The host copies (waits for them when they have not landed): on
        the card the pinned buffers themselves, to be read before
        ``release``."""
        if self.event is not None:
            self.event.synchronize()
        return self.bufs

    def release(self) -> None:
        """Give the pinned buffers back to the pool (read them first)."""
        if self.event is not None:
            for b in self.bufs:
                self.pool[(tuple(b.shape), b.dtype)].append(b)
            self.bufs = []


class _HostCopy(_PinnedCopy):
    """A dispatch's sampled ids (and logprob data) on their way to the
    host, packed into one int32 tensor (``_pack``)."""

    def __init__(self, ids: torch.Tensor, lp, pool: dict) -> None:
        super().__init__([_pack(ids, lp)], pool)
        self.with_lp = lp is not None

    def result(self):
        """(ids, None | (chosen, vals, lids)) as numpy; waits for the copy
        when it has not landed yet."""
        out = self.tensors()[0].numpy().copy()
        self.release()
        return _unpack(out, self.with_lp)


def mixed_pipe(params: tf.Params, cfg: ModelConfig, cache: tf.PagedKVCache,
               tokens: torch.Tensor, lengths: torch.Tensor,
               alive: torch.Tensor, stop_ids: torch.Tensor,
               dead_len: torch.Tensor, sstate: sampler_mod.SamplingState,
               tables: torch.Tensor, gtables, gates: sampler_mod.Gates,
               want_lp: bool, sentinel: int):
    """One steady-state mixed decode dispatch on device-resident state
    (the reference's ``mixed_pipe``): a flat batch of B lanes, lane t =
    slot t, the dead ones at the sentinel position with no query (writes
    dropped, nothing attended), through the same ``mixed_step`` and
    kernels as the host-built batch; then one ``sample`` over every lane
    and the end-of-dispatch liveness.  ``tokens``/``lengths``/``alive``
    [B] are the previous dispatch's outputs (or the host mirrors on a
    fresh issue), ``stop_ids`` [B, STOP_IDS_MAX] and ``dead_len`` [B] the
    slots' frozen liveness data.  An MoE model takes the dispatch its rule
    gives B tokens.  Returns (toks [1, B], None | logprob data [1, B(, L)],
    next tokens, next lengths, next alive, the sampling state)."""
    b = tokens.shape[0]
    lane = torch.arange(b, dtype=torch.int32, device=tokens.device)
    eff = torch.where(alive, lengths, sentinel)
    if gates.penalties:
        sstate = sampler_mod.count_tokens(sstate, tokens, alive)
    logits = tf.mixed_step(params, cfg, cache, tables, tokens,
                           torch.where(alive, lane, -1), eff, lane, lane,
                           alive.to(torch.int32), eff, qmax=1)
    nxt, sstate = sampler_mod.sample(logits, sstate, alive, eff, gtables,
                                     gates)
    nxt = torch.where(alive, nxt, 0)
    lengths = lengths + 1
    alive = sampler_mod.advance_liveness(nxt[None], alive, lengths, stop_ids,
                                         dead_len)
    lp = None
    if want_lp:
        lp = tuple(x[None] for x in sampler_mod.top_logprobs(logits, nxt))
    return (nxt[None], lp, torch.where(alive, nxt, 0), lengths, alive,
            sstate)


def decode_pipe(params: tf.Params, cfg: ModelConfig, cache,
                tokens: torch.Tensor, lengths: torch.Tensor,
                alive: torch.Tensor, stop_ids: torch.Tensor,
                dead_len: torch.Tensor, sstate: sampler_mod.SamplingState,
                tables: torch.Tensor | None, gtables,
                gates: sampler_mod.Gates, want_lp: bool, sentinel: int,
                k_steps: int):
    """One steady-state legacy dispatch on device-resident state (the
    reference's ``decode_pipe``): ``k_steps`` ``decode_state_step``s, each
    counting its fed tokens first (when a lane has penalties) and sampling
    every live slot, then the end-of-dispatch liveness.  Arguments as
    ``mixed_pipe``'s (``tables`` None on the slot cache).  Returns (toks
    [K, B], None | logprob data [K, B(, L)], next tokens, next lengths,
    next alive, the sampling state)."""
    toks, lps = [], []
    for _ in range(k_steps):
        eff = torch.where(alive, lengths, sentinel)
        active = eff < sentinel
        if gates.penalties:
            sstate = sampler_mod.count_tokens(sstate, tokens, active)
        logits = tf.decode_state_step(params, cfg, cache, tokens, lengths,
                                      alive, sentinel, tables)
        nxt, sstate = sampler_mod.sample(logits, sstate, active, eff,
                                         gtables, gates)
        tokens = torch.where(alive, nxt, 0)
        toks.append(tokens)
        if want_lp:
            lps.append(sampler_mod.top_logprobs(logits, tokens))
        lengths = lengths + 1
    toks = torch.stack(toks)
    alive = sampler_mod.advance_liveness(toks, alive, lengths, stop_ids,
                                         dead_len)
    lp = tuple(torch.stack(x) for x in zip(*lps)) if want_lp else None
    return toks, lp, torch.where(alive, tokens, 0), lengths, alive, sstate


class InferenceEngine:
    def __init__(self, cfg: ModelConfig, engine_cfg: EngineConfig,
                 tokenizer, params: tf.Params | None = None,
                 device: str | torch.device | None = None) -> None:
        # A model config's KV dtype preference applies when the engine's
        # setting is "auto" (an explicit engine setting wins).
        if engine_cfg.kv_cache_dtype == "auto" and \
                cfg.kv_cache_dtype != "auto":
            engine_cfg = dataclasses.replace(
                engine_cfg, kv_cache_dtype=cfg.kv_cache_dtype)
            log.info("kv_cache_dtype=%s from the model config",
                     cfg.kv_cache_dtype)
        engine_cfg.validate()
        check_unserved_knobs()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ecfg = engine_cfg
        self.tokenizer = tokenizer
        dtype = tf.torch_dtype(engine_cfg.dtype or cfg.dtype)
        wbits = quant.weight_bits(engine_cfg.weight_dtype)
        if params is None:
            # A quantized init quantizes slice by slice as it draws: a
            # full-width init of a model that only fits quantized (Mixtral
            # on one card) would not fit first.
            params = tf.init_params(cfg, engine_cfg.seed, dtype, self.device,
                                    bits=wbits)
        elif wbits and not quant.is_quantized(params["layers"].get("wq")):
            params = quant.quantize_params(params, bits=wbits)
        self.params = params

        # Chunk (= page for a paged pool): the largest divisor of the cache
        # length not above the configured chunk, so every chunk's rows stay
        # inside a slot's cache (its pages inside the slot's table) and a
        # chunk never straddles a page boundary it cannot own.
        c = min(engine_cfg.prefill_chunk, engine_cfg.max_cache_len)
        while engine_cfg.max_cache_len % c:
            c -= 1
        self._page = c
        kv = engine_cfg.resolve_kv_cache_dtype()
        # An unquantized cache is bf16 when asked for, whatever the engine
        # dtype (the reference's _cache_dtype); the attention kernels read
        # it widened to an f32 engine's dtype.
        cache_dtype = torch.bfloat16 if kv == "bf16" else dtype
        self._paged = engine_cfg.kv_layout != "slot"
        knob = mixed_step_knob()
        self._mixed = self._paged and knob != "0"
        if knob == "1" and not self._paged:
            log.warning("ARKS_MIXED_STEP=1 requested but the slot layout "
                        "has no mixed scheduler; staying on the legacy one")
        quantized = kv in ("int8", "int4")
        n = engine_cfg.num_slots
        if self._paged:
            self._max_pages = engine_cfg.max_cache_len // c
            # Every slot's full table always fits; prefix_cache_mb adds
            # retention pages for the device index (capped in proportion,
            # so a tiny model's pool stays small), as the reference sizes
            # its pool.
            bits = (4 if kv == "int4" else 8) if quantized else \
                torch.finfo(cache_dtype).bits
            page_bytes = (cfg.num_layers * cfg.num_kv_heads * c
                          * cfg.head_dim * bits // 8 * 2)
            if quantized:
                page_bytes += cfg.num_layers * cfg.num_kv_heads * c * 8
            self._page_bytes = page_bytes
            extra = min(engine_cfg.prefix_cache_mb * 2**20 // page_bytes,
                        n * self._max_pages * 4)
            num_pages = n * self._max_pages + extra
            self.cache = tf.init_paged_cache(
                cfg, num_pages, c, cache_dtype, self.device,
                quantized=quantized,
                kv_bits=4 if kv == "int4" else 8)
            self._alloc = PageAllocator(num_pages, c)
        else:
            self._max_pages = 0
            self._page_bytes = 0
            self.cache = tf.init_cache(cfg, n, engine_cfg.max_cache_len,
                                       cache_dtype, self.device,
                                       quantized=quantized)
            self._alloc = None
        # Prefix reuse beyond the device index: the host tier behind a
        # paged pool (spilled pages, restored at admission), or the slot
        # cache's host prefix cache.  Spills and restores move whole pages
        # in groups of a fixed size, as the reference's.
        host_mb = prefix_host_mb_knob()
        self._host = None
        # (digest, page) evicted from the device index since the last
        # spill flush.
        self._spill_victims: list = []
        if self._paged and host_mb:
            self._host = HostPrefixTier(c, host_mb * 2**20)
            # The allocator's on_evict (the reference's ``_note_evicted``):
            # queue the page, as it runs mid-allocation; ``_spill_flush``
            # copies it before any dispatch can write it.  A closure over
            # the list, not a bound method: engine -> allocator -> engine
            # would be a cycle that keeps the pool alive past ``del``.
            victims = self._spill_victims
            self._alloc.on_evict = lambda digest, page: victims.append(
                (digest, page))
        self._prefix = None
        if not self._paged and engine_cfg.prefix_cache_mb:
            self._prefix = PrefixKVCache(c, engine_cfg.prefix_cache_mb * 2**20)
        self._spill_group = min(8, max(self._max_pages, 1))
        self._spills: collections.deque = collections.deque()
        self._awaiting_restore: list[_RestoreState] = []
        self._mixed_budget = 0
        self._moe_grouped = False
        if self._mixed:
            budget = knobs.get_int("ARKS_MIXED_CHUNK_TOKENS", fallback=c,
                                   minimum=1)
            self._mixed_budget = min(budget, engine_cfg.max_cache_len)
            # The reference runs every mixed step at its padded flat batch
            # (num_slots + budget tokens), so its MoE dispatch is fixed per
            # engine; the port trims the batch but keeps that decision.
            self._moe_grouped = moe.use_grouped(n + self._mixed_budget)
        self._buckets = engine_cfg.resolve_buckets()
        self._admit_sizes = admit_batch_sizes()
        self._pipe_depth = pipeline_depth_knob()
        self._sampler_fuse = sampler_fuse_knob()
        self._overlap = overlap_decode_knob(self.device)
        # Rows a pipelined dispatch writes per slot (mixed: its one-token
        # step; legacy: the K-step loop), also dead_len's cache margin.
        self._pipe_rows = 1 if self._mixed else engine_cfg.steps_per_dispatch

        # Host-authoritative scheduler state (engine thread only).  Slots
        # start parked in a paged pool (their rows' writes drop); in the
        # slot cache at length 0, as in the reference.
        self._tables = np.zeros((n, max(self._max_pages, 1)), np.int32)
        self._lengths = np.full((n,), self._park_sentinel() if self._paged
                                else 0, np.int32)
        self._last_token = np.zeros((n,), np.int32)
        self._slots: dict[int, _Slot] = {}
        self._prefilling: dict[int, _ChunkState] = {}
        self._slot_pages: dict[int, list[int]] = {}
        self._free: list[int] = list(range(n))
        self._request_seed = 0
        # Bumped at every registration: a pipelined resolve drops the
        # tokens of a slot retired (or re-registered) since its issue.
        self._slot_gen = np.zeros((n,), np.int64)
        # In-flight pipelined dispatches (FIFO), the device state threaded
        # from one to the next (tokens, lengths, alive) and the run's
        # liveness columns (stop ids, dead_len).
        self._pipe_inflight: collections.deque = collections.deque()
        self._pipe_state = None
        self._pipe_cols = None
        # Deferred admissions: issued one-shot batches whose first tokens
        # have not been read yet (FIFO), and their request count.
        self._pending_admits: collections.deque = collections.deque()
        self._pending_n = 0
        # Free pinned buffers of the async result copies, by shape.
        self._host_bufs: dict = {}
        # Each slot's sampling row and decode key (registered slots' rows
        # are read).
        self._sampling = sampler_mod.init_sampling_state(
            n, engine_cfg.seed, cfg.vocab_size, self.device)
        # Guided decoding: the compiler owns the host tables; the device
        # copies have fixed budget shapes and take new CONTENTS (engine
        # thread, between dispatches) when its version bumps.
        eos_all = tuple(dict.fromkeys(list(cfg.eos_token_ids)
                                      + list(tokenizer.eos_token_ids)))
        self.metrics = EngineMetrics()
        m = self.metrics
        self.guides = GuideCompiler(
            tokenizer, cfg.vocab_size, eos_all,
            metrics=SimpleNamespace(
                compile_seconds=m.guide_compile_seconds,
                hits=m.guide_cache_hits_total,
                misses=m.guide_cache_misses_total,
                evictions=m.guide_cache_evictions_total,
                guides_in_use=m.guide_registry_guides_in_use,
                rows_in_use=m.guide_registry_rows_in_use))
        self._guide_dev = (
            torch.from_numpy(self.guides.class_ids).to(self.device),
            torch.from_numpy(self.guides.trans).to(self.device))
        self._guide_ver = self.guides.version
        # Requests parked on an in-flight guide compile, with its ticket
        # (engine thread only), and request id -> guide key of the pins
        # held from admission to the request's end.
        self._awaiting_guide: list = []
        self._guide_pins: dict[str, tuple[str, str]] = {}

        # Shared with caller threads.  The admission queue is tenant-fair
        # and bounded for the callers' puts (``fairqueue.FairQueue``).
        self._queue = fairqueue.FairQueue()
        self._queue_seq = 0
        self._shed_deadline_factor = knobs.get_float("ARKS_SHED_DEADLINE",
                                                     minimum=0)
        self._tenant_labels = tenancy.TenantLabels()
        self._slo = slo_mod.from_env()
        self._slo_burn_window_s = knobs.get_float("ARKS_SLO_BURN_WINDOW_S")
        self._slo_error_budget = max(
            knobs.get_float("ARKS_SLO_ERROR_BUDGET"), 1e-6)
        self._slo_events: dict[str, list] = {}
        self._queue_aging_s = knobs.get_float("ARKS_QUEUE_AGING_S", minimum=0)
        self._queue_age_last = 0.0
        # The last pipelined resolve's time (TPOT by resolve interarrival).
        self._pipe_last_resolve: float | None = None
        # The loop's first finished step (readiness).
        self.warm = False
        self._abort_lock = threading.Lock()
        self._aborted: set[str] = set()
        self._running = False
        self._thread: threading.Thread | None = None
        # Mixed dispatches issued (each runs every layer's two kernels once),
        # and those that carried decode and prefill-chunk tokens together;
        # legacy decode dispatches and their decode steps (each step runs
        # every layer's update and attention kernels once).
        self.dispatches = 0
        self.shared_dispatches = 0
        self.decode_dispatches = 0
        self.decode_steps = 0
        # Of those, the pipelined ones (fused depth-0 ones included), the
        # in-flight count each issue left (occupancy -> dispatches) and its
        # largest value.  (The fused ones, the resolve waits and the prefix
        # counters are metric families; properties below read them.)
        self.pipe_dispatches = 0
        self.pipe_occupancy: dict[int, int] = {}
        self.pipe_occupancy_max = 0
        # Each host-tier restore's seconds from issue to unpark, and the
        # prompt tokens the model computed (chunks and one-shot prefills).
        self.prefix_restore_seconds: list[float] = []
        self.prefill_tokens_total = 0
        # The configuration this engine runs, under the reference's label
        # names (``engine_config_info``).
        self.resolved_config = {
            "kv_layout": "paged" if self._paged else "slot",
            "decode_impl": "kernel" if self.device.type == "cuda"
            else "plain",
            "admit_batch_sizes": ",".join(map(str, self._admit_sizes)),
            "pad_head": "false",
            "overlap": str(bool(self._overlap)).lower(),
            "kv_cache_dtype": kv,
            "kv_dtype": kv,
            "kernel_tune": "none",
            "mixed_grid": mixed_grid_mode(),
            "weight_dtype": engine_cfg.weight_dtype or "native",
            "model": engine_cfg.model,
            "mixed_step": str(bool(self._mixed)).lower(),
            "pipeline_depth": str(self._pipe_depth),
            "prefix_host_mb": str(host_mb),
            "spec_mixed": "false",
            "preempt": "off",
            "tensor_parallel": "1",
            "data_parallel": "1",
        }
        self.metrics.engine_config_info.set(1, **self.resolved_config)

    # ------------------------------------------------------------------
    # Request API
    # ------------------------------------------------------------------

    @property
    def kv_quantized(self) -> bool:
        return self.cache.quantized

    # Engine counters read from the metric families: prompt tokens looked
    # up in the prefix cache, tokens served by tier ("device": the pool's
    # index; "host": the host tier, or the slot cache's prefix cache),
    # pages spilled to and restored from the host tier, fused depth-0
    # dispatches, and the seconds the host waited for decode results.
    @property
    def prefix_cache_query_tokens_total(self) -> int:
        return int(self.metrics.prefix_cache_query_tokens_total.total())

    @property
    def prefix_cache_hit_tokens_total(self) -> dict[str, int]:
        hits = self.metrics.prefix_cache_hit_tokens_total
        return {tier: int(hits.get(tier=tier)) for tier in ("device", "host")}

    @property
    def prefix_spill_blocks_total(self) -> int:
        return int(self.metrics.prefix_spill_blocks_total.total())

    @property
    def prefix_restore_blocks_total(self) -> int:
        return int(self.metrics.prefix_restore_blocks_total.total())

    @property
    def sampler_fused_dispatches(self) -> int:
        return int(self.metrics.sampler_fused_dispatch_total.total())

    @property
    def decode_resolve_wait_s(self) -> float:
        return self.metrics.decode_resolve_wait_seconds_total.total()

    @property
    def kv_bits(self) -> int:
        return self.cache.kv_bits

    @property
    def max_prompt_len(self) -> int:
        """Largest admissible prompt (the decode reserve kept)."""
        return self.ecfg.max_cache_len - self.ecfg.steps_per_dispatch - 1

    def min_tokens_suppress_ids(self, p) -> list[int]:
        """Deduped token ids suppressed while a request is below
        min_tokens (eos unless ignore_eos, plus stop_token_ids): the one
        definition admission, ``_shaping_cols`` and the HTTP check share."""
        if p.min_tokens <= 0:
            return []
        stop: list[int] = []
        if not p.ignore_eos:
            stop += list(self.cfg.eos_token_ids)
            stop += list(self.tokenizer.eos_token_ids)
        stop += list(p.stop_token_ids)
        return list(dict.fromkeys(stop))

    def add_request(self, request: Request) -> None:
        """Queue a request (any thread).  A bad request raises ValueError
        here, on the caller's thread: an oversized min_tokens suppress
        set, a malformed guide pattern (GuideError), max_tokens < 1, a
        negative priority (the fair queue's urgent lane, which skips its
        bounds, is the engine's own).  A guide's compile starts on the
        compiler's workers; the scheduler parks the request until it
        publishes."""
        p = request.params
        sampler_mod.np_suppress_col(self.min_tokens_suppress_ids(p))
        if p.max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        if p.priority < 0:
            raise ValueError("priority must be >= 0")
        if p.guide is not None:
            if self.guides.lookup(*p.guide) is None:
                self.guides.validate(*p.guide)
            self.guides.ensure(*p.guide)
            self.metrics.guided_requests_total.inc(1, kind=p.guide[0])
        with self._abort_lock:
            self._queue_seq += 1
            seq = self._queue_seq
        try:
            # Bounded: a full queue (or tenant lane) refuses here, on the
            # caller's thread, with a drain-rate Retry-After.
            self._queue.put((p.priority, seq, request), bounded=True)
        except fairqueue.QueueFullError as e:
            self.metrics.requests_shed_total.inc(
                1, reason="queue_full" if e.scope == "queue" else
                "tenant_cap", tier=self._slo.tier_of(p.priority),
                tenant=self._tenant_labels.label(request.tenant))
            raise
        self._update_waiting()

    def saturation(self) -> dict:
        """The admission queue's overload signal (depth, caps, waiting
        tenants, drain rate, 0-1 saturation): ``/readiness`` and the shed
        responses' ``x-arks-saturation`` header."""
        return self._queue.saturation()

    def queue_retry_after(self) -> int:
        """Drain-rate-derived backoff (seconds) for shed responses."""
        return self._queue.retry_after()

    def slo_burn(self) -> dict:
        """Per-tier SLO burn over ``ARKS_SLO_BURN_WINDOW_S``: the share of
        first tokens that missed the tier's ttft_ms target, divided by
        ``ARKS_SLO_ERROR_BUDGET`` (1.0 = burning at budget).  Any thread."""
        cutoff = time.monotonic() - self._slo_burn_window_s
        out: dict[str, float] = {}
        for name, ev in list(self._slo_events.items()):
            recent = [v for (t, v) in ev[-1024:] if t >= cutoff]
            if recent:
                out[name] = round(sum(recent) / len(recent)
                                  / self._slo_error_budget, 4)
        return out

    def _slo_burn_record(self, priority: int, ttft_s: float) -> None:
        """One first-token sample for the burn tracker (engine thread;
        tiers without a ttft_ms target record nothing)."""
        if not self._slo:
            return
        name = self._slo.tier_of(priority)
        tier = self._slo.get(name)
        if tier is None or not tier.ttft_ms:
            return
        ev = self._slo_events.setdefault(name, [])
        ev.append((time.monotonic(), ttft_s * 1000.0 > tier.ttft_ms))
        if len(ev) > 1024:
            del ev[:len(ev) - 512]

    def _shed_due(self, req: Request) -> bool:
        """Deadline shedding (``ARKS_SHED_DEADLINE``): the popped request
        waited longer than the factor times its tier's ttft_ms budget."""
        if not self._shed_deadline_factor or not self._slo:
            return False
        tier = self._slo.get(self._slo.tier_of(req.params.priority))
        if tier is None or not tier.ttft_ms:
            return False
        budget_s = tier.ttft_ms / 1000.0 * self._shed_deadline_factor
        return (time.monotonic() - req.arrival_time) > budget_s

    def _queue_age_tick(self) -> None:
        """Queue aging (``ARKS_QUEUE_AGING_S``): queued entries climb one
        tier per window (inside the fair queue, per tenant), throttled to
        a fraction of the window."""
        if not self._queue_aging_s:
            return
        now = time.monotonic()
        if now - self._queue_age_last < min(1.0, self._queue_aging_s / 4):
            return
        self._queue_age_last = now
        self._queue.age_tick(now, self._queue_aging_s)

    def _update_waiting(self) -> None:
        """The queue gauges, set from the queue and the park lists (one
        setter instead of increments on every path; any thread)."""
        m = self.metrics
        m.admission_queue_depth.set(self._queue.qsize())
        guide, restore = len(self._awaiting_guide), len(self._awaiting_restore)
        m.num_requests_waiting.set(self._queue.qsize() + guide + restore)
        m.requests_parked.set(guide, reason="guide")
        m.requests_parked.set(restore, reason="restore")

    def abort(self, request_id: str) -> None:
        """Free the request's slot at the next scheduler boundary."""
        with self._abort_lock:
            self._aborted.add(request_id)

    def start(self) -> None:
        self._running = True
        self._thread = threading.Thread(target=self._run, name="engine",
                                         daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=120.0)
            if self._thread.is_alive():
                log.warning("engine thread did not exit within 120s")

    @property
    def num_running(self) -> int:
        """Registered, prefilling and deferred-admission requests."""
        return len(self._slots) + len(self._prefilling) + self._pending_n

    @property
    def idle(self) -> bool:
        return (not self._slots and not self._prefilling
                and not self._pending_admits and not self._pipe_inflight
                and self._pipe_state is None
                and not self._awaiting_guide and not self._awaiting_restore
                and self._queue.empty())

    @property
    def serving(self) -> bool:
        """The step loop runs (started, not stopped, its thread alive)."""
        return (self._running and self._thread is not None
                and self._thread.is_alive())

    def _run(self) -> None:
        try:
            while self._running:
                try:
                    self.step()
                    self.warm = True
                except Exception as e:  # the loop must outlive one bad step
                    log.exception("engine step failed")
                    self._fail_all(f"engine_fault: {type(e).__name__}: {e}")
        finally:
            # No scheduler remains to unpark or register them.
            self._abort_awaiting_guide()
            self._abort_pending_admits()
            self._abort_awaiting_restores()

    def _fail_all(self, error: str) -> None:
        """After a failed step: drop the in-flight pipelined dispatches,
        end every in-flight request with an error and return its slot (the
        reference's fault recovery and replay are a later slice)."""
        self._pipe_reset()
        self._abort_pending_admits()
        self._abort_awaiting_restores(error)
        for slot in list(self._slots):
            st = self._slots.pop(slot)
            self._release_slot(slot, st.request)
            st.request.outputs.put(RequestOutput(
                request_id=st.request.request_id, token_ids=[],
                finished=True, finish_reason="error", error=error,
                num_prompt_tokens=st.num_prompt))
            self.metrics.request_success_total.inc(reason="error")
        for slot in list(self._prefilling):
            cs = self._prefilling.pop(slot)
            self._release_slot(slot, cs.request)
            cs.request.outputs.put(RequestOutput(
                request_id=cs.request.request_id, token_ids=[],
                finished=True, finish_reason="error", error=error,
                num_prompt_tokens=len(cs.ids)))
            self.metrics.request_success_total.inc(reason="error")
        self.metrics.num_requests_running.set(len(self._slots))

    # ------------------------------------------------------------------
    # Scheduler
    # ------------------------------------------------------------------

    def step(self, block_s: float = 0.05) -> bool:
        """One scheduler iteration; returns True if any work was done.

        First, on either scheduler: new guide tables go to the device, and
        requests parked on a guide compile move on (re-queued once it
        published, failed if it failed).  Then, in the reference's order:
        - steady state with ``ARKS_PIPELINE_DEPTH`` > 0: ONE pipelined
          dispatch, resolving the oldest in flight once the pipeline is
          full (``_step_pipelined``);
        - otherwise, with dispatches in flight: resolve them all first, so
          the host mirrors are exact before anything changes them;
        - steady state at depth 0 on a mixed engine with
          ``ARKS_SAMPLER_FUSE``: the pipe program resolved at once;
        - mixed: issue ONE mixed dispatch, admit waiting requests while it
          runs, then fan its tokens out;
        - legacy: with the overlap on, issue the K-step decode dispatch,
          admit and advance one prefill chunk while it runs, then resolve
          it; with it off admit, chunk, then decode;
        - then read the deferred admissions whose first tokens landed (the
          oldest even if it has not, when nothing else moved).
        Before the mixed or legacy step, host-tier restores that landed
        continue into the chunked path and landed spills enter the host
        tier.  Each phase's wall seconds go to ``scheduler_seconds_total``
        under the reference's phase names."""
        sec = self.metrics.scheduler_seconds_total
        t0 = time.monotonic()
        self._ensure_guides_uploaded()
        worked = False
        if self._awaiting_guide:
            worked = self._service_awaiting_guides()
            tg = time.monotonic()
            sec.inc(tg - t0, phase="guide_wait")
            t0 = tg
        if self._pipe_ready():
            self._step_pipelined()
            sec.inc(time.monotonic() - t0, phase="decode")
            return True
        if self._pipe_inflight or self._pipe_state is not None:
            self._pipe_drain()
            worked = True
            td = time.monotonic()
            sec.inc(td - t0, phase="decode")
            t0 = td
        if self._fuse_ready():
            self._step_fused()
            sec.inc(time.monotonic() - t0, phase="mixed")
            return True
        if self._awaiting_restore:
            # Restores whose scatter landed continue into the chunked path
            # (on exact host mirrors: the pipeline drained above).
            worked = self._resolve_restores() or worked
            tr = time.monotonic()
            sec.inc(tr - t0, phase="restore")
            t0 = tr
        if self._spills:
            worked = self._resolve_spills() or worked
        self._queue_age_tick()
        if self._mixed:
            rec = None
            if self._slots or self._prefilling:
                rec = self._issue_mixed()
            t1 = time.monotonic()
            if rec is not None:
                sec.inc(t1 - t0, phase="mixed")
            worked = self._admit() or worked
            t2 = time.monotonic()
            if t2 - t1 > 1e-4:
                sec.inc(t2 - t1, phase="admit")
            if rec is not None:
                self._resolve_mixed(rec, exclude_s=t2 - t1)
                sec.inc(time.monotonic() - t2, phase="mixed")
                worked = True
        else:
            pending = None
            issued = False
            if self._slots and self._overlap:
                # May retire or abort every slot and issue nothing.
                pending = self._issue_decode()
                issued = True
            t1 = time.monotonic()
            if issued:
                sec.inc(t1 - t0, phase="decode")
            worked = self._admit() or worked or issued
            t2 = time.monotonic()
            if t2 - t1 > 1e-4:
                sec.inc(t2 - t1, phase="admit")
            if self._prefilling:
                self._process_chunk()
                t3 = time.monotonic()
                sec.inc(t3 - t2, phase="chunk")
                t2 = t3
                worked = True
            if pending is not None:
                self._resolve_decode(pending, exclude_s=t2 - t1)
                sec.inc(time.monotonic() - t2, phase="decode")
            elif self._slots and not self._overlap:
                self._decode_dispatch()
                sec.inc(time.monotonic() - t2, phase="decode")
                worked = True
        if self._pending_admits:
            t4 = time.monotonic()
            worked = self._drain_ready_admits(force_one=not worked) or worked
            sec.inc(time.monotonic() - t4, phase="admit")
        self._update_waiting()
        if worked:
            return True
        if self._awaiting_restore or self._spills:
            # They land on device time, not on queue arrivals: poll again.
            time.sleep(0.001)
            return True
        self._purge_stale_aborts()
        try:
            _, _, req = self._queue.get(timeout=block_s)
        except queue.Empty:
            return False
        pre = self._preadmit(req)
        if pre is not None:
            self._resolve_admit_batch(self._issue_admit_batch([pre]))
        self._update_waiting()
        return True

    def _park_sentinel(self) -> int:
        """Write-drop position for parked slots: the kernels drop K/V
        writes at/beyond it (the table coverage of a paged pool, the cache
        length of the slot cache), and the decode loop's active mask
        freezes keys there."""
        if self._paged:
            return self._max_pages * self._page
        return self.ecfg.max_cache_len

    def _resolve_seed(self, req: Request) -> int:
        if req.params.seed is not None:
            return req.params.seed
        if req.assigned_seed is None:
            self._request_seed += 1
            req.assigned_seed = self._request_seed
        return req.assigned_seed

    def _admit(self) -> bool:
        """Admit waiting requests while slots are free.  Chunked prompts
        take their slot at once; one-shot prompts (legacy) are grouped by
        bucket and issued in batches of ``admit_batch_sizes``, whose first
        tokens are read later (deferred: ``_drain_ready_admits``), so the
        engine thread never waits on an admission's copy while it could
        be issuing decode work."""
        admitted = False
        groups: dict[int, list] = {}
        while self._free:
            # Requests parked on a restore hold pages for a slot they have
            # yet to take: they count against the free slots.
            if sum(len(v) for v in groups.values()) + \
                    len(self._awaiting_restore) >= len(self._free):
                break
            try:
                _, _, req = self._queue.get_nowait()
            except queue.Empty:
                break
            admitted = True
            pre = self._preadmit(req)
            if pre is not None:
                groups.setdefault(pre[2].shape[1], []).append(pre)
        for items in groups.values():
            while items:
                m = next(x for x in self._admit_sizes if x <= len(items))
                rec = self._issue_admit_batch(items[:m])
                del items[:m]
                self._pending_admits.append(rec)
                self._pending_n += len(rec[0])
        if self._pending_admits:
            self._drain_ready_admits()
        return admitted

    def _drain_ready_admits(self, force_one: bool = False) -> bool:
        """Resolve the deferred admission batches whose first tokens have
        landed, oldest first (emission order = issue order); with
        ``force_one`` the oldest even if it has not (the idle path: a
        pending admission must never starve behind an empty queue).
        Returns True if any resolved."""
        did = False
        while self._pending_admits:
            rec = self._pending_admits[0]
            if not (force_one and not did) and not rec[2].ready():
                break
            self._pending_admits.popleft()
            self._pending_n -= len(rec[0])
            self._resolve_admit_batch(rec)
            did = True
        return did

    def _abort_pending_admits(self) -> None:
        """End every deferred admission (engine exit, a failed step): its
        requests hold slots and pages but are registered nowhere else."""
        while self._pending_admits:
            items, slots, *_ = self._pending_admits.popleft()
            self._pending_n -= len(items)
            for (req, ids, _), slot in zip(items, slots):
                self._release_slot(slot, req)
                req.outputs.put(RequestOutput(
                    request_id=req.request_id, token_ids=[], finished=True,
                    finish_reason="abort", num_prompt_tokens=len(ids)))

    def _preadmit(self, req: Request):
        """Aborts and rejects; prefix hits, host-tier restores and chunked
        prompts start here.  Returns (req, ids, padded [1, bucket]) for a
        one-shot prompt, else None."""
        with self._abort_lock:
            if req.request_id in self._aborted:
                self._aborted.discard(req.request_id)
                self._unpin_guide(req)
                req.outputs.put(RequestOutput(
                    request_id=req.request_id, token_ids=[], finished=True,
                    finish_reason="abort"))
                return None
        if self._shed_due(req):
            # The queue wait already spent the tier's TTFT budget (times
            # ARKS_SHED_DEADLINE): prefill would serve a stream its client
            # has written off.  The server answers 503 + Retry-After.
            waited = time.monotonic() - req.arrival_time
            tier = self._slo.tier_of(req.params.priority)
            self._unpin_guide(req)
            self.metrics.requests_shed_total.inc(
                1, reason="deadline", tier=tier,
                tenant=self._tenant_labels.label(req.tenant))
            req.outputs.put(RequestOutput(
                request_id=req.request_id, token_ids=[], finished=True,
                finish_reason="error",
                error=(f"shed_deadline: queued {waited:.2f}s, tier {tier} "
                       "ttft budget already unmeetable"),
                num_prompt_tokens=len(req.prompt_ids)))
            return None
        ids = list(req.prompt_ids)
        if not ids or len(ids) > self.max_prompt_len:
            self._unpin_guide(req)
            req.outputs.put(RequestOutput(
                request_id=req.request_id, token_ids=[], finished=True,
                finish_reason="error", error="context_length_exceeded",
                num_prompt_tokens=len(ids)))
            log.info("rejected %s: prompt of %d tokens (limit %d)",
                     req.request_id, len(ids), self.max_prompt_len)
            return None
        if req.params.guide is not None:
            # Park while the guide compiles; fail on a compile error; PIN
            # the published guide for the request's life, so eviction
            # cannot repack the rows its slot decodes against.
            gate = self._gate_guide(req)
            if gate == "park":
                return None
            if gate is not None:
                req.outputs.put(RequestOutput(
                    request_id=req.request_id, token_ids=[], finished=True,
                    finish_reason="error",
                    error=f"guide_compile_failed: {gate}",
                    num_prompt_tokens=len(ids)))
                log.info("rejected %s: guide compile failed: %s",
                         req.request_id, gate)
                return None
        if self._prefix_hit(req, ids):
            return None
        if self._mixed or len(ids) > self._one_shot_limit():
            self._start_chunked(req, ids)
            return None
        return req, ids, self._pad_to_bucket(ids)

    def _prefix_hit(self, req: Request, ids: list[int]) -> bool:
        """Prefix reuse at admission (the reference's ``_preadmit``).  A
        paged pool matches the prompt's chained page digests against the
        device index, then the consecutive blocks after them against the
        host tier: a host hit parks the request on a restore, a device hit
        starts it chunked after its shared pages.  The slot cache matches
        its host prefix cache.  At least one tail token is always left to
        compute (its logits sample the first token).  Returns True when
        the request was started or parked here."""
        page = self._page
        if self._paged:
            nfull = (len(ids) - 1) // page
            digests = chain_digests(ids, page, nfull) if nfull else []
            shared = self._alloc.match(digests)
            blocks = []
            if self._host is not None and len(shared) < nfull:
                blocks = self._host.match_blocks(digests, len(shared))
            plen, hlen = len(shared) * page, len(blocks) * page
            self._alloc.record_query(len(ids), plen + hlen)
            self._count_prefix(len(ids), plen, hlen, self._alloc.hit_rate)
            if blocks:
                self._issue_restore(req, ids, digests, shared, blocks)
                return True
            if plen:
                self._start_chunked(req, ids, prefix_len=plen,
                                    prefix_pages=shared, digests=digests)
                return True
            return False
        if self._prefix is None:
            return False
        plen = min(self._prefix.match(ids), (len(ids) - 1) // page * page)
        self._prefix.record_query(len(ids), plen)
        self._count_prefix(len(ids), 0, plen, self._prefix.hit_rate)
        if plen:
            self._start_chunked(req, ids, prefix_len=plen)
        return bool(plen)

    def _count_prefix(self, n: int, device: int, host: int,
                      hit_rate: float) -> None:
        m = self.metrics
        m.prefix_cache_query_tokens_total.inc(n)
        if device:
            m.prefix_cache_hit_tokens_total.inc(device, tier="device")
        if host or not self._paged:
            # The slot cache's prefix cache counts as the host tier, zero
            # hits included (the reference's accounting).
            m.prefix_cache_hit_tokens_total.inc(host, tier="host")
        m.prefix_cache_hit_rate.set(hit_rate)

    def _one_shot_limit(self) -> int:
        return min(self._buckets[-1], self.max_prompt_len)

    def _pad_to_bucket(self, ids: list[int]) -> np.ndarray:
        """[1, bucket] zero-padded prompt at the smallest covering bucket."""
        bucket = next(b for b in self._buckets if b >= len(ids))
        padded = np.zeros((1, bucket), np.int32)
        padded[0, : len(ids)] = ids
        return padded

    def _assign_slot_pages(self, slot: int, total: int,
                           head_pages=()) -> np.ndarray:
        """Give a slot its first ``total`` pages, headed by ``head_pages``
        (shared prefix pages whose references the caller holds), and write
        its zero-padded table row (returned): the one place of the
        row/ownership invariant.  Pages the allocation evicted from the
        device index spill before any later dispatch can write them."""
        pages = list(head_pages) + self._alloc.alloc(total - len(head_pages))
        self._slot_pages[slot] = pages
        self._tables[slot] = 0
        self._tables[slot, :total] = pages
        self._spill_flush()
        return self._tables[slot]

    def _start_chunked(self, req: Request, ids: list[int],
                       prefix_len: int = 0, prefix_pages=None,
                       digests=None) -> None:
        """Reserve a slot and start the prompt's chunked prefill at
        ``prefix_len``: after the shared ``prefix_pages`` heading its table
        (a paged pool), or after the host prefix cache's blocks inserted
        into the slot (the slot cache)."""
        seed = self._resolve_seed(req)
        slot = self._free.pop()
        if self._paged:
            # Pages cover [0, len + K - 1] from the start: the legacy decode
            # loop writes this slot's garbage rows at len..len+K-1 while it
            # chunk-prefills, and they must land in pages it owns.
            self._assign_slot_pages(slot, pages_needed(
                len(ids), self.ecfg.steps_per_dispatch, self._page,
                self._max_pages), head_pages=prefix_pages or ())
        elif prefix_len:
            # Exactly the prefix's rows: eager PyTorch has no compiled
            # insert shapes to bound (the reference pads to a bucket).
            k, v = self._prefix.get(ids, prefix_len)
            tf.insert(self.cache, self._upload_tensor(k),
                      self._upload_tensor(v), slot)
        self._prefilling[slot] = _ChunkState(request=req, ids=ids,
                                             pos=prefix_len,
                                             key=prng.np_prng_key(seed),
                                             digests=digests)
        # Length parked at the prompt's end: interleaved decode writes land
        # past every masked read until real decode overwrites them.
        self._lengths[slot] = len(ids)
        self._last_token[slot] = 0

    def _purge_stale_aborts(self, consumed=()) -> None:
        live = {st.request.request_id for st in self._slots.values()}
        live |= {cs.request.request_id for cs in self._prefilling.values()}
        live |= {req.request_id for req, _ in self._awaiting_guide}
        live |= {req.request_id for rec in self._pending_admits
                 for req, _, _ in rec[0]}
        live |= {rec.request.request_id for rec in self._awaiting_restore}
        with self._abort_lock:
            self._aborted -= set(consumed)
            if not live and self._queue.empty():
                self._aborted.clear()

    def _abort_prefill(self, slot: int) -> None:
        st = self._prefilling.pop(slot)
        self._release_slot(slot, st.request)
        st.request.outputs.put(RequestOutput(
            request_id=st.request.request_id, token_ids=[], finished=True,
            finish_reason="abort", num_prompt_tokens=len(st.ids)))

    def _abort_and_retire(self, headroom: int) -> None:
        """Honor aborts of decoding sequences (and, mixed, of prefilling
        ones), and retire slots whose next ``headroom`` rows would overflow
        the cache."""
        with self._abort_lock:
            aborted = set(self._aborted)
        consumed = set()
        for slot in list(self._slots):
            rid = self._slots[slot].request.request_id
            if rid in aborted:
                self._finish(slot, "abort")
                consumed.add(rid)
        if self._mixed:
            for slot, st in list(self._prefilling.items()):
                if st.request.request_id in aborted:
                    self._abort_prefill(slot)
                    consumed.add(st.request.request_id)
        self._purge_stale_aborts(consumed)
        for slot in list(self._slots):
            if int(self._lengths[slot]) + headroom > self.ecfg.max_cache_len:
                self._finish(slot, "length")

    def _grow_slot_pages(self, rows: int, ahead: int = 0) -> None:
        """Extend every decoding slot's table to cover the ``rows`` rows
        its next dispatch writes, and those of the ``ahead`` dispatches
        already in flight (the host's lengths lag them).  The pool holds
        every slot's full table, so the allocation cannot fail."""
        rows *= ahead + 1
        for slot in self._slots:
            need = pages_needed(int(self._lengths[slot]), rows, self._page,
                                self._max_pages)
            row = self._slot_pages[slot]
            if len(row) < need:
                new = self._alloc.alloc(need - len(row))
                self._tables[slot, len(row): len(row) + len(new)] = new
                row.extend(new)
        self._spill_flush()

    def _set_slots(self, slots: list[int], params: list, keys: torch.Tensor,
                   num_prompts: list[int], guide_rows) -> None:
        """Write the slots' sampling rows: their request parameters, their
        decode keys ``keys`` [M, 2], and for requests that shape their
        logits the penalty, bias, min_tokens and guide columns (the guide
        rows [M], host or device, already advanced by the first token)."""
        temp = np.array([p.temperature for p in params], np.float32)
        top_p = np.array([p.top_p for p in params], np.float32)
        top_k = np.array([p.top_k for p in params], np.int32)
        if not any(_shapes(p) for p in params):
            self._sampling = sampler_mod.set_slots(
                self._sampling, slots, temp, top_p, top_k, keys,
                shaping=False)
            return
        c = self._shaping_cols(params, num_prompts)
        self._sampling = sampler_mod.set_slots(
            self._sampling, slots, temp, top_p, top_k, keys,
            np.array([p.presence_penalty for p in params], np.float32),
            np.array([p.frequency_penalty for p in params], np.float32),
            c["bias_ids"], c["bias_vals"], c["suppress_ids"], c["min_until"],
            c["guide"], guide_rows)

    # ------------------------------------------------------------------
    # Request-level shaping: columns, logprobs, guides
    # ------------------------------------------------------------------

    @staticmethod
    def _lp_entry(clp, vals, lids, n: int):
        """(chosen_logprob, [(token_id, logprob) x min(n, MAX)]) from one
        lane's host copy of ``top_logprobs``."""
        n = min(n, sampler_mod.TOP_LOGPROBS_MAX)
        return (float(clp),
                [(int(lids[i]), float(vals[i])) for i in range(n)])

    def _shaping_cols(self, params: list, num_prompts=None) -> dict:
        """Host-side shaping columns of M requests (a None entry gets the
        identity row): bias_ids/bias_vals [M, NB], suppress_ids [M, NS],
        min_first [M] (the first-token flag: min_tokens >= 1), min_until
        [M] (the sequence length below which the decode loops suppress:
        the token sampled at length L is generated token
        L - num_prompt + 2; needs ``num_prompts``), guide and guide_row
        [M] (the guide's id and start row)."""
        m = len(params)
        c = dict(
            bias_ids=np.full((m, sampler_mod.LOGIT_BIAS_MAX), -1, np.int32),
            bias_vals=np.zeros((m, sampler_mod.LOGIT_BIAS_MAX), np.float32),
            suppress_ids=np.full((m, sampler_mod.SUPPRESS_MAX), -1, np.int32),
            min_first=np.zeros((m,), np.int32),
            min_until=np.zeros((m,), np.int32),
            guide=np.full((m,), -1, np.int32),
            guide_row=np.zeros((m,), np.int32))
        for i, p in enumerate(params):
            if p is None:
                continue
            if p.logit_bias or p.min_tokens:
                c["bias_ids"][i], c["bias_vals"][i] = \
                    sampler_mod.np_bias_cols(p, self.cfg.vocab_size)
                c["suppress_ids"][i] = sampler_mod.np_suppress_col(
                    self.min_tokens_suppress_ids(p))
            if p.min_tokens > 0:
                c["min_first"][i] = 1
                if num_prompts is not None:
                    c["min_until"][i] = num_prompts[i] + p.min_tokens - 1
            c["guide"][i], c["guide_row"][i] = self._guide_cols(p)
        return c

    def _first_state(self, params: list, keys: torch.Tensor,
                     gates: sampler_mod.Gates) -> sampler_mod.SamplingState:
        """The transient state that samples M first tokens (rows of
        ``params``, keys [M, 2]).  Columns no pass of ``gates`` reads are
        left out (None)."""
        dev = self.device
        temp = torch.tensor([p.temperature for p in params],
                            dtype=torch.float32, device=dev)
        top_p = torch.tensor([p.top_p for p in params], dtype=torch.float32,
                             device=dev)
        top_k = torch.tensor([p.top_k for p in params], dtype=torch.int32,
                             device=dev)
        if not (gates.bias or gates.min_tokens or gates.guide):
            return sampler_mod.SamplingState(temp, top_p, top_k, keys,
                                             *([None] * 9))
        c = self._shaping_cols(params)
        return sampler_mod.transient_state_batch(
            temp, top_p, top_k, keys, self.cfg.vocab_size, **{
                k: torch.from_numpy(c[k]).to(dev) for k in (
                    "bias_ids", "bias_vals", "suppress_ids", "min_first",
                    "guide", "guide_row")})

    def _ensure_guides_uploaded(self) -> None:
        """Copy the compiler's tables to the device when its version bumped
        (guides compile on other threads; only this copy runs here)."""
        if self._guide_ver == self.guides.version:
            return
        cls_host, trans_host, ver = self.guides.snapshot()
        self._guide_dev[0].copy_(torch.from_numpy(cls_host))
        self._guide_dev[1].copy_(torch.from_numpy(trans_host))
        self._guide_ver = ver

    def _gate_guide(self, req: Request) -> str | None:
        """Resolve a guided request's guide at admission: None = published
        and PINNED (proceed), "park" = parked on the in-flight compile,
        any other string = the compile's error.  Never blocks."""
        if req.request_id in self._guide_pins:
            return None
        for _ in range(3):
            got = self.guides.ensure(*req.params.guide)
            if isinstance(got, Guide):
                try:
                    self._pin_guide(req)
                    return None
                except GuideError:
                    # Evicted between publish and pin: re-kick and retry.
                    continue
            if got.event.is_set() and got.error is not None:
                return got.error
            self._awaiting_guide.append((req, got))
            return "park"
        return "guide evicted repeatedly during admission"

    def _service_awaiting_guides(self) -> bool:
        """Move the parked requests on: aborted ones end, failed compiles
        end with an error, published guides send their requests back to
        the admission queue.  Returns True when any moved."""
        did = False
        still: list = []
        for req, ticket in self._awaiting_guide:
            with self._abort_lock:
                was_aborted = req.request_id in self._aborted
                self._aborted.discard(req.request_id)
            if was_aborted:
                req.outputs.put(RequestOutput(
                    request_id=req.request_id, token_ids=[], finished=True,
                    finish_reason="abort",
                    num_prompt_tokens=len(req.prompt_ids)))
                did = True
                continue
            if not ticket.event.is_set():
                still.append((req, ticket))
                continue
            did = True
            if ticket.error is not None:
                req.outputs.put(RequestOutput(
                    request_id=req.request_id, token_ids=[], finished=True,
                    finish_reason="error",
                    error=f"guide_compile_failed: {ticket.error}",
                    num_prompt_tokens=len(req.prompt_ids)))
                log.info("rejected %s: guide compile failed: %s",
                         req.request_id, ticket.error)
                continue
            self._requeue(req)
        self._awaiting_guide = still
        return did

    def _requeue(self, req: Request) -> None:
        with self._abort_lock:
            self._queue_seq += 1
            seq = self._queue_seq
        self._queue.put((req.params.priority, seq, req))

    def _requeue_awaiting_guide(self) -> None:
        """Send every guide-parked request back to the admission queue,
        where it re-ensures its guide: for a rebuild of the compiler (a
        context switch or resize) that drops the tickets they wait on."""
        for req, _ticket in self._awaiting_guide:
            self._requeue(req)
        self._awaiting_guide = []

    def _abort_awaiting_guide(self) -> None:
        """End every request parked on a guide compile (engine exit)."""
        for req, _ in self._awaiting_guide:
            req.outputs.put(RequestOutput(
                request_id=req.request_id, token_ids=[], finished=True,
                finish_reason="abort",
                num_prompt_tokens=len(req.prompt_ids)))
        self._awaiting_guide = []

    def _pin_guide(self, req: Request) -> None:
        """Refcount the request's guide (once per request): a pinned guide
        is never evicted, so its absolute rows stay valid until the
        request ends."""
        if req.params.guide is None or req.request_id in self._guide_pins:
            return
        self.guides.acquire(*req.params.guide)
        self._guide_pins[req.request_id] = req.params.guide

    def _unpin_guide(self, req: Request) -> None:
        """Release the request's pin (no-op when it holds none): on every
        path that ends a request."""
        key = self._guide_pins.pop(req.request_id, None)
        if key is not None:
            self.guides.release(*key)

    def _guide_cols(self, p) -> tuple[int, int]:
        """(guide_id, start_row) of a request's guide, (-1, 0) unguided.
        Admission reaches here only after ``_gate_guide`` pinned the
        guide, so a miss means the pin discipline broke."""
        if p.guide is None:
            return -1, 0
        g = self.guides.lookup(*p.guide)
        if g is None:
            raise GuideError(f"guide {p.guide[0]}:{p.guide[1]!r} is not "
                             "registered (evicted without a pin?)")
        return g.guide_id, g.start_row

    # ------------------------------------------------------------------
    # Legacy scheduler: one-shot admission, chunks, K-step decode
    # ------------------------------------------------------------------

    def _issue_admit_batch(self, items: list):
        """Issue the admission of one-shot prompts of one bucket in one go
        (the reference's fused ``admit_batch``): prefill, first-token
        sample with each request's key, the cache insert and the slots'
        sampling rows with the decode keys fold_in(key, 1) and the guide
        rows their first tokens advance to, all on the device; the first
        tokens start their copy to the host.  The slots stay parked (their
        rows in any decode dispatch before ``_resolve_admit_batch`` are
        dropped).  Returns the record for ``_resolve_admit_batch``."""
        m = len(items)
        dev = self.device
        slots: list[int] = []
        keys = np.zeros((m, 2), np.uint32)
        n_pages = np.zeros((m,), np.int32)
        pages = np.zeros((m, max(self._max_pages, 1)), np.int32)
        for i, (req, ids, _) in enumerate(items):
            keys[i] = prng.np_prng_key(self._resolve_seed(req))
            slot = self._free.pop()
            slots.append(slot)
            self._lengths[slot] = self._park_sentinel()
            if self._paged:
                n_pages[i] = -(-len(ids) // self._page)
                pages[i] = self._assign_slot_pages(slot, int(n_pages[i]))
        tokens = torch.from_numpy(np.concatenate([p for _, _, p in items])
                                  ).to(dev)
        lengths = torch.tensor([len(ids) for _, ids, _ in items],
                               dtype=torch.int32, device=dev)
        params = [req.params for req, _, _ in items]
        logits, ks, vs = tf.prefill(self.params, self.cfg, tokens, lengths)
        key_t = prng.key_tensor(keys, dev)
        firsts, lp, rows = self._sample_first(logits, params, key_t)
        if self._paged:
            tf.insert_pages_batch(self.cache, ks, vs, pages, n_pages)
        else:
            tf.insert_batch(self.cache, ks, vs, slots)
        self._set_slots(slots, params, prng.fold_in(key_t, 1),
                        [len(ids) for _, ids, _ in items], rows)
        self.prefill_tokens_total += sum(len(ids) for _, ids, _ in items)
        # Only the slot cache's single-prompt harvest reads the prompt's
        # K/V at resolve; anything else would hold them for nothing.
        kv = (ks, vs) if self._prefix is not None and m == 1 else None
        return items, slots, _HostCopy(firsts, lp, self._host_bufs), kv

    def _resolve_admit_batch(self, rec) -> None:
        """Read an admission batch's first tokens and register its slots;
        a request aborted since the issue frees its slot instead.  Each
        registered prompt's full pages enter the device index (a paged
        pool), or a lone prompt's full blocks the host prefix cache (the
        slot cache), unless requests are waiting: the copy to the host
        would hold them up."""
        items, slots, copy, kv = rec
        firsts, lp_h = copy.result()
        for i, ((req, ids, _), slot) in enumerate(zip(items, slots)):
            with self._abort_lock:
                aborted = req.request_id in self._aborted
                self._aborted.discard(req.request_id)
            if aborted:
                self._release_slot(slot, req)
                req.outputs.put(RequestOutput(
                    request_id=req.request_id, token_ids=[], finished=True,
                    finish_reason="abort", num_prompt_tokens=len(ids)))
                continue
            self._register_slot(req, slot, int(firsts[i]), len(ids),
                                self._first_lp(req.params, lp_h, i))
            if self._paged:
                self._register_prompt_pages(ids,
                                            self._slot_pages.get(slot, []))
            elif kv is not None and self._queue.empty():
                self._harvest(ids, lambda: kv)

    def _sample_first(self, logits: torch.Tensor, params: list,
                      keys: torch.Tensor):
        """First tokens of prompts whose last logits are ``logits``
        [M, V], each drawn with its request's key (the reference's
        transient sampling state; the keys are not carried) and shaped by
        its bias, min_tokens and guide, on the device.  Returns (ids [M],
        None | their logprob data, the guide rows the tokens advance to
        [M])."""
        gates = _lane_gates(params)
        if gates.guide:
            self._ensure_guides_uploaded()
        state = self._first_state(params, keys, gates)
        ids, state = sampler_mod.sample(
            logits, state, guide_tables=self._guide_dev if gates.guide
            else None, gates=gates)
        lp = sampler_mod.top_logprobs(logits, ids) \
            if any(p.logprobs is not None for p in params) else None
        rows = state.guide_row if gates.guide else np.zeros(
            (len(params),), np.int32)
        return ids, lp, rows

    def _first_lp(self, p, lp_h, i: int):
        """Lane ``i``'s logprob entry from a host copy of a step's logprob
        data; None unless its request (params ``p``) asked for them."""
        if lp_h is None or p.logprobs is None:
            return None
        return self._lp_entry(lp_h[0][i], lp_h[1][i], lp_h[2][i], p.logprobs)

    def _process_chunk(self) -> None:
        """Advance the oldest prefilling prompt by one chunk; on its last
        chunk sample the first token and promote the slot to decoding."""
        slot, st = next(iter(self._prefilling.items()))
        with self._abort_lock:
            aborted = st.request.request_id in self._aborted
            self._aborted.discard(st.request.request_id)
        if aborted:
            self._abort_prefill(slot)
            return
        c = self._page
        chunk = st.ids[st.pos: st.pos + c]
        valid = len(chunk)
        self.prefill_tokens_total += valid
        padded = np.zeros((c,), np.int32)
        padded[:valid] = chunk
        dev = self.device
        tokens = torch.from_numpy(padded).to(dev)
        if self._paged:
            row = torch.from_numpy(self._tables[slot].copy()).to(dev)
            logits = tf.prefill_chunk_paged(self.params, self.cfg, self.cache,
                                            row, tokens, st.pos, valid)
        else:
            logits = tf.prefill_chunk(self.params, self.cfg, self.cache,
                                      slot, tokens, st.pos, valid)
        st.pos += valid
        if st.pos < len(st.ids):
            return
        key = prng.key_tensor(st.key[None], dev)
        p = st.request.params
        first, lp, rows = self._sample_first(logits, [p], key)
        first_h, lp_h = _to_host(first, lp)
        del self._prefilling[slot]
        self._set_slots([slot], [p], prng.fold_in(key, 1), [len(st.ids)],
                        rows)
        self._register_slot(st.request, slot, int(first_h[0]), len(st.ids),
                            self._first_lp(p, lp_h, 0))
        if self._paged:
            self._register_prompt_pages(st.ids, self._slot_pages.get(slot, []),
                                        st.digests)
        elif self._prefix is not None and self._queue.empty():
            # The chunked prompt's K/V exist only in its slot: read its full
            # blocks back before decode grows past them.
            self._harvest(st.ids, lambda: tf.extract(
                self.cache, slot, self.params["layers"]["attn_norm"].dtype))

    def _harvest(self, ids: list[int], kv) -> None:
        """Put a prompt's full blocks into the slot cache's host prefix
        cache when any is missing: ``kv()`` gives its time-major K/V [L, 1,
        >= len, Hkv, D] on the device, of which one blocking copy takes
        just those rows."""
        nfull = len(ids) // self._page * self._page
        if nfull and self._prefix.missing_blocks(ids, nfull):
            k, v = kv()
            self._prefix.put(ids, k[:, :, :nfull].cpu(),
                             v[:, :, :nfull].cpu(), nfull)
            self.metrics.prefix_cache_usage_bytes.set(
                self._prefix.bytes_used, tier="host")

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the device, taken by value now.  On a CUDA
        device a non-blocking copy from pinned memory: a pageable copy
        would wait for every kernel queued before it (a host sync)."""
        return self._upload_tensor(torch.from_numpy(np.array(a)))

    def _upload_tensor(self, t: torch.Tensor) -> torch.Tensor:
        """``_upload`` of a CPU tensor (pinned first unless it is)."""
        if self.device.type != "cuda":
            return t
        if not t.is_pinned():
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _decode_dispatch(self) -> None:
        """ONE fused K-step decode dispatch and its resolve (the
        sequential order)."""
        rec = self._issue_decode()
        if rec is not None:
            self._resolve_decode(rec)

    def _issue_decode(self):
        """Issue ONE fused K-step decode dispatch over every slot: aborted
        slots and slots whose next K rows would overflow the cache are
        freed first (pages handed to admissions during the flight are then
        never written by it), and the dispatch's slot set is taken now.
        Returns the record for ``_resolve_decode``, or None when no slot
        is left."""
        k_steps = self.ecfg.steps_per_dispatch
        self._abort_and_retire(1 + k_steps)
        if not self._slots:
            return None
        if self._paged:
            self._grow_slot_pages(k_steps)
        snapshot = list(self._slots)
        t0 = time.monotonic()
        tokens = self._upload(self._last_token)
        lengths = self._upload(self._lengths)
        tables = self._upload(self._tables) if self._paged else None
        params = [self._slots[s].request.params for s in snapshot]
        ids, lp = self._decode_loop(tokens, lengths, tables, params)
        self.decode_dispatches += 1
        self.decode_steps += k_steps
        return snapshot, _HostCopy(ids, lp, self._host_bufs), t0

    def _resolve_decode(self, rec, exclude_s: float = 0.0) -> None:
        """Read a decode dispatch's tokens (the host sync point) and fan
        them out to the slots of its snapshot.  ``exclude_s``, the
        overlapped admission's wall time, is not decode time (TPOT)."""
        snapshot, copy, t_issue = rec
        t0 = time.monotonic()
        ids_h, lp_h = copy.result()
        self.metrics.decode_resolve_wait_seconds_total.inc(
            time.monotonic() - t0, mode="sequential")
        dt = max(time.monotonic() - t_issue - exclude_s, 1e-6)
        cols = ids_h.T.tolist()
        for slot in snapshot:
            rows = None
            if lp_h is not None and \
                    self._slots[slot].request.params.logprobs is not None:
                rows = tuple(x[:, slot] for x in lp_h)
            self._fanout_decode_tokens(slot, cols[slot], rows, dt)

    def _decode_loop(self, tokens: torch.Tensor, lengths: torch.Tensor,
                     tables: torch.Tensor | None, params: list):
        """The device side of one legacy dispatch: K ``decode_step``s, each
        sampling every slot, for registered requests ``params``.  Keys
        advance (active slots only) when one of them samples; the counts,
        shaping passes and logprobs run only when one asks for them.
        Returns (ids [K, B], None | (chosen [K, B], top values and ids
        [K, B, L]))."""
        sentinel = self._park_sentinel()
        gates = _lane_gates(params, params)
        gtables = self._guide_dev if gates.guide else None
        want_lp = any(p.logprobs is not None for p in params)
        masked = gates.sampled or gates.penalties or gates.guide
        st = self._sampling
        toks, lps = [], []
        for _ in range(self.ecfg.steps_per_dispatch):
            active = lengths < sentinel if masked else None
            if gates.penalties:
                # Feed-time counting: every generated token is fed once.
                st = sampler_mod.count_tokens(st, tokens, active)
            logits = tf.decode_step(self.params, self.cfg, self.cache, tokens,
                                    lengths, tables)
            tokens, st = sampler_mod.sample(logits, st, active, lengths,
                                            gtables, gates)
            toks.append(tokens)
            if want_lp:
                lps.append(sampler_mod.top_logprobs(logits, tokens))
            lengths = lengths + 1
        self._sampling = st
        lp = tuple(torch.stack(x) for x in zip(*lps)) if want_lp else None
        return torch.stack(toks), lp

    def _fanout_decode_tokens(self, slot: int, col: list[int],
                              lp_rows=None, dt: float = 1e-6) -> None:
        """Append a dispatch's K tokens (stopping at a stop token or the
        max_tokens cutoff — the rest is overshoot no client sees) with
        their logprob entries (``lp_rows``: chosen [K], top values and ids
        [K, L]), advance the host mirrors, and finish or stream the
        delta.  ``dt``: the dispatch's seconds (TPOT = dt / K)."""
        st = self._slots[slot]
        finished = False
        new_tokens = 0
        for k, tok in enumerate(col):
            st.generated.append(tok)
            new_tokens += 1
            if lp_rows is not None:
                st.logprobs.append(self._lp_entry(
                    lp_rows[0][k], lp_rows[1][k], lp_rows[2][k],
                    st.request.params.logprobs))
            if (self._is_stop(st, tok)
                    or len(st.generated) >= st.request.params.max_tokens):
                finished = True
                break
        self._lengths[slot] += len(col)   # all K rows were written
        self._last_token[slot] = col[-1]
        m = self.metrics
        m.generation_tokens_total.inc(new_tokens)
        m.time_per_output_token_seconds.observe(dt / len(col))
        m.tpot_seconds.observe(dt / len(col), tier=self._slo.tier_of(
            st.request.params.priority))
        if finished:
            self._finish(slot, self._finish_reason(st))
        else:
            self._emit_delta(st)

    def _emit_delta(self, st: _Slot) -> None:
        delta = st.generated[st.num_emitted:]
        lp_delta = (st.logprobs[st.num_emitted:]
                    if st.request.params.logprobs is not None else None)
        st.num_emitted = len(st.generated)
        st.request.outputs.put(RequestOutput(
            request_id=st.request.request_id, token_ids=delta,
            num_prompt_tokens=st.num_prompt, logprobs=lp_delta))

    # ------------------------------------------------------------------
    # Mixed scheduler
    # ------------------------------------------------------------------

    def _fill_chunk_lanes(self, a: dict, t: int):
        """Round-robin prefill-chunk fill starting at flat index ``t``: an
        even quota per prefilling sequence first, FIFO greedy for the
        leftover.  Returns (completing slots, [(slot, take)], t)."""
        completing: list[int] = []
        chunk_take: list[tuple[int, int]] = []
        pre = list(self._prefilling.items())
        if not pre:
            return completing, chunk_take, t
        budget = self._mixed_budget
        quota = max(budget // len(pre), 1)
        takes: dict[int, int] = {}
        for slot, st in pre:
            if budget <= 0:
                break
            take = min(len(st.ids) - st.pos, quota, budget)
            if take > 0:
                takes[slot] = take
                budget -= take
        for slot, st in pre:
            if budget <= 0:
                break
            extra = min(len(st.ids) - st.pos - takes.get(slot, 0), budget)
            if extra > 0:
                takes[slot] = takes.get(slot, 0) + extra
                budget -= extra
        for slot, st in pre:
            take = takes.get(slot, 0)
            if not take:
                continue
            a["tokens"][t: t + take] = st.ids[st.pos: st.pos + take]
            a["token_slot"][t: t + take] = slot
            a["token_pos"][t: t + take] = np.arange(st.pos, st.pos + take)
            a["seq_q_start"][slot] = t
            a["seq_q_len"][slot] = take
            a["seq_pos_start"][slot] = st.pos
            chunk_take.append((slot, take))
            if st.pos + take == len(st.ids):
                a["sample_src"][slot] = t + take - 1
                completing.append(slot)
            t += take
        return completing, chunk_take, t

    def _lane_sampling(self, dec_slots: list[int], completing: list[int]):
        """The sampling state of the lanes that sample this step, with the
        passes they need; other lanes are greedy and unread.  Decoding
        lanes sample with their slot's row and carry its key on; a
        completing lane draws its first token with its chunk key and the
        reference's override columns: no penalties (its output is empty),
        its bias, min_tokens and guide, and ``min_until`` shifted so that
        ``lengths < min_until`` reads as its first-token flag.  Returns
        (state, gates, active): ``active`` (the decode lanes) is None
        unless keys, guide rows or counts advance."""
        n = self.ecfg.num_slots
        temp = np.zeros((n,), np.float32)
        top_p = np.ones((n,), np.float32)
        top_k = np.zeros((n,), np.int32)
        dec = [self._slots[s].request.params for s in dec_slots]
        comp = [self._prefilling[s].request.params for s in completing]
        for slot, p in zip(dec_slots + completing, dec + comp):
            temp[slot] = p.temperature
            top_p[slot] = p.top_p
            top_k[slot] = p.top_k
        gates = _lane_gates(dec + comp, dec)
        st = self._sampling._replace(**{
            k: self._upload(x)
            for k, x in (("temperature", temp), ("top_p", top_p),
                         ("top_k", top_k))})
        active = None
        if gates.sampled or gates.guide or gates.penalties:
            act = np.zeros((n,), bool)
            act[dec_slots] = True
            active = self._upload(act)
        if not completing or gates == sampler_mod.OFF:
            return st, gates, active
        ov = np.zeros((n,), bool)
        ov[completing] = True
        ov_dev = self._upload(ov)
        if gates.sampled:
            ov_keys = np.zeros((n, 2), np.uint32)
            for slot in completing:
                ov_keys[slot] = self._prefilling[slot].key
            st = st._replace(key=torch.where(
                ov_dev[:, None], self._upload_tensor(prng.key_tensor(
                    ov_keys)), st.key))
        if gates.penalties:
            st = st._replace(
                presence=torch.where(ov_dev, 0.0, st.presence),
                frequency=torch.where(ov_dev, 0.0, st.frequency))
        if not (gates.bias or gates.min_tokens or gates.guide):
            return st, gates, active
        lane_params = [None] * n
        for slot, p in zip(completing, comp):
            lane_params[slot] = p
        cols = self._shaping_cols(lane_params)
        # lengths[slot] holds len(ids) while prefilling: len(ids) + 1 makes
        # ``lengths < min_until`` read as the first-token flag.
        cols["min_until"] = cols["min_first"] * (self._lengths + 1)
        keep = [("bias_ids", gates.bias), ("bias_vals", gates.bias),
                ("suppress_ids", gates.min_tokens),
                ("min_until", gates.min_tokens), ("guide", gates.guide),
                ("guide_row", gates.guide)]
        st = st._replace(**{
            k: torch.where(ov_dev[:, None] if cols[k].ndim == 2 else ov_dev,
                           self._upload(cols[k]), getattr(st, k))
            for k, on in keep if on})
        return st, gates, active

    def _issue_mixed(self):
        """Build and run ONE mixed dispatch: every decoding slot's next
        token plus the round-robin chunk fill.  Returns the record for
        ``_resolve_mixed`` or None when nothing needs the model."""
        self._abort_and_retire(2)
        if not self._slots and not self._prefilling:
            return None
        self._ensure_guides_uploaded()
        self._grow_slot_pages(1)
        n = self.ecfg.num_slots
        t_budget = n + self._mixed_budget
        sentinel = self._park_sentinel()
        a = dict(tokens=np.zeros((t_budget,), np.int32),
                 token_slot=np.full((t_budget,), -1, np.int32),
                 token_pos=np.full((t_budget,), sentinel, np.int32),
                 sample_src=np.zeros((n,), np.int32),
                 seq_q_start=np.zeros((n,), np.int32),
                 seq_q_len=np.zeros((n,), np.int32),
                 seq_pos_start=np.zeros((n,), np.int32))
        dec_slots = list(self._slots)
        t = 0
        for slot in dec_slots:
            a["tokens"][t] = self._last_token[slot]
            a["token_slot"][t] = slot
            a["token_pos"][t] = self._lengths[slot]
            a["sample_src"][slot] = t
            a["seq_q_start"][slot] = t
            a["seq_q_len"][slot] = 1
            a["seq_pos_start"][slot] = self._lengths[slot]
            t += 1
        completing, chunk_take, t = self._fill_chunk_lanes(a, t)
        # Eager PyTorch has no static-shape constraint: the batch is the
        # tokens actually used, and the work list spans the widest lane.
        for key in ("tokens", "token_slot", "token_pos"):
            a[key] = a[key][:max(t, 1)]
        qmax = max(int(a["seq_q_len"].max()), 1)
        n_chunk = sum(take for _, take in chunk_take)
        self.metrics.mixed_batch_tokens.observe(t)
        if n_chunk:
            self.metrics.mixed_chunk_tokens_total.inc(n_chunk)
        self._mixed_grid_counters(a["seq_pos_start"], a["seq_q_len"], qmax)
        t0 = time.monotonic()
        d = {k: self._upload(v) for k, v in a.items()}
        logits = tf.mixed_step(
            self.params, self.cfg, self.cache,
            self._upload(self._tables), d["tokens"],
            d["token_slot"], d["token_pos"], d["sample_src"],
            d["seq_q_start"], d["seq_q_len"], d["seq_pos_start"], qmax=qmax,
            moe_grouped=self._moe_grouped)
        ids_dev, lp = self._sample_mixed(logits, dec_slots, completing)
        self.dispatches += 1
        self.shared_dispatches += bool(dec_slots and chunk_take)
        return dec_slots, completing, chunk_take, ids_dev, lp, t0

    def _mixed_grid_counters(self, pos_start: np.ndarray, q_len: np.ndarray,
                             qmax: int) -> None:
        """The page-step and KV-byte counter pairs of one mixed dispatch,
        from its host-side batch arrays and the launch's plan (no device
        read).  KV bytes count the port's unpadded head_dim."""
        plan = mixed_grid_plan(qmax)
        kw = dict(page=self._page, block_q=plan["block_q"],
                  num_qb=plan["num_qb"], max_pages=self._max_pages)
        ideal, dense = mixed_grid_steps(pos_start, q_len, **kw)
        m = self.metrics
        m.mixed_grid_steps_total.inc(
            ideal if self.resolved_config["mixed_grid"] == "ragged" else dense)
        m.mixed_grid_steps_ideal_total.inc(ideal)
        k = self.cache.k
        per = 2 * k.shape[3] * k.shape[4] * k.element_size()
        if self.cache.k_scale is not None:
            per += 2 * self.cache.k_scale.shape[3] * 4
        actual, best = mixed_kv_bytes(pos_start, q_len, hkv=k.shape[2],
                                      page_head_bytes=per, **kw)
        m.mixed_kv_bytes_total.inc(actual)
        m.mixed_kv_bytes_ideal_total.inc(best)

    def _sample_mixed(self, logits: torch.Tensor, dec_slots: list[int],
                      completing: list[int]):
        """Sample a mixed dispatch's lanes from its ``logits`` [B, V]: the
        decode lanes' counts first (their fed tokens), then one ``sample``
        over every lane, the logprobs when a lane asks.  Returns (ids [B],
        None | (chosen [B], top values and ids [B, L]))."""
        st, gates, active = self._lane_sampling(dec_slots, completing)
        lengths = None
        if gates.penalties:
            # In place: ``st`` shares the counts.
            fed = self._upload(self._last_token)
            sampler_mod.count_tokens(self._sampling, fed, active)
        if gates.min_tokens:
            lengths = self._upload(self._lengths)
        ids, st = sampler_mod.sample(
            logits, st, active, lengths,
            self._guide_dev if gates.guide else None, gates)
        # Only decode lanes' keys and guide rows move (``active``); a
        # completing lane's row is written at its registration.
        self._sampling = self._sampling._replace(key=st.key,
                                                 guide_row=st.guide_row)
        lanes = [self._slots[s].request.params for s in dec_slots] + \
            [self._prefilling[s].request.params for s in completing]
        lp = sampler_mod.top_logprobs(logits, ids) \
            if any(p.logprobs is not None for p in lanes) else None
        return ids, lp

    def _resolve_mixed(self, rec, exclude_s: float = 0.0) -> None:
        """Host tail of a mixed dispatch: fan the decode tokens out,
        advance every prefilling sequence, promote completed prompts."""
        dec_slots, completing, chunk_take, ids_dev, lp, t_issue = rec
        t0 = time.monotonic()
        ids, lp_h = _to_host(ids_dev, lp)    # the host sync point
        self.metrics.decode_resolve_wait_seconds_total.inc(
            time.monotonic() - t0, mode="sequential")
        dt = max(time.monotonic() - t_issue - exclude_s, 1e-6)
        for slot in dec_slots:
            rows = None
            if lp_h is not None and \
                    self._slots[slot].request.params.logprobs is not None:
                rows = tuple(x[slot: slot + 1] for x in lp_h)
            self._fanout_decode_tokens(slot, [int(ids[slot])], rows, dt)
        for slot, take in chunk_take:
            self._prefilling[slot].pos += take
            self.prefill_tokens_total += take
        for slot in completing:
            cs = self._prefilling.pop(slot)
            p = cs.request.params
            first = int(ids[slot])
            gid, row = self._guide_cols(p)
            # The decode key stream is the chunk key folded with 1.
            key = prng.key_tensor(cs.key[None], self.device)
            self._set_slots([slot], [p], prng.fold_in(key, 1), [len(cs.ids)],
                            [self.guides.next_row(row, first)
                             if gid >= 0 else 0])
            self._register_slot(cs.request, slot, first, len(cs.ids),
                                self._first_lp(p, lp_h, slot))
            self._register_prompt_pages(cs.ids, self._slot_pages.get(slot, []),
                                        cs.digests)

    def _register_slot(self, req: Request, slot: int, first: int,
                       num_prompt: int, first_lp=None) -> None:
        p = req.params
        st = _Slot(request=req, num_prompt=num_prompt,
                   stop_col=sampler_mod.np_stop_col(self._stop_ids_for(p)),
                   dead_len=min(num_prompt + p.max_tokens - 1,
                                self.ecfg.max_cache_len - self._pipe_rows))
        st.generated.append(first)
        if first_lp is not None:
            st.logprobs.append(first_lp)
        self._slot_gen[slot] += 1
        self._slots[slot] = st
        self._lengths[slot] = num_prompt
        self._last_token[slot] = first
        ttft = time.monotonic() - req.arrival_time
        m = self.metrics
        m.prompt_tokens_total.inc(num_prompt)
        m.num_requests_running.set(len(self._slots))
        m.time_to_first_token_seconds.observe(ttft)
        m.ttft_seconds.observe(ttft, tier=self._slo.tier_of(p.priority))
        self._slo_burn_record(p.priority, ttft)
        if self._check_finished(slot):
            return
        st.num_emitted = 1
        req.outputs.put(RequestOutput(
            request_id=req.request_id, token_ids=[first],
            num_prompt_tokens=num_prompt, ttft_s=ttft,
            logprobs=list(st.logprobs) if st.logprobs else None))

    # ------------------------------------------------------------------
    # Prefix reuse: the device index (tier 0) and the host tier (tier 1)
    # ------------------------------------------------------------------

    def _register_prompt_pages(self, ids: list[int], pages: list[int],
                               digests=None) -> None:
        """Enter a prompt's full pages into the device index once they are
        written (decode writes start at position len(ids), past them)."""
        nreg = min(len(ids) // self._page, len(pages))
        if nreg:
            if digests is None or len(digests) < nreg:
                digests = chain_digests(ids, self._page, nreg)
            self._alloc.register(digests[:nreg], pages[:nreg])
            self.metrics.prefix_cache_usage_bytes.set(
                self._alloc.retained_pages * self._page_bytes, tier="device")

    def _spill_flush(self) -> None:
        """Spill every page evicted since the last flush: gather the pages
        into a staging block on the device and start its copy to pinned
        host memory (``_PinnedCopy``, with an event); ``_resolve_spills``
        stores the blocks once it has landed.  Runs right after the
        evicting allocation, so on the stream the gather precedes every
        dispatch that may write the recycled pages.  No host sync."""
        if not self._spill_victims:
            return
        victims = [(d, p) for d, p in self._spill_victims
                   if not self._host.has(d)]
        self._spill_victims.clear()
        g = self._spill_group
        for i in range(0, len(victims), g):
            grp = victims[i: i + g]
            # A short group repeats a real page (one staging shape, so one
            # set of pinned buffers); the host drops the padded entries.
            pages = [p for _, p in grp] + [grp[0][1]] * (g - len(grp))
            out = tf.gather_pool_pages(
                self.cache, self._upload(np.asarray(pages, np.int64)))
            self._spills.append((
                [d for d, _ in grp],
                _PinnedCopy([x for x in out if x is not None],
                            self._host_bufs)))

    def _resolve_spills(self) -> bool:
        """Store the landed spills in the host tier (oldest first; never
        waits).  Returns True if any landed."""
        did = False
        while self._spills and self._spills[0][1].ready():
            digests, copy = self._spills.popleft()
            did = True
            arrays = copy.tensors()
            names = ("k", "v", "k_scale", "v_scale")[:len(arrays)]
            stored = 0
            for j, d in enumerate(digests):
                # Copies: the staging buffers go back to the pool.
                blk = {n: a[:, j].clone() for n, a in zip(names, arrays)}
                stored += self._host.put(d, blk)
            copy.release()
            if stored:
                self.metrics.prefix_spill_blocks_total.inc(stored)
            self.metrics.prefix_cache_usage_bytes.set(
                self._host.bytes_used, tier="host")
        return did

    def _issue_restore(self, req: Request, ids: list[int], digests: list,
                       shared: list[int], blocks: list) -> None:
        """A host-tier hit at admission: allocate fresh pages for the
        blocks, scatter them in (groups of ``_spill_group``, staged in
        pinned memory and uploaded without a host sync) and park the
        request until the last scatter's event has passed
        (``_resolve_restores``).  Decoding goes on meanwhile."""
        pages = self._alloc.alloc(len(blocks))
        # Pages the allocation evicted spill before the scatter, which may
        # write those very pages.
        self._spill_flush()
        g = self._spill_group
        for i in range(0, len(blocks), g):
            grp, pg = blocks[i: i + g], pages[i: i + g]
            staged = {name: self._stage(grp, name, g) for name in grp[0]}
            pad = np.asarray(pg + [pg[0]] * (g - len(pg)), np.int64)
            tf.scatter_pool_pages(
                self.cache, staged["k"], staged["v"], self._upload(pad),
                len(grp), staged.get("k_scale"), staged.get("v_scale"))
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        self._awaiting_restore.append(_RestoreState(
            request=req, ids=ids, digests=digests, shared=shared,
            pages=pages, done=done, t0=time.monotonic()))

    def _stage(self, blocks: list, name: str, g: int) -> torch.Tensor:
        """Field ``name`` of up to ``g`` host blocks stacked on axis 1 and
        uploaded: [L, g, ...] on the device (entries past the blocks are
        never scattered)."""
        first = blocks[0][name]
        out = torch.empty((first.shape[0], g) + tuple(first.shape[1:]),
                          dtype=first.dtype,
                          pin_memory=self.device.type == "cuda")
        for j, b in enumerate(blocks):
            out[:, j] = b[name]
        return self._upload_tensor(out)

    def _resolve_restores(self) -> bool:
        """Unpark the restores whose scatter landed, while a slot is free:
        the restored pages enter the device index (a host hit refills tier
        0) and the request continues chunked after shared + restored pages.
        An abort while parked releases its pages.  Returns True if any
        moved."""
        did = False
        still: list[_RestoreState] = []
        for rec in self._awaiting_restore:
            rid = rec.request.request_id
            with self._abort_lock:
                aborted = rid in self._aborted
                self._aborted.discard(rid)
            if aborted:
                did = True
                # A scatter still in flight to these pages is harmless: any
                # later write to them queues behind it on the stream.
                self._end_restore(rec, "abort")
                continue
            if not self._free or (rec.done is not None
                                  and not rec.done.query()):
                still.append(rec)
                continue
            did = True
            start = len(rec.shared)
            self._alloc.register(rec.digests[start: start + len(rec.pages)],
                                 rec.pages)
            self._host.restored_blocks += len(rec.pages)
            waited = time.monotonic() - rec.t0
            self.prefix_restore_seconds.append(waited)
            m = self.metrics
            m.prefix_restore_blocks_total.inc(len(rec.pages))
            m.prefix_restore_seconds.observe(waited)
            m.prefix_cache_usage_bytes.set(
                self._alloc.retained_pages * self._page_bytes, tier="device")
            # The request's references on shared + restored pages pass to
            # its slot (the index holds its own on the restored ones).
            self._start_chunked(
                rec.request, rec.ids,
                prefix_len=(start + len(rec.pages)) * self._page,
                prefix_pages=rec.shared + rec.pages, digests=rec.digests)
        self._awaiting_restore = still
        return did

    def _end_restore(self, rec: _RestoreState, reason: str,
                     error: str | None = None) -> None:
        self._alloc.decref(rec.shared)
        self._alloc.decref(rec.pages)
        self._unpin_guide(rec.request)
        rec.request.outputs.put(RequestOutput(
            request_id=rec.request.request_id, token_ids=[], finished=True,
            finish_reason=reason, error=error,
            num_prompt_tokens=len(rec.ids)))

    def _abort_awaiting_restores(self, error: str | None = None) -> None:
        """End every request parked on a restore (engine exit: "abort"; a
        failed step: "error")."""
        for rec in self._awaiting_restore:
            self._end_restore(rec, "error" if error else "abort", error)
        self._awaiting_restore = []

    def _restore_ready_any(self) -> bool:
        return any(rec.done is None or rec.done.query()
                   for rec in self._awaiting_restore)

    # ------------------------------------------------------------------
    # Pipelined decode (ARKS_PIPELINE_DEPTH) and depth-0 sampler fusion
    # ------------------------------------------------------------------

    def _stop_ids_for(self, p) -> list[int]:
        """The token ids that end a stream for these params: the set
        ``_is_stop`` checks, mirrored onto the device as a stop column."""
        if p.ignore_eos:
            return list(p.stop_token_ids)
        return (list(self.cfg.eos_token_ids)
                + list(self.tokenizer.eos_token_ids)
                + list(p.stop_token_ids))

    def _pipe_ready(self) -> bool:
        """True when this iteration can stay on the pipelined path (depth
        > 0 and ``_steady_ready``).  Requests parked on a guide compile do
        not drain it: the park is host bookkeeping, and the request comes
        back through the admission queue, which ``_steady_ready`` sees."""
        return bool(self._pipe_depth) and self._steady_ready()

    def _fuse_ready(self) -> bool:
        """Depth-0 sampler fusion (``ARKS_SAMPLER_FUSE``) on a mixed
        engine: a steady-state iteration runs the pipe program, fresh from
        the host mirrors, and resolves it at once, in place of the
        host-built mixed batch.  The gates are the pipelined path's."""
        if self._pipe_depth or not self._sampler_fuse or not self._mixed:
            return False
        return self._steady_ready()

    def _steady_ready(self) -> bool:
        """The steady-state gate shared by the pipelined and fused paths:
        live decoding slots, no prefill chunk and no deferred admission
        pending, no admission possible (a free slot and a waiting
        request), no landed host-tier restore with a free slot to take,
        every slot's stop set on the device, and no abort aimed at a live
        slot.  The reference's other gates guard subsystems the port does
        not have (windowed residency, disk or peer fetches, swaps and
        preemption) and are left out; so is
        its wait for the pipe programs' ahead-of-time compile: eager
        PyTorch has nothing to compile, and the kernels build at their
        first launch."""
        if not self._slots or self._prefilling or self._pending_admits:
            return False
        if self._awaiting_restore and self._free and \
                self._restore_ready_any():
            # A restore landed: drain so it can take a slot on exact host
            # mirrors (restores in flight keep the pipeline going).
            return False
        if self._free and not self._queue.empty():
            return False
        if any(st.stop_col is None for st in self._slots.values()):
            return False
        with self._abort_lock:
            if self._aborted and self._aborted & {
                    st.request.request_id for st in self._slots.values()}:
                return False
        return True

    def _step_pipelined(self) -> None:
        """One steady-state iteration: issue ONE dispatch when the pipeline
        has room, then resolve the oldest, waiting for it only when the
        pipeline is full, else resolving whatever has already landed."""
        if len(self._pipe_inflight) < self._pipe_depth:
            self._pipe_issue()
        if len(self._pipe_inflight) >= self._pipe_depth:
            self._pipe_resolve_one()
        else:
            while self._pipe_inflight and self._pipe_rec_ready(
                    self._pipe_inflight[0]):
                self._pipe_resolve_one()
        if self._spills:
            self._resolve_spills()

    def _step_fused(self) -> None:
        """One depth-0 fused iteration: the pipe program issued fresh from
        the host mirrors and resolved at once; the threaded state is
        dropped, so the host stays authoritative."""
        self._pipe_issue()
        if self._pipe_inflight:
            self.metrics.sampler_fused_dispatch_total.inc()
            self._pipe_resolve_one()
        self._pipe_state = None
        self._pipe_cols = None
        if self._spills:
            self._resolve_spills()

    @staticmethod
    def _pipe_rec_ready(rec) -> bool:
        return rec[2].ready()

    def _pipe_issue(self) -> None:
        """Issue one pipelined dispatch.  Fresh (nothing threaded): the
        device state comes from the host mirrors, the run's one upload of
        it, after retiring slots whose next dispatch would pass the cache
        cap (the margin ``dead_len`` keeps on the device for the rest of
        the run).  Threaded: the previous dispatch's outputs feed this one
        untouched; only the block tables travel.  The results start their
        copy to the host at once.  No host sync: uploads go through pinned
        memory, the sampler's passes are gated by the live slots' requests
        (host booleans), and the results are read at resolve."""
        k = self._pipe_rows
        fresh = self._pipe_state is None
        if fresh:
            for slot in list(self._slots):
                if int(self._lengths[slot]) >= self.ecfg.max_cache_len - k:
                    self._finish(slot, "length")
            if not self._slots:
                return
        if self._paged:
            self._grow_slot_pages(k, ahead=len(self._pipe_inflight))
        self._ensure_guides_uploaded()
        if fresh:
            n = self.ecfg.num_slots
            alive = np.zeros((n,), bool)
            stop_ids = np.full((n, sampler_mod.STOP_IDS_MAX), -1, np.int32)
            dead_len = np.zeros((n,), np.int32)
            for slot, st in self._slots.items():
                alive[slot] = True
                stop_ids[slot] = st.stop_col
                dead_len[slot] = st.dead_len
            state = (self._upload(self._last_token),
                     self._upload(self._lengths), self._upload(alive))
            self._pipe_cols = (self._upload(stop_ids),
                               self._upload(dead_len))
        else:
            state = self._pipe_state
        params = [st.request.params for st in self._slots.values()]
        gates = _lane_gates(params, params)
        want_lp = any(p.logprobs is not None for p in params)
        tables = self._upload(self._tables) if self._paged else None
        t0 = time.monotonic()
        args = (self.params, self.cfg, self.cache, *state, *self._pipe_cols,
                self._sampling, tables,
                self._guide_dev if gates.guide else None, gates, want_lp,
                self._park_sentinel())
        if self._mixed:
            toks, lp, *nxt, self._sampling = mixed_pipe(*args)
            self.dispatches += 1
        else:
            toks, lp, *nxt, self._sampling = decode_pipe(*args, k)
            self.decode_dispatches += 1
            self.decode_steps += k
        self._pipe_state = tuple(nxt)
        copy = _HostCopy(toks, lp, self._host_bufs)
        snapshot = [(s, int(self._slot_gen[s])) for s in self._slots]
        self._pipe_inflight.append((snapshot, want_lp, copy, t0))
        occ = len(self._pipe_inflight)
        self.metrics.pipeline_depth_occupancy.observe(occ)
        self.pipe_dispatches += 1
        self.pipe_occupancy[occ] = self.pipe_occupancy.get(occ, 0) + 1
        self.pipe_occupancy_max = max(self.pipe_occupancy_max, occ)

    def _pipe_resolve_one(self) -> None:
        """Resolve the OLDEST in-flight dispatch on the lagged host view:
        fan its tokens out (stop tokens, max_tokens truncation, logprob
        entries) and retire finished slots, whose overshoot tokens in
        newer dispatches the (slot, generation) snapshot drops.  A slot
        the device retired by the cache cap (``dead_len``) is retired here
        too, as the sequential path retires it at its next issue."""
        snapshot, want_lp, copy, t_issue = self._pipe_inflight.popleft()
        t0 = time.monotonic()
        toks, lp_h = copy.result()
        now = time.monotonic()
        self.metrics.decode_resolve_wait_seconds_total.inc(
            now - t0, mode="pipelined")
        # TPOT by resolve interarrival: in steady state one resolve lands
        # per dispatch, and the issue-to-resolve span covers the depth.
        last = self._pipe_last_resolve
        self._pipe_last_resolve = now
        dt = max(now - (t_issue if last is None else last), 1e-6)
        cols = toks.T.tolist()
        cap = self.ecfg.max_cache_len - self._pipe_rows
        for slot, gen in snapshot:
            st = self._slots.get(slot)
            if st is None or int(self._slot_gen[slot]) != gen:
                continue
            rows = None
            if want_lp and st.request.params.logprobs is not None:
                rows = tuple(x[:, slot] for x in lp_h)
            self._fanout_decode_tokens(slot, cols[slot], rows, dt)
            if slot in self._slots and int(self._lengths[slot]) >= cap:
                self._finish(slot, "length")

    def _pipe_drain(self) -> None:
        """Resolve every in-flight dispatch and hand authority back to the
        host mirrors (exact after the last resolve)."""
        try:
            while self._pipe_inflight:
                self._pipe_resolve_one()
        finally:
            self._pipe_state = None
            self._pipe_cols = None
            self._pipe_last_resolve = None

    def _pipe_reset(self) -> None:
        """Fault path: drop the in-flight records without resolving them
        (the failed step ends their requests)."""
        self._pipe_inflight.clear()
        self._pipe_state = None
        self._pipe_cols = None
        self._pipe_last_resolve = None

    # ------------------------------------------------------------------
    # Stop handling
    # ------------------------------------------------------------------

    def _is_stop(self, st: _Slot, tok: int) -> bool:
        p = st.request.params
        if p.ignore_eos:
            return tok in p.stop_token_ids
        return (tok in self.cfg.eos_token_ids
                or tok in self.tokenizer.eos_token_ids
                or tok in p.stop_token_ids)

    def _finish_reason(self, st: _Slot) -> str:
        if len(st.generated) >= st.request.params.max_tokens:
            return "length"
        return "stop"

    def _check_finished(self, slot: int) -> bool:
        st = self._slots[slot]
        tok = st.generated[-1]
        if (self._is_stop(st, tok)
                or len(st.generated) >= st.request.params.max_tokens):
            self._finish(slot, self._finish_reason(st))
            return True
        return False

    def _release_slot(self, slot: int, req: Request) -> None:
        """Free the slot of ``req``.  A paged slot returns its pages and
        parks at the write-drop sentinel (its dispatch rows must never land
        in pages another slot may now own); a slot-cache slot keeps its
        length, as in the reference — its rows land in its own stripe.
        The request's guide pin is released, and a request that shaped its
        logits returns the slot's shaping columns to their identity
        values, so that later batches without such requests skip the
        passes."""
        self._unpin_guide(req)
        if _shapes(req.params):
            self._sampling = sampler_mod.clear_slot_penalties(self._sampling,
                                                              slot)
        if self._paged:
            pages = self._slot_pages.pop(slot, [])
            if pages:
                self._alloc.decref(pages)
            self._lengths[slot] = self._park_sentinel()
        self._free.append(slot)

    def _finish(self, slot: int, reason: str) -> None:
        st = self._slots.pop(slot)
        self._release_slot(slot, st.request)
        gen = st.generated
        # The stop token itself is not part of the output.
        if reason == "stop" and gen and self._is_stop(st, gen[-1]):
            final_ids = gen[:-1]
        else:
            final_ids = gen[: st.request.params.max_tokens]
        lp_delta = None
        if st.request.params.logprobs is not None and st.logprobs:
            lp_delta = st.logprobs[st.num_emitted: len(final_ids)]
        st.request.outputs.put(RequestOutput(
            request_id=st.request.request_id,
            token_ids=final_ids[st.num_emitted:], finished=True,
            finish_reason=reason, num_prompt_tokens=st.num_prompt,
            num_generated_tokens=len(final_ids), logprobs=lp_delta))
        m = self.metrics
        m.e2e_request_latency_seconds.observe(
            time.monotonic() - st.request.arrival_time)
        m.request_success_total.inc(reason=reason)
        m.num_requests_running.set(len(self._slots))

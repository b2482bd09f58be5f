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

A step that raises does not fail everyone in flight: the reference's fault
isolation (``engine/faults.py``, ``_recover_from_fault``).  Every scheduler
phase runs inside a phase scope (``_scoped``) that tags a fault with its
phase and the requests it was doing work for (the culprits).  Recovery
charges the culprits' retry budgets (``ARKS_FAULT_RETRIES``, default 1),
quarantines those over budget (they alone end with an ``engine_fault``
error), zeroes the pool and resets the host mirrors in place, and re-queues
everyone else: a request that had emitted tokens replays from its prompt
with its pinned seed behind a ``_ReplayGate`` that drops what the client
already has and checks every regenerated token (a mismatch fails the
request with ``replay_diverged``, never splices a divergent tail).  Replays
take the shapes the original prefill had (``_ReplayShape``): a replayed
prompt is cut into the original's chunks, and a replayed one-shot
admission is padded to its original batch size.  A decode lane's bits do
not depend on the step form: a classic mixed step runs its decode lanes as
a block of ``num_slots`` rows, the pipe step's, apart from the chunk
budget's block when it carries prefill chunks (``mixed_step``'s
``split``).  A CUDA error that poisons the context (``faults.is_sticky``)
cannot be recovered in-process: the engine fails every request, flips to
``wedged`` and exits 70, as the dispatch watchdog does
(``ARKS_DISPATCH_DEADLINE_S``).  The tracer (``obs/trace.py``,
``ARKS_TRACE``, default on) records the reference's lifecycle events into
per-thread rings; ``profiler`` opens ``torch.profiler`` windows.

SLO tiers preempt (``ARKS_PREEMPT``): a queued request of a higher tier
that finds no free slot takes the slot of a running lower-tier request.
On a paged pool with the host tier the victim's valid pages and sampler
row go to host RAM (``SwapStore``, inside ``ARKS_PREFIX_HOST_MB``) and it
resumes later where it stopped; otherwise (the slot cache, the host tier
off, or a full budget) it re-queues behind a ``_ReplayGate`` and re-runs.

Speculative decoding (``draft_model``, ``draft_len``) rides the mixed
scheduler, as in the reference: a draft model on its own slot-contiguous
cache proposes ``draft_len - 1`` tokens per decoding lane (``draft_len``
``decode_step``s over every slot), and the target verifies each lane's
block as a ragged ``q_len = draft_len`` lane of the same ``mixed_step``
that carries the prefill chunks; ``sampler.speculative_accept`` keeps the
longest greedy-matching prefix plus one token, or accepts by rejection
sampling, so greedy lanes emit the target-only tokens and sampled lanes
keep the target's distribution.  The verify block of every lane is a
``num_slots * draft_len``-row block in every step form (the chunk
budget's rows a second block of ``split``), and the pipelined path runs
the same program on device state (``spec_pipe``).  A lane speculates when
its request allows it (``spec_ok``: no penalties, logprobs, bias or
min_tokens, a prompt the draft prefilled); the others advance one token a
step through the same dispatch.  A speculative engine preempts in replay
mode (the draft cache has no swap snapshot).

One engine serves several models through the weight pool
(``engine/model_pool.py``, ``pool``): a request for another registered
model parks while the pool streams its weights in on a background thread
(the resident model keeps decoding), and the engine switches its whole
per-model context (``_init_model_state``) at a drained boundary.  An idle
engine scales to zero (``ARKS_ELASTIC_IDLE_ZERO_S``: weights and KV pool
dropped) and re-arms on the next request.  Under windowed residency
(``ARKS_RESIDENCY_WINDOW_PAGES``, ``engine/residency.py``) a slot's device
pages are bounded by the window: a context that outgrows it keeps its cold
pages in host RAM and decodes span by span through the ragged kernel's
carried state, byte-identical to a pool that holds it whole.

The engine is a member of a fleet, as the reference's is.  A prefill-only
engine runs ``prefill_detached`` from server threads (its step loop never
starts) and hands the first token and the prompt's K/V over as a
``PrefilledState``; a decode engine admits such a request by inserting the
K/V (``_admit_prefilled``, either scheduler) and decoding on from
``fold_in(key(seed), 1)``.  Behind the host tier a paged pool may keep a
disk tier (``ARKS_PREFIX_DISK_MB``, ``DiskPrefixTier``: the host tier's
evictions written by a writer thread, re-indexed at boot) and fetch
missing prefix blocks from the disk tier or from peer replicas
(``ARKS_PEER_FETCH``: a worker thread stages them into the host tier,
whence the ordinary restore brings them to the pool).  ``cache_sketch``
summarizes which digests each tier holds for the router.  Both threads
touch host memory only, and every block they move carries the pool
layout's epoch.

What the reference does and this port does not (live resize,
parallelism) is rejected (``EngineConfig.validate``) rather than silently
ignored.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import logging
import os
import queue
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

from arks_tpu_torch import knobs, tenancy
from arks_tpu_torch import slo as slo_mod
from arks_tpu_torch.device import resolve_device
from arks_tpu_torch.engine import fairqueue, kv_transfer, prng
from arks_tpu_torch.engine import faults as faults_mod
from arks_tpu_torch.engine import sampler as sampler_mod
from arks_tpu_torch.engine.faults import StepFault
from arks_tpu_torch.engine.guides import Guide, GuideCompiler, GuideError
from arks_tpu_torch.engine.metrics import EngineMetrics
from arks_tpu_torch.engine.model_pool import (LoadTicket, ModelPool,
                                              PoolFullError, tree_tensors)
from arks_tpu_torch.engine.paged import (PageAllocator, chain_digests,
                                         mixed_grid_steps, mixed_kv_bytes,
                                         pages_needed)
from arks_tpu_torch.engine.prefix_cache import (DiskPrefixTier,
                                                HostPrefixTier, PrefixKVCache,
                                                SwapStore)
from arks_tpu_torch.engine.residency import ResidencyManager
from arks_tpu_torch.engine.types import (PrefilledState, Request,
                                         RequestOutput, SamplingParams)
from arks_tpu_torch.models import quant
from arks_tpu_torch.models import transformer as tf
from arks_tpu_torch.models.config import ModelConfig, get_config
from arks_tpu_torch.obs import logctx
from arks_tpu_torch.obs.profiler import ProfilerWindows
from arks_tpu_torch.obs.trace import Tracer
from arks_tpu_torch.ops.paged_attention import mixed_grid_mode, mixed_grid_plan
from arks_tpu_torch.prefix_sketch import SketchExporter, canonical_prompt_text

log = logging.getLogger("arks_tpu_torch.engine")
logctx.install(log)


class ContextLengthExceededError(ValueError):
    """Prompt does not fit the serving window (HTTP 400
    ``context_length_exceeded`` — never silent truncation)."""


@dataclasses.dataclass
class EngineConfig:
    """The reference's engine fields that the port serves or rejects
    (parallelism).  Values outside them raise in ``validate``."""

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
    # Speculative decoding: a draft model (a config name; its weights come
    # with the engine's draft_params) proposes draft_len - 1 tokens a
    # step, verified as q_len = draft_len lanes of the mixed step.
    draft_model: str | None = None
    draft_len: int = 4
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
            # The reference's checks (its engine raises them at init).
            if (self.pipeline_parallel or 1) > 1:
                raise ValueError("speculative decoding is incompatible with "
                                 "pipeline_parallel")
            if (self.data_parallel or 1) > 1:
                raise ValueError("speculative decoding requires "
                                 "data_parallel == 1 (and no slice axis)")
            if self.draft_len < 2:
                raise ValueError("draft_len must be >= 2")
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
    # How its prompt was prefilled, for a replay to repeat (_ReplayShape).
    shape: "_ReplayShape | None" = None
    # Speculative decoding: the lane speculates (frozen at registration, a
    # function of the request alone, so that a replay advances its key by
    # the same structure): the draft prefilled its prompt, and it asks for
    # no penalties, logprobs, logit_bias or min_tokens.
    spec_ok: bool = False


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
    # The position the chunked prefill started at (a prefix's length), the
    # chunk sizes taken so far, and a replay's planned sizes still to take
    # (its original prefill's, ``_ReplayShape``).
    start: int = 0
    takes: list = dataclasses.field(default_factory=list)
    plan: list = dataclasses.field(default_factory=list)


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


@dataclasses.dataclass
class _FetchState:
    """A disk or peer prefix fetch in flight: the request parks here while
    the fetch worker stages its missing blocks from the disk tier or a
    peer INTO THE HOST TIER.  No device pages are held across the park:
    ``_resolve_fetches`` re-runs the admission match, so the request rides
    the ordinary host-tier restore (or a plain chunked prefill when the
    fetch came back empty).  The worker writes only ``done`` and
    ``fetched_*``."""

    request: Request
    ids: list[int]
    digests: list          # the usable digest chain (computed at match)
    start: int             # the first uncovered digest at park time
    peer: str | None       # the hinted peer ("host:port")
    seed: int
    t0: float
    done: bool = False
    fetched_disk: int = 0
    fetched_peer: int = 0


@dataclasses.dataclass
class _SwapRecord:
    """A preempted request's host-side slot snapshot (``ARKS_PREEMPT``):
    what ``_finish_resume`` rebuilds its ``_Slot`` and host mirrors from
    once its pages are back.  The device halves (page blocks, sampler
    row) sit in the ``SwapStore`` entry under the same request id."""

    request: Request
    num_prompt: int
    generated: list
    num_emitted: int
    logprobs: list
    seed: int
    length: int       # host lengths mirror at preempt (valid KV rows)
    last_token: int   # host last-token mirror at preempt
    stop_col: object
    dead_len: int
    n_pages: int      # pool pages covering rows [0, length)
    priority: int
    t0: float         # preempt issue time (preempt_swap_seconds)
    shape: "_ReplayShape | None" = None


@dataclasses.dataclass
class _SwapState:
    """An in-flight preempt spill: the victim's slot is already free
    (stream order keeps the gathers ahead of any later write) and these
    device-to-host copies are draining: ``staged`` [(valid pages,
    _PinnedCopy of the gathered k, v[, scales])] and ``row`` (a
    _PinnedCopy of key, counts, guide_row)."""

    rec: _SwapRecord
    staged: list
    row: "_PinnedCopy"

    def ready(self) -> bool:
        return self.row.ready() and all(c.ready() for _, c in self.staged)

    def copies(self) -> list:
        return [c for _, c in self.staged] + [self.row]


@dataclasses.dataclass
class _ResumeState:
    """A preempt-swap resume in flight: the request holds ``slot`` while
    its page blocks scatter back, parked in ``_awaiting_restore`` beside
    the prefix restores; ``_finish_resume`` registers the slot once
    ``done`` has passed.  No prefill, no first token: the stream goes
    on."""

    rec: _SwapRecord
    slot: int
    pages: list[int]
    done: object         # a CUDA event after the last scatter, or None
    t0: float

    @property
    def request(self) -> Request:
        return self.rec.request

    @property
    def ids(self) -> list[int]:
        return self.rec.request.prompt_ids


@dataclasses.dataclass(frozen=True)
class _ReplayShape:
    """How a request's prompt was prefilled: the one-shot admission
    batch's size (``admit_m``; 0 = the chunked path), or the position its
    chunked prefill started at and the chunk sizes it took.  A replay
    repeats it — its one-shot batch padded back to ``admit_m`` rows, its
    chunks cut where the original's were — because on the card a row's
    bits depend on the batch's size and on where its prompt was cut into
    chunks (the attention's output at a position differs with the step
    its prefix was written in), though not on what else the step carries
    or on where the row sits."""

    admit_m: int = 0
    chunk_start: int = 0
    takes: tuple = ()


@dataclasses.dataclass
class _Survivor:
    """An in-flight request's replayable state, snapshotted at a step
    fault (``_recover_from_fault``).  ``generated`` empty = the request had
    emitted nothing (queued, prefilling or a deferred admission) and simply
    re-queues; non-empty = token-replay resume (deterministic re-execution
    behind a ``_ReplayGate``)."""

    request: Request
    seed: int
    num_prompt: int
    generated: list = dataclasses.field(default_factory=list)
    num_emitted: int = 0
    # How the original prefill ran (a replay repeats it), if known.
    shape: _ReplayShape | None = None


class _ReplayGate:
    """Token-replay resume by DETERMINISTIC RE-EXECUTION (fault recovery).

    A surviving stream is re-admitted through its original path with its
    pinned seed, its prefill in the original's shapes, so every
    regenerated token is expected to equal the recorded stream.  (The
    alternative, re-prefilling the generated tokens and restoring sampler
    state, recomputes KV rows with different shapes than the original
    decode wrote them — the last-bit drift can flip a sampled token
    several steps after resume, which is exactly the silent corruption
    replay must never produce.)

    The gate wraps the request's output queue for the re-run:

    - **suppression**: regenerated tokens the client already received
      (the first ``client_total``) are dropped, so the resumed stream has
      no duplicates;
    - **verification**: every regenerated token that was generated before
      the fault (``expect``, the tokens the client holds or was about to
      get) is checked against the recorded stream; a mismatch fails THIS
      request with an engine_fault error instead of splicing a divergent
      tail onto the client's stream.  The gate checks that prefix only: a
      token after it is new.  It equals the fault-free run's token too,
      since the replay's prefill repeats the original's shapes
      (``_ReplayShape``) and a decode lane computes the same bits in
      every step form (the pipe step's B rows, and the decode block of a
      classic mixed step, with or without prefill chunks beside it);
    - **re-entrancy**: a second fault during the re-run just restarts the
      cursor (``restart``); ``client_total`` survives, so suppression
      stays exact across nested recoveries.

    put() runs on the engine thread; get() is the server side's
    pass-through to the original queue.
    """

    def __init__(self, inner, engine, request_id: str, expect: list,
                 client_total: int):
        self._inner = inner
        self._engine = engine
        self._rid = request_id
        self.expect = [int(t) for t in expect]
        self.pos = 0              # regenerated tokens seen this run
        self.client_total = client_total  # tokens the client has received
        self.failed = False

    def restart(self, expect: list | None = None) -> None:
        self.pos = 0
        if expect and len(expect) > len(self.expect):
            self.expect = [int(t) for t in expect]

    def get(self, *args, **kwargs):
        return self._inner.get(*args, **kwargs)

    def get_nowait(self):
        return self._inner.get_nowait()

    def put(self, out: RequestOutput) -> None:
        if self.failed:
            # The client already saw the divergence error; drop the rest
            # of the doomed re-run (its abort tail included).
            return
        toks = list(out.token_ids)
        start = self.pos
        # Past the recorded prefix nothing is checked: a put that starts
        # there (a speculative block of any length) checks no token.
        n_check = max(0, min(len(toks), len(self.expect) - start))
        if toks[:n_check] != self.expect[start:start + n_check]:
            self.failed = True
            self._engine.abort(self._rid)
            self._inner.put(RequestOutput(
                request_id=self._rid, token_ids=[], finished=True,
                finish_reason="error",
                error="engine_fault: replay_diverged",
                num_prompt_tokens=out.num_prompt_tokens))
            log.error("replay of %s diverged from the recorded stream at "
                      "token %d; failing the request", self._rid,
                      start + 1)
            return
        self.pos += len(toks)
        skip = max(0, min(self.client_total - start, len(toks)))
        fwd = toks[skip:]
        lps = out.logprobs[skip:] if out.logprobs else None
        if not fwd and not out.finished:
            return  # entirely inside the already-delivered prefix
        self.client_total = max(self.client_total, self.pos)
        self._inner.put(dataclasses.replace(
            out, token_ids=fwd, logprobs=lps, ttft_s=None))


def _scoped(phase: str):
    """Fault-context decorator for scheduler phases: any exception leaving
    the wrapped method is re-raised as a StepFault tagged with the phase
    and the culprit request ids (blast-radius attribution — the recovery
    loop's quarantine input).  Inner StepFaults (narrower attribution from
    a per-request handler) pass through untouched.  It also moves the
    watchdog's heartbeat to the phase and records the phase's span."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            hb = self._step_hb
            if hb is not None:
                self._step_hb = (phase, hb[1])
            self.trace.evt("", "phase." + phase, "B")
            try:
                return fn(self, *args, **kwargs)
            except StepFault:
                raise
            except Exception as e:
                raise StepFault(phase, faults_mod.classify(e),
                                culprits=self._phase_culprits(phase)) from e
            finally:
                self.trace.evt("", "phase." + phase, "E")
        return wrapper
    return deco


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

    def drop(self) -> None:
        """Fault path: wait for the copies that may still be running into
        the pinned buffers, then give them back unread (a buffer must not
        be reused while a device copy may still write it)."""
        if self.event is not None:
            self.event.synchronize()
        self.release()


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


def draft_propose(dparams: tf.Params, dcfg: ModelConfig, dcache: tf.KVCache,
                  tokens: torch.Tensor, lengths: torch.Tensor,
                  sstate: sampler_mod.SamplingState, steps: int,
                  sampled: bool):
    """The draft's proposals for one speculative dispatch (the reference's
    ``draft_propose``): ``steps`` (= draft_len) ``decode_step``s over every
    slot of the draft's slot cache from ``tokens`` at ``lengths``, each
    proposal drawn by ``draft_sample``.  The last step only writes the last
    proposal's K/V row (its logits are not computed; its key split is):
    after a fully accepted block the next dispatch's draft then attends a
    whole prefix.  Parked lanes (lengths at or past the cache) drop their
    writes.  Returns (drafts [B, steps - 1], q [B, steps - 1], q window
    probs and ids [B, steps - 1, W] (None when no lane samples), the keys
    after the steps' splits)."""
    toks, qs, qps, qis = [], [], [], []
    keys = sstate.key
    tok, ln = tokens, lengths
    for i in range(steps):
        last = i == steps - 1
        logits = tf.decode_step(dparams, dcfg, dcache, tok, ln,
                                unembed=not last)
        if last:
            if sampled:
                keys = prng.split(keys, 2)[:, 1]
            break
        tok, q, qp, qi, keys = sampler_mod.draft_sample(logits, sstate, keys,
                                                        sampled)
        toks.append(tok)
        qs.append(q)
        qps.append(qp)
        qis.append(qi)
        ln = ln + 1
    drafts = torch.stack(toks, dim=1)
    if not sampled:
        return drafts, None, None, None, keys
    return (drafts, torch.stack(qs, dim=1), torch.stack(qps, dim=1),
            torch.stack(qis, dim=1), keys)


def spec_carry(sstate: sampler_mod.SamplingState, active: torch.Tensor,
               keys: torch.Tensor, guide_row: torch.Tensor,
               gates: sampler_mod.Gates) -> sampler_mod.SamplingState:
    """The sampling state after a speculative dispatch: the ``active``
    lanes take the carried keys and the guide rows ``speculative_accept``
    returned (nothing moves where no lane samples or is guided)."""
    if gates.sampled:
        sstate = sstate._replace(key=torch.where(active[:, None], keys,
                                                 sstate.key))
    if gates.guide:
        sstate = sstate._replace(guide_row=torch.where(active, guide_row,
                                                       sstate.guide_row))
    return sstate


def spec_verify(params: tf.Params, cfg: ModelConfig, dparams: tf.Params,
                dcfg: ModelConfig, cache: tf.PagedKVCache, dcache: tf.KVCache,
                feed: torch.Tensor, lengths: torch.Tensor,
                sstate: sampler_mod.SamplingState, enable: torch.Tensor,
                active: torch.Tensor, gtables, gates: sampler_mod.Gates,
                dk: int, rows: dict, chunk_tokens: torch.Tensor | None = None):
    """What both speculative step forms share: the draft's proposals
    (``draft_propose``) from ``feed`` [B] at ``lengths``, every lane's
    verify block (its fed token, then the proposals; lane b in rows
    [b * dk, (b + 1) * dk), put into the token rows on the device, with
    ``chunk_tokens`` after them) through ``mixed_step`` on the row layout
    ``rows`` (its keyword arguments, ``tables`` on), then
    ``speculative_accept`` over the verify logits (``enable`` lanes
    speculate, the others take one token) and ``spec_carry`` on the
    ``active`` lanes.  Returns (the step's logits, the verify logits [B,
    dk, V], the block's tokens [B, dk], the accepted counts [B], at least
    1, the sampling state)."""
    b = feed.shape[0]
    drafts, q_sel, q_probs, q_idx, dkeys = draft_propose(
        dparams, dcfg, dcache, feed, lengths, sstate, dk, gates.sampled)
    tokens = torch.cat([feed[:, None], drafts], dim=1).reshape(-1)
    if chunk_tokens is not None:
        tokens = torch.cat([tokens, chunk_tokens])
    logits = tf.mixed_step(params, cfg, cache, tokens=tokens, **rows)
    vlogits = logits[: b * dk].reshape(b, dk, -1)
    out, counts, carry, grow = sampler_mod.speculative_accept(
        drafts, q_sel, q_probs, q_idx, vlogits, sstate, dkeys, enable=enable,
        lengths=lengths, guide_tables=gtables, gates=gates)
    sstate = spec_carry(sstate, active, carry, grow, gates)
    return logits, vlogits, out, torch.clamp(counts, min=1), sstate


def spec_pipe(params: tf.Params, cfg: ModelConfig, dparams: tf.Params,
              dcfg: ModelConfig, cache: tf.PagedKVCache, dcache: tf.KVCache,
              tokens: torch.Tensor, lengths: torch.Tensor,
              alive: torch.Tensor, stop_ids: torch.Tensor,
              dead_len: torch.Tensor, spec_col: torch.Tensor,
              sstate: sampler_mod.SamplingState, tables: torch.Tensor,
              gtables, gates: sampler_mod.Gates, want_lp: bool,
              sentinel: int, dk: int):
    """One steady-state speculative dispatch on device-resident state (the
    reference's ``spec_pipe``): ``spec_verify`` with every lane's verify
    block at positions lengths .. lengths + dk - 1, in a flat batch of
    B * dk rows, the dead lanes without a query (``spec_col`` & alive
    lanes speculate, the others take one token), then the liveness over
    the accepted prefix only.  Arguments as ``mixed_pipe``'s, plus the draft
    and ``spec_col`` [B].  Returns (toks [dk + 1, B]: the block's tokens
    and, last, each lane's accepted count; None | logprob data of position
    0, repeated to [dk + 1, B(, L)]; next tokens, lengths, alive; the
    sampling state)."""
    b = tokens.shape[0]
    dev = tokens.device
    lane = torch.arange(b, dtype=torch.int32, device=dev)
    blk = torch.arange(dk, dtype=torch.int32, device=dev)
    eff = torch.where(alive, lengths, sentinel)
    if gates.penalties:
        sstate = sampler_mod.count_tokens(sstate, tokens, alive)
    _, vlogits, out, counts, sstate = spec_verify(
        params, cfg, dparams, dcfg, cache, dcache, tokens, eff, sstate,
        spec_col & alive, alive, gtables, gates, dk, dict(
            tables=tables,
            token_slot=torch.where(alive, lane, -1).repeat_interleave(dk),
            token_pos=(eff[:, None] + blk[None, :]).reshape(-1),
            sample_src=torch.cat([
                torch.arange(b * dk, dtype=torch.int32, device=dev),
                lane * dk]),
            seq_q_start=lane * dk, seq_q_len=alive.to(torch.int32) * dk,
            seq_pos_start=eff, qmax=dk))
    # Liveness over the accepted prefix only: tokens past the count are
    # rejected proposals no one sees.
    masked = torch.where((blk[None, :] < counts[:, None]) & alive[:, None],
                         out, -1)
    lengths = lengths + torch.where(alive, counts, 1)
    alive = sampler_mod.advance_liveness(masked.T, alive, lengths, stop_ids,
                                         dead_len)
    last = out.gather(1, (counts - 1).long()[:, None])[:, 0]
    toks = torch.cat([out.T, counts[None].to(out.dtype)])
    lp = None
    if want_lp:
        # A logprob lane never speculates: its one token is position 0's.
        lp = tuple(x[None].expand(dk + 1, *x.shape) for x in
                   sampler_mod.top_logprobs(vlogits[:, 0], out[:, 0]))
    return toks, lp, torch.where(alive, last, 0), lengths, alive, sstate


class _DiskStats:
    """The disk tier's counters mirrored into the metric families, from
    the writer and fetch threads (no engine reference: a thread holding
    the engine would keep it alive past ``del``)."""

    def __init__(self, disk: DiskPrefixTier, metrics) -> None:
        self.disk, self.metrics = disk, metrics
        self._lock = threading.Lock()
        self._evicted = disk.evicted_blocks
        self._corrupt = disk.corrupt_blocks

    def mirror(self) -> None:
        d, m = self.disk, self.metrics
        m.prefix_cache_usage_bytes.set(d.bytes_used, tier="disk")
        with self._lock:
            ev, co = d.evicted_blocks, d.corrupt_blocks
            if ev > self._evicted:
                m.prefix_disk_evictions_total.inc(ev - self._evicted)
                self._evicted = ev
            if co > self._corrupt:
                m.prefix_disk_corrupt_total.inc(co - self._corrupt)
                self._corrupt = co


def _disk_write_loop(q: queue.Queue, disk: DiskPrefixTier,
                     stats: _DiskStats) -> None:
    """The disk tier's writer thread: persist the queued host-tier
    evictions (host tensors only) until the None sentinel.  A failed write
    costs warmth, never correctness: swallowed."""
    while True:
        item = q.get()
        if item is None:
            return
        try:
            disk.put(*item)
        except Exception as e:
            faults_mod.swallowed("disk_spill.write", e)
        stats.mirror()


class _BlockFetcher:
    """The fetch worker's side of disk and peer prefix fetch: stages a
    parked admission's missing blocks into the host tier, from the disk
    tier first, then the hinted peer, then ``ARKS_PEER_ADDRS``.  Host
    memory and sockets only."""

    def __init__(self, host: HostPrefixTier, disk, peers: list[str],
                 timeout_s: float, epoch: str, stats) -> None:
        self.host, self.disk, self.peers = host, disk, peers
        self.timeout_s, self.epoch, self.stats = timeout_s, epoch, stats

    def run(self, q: queue.Queue) -> None:
        """Serve parked fetches until the None sentinel.  Every failure
        ends in ``done`` with whatever run was staged: the resolve then
        restores that and prefills the rest (a peer dying mid-fetch costs
        latency, never correctness)."""
        while True:
            st = q.get()
            if st is None:
                return
            try:
                self.fetch(st)
            except Exception as e:
                faults_mod.swallowed("prefix_fetch", e)
            st.done = True

    def fetch(self, st: _FetchState) -> None:
        """Stage ``st``'s uncovered digests, consecutively (a gap stops the
        run: a restore needs a contiguous prefix)."""
        peers = [a for a in ([st.peer] if st.peer else []) + self.peers
                 if a]
        for d in st.digests[st.start:]:
            if self.host.has(d):
                continue
            blk = self.disk.get(d) if self.disk is not None else None
            src = "disk"
            if blk is None and peers:
                blk = self.from_peers(peers, d)
                src = "peer"
            if blk is None:
                break
            if not self.host.put(d, blk) and not self.host.has(d):
                break       # the host budget cannot hold the staged run
            if src == "disk":
                st.fetched_disk += 1
            else:
                st.fetched_peer += 1
        if self.stats is not None:
            self.stats.mirror()

    def from_peers(self, peers: list[str], digest: bytes) -> dict | None:
        """One block from the first peer that has it, checked against this
        pool's layout epoch (another layout's block is refused, never
        reinterpreted)."""
        for addr in peers:
            buf = self.block_get(addr, digest)
            if buf is None:
                continue
            try:
                return kv_transfer.unpack_block(buf, digest, self.epoch)
            except ValueError as e:
                faults_mod.swallowed("peer_fetch.unpack", e)
        return None

    def block_get(self, addr: str, digest: bytes) -> bytes | None:
        """``GET /v1/cache/blocks/{digest}`` from one peer; None on any
        failure (timeout, refusal, 404, a body cut short)."""
        import http.client
        addr = addr.split("//", 1)[-1].rstrip("/")
        host, _, port = addr.rpartition(":")
        try:
            conn = http.client.HTTPConnection(
                host or addr, int(port) if port else 80,
                timeout=self.timeout_s)
            try:
                conn.request("GET", f"/v1/cache/blocks/{digest.hex()}")
                resp = conn.getresponse()
                if resp.status != 200:
                    resp.read()
                    return None
                return resp.read()
            finally:
                conn.close()
        except Exception as e:
            faults_mod.swallowed("peer_fetch.http", e)
            return None


class InferenceEngine:
    def __init__(self, cfg: ModelConfig, engine_cfg: EngineConfig,
                 tokenizer, params: tf.Params | None = None,
                 device: str | torch.device | None = None,
                 draft_params: tf.Params | None = None,
                 draft_cfg: ModelConfig | None = None,
                 pool: ModelPool | None = None) -> None:
        """Engine-global state here; everything that belongs to one model
        (weights, pool, mirrors, guides, tiers, draft) in
        ``_init_model_state``, whose attribute names a model switch swaps
        wholesale (``_model_attr_names``).  ``pool``: the multi-model
        weight pool (``engine/model_pool.py``); the primary is adopted
        into it pinned, with its draft."""
        self.device = resolve_device(device)
        self.tokenizer = tokenizer
        self._admit_sizes = admit_batch_sizes()
        self._pipe_depth = pipeline_depth_knob()
        self._sampler_fuse = sampler_fuse_knob()
        self._overlap = overlap_decode_knob(self.device)
        # Preemptive KV swap (ARKS_PREEMPT): the knobs, the replay-mode
        # victims on their way back to a slot and each victim's last
        # preempt (the anti-thrash cooldown).  The victims in flight or
        # parked in host RAM belong to their model's context.
        self._preempt_on = knobs.get_bool("ARKS_PREEMPT")
        self._preempt_max = knobs.get_int("ARKS_PREEMPT_MAX_INFLIGHT",
                                          minimum=1)
        self._preempt_cooldown_s = knobs.get_float("ARKS_PREEMPT_COOLDOWN_S",
                                                   minimum=0)
        self._resuming: set[str] = set()
        self._preempt_last: dict[str, float] = {}
        self._request_seed = 0
        # Free pinned buffers of the async result copies, by shape.
        self._host_bufs: dict = {}
        self.metrics = EngineMetrics()
        m = self.metrics
        # Fault isolation and token replay (engine/faults.py): the chaos
        # hook, the per-request retry budget and fault counts, the
        # replaying requests (re-queued, not yet decoding again), how each
        # replayer's original prefill ran, the pinned copies a recovery
        # drops, and the state /readiness reads.  The step
        # heartbeat (phase, t0) feeds the watchdog; ``_exit_fn`` is the
        # escalation's exit (injectable for tests).
        self._faults = faults_mod.FaultInjector()
        self._fault_retries = knobs.get_int("ARKS_FAULT_RETRIES", minimum=0)
        self._fault_counts: dict[str, int] = {}
        self._consec_faults = 0
        self._replaying: set[str] = set()
        self._replay_shape: dict[str, _ReplayShape] = {}
        self._dropped_copies: list[_PinnedCopy] = []
        self._recover_t0 = 0.0
        self._state = "serving"
        m.engine_state.set(faults_mod.STATE_SERVING)
        self._step_hb: tuple[str, float] | None = None
        self._watchdog: faults_mod.Watchdog | None = None
        self._exit_fn = os._exit
        # Request tracing (its collector thread starts in ``start``) and
        # the profiler windows.
        self.trace = Tracer()
        self.profiler = ProfilerWindows()
        self._pipe_seq = 0

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
        # The loop's first finished step (readiness).
        self.warm = False
        self._abort_lock = threading.Lock()
        self._aborted: set[str] = set()
        # Request ids waiting in the admission queue (under _abort_lock):
        # with the in-flight structures, the replay-liveness universe.
        self._queued_rids: set[str] = set()
        self._running = False
        self._thread: threading.Thread | None = None
        # Mixed dispatches issued (each runs every layer's two kernels once),
        # those that carried prefill chunks (run as two row blocks) and
        # those that carried decode and prefill-chunk tokens together;
        # legacy decode dispatches and their decode steps (each step runs
        # every layer's update and attention kernels once).
        self.dispatches = 0
        self.chunk_dispatches = 0
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

        # Multi-model pool: requests for a pool model that is not active
        # park in _awaiting_model (request, model, park time) while the
        # pool streams its weights in the background; the scheduler
        # switches contexts at a drained boundary ("model_switch" fault
        # phase).  add_request drops a model's name into _model_prefetch
        # so its load starts as soon as demand arrives.
        self.pool = pool
        self._awaiting_model: list[tuple[Request, str, float]] = []
        self._model_loads: dict[str, LoadTicket] = {}
        self._model_prefetch: set[str] = set()
        self._model_ctxs: dict[str, dict] = {}      # saved per-model state
        self._switch_target: str | None = None
        self._switch_policy = knobs.get_enum("ARKS_MODEL_SWITCH_POLICY",
                                             ("drain", "timeslice"))
        self._switch_quantum = knobs.get_float("ARKS_MODEL_SWITCH_QUANTUM_S")
        if self._switch_quantum <= 0:
            raise ValueError(f"ARKS_MODEL_SWITCH_QUANTUM_S="
                             f"{self._switch_quantum}: must be > 0")
        self._slice_t0 = time.monotonic()   # the active model's timeslice
        self._switch_t0: dict[str, float] = {}   # first park per model
        # Dispatches issued while a load is in flight, and the deepest
        # pipeline among them: the proof that the resident model kept its
        # depth while the next one streamed in.
        self._switch_stats = {"dispatches": 0, "max_depth": 0}
        self.last_switch_stats: dict | None = None

        # Scale-to-zero (ARKS_ELASTIC_IDLE_ZERO_S): an engine idle for the
        # window drops its weights and device KV until demand re-arms it.
        self._armed = True
        self._zero_t0 = 0.0
        self._idle_since: float | None = None
        self._rearm_loader = None   # optional cfg -> params
        self._idle_zero_s = knobs.get_float("ARKS_ELASTIC_IDLE_ZERO_S",
                                            minimum=0)
        self._elastic_warmup = knobs.get_bool("ARKS_ELASTIC_WARMUP")
        self._warmup_seq = 0
        self._rearm_fail_t = -1e9
        self.last_rearm_stats: dict | None = None

        # Detached prefills (a prefill-only engine) run on server threads:
        # one at a time on the device.
        self._prefill_lock = threading.Lock()

        pre = set(vars(self))
        self._init_model_state(cfg, engine_cfg, params=params,
                               draft_params=draft_params, draft_cfg=draft_cfg)
        # Every per-model attribute (weights, pool, mirrors, guides, tiers,
        # draft): _switch_to swaps exactly these between saved contexts.
        self._model_attr_names = tuple(sorted(set(vars(self)) - pre))
        # The prefix-digest sketch for cache-aware routing: one per engine,
        # not per model (its epoch follows this engine's resets, which is
        # what routers key staleness on), so it stays out of the contexts.
        self._sketch = SketchExporter(self._page) if self._paged else None
        self._primary_model = cfg.name
        self._primary_ecfg = self.ecfg
        if self.pool is not None:
            self.pool.adopt(cfg.name, cfg, self.params, pinned=True)
            self.pool.acquire(cfg.name)   # the active model's ref
            if self._draft_cfg is not None:
                self.pool.adopt(self._draft_cfg.name, self._draft_cfg,
                                self._draft_params, pinned=True)
            if self.pool.metrics is None:
                self.pool.metrics = SimpleNamespace(
                    resident_bytes=m.model_pool_resident_bytes,
                    cold_starts=m.model_cold_starts_total)
                self.pool._publish_metrics()
            # An eviction drops the model's saved context too: it holds a
            # params reference, so the card would not get the bytes back.
            # A closure over the dict, not a bound method: pool -> engine
            # would be a cycle that keeps the engine alive past ``del``.
            ctxs = self._model_ctxs
            self.pool.on_evict = lambda n: ctxs.pop(n, None)

    def _init_model_state(self, cfg: ModelConfig, engine_cfg: EngineConfig,
                          params: tf.Params | None = None,
                          draft_params: tf.Params | None = None,
                          draft_cfg: ModelConfig | None = None,
                          keep_tiers: dict | None = None) -> None:
        """Build ALL per-model engine state: weights, the KV pool and its
        allocator, the sampling rows, the guide compiler, the host
        mirrors, the prefix tiers, the draft, and the scheduler's per-model
        queues.  Called from ``__init__`` for the primary, from
        ``_switch_to`` for a pool model's first activation, and from
        ``_rearm``.  Every attribute assigned here is saved and restored
        wholesale by a model switch, which is legal only because switches
        happen at fully drained boundaries.  ``keep_tiers`` (a re-arm):
        reuse the host prefix tier, the swap store and the swapped-out
        victims instead of building fresh ones."""
        # A model config's KV dtype preference applies when the engine's
        # setting is "auto" (an explicit engine setting wins).
        if engine_cfg.kv_cache_dtype == "auto" and \
                cfg.kv_cache_dtype != "auto":
            engine_cfg = dataclasses.replace(
                engine_cfg, kv_cache_dtype=cfg.kv_cache_dtype)
            log.info("kv_cache_dtype=%s from the model config",
                     cfg.kv_cache_dtype)
        engine_cfg.validate()
        self.cfg = cfg
        self.ecfg = engine_cfg
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
        if engine_cfg.draft_model and not self._mixed:
            raise ValueError(
                "speculative decoding rides the mixed scheduler and "
                "requires the paged KV layout with chunked prefill "
                f"(resolved kv_layout={'paged' if self._paged else 'slot'}, "
                f"ARKS_MIXED_STEP={knob})")
        quantized = kv in ("int8", "int4")
        n = engine_cfg.num_slots
        # Windowed residency (ARKS_RESIDENCY_WINDOW_PAGES): a slot's
        # RESIDENT page budget below its logical table width; a slot whose
        # context outgrows it decodes span by span (engine/residency.py).
        self._residency_window = 0
        self._residency = None
        window = knobs.get_int("ARKS_RESIDENCY_WINDOW_PAGES", minimum=0)
        if self._paged:
            self._max_pages = engine_cfg.max_cache_len // c
            # Every slot's full table (or window) always fits;
            # prefix_cache_mb adds retention pages for the device index
            # (capped in proportion, so a tiny model's pool stays small),
            # as the reference sizes its pool.
            bits = (4 if kv == "int4" else 8) if quantized else \
                torch.finfo(cache_dtype).bits
            page_bytes = (cfg.num_layers * cfg.num_kv_heads * c
                          * cfg.head_dim * bits // 8 * 2)
            if quantized:
                page_bytes += cfg.num_layers * cfg.num_kv_heads * c * 8
            self._page_bytes = page_bytes
            extra = min(engine_cfg.prefix_cache_mb * 2**20 // page_bytes,
                        n * self._max_pages * 4)
            per_slot = self._max_pages
            if window and window < self._max_pages:
                if window < 4:
                    raise ValueError(
                        f"ARKS_RESIDENCY_WINDOW_PAGES={window}: the window "
                        "must cover 2 hot-tail pages + 2 staging halves "
                        "(>= 4)")
                per_slot = window
                self._residency_window = window
            num_pages = n * per_slot + extra
            self.cache = tf.init_paged_cache(
                cfg, num_pages, c, cache_dtype, self.device,
                quantized=quantized,
                kv_bits=4 if kv == "int4" else 8)
        else:
            self._max_pages = 0
            self._page_bytes = 0
            self.cache = tf.init_cache(cfg, n, engine_cfg.max_cache_len,
                                       cache_dtype, self.device,
                                       quantized=quantized)
        # Speculative decoding: the draft's params (the caller's, or drawn
        # from seed + 1 in the engine dtype, as the reference draws them)
        # and its slot-contiguous cache, stored as the pool is (int8 when
        # the pool is quantized).
        self._draft_cfg = None
        self._draft_params = None
        self._draft_cache = None
        if engine_cfg.draft_model:
            dcfg = draft_cfg or get_config(engine_cfg.draft_model)
            if dcfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {dcfg.vocab_size} != target "
                    f"{cfg.vocab_size} — the draft must share the target's "
                    "tokenizer")
            self._draft_cfg = dcfg
            self._draft_params = draft_params if draft_params is not None \
                else tf.init_params(dcfg, engine_cfg.seed + 1, dtype,
                                    self.device)
            self._draft_cache = tf.init_cache(
                dcfg, n, engine_cfg.max_cache_len, cache_dtype, self.device,
                quantized=quantized)
        # Prefix reuse beyond the device index: the host tier behind a
        # paged pool (spilled pages, restored at admission), or the slot
        # cache's host prefix cache.  Spills and restores move whole pages
        # in groups of a fixed size, as the reference's.
        host_mb = prefix_host_mb_knob()
        # (digest, page) evicted from the device index since the last
        # spill flush.
        self._spill_victims: list = []
        # Preemptive KV swap: victims' decode state parks in the SwapStore,
        # inside the host tier's budget, so swap mode needs the host tier;
        # without it victims preempt in replay mode.  The victims whose
        # spill copies are in flight and those parked in host RAM.
        if keep_tiers is not None:
            self._host = keep_tiers["host"]
            self._swap = keep_tiers["swap"]
            self._swapped: dict[str, _SwapRecord] = keep_tiers["swapped"]
        else:
            self._host = None
            if self._paged and host_mb:
                self._host = HostPrefixTier(c, host_mb * 2**20)
            self._swap = SwapStore(self._host) if self._host is not None \
                else None
            self._swapped = {}
        self._swap_pending: list[_SwapState] = []
        self._alloc = self._new_allocator(num_pages) if self._paged else None
        self._prefix = None
        if not self._paged and engine_cfg.prefix_cache_mb:
            self._prefix = PrefixKVCache(c, engine_cfg.prefix_cache_mb * 2**20)
        self._spill_group = min(8, max(self._max_pages, 1))
        self._spills: collections.deque = collections.deque()
        self._kv_epoch = self._kv_layout_epoch()
        self._init_fleet_tiers(keep_tiers)
        # Host-tier restores and preempt-swap resumes in flight.
        self._awaiting_restore: list = []
        self._mixed_budget = 0
        if self._mixed:
            budget = knobs.get_int("ARKS_MIXED_CHUNK_TOKENS", fallback=c,
                                   minimum=1)
            self._mixed_budget = min(budget, engine_cfg.max_cache_len)
        self._buckets = engine_cfg.resolve_buckets()
        # Rows a pipelined dispatch writes per slot (speculative: its verify
        # block; mixed: its one-token step; legacy: the K-step loop), also
        # dead_len's cache margin.
        self._pipe_rows = (engine_cfg.draft_len if self._draft_cfg is not None
                           else 1 if self._mixed
                           else engine_cfg.steps_per_dispatch)

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
        # Bumped at every registration: a pipelined resolve drops the
        # tokens of a slot retired (or re-registered) since its issue.
        self._slot_gen = np.zeros((n,), np.int64)
        # In-flight pipelined dispatches (FIFO), the device state threaded
        # from one to the next (tokens, lengths, alive) and the run's
        # liveness columns (stop ids, dead_len).
        self._pipe_inflight: collections.deque = collections.deque()
        self._pipe_state = None
        self._pipe_cols = None
        # The last pipelined resolve's time (TPOT by resolve interarrival).
        self._pipe_last_resolve: float | None = None
        # Deferred admissions: issued one-shot batches whose first tokens
        # have not been read yet (FIFO), and their request count.
        self._pending_admits: collections.deque = collections.deque()
        self._pending_n = 0
        # Each slot's sampling row and decode key (registered slots' rows
        # are read).
        self._sampling = sampler_mod.init_sampling_state(
            n, engine_cfg.seed, cfg.vocab_size, self.device)
        # Guided decoding: the compiler owns the host tables; the device
        # copies have fixed budget shapes and take new CONTENTS (engine
        # thread, between dispatches) when its version bumps.
        eos_all = tuple(dict.fromkeys(list(cfg.eos_token_ids)
                                      + list(self.tokenizer.eos_token_ids)))
        m = self.metrics
        self.guides = GuideCompiler(
            self.tokenizer, cfg.vocab_size, eos_all,
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
        if self._residency_window:
            # The span chain rides the mixed scheduler's step forms; a
            # speculative verify block never takes the span path.
            if not self._mixed:
                raise ValueError(
                    "ARKS_RESIDENCY_WINDOW_PAGES requires the mixed "
                    "scheduler (paged KV + chunked prefill, "
                    "ARKS_MIXED_STEP!=0)")
            if self._draft_cfg is not None:
                raise ValueError(
                    "ARKS_RESIDENCY_WINDOW_PAGES is incompatible with "
                    "speculative decoding (spec verify blocks never ride "
                    "the span-streaming path)")
            self._residency = ResidencyManager(self, self._residency_window)
            log.info("windowed residency: %d-page window (2x%d staging), "
                     "%d-page logical tables", self._residency_window,
                     self._residency.chunk, self._max_pages)
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
            # Speculative engines verify inside the mixed dispatch.
            "spec_mixed": str(self._draft_cfg is not None).lower(),
            # "swap": victims' decode state goes to host RAM; "replay":
            # victims re-queue and re-run; "off": priority only orders the
            # queue.
            "preempt": ("off" if not self._preempt_on else
                        "swap" if self._preempt_swap_capable() else
                        "replay"),
            "tensor_parallel": "1",
            "data_parallel": "1",
        }
        self.metrics.engine_config_info.set(1, **self.resolved_config)

    def _init_fleet_tiers(self, keep_tiers: dict | None) -> None:
        """The disk tier behind the host tier (``ARKS_PREFIX_DISK_MB``,
        ``ARKS_PREFIX_DISK_DIR``) with its writer thread, and the fetch
        worker of disk and peer prefix fetch (``ARKS_PEER_FETCH``,
        ``ARKS_PEER_ADDRS``, ``ARKS_PEER_FETCH_TIMEOUT_S``), both on a
        paged pool with the host tier.  The host tier's evictions queue in
        ``_disk_spill_pending`` (a closure over the deque: the tier must
        not hold the engine); the step loop hands them to the writer.  A
        re-arm (``keep_tiers``) keeps the tier, its queues and threads."""
        self._disk_spill_pending: collections.deque = collections.deque()
        self._awaiting_fetch: list[_FetchState] = []
        disk_mb = knobs.get_int("ARKS_PREFIX_DISK_MB")
        if disk_mb < 0:
            raise ValueError(f"ARKS_PREFIX_DISK_MB={disk_mb}: must be >= 0")
        timeout = knobs.get_float("ARKS_PEER_FETCH_TIMEOUT_S")
        if timeout <= 0:
            raise ValueError(f"ARKS_PEER_FETCH_TIMEOUT_S={timeout}: must "
                             "be > 0")
        self._peer_addrs = knobs.get_list("ARKS_PEER_ADDRS")
        self._peer_fetch = (knobs.get_bool("ARKS_PEER_FETCH")
                            and self._host is not None)
        if keep_tiers is not None and "disk" in keep_tiers:
            for name in ("disk", "disk_write_queue", "disk_writer",
                         "fetch_queue", "disk_stats"):
                setattr(self, "_" + name, keep_tiers[name])
        else:
            self._disk = self._disk_write_queue = self._disk_writer = None
            self._fetch_queue = self._disk_stats = None
            if disk_mb and self._host is not None:
                import tempfile
                ddir = knobs.get_str("ARKS_PREFIX_DISK_DIR") or os.path.join(
                    tempfile.gettempdir(), "arks-prefix-disk")
                self._disk = DiskPrefixTier(self._page, disk_mb * 2**20,
                                            ddir, self._kv_epoch)
                self._disk_stats = _DiskStats(self._disk, self.metrics)
                # Bounded: a spill storm drops blocks (warmth is best
                # effort) rather than growing a backlog of host RAM.
                self._disk_write_queue = queue.Queue(maxsize=256)
                self._disk_writer = threading.Thread(
                    target=_disk_write_loop, name="disk-spill", daemon=True,
                    args=(self._disk_write_queue, self._disk,
                          self._disk_stats))
                self._disk_writer.start()
            if self._disk is not None or self._peer_fetch:
                self._fetch_queue = queue.Queue()
                fetcher = _BlockFetcher(self._host, self._disk,
                                        self._peer_addrs, timeout,
                                        self._kv_epoch, self._disk_stats)
                threading.Thread(target=fetcher.run, args=(self._fetch_queue,),
                                 name="prefix-fetch", daemon=True).start()
        if self._disk is not None:
            pending = self._disk_spill_pending

            def note_evicted(digest, block, pending=pending):
                # Bookkeeping only, from whichever thread evicted: the step
                # loop drains it to the writer.
                if len(pending) < 1024:
                    pending.append((digest, block))

            self._host.on_evict = note_evicted

    def _kv_layout_epoch(self) -> str:
        """The pool layout's signature: chain digests key content only,
        so every disk file and every peer block carries this stamp and a
        reader on another layout refuses the bytes.  The fields are the
        reference's, but the port stores head_dim unpadded: where the
        reference pads the stored head dim (its 128-lane tile) its
        ``_page_bytes``, and so its epoch, differ from the port's for the
        same model and pool dtype, and the two refuse each other's
        blocks."""
        import hashlib
        kvd = self.ecfg.resolve_kv_cache_dtype()
        sig = "|".join(str(x) for x in (
            self.cfg.name, self._page, self.cfg.num_layers,
            self.cfg.num_kv_heads, self._page_bytes, self.ecfg.kv_quantized,
            {"int4": 4, "int8": 8}.get(kvd, 16), kvd))
        return hashlib.sha1(sig.encode()).hexdigest()[:16]

    @property
    def kv_epoch(self) -> str:
        """The layout epoch peers check fetched blocks against."""
        return self._kv_epoch

    def _new_allocator(self, num_pages: int) -> PageAllocator:
        """An empty page allocator over the pool.  With the host tier, its
        on_evict (the reference's ``_note_evicted``) queues the evicted
        page, as it runs mid-allocation; ``_spill_flush`` copies it before
        any dispatch can write it.  A closure over the list, not a bound
        method: engine -> allocator -> engine would be a cycle that keeps
        the pool alive past ``del``."""
        alloc = PageAllocator(num_pages, self._page)
        if self._host is not None:
            victims = self._spill_victims
            alloc.on_evict = lambda digest, page: victims.append(
                (digest, page))
        return alloc

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
        """Largest admissible prompt (the decode reserve kept).  Under
        windowed residency a prompt must fit the window with that reserve:
        residency streams decode-grown context, and a prefill chunk
        attends its whole causal prefix on the device."""
        k = self.ecfg.steps_per_dispatch
        limit = self.ecfg.max_cache_len - k - 1
        if self._residency_window:
            limit = min(limit, self._residency_window * self._page - k)
        return limit

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
            # Compile into the active model's registry only: a request for
            # another pool model compiles after its switch (the guide gate
            # ensures it then).
            if request.model in (None, self.cfg.name):
                self.guides.ensure(*p.guide)
            self.metrics.guided_requests_total.inc(1, kind=p.guide[0])
        if (request.model is not None and self.pool is not None
                and request.model != self.cfg.name
                and self.pool.has(request.model)):
            # Cold-start prefetch: start streaming the model's weights as
            # soon as demand arrives, not once the request parks behind
            # busy slots.
            self._model_prefetch.add(request.model)
        if self.trace.enabled:
            # Register the trace context (caller's thread: locking is fine
            # here) and open the queue span.
            self.trace.register(
                request.request_id, ctx=request.trace,
                tier=self._slo.tier_of(p.priority) if self._slo else None)
            self.trace.evt(request.request_id, "queue", "B")
            with logctx.bound(request.request_id,
                              request.trace.trace_id
                              if request.trace is not None else None):
                log.debug("request queued: %d prompt tokens, priority %d",
                          len(request.prompt_ids), p.priority)
        with self._abort_lock:
            self._queued_rids.add(request.request_id)
            self._queue_seq += 1
            seq = self._queue_seq
        try:
            # Bounded: a full queue (or tenant lane) refuses here, on the
            # caller's thread, with a drain-rate Retry-After.
            self._queue.put((p.priority, seq, request), bounded=True)
        except fairqueue.QueueFullError as e:
            with self._abort_lock:
                self._queued_rids.discard(request.request_id)
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
        if isinstance(req.outputs, _ReplayGate) or \
                req.request_id in self._resuming or \
                req.prefilled is not None:
            # A replayer was decoding before its fault or its preemption:
            # shedding it would break the stream its client already holds.
            # A prefilled request's expensive half is already paid for.
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
        guide = len(self._awaiting_guide)
        resume = sum(isinstance(r, _ResumeState)
                     for r in self._awaiting_restore)
        restore = len(self._awaiting_restore) - resume
        # Preempted victims: spill in flight, in host RAM, or scattering
        # back into a slot.
        preempt = len(self._swap_pending) + len(self._swapped) + resume
        model = len(self._awaiting_model)
        m.num_requests_waiting.set(self._queue.qsize() + guide + restore
                                   + preempt + model)
        m.requests_parked.set(guide, reason="guide")
        m.requests_parked.set(restore, reason="restore")
        m.requests_parked.set(model, reason="model")
        m.requests_parked.set(preempt, reason="preempt")

    def abort(self, request_id: str) -> None:
        """Free the request's slot at the next scheduler boundary."""
        with self._abort_lock:
            self._aborted.add(request_id)

    def start(self) -> None:
        self._running = True
        self.trace.start()
        deadline = knobs.get_float("ARKS_DISPATCH_DEADLINE_S", minimum=0)
        if deadline > 0:
            # Wedged-dispatch escalation: a device call that never returns
            # cannot be cancelled from Python — flip the state (readiness
            # answers 503), dump diagnostics, exit 70 so the supervisor
            # restarts the process.  The deadline must exceed the slowest
            # step, the kernels' first-launch builds included.
            self._watchdog = faults_mod.Watchdog(
                deadline, lambda: self._step_hb, self._on_wedged,
                exit_fn=lambda code: self._exit_fn(code))
            self._watchdog.start()
        self._thread = threading.Thread(target=self._run, name="engine",
                                         daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        self.trace.stop()
        if self._watchdog is not None:
            # Its callbacks close over this engine: a watchdog kept past
            # the stop would be a cycle holding it.
            self._watchdog.stop()
            self._watchdog = None
        if self._thread is not None:
            self._thread.join(timeout=120.0)
            if self._thread.is_alive():
                log.warning("engine thread did not exit within 120s")
        # Graceful stop: the warm prefixes still on the device or in the
        # host tier go to the disk tier before the writer's sentinel, so a
        # relaunch on the same directory serves them without a prefill.
        if self._disk is not None:
            try:
                self._flush_warm_to_disk()
            except Exception as e:   # warmth, not the shutdown
                faults_mod.swallowed("disk_tier.flush", e)
        for wq in (self._disk_write_queue, self._fetch_queue):
            if wq is not None:
                try:
                    wq.put(None, timeout=5.0)
                except queue.Full as e:
                    faults_mod.swallowed("fleet_tiers.stop", e)
        if self._disk_writer is not None:
            self._disk_writer.join(timeout=30.0)

    def _on_wedged(self, phase: str, age_s: float) -> None:
        """Watchdog callback: record the wedged state (readiness reads it)
        and log the in-flight picture an operator needs post-mortem."""
        self._set_state("wedged")
        log.critical(
            "wedged dispatch diagnostics: phase=%s age=%.1fs slots=%s "
            "prefilling=%s pending_admits=%d pipe_inflight=%d queue=%d",
            phase, age_s,
            {s: st.request.request_id for s, st in self._slots.items()},
            {s: cs.request.request_id for s, cs in self._prefilling.items()},
            self._pending_n, len(self._pipe_inflight), self._queue.qsize())
        self._log_flight_tail(log.critical, self.trace.tail())

    @staticmethod
    def _log_flight_tail(emit, tail: list) -> None:
        """The flight recorder's last events on one log line: the dump
        ships its own timeline."""
        if tail:
            emit("flight recorder (last %d events): %s", len(tail),
                 "; ".join(f"{e['t']:.3f} {e['rid'] or '<engine>'} "
                           f"{e['name']}/{e['ph']}" for e in tail))

    def _set_state(self, state: str) -> None:
        self._state = state
        self.metrics.engine_state.set(faults_mod.STATE_CODES[state])

    @property
    def state(self) -> str:
        """"serving" | "recovering" | "wedged" — the /readiness gate."""
        return self._state

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
                and not self._awaiting_fetch
                and not self._swap_pending and not self._swapped
                and not self._awaiting_model and self._queue.empty())

    @property
    def serving(self) -> bool:
        """The step loop runs (started, not stopped, its thread alive)."""
        return (self._running and self._thread is not None
                and self._thread.is_alive())

    def _run(self) -> None:
        try:
            self._run_loop()
        finally:
            # No scheduler remains to unpark or register them.
            self._abort_awaiting_guide()
            self._abort_awaiting_model()
            self._abort_pending_admits()
            self._abort_awaiting_restores()
            self._abort_awaiting_fetches()
            self._abort_swapped()

    def _run_loop(self) -> None:
        prof = self.profiler
        # Profiler windows open and close on this thread (obs/profiler.py).
        prof.bind(threading.current_thread())
        try:
            self._loop_steps(prof)
        finally:
            if prof.active:
                prof.stop()
            prof.bind(None)

    def _loop_steps(self, prof: ProfilerWindows) -> None:
        while self._running:
            prof.pump()
            t0 = time.monotonic()
            self._step_hb = ("step", t0)
            try:
                if prof.active:
                    # Stamp the live span ids into the profile's timeline,
                    # so it correlates back to the trace store.
                    with prof.annotate("arks_step", self.trace.live_ids()):
                        self.step()
                else:
                    self.step()
                self.warm = True
                self._consec_faults = 0
            except Exception as e:
                # Fault-isolated recovery: quarantine the culprit
                # request(s), rebuild the device state in place, and
                # token-replay every other in-flight request so that its
                # stream resumes byte-identically.
                self._recover_from_fault(e)
            finally:
                self._step_hb = None
            # Auto-arm hook: a step whose wall time jumps past
            # ARKS_PROF_AUTO_ARM x the trailing median opens a profiler
            # window by itself (closed after ARKS_PROF_WINDOW_S).
            prof.on_step(time.monotonic() - t0)

    # ------------------------------------------------------------------
    # Fault-isolated recovery
    # ------------------------------------------------------------------

    def _recover_from_fault(self, exc: Exception) -> bool:
        """Top-level fault handler: attempt quarantine + token-replay
        recovery, escalating to the blanket abort-everything path only
        when recovery itself keeps faulting (crash-loop guard).  A CUDA
        error that poisons the context goes to ``_wedge``."""
        if faults_mod.is_sticky(exc):
            self._wedge(exc)
            return True
        self._set_state("recovering")
        self._recover_t0 = time.monotonic()
        attempts = max(self._fault_retries + 2, 3)
        for _ in range(attempts):
            try:
                self._do_recovery(exc)
                return True
            except Exception as e:  # routed back into _do_recovery
                if faults_mod.is_sticky(e):
                    self._wedge(e)
                    return True
                exc = e
        log.error("recovery kept faulting after %d attempts; falling back "
                  "to abort-everything", attempts)
        self._blanket_abort(exc)
        return True

    def _wedge(self, exc: BaseException) -> None:
        """A sticky CUDA error (an illegal address, a device-side assert,
        an unspecified launch failure): every later CUDA call fails too, so
        the device state cannot be rebuilt in this process and recovery
        would fault forever.  Fail every request in flight or queued with
        an error, flip to "wedged" (readiness answers 503), log the flight
        recorder, and exit 70 so the supervisor restarts the process — the
        escalation of the dispatch watchdog."""
        self._set_state("wedged")
        log.critical("sticky device error: the CUDA context is unusable; "
                     "failing every request and exiting 70", exc_info=exc)
        self._log_flight_tail(log.critical, self.trace.tail())
        err = "engine_fault: device/wedged"
        failed = [(st.request, st.num_prompt, len(st.generated))
                  for st in self._slots.values()]
        failed += [(cs.request, len(cs.ids), 0)
                   for cs in self._prefilling.values()]
        failed += [(req, len(ids), 0) for rec in self._pending_admits
                   for req, ids, _ in rec[0]]
        failed += [(rec.request, len(rec.ids), 0)
                   for rec in self._awaiting_restore]
        failed += [(req, len(req.prompt_ids), 0)
                   for req, _ in self._awaiting_guide]
        failed += [(rec.request, rec.num_prompt, len(rec.generated))
                   for rec in [sw.rec for sw in self._swap_pending]
                   + list(self._swapped.values())]
        while True:
            try:
                _, _, req = self._queue.get_nowait()
            except queue.Empty:
                break
            failed.append((req, len(req.prompt_ids), 0))
        self._slots.clear()
        self._prefilling.clear()
        self._pending_admits.clear()
        self._pending_n = 0
        self._awaiting_restore = []
        self._awaiting_guide = []
        self._swap_pending = []
        self._swapped.clear()
        for req, n_prompt, n_gen in failed:
            req.outputs.put(RequestOutput(
                request_id=req.request_id, token_ids=[], finished=True,
                finish_reason="error", error=err,
                num_prompt_tokens=n_prompt, num_generated_tokens=n_gen))
            self.metrics.request_success_total.inc(reason="error")
        self._update_waiting()
        self._running = False
        # A moment for the server's threads to answer the failed requests.
        time.sleep(0.5)
        self._exit_fn(70)

    def _do_recovery(self, exc: Exception) -> None:
        """One recovery round: attribute, quarantine culprits over budget,
        snapshot every other in-flight request, re-queue the survivors
        (token replay for streams that already emitted, plain re-queue for
        the rest), and rebuild the device state in place."""
        if isinstance(exc, StepFault):
            phase, kind = exc.phase, exc.kind
            culprits = set(exc.culprits)
            survivors: list[_Survivor] = list(exc.survivors)
            cause = exc.__cause__ or exc
        else:
            phase, kind = "step", faults_mod.classify(exc)
            culprits, survivors = set(), []
            cause = exc
        self._consec_faults += 1
        self.metrics.engine_faults_total.inc(1, phase=phase, kind=kind)
        log.error("engine fault in phase %r (kind=%s, culprits=%s, "
                  "consecutive=%d); recovering",
                  phase, kind, sorted(culprits) or "-", self._consec_faults,
                  exc_info=cause)
        # Flight recorder: snapshot the ring tail ONCE and pin it onto
        # every culprit's eventual trace (recovery is a slow path).
        self.trace.evt("", "recover", "B", f"{phase}/{kind}")
        flight_tail = self.trace.tail()
        self._log_flight_tail(log.error, flight_tail)
        for rid in culprits:
            self._fault_counts[rid] = self._fault_counts.get(rid, 0) + 1
            self.trace.evt(rid, "fault", "I", f"{phase}/{kind}")
            self.trace.attach_tail(rid, flight_tail)
        if self._consec_faults > max(self._fault_retries + 1, 2):
            # Unattributed (or mis-attributed) fault storm: per-request
            # budgets cannot bound it — stop the crash loop.  The survivors
            # this round could not take in ride the fault on, to the
            # blanket abort that ends them.
            raise StepFault(
                "step", "runtime", survivors=survivors,
                message=f"{self._consec_faults} consecutive step faults"
            ) from cause

        # ---- snapshot every in-flight request --------------------------
        for st in self._slots.values():
            survivors.append(_Survivor(
                request=st.request, seed=self._resolve_seed(st.request),
                num_prompt=st.num_prompt, generated=list(st.generated),
                num_emitted=st.num_emitted, shape=st.shape))
        for cs in self._prefilling.values():
            # Mid-prefill sequences re-run from the top (nothing emitted);
            # a replaying one keeps its gate, restarted at re-admission.
            survivors.append(self._survivor_of(cs.request, len(cs.ids)))
        for rec in self._pending_admits:
            for req, ids, _ in rec[0]:
                survivors.append(self._survivor_of(req, len(ids)))
            self._dropped_copies.append(rec[2])
        for rst in self._awaiting_restore:
            if isinstance(rst, _ResumeState):
                # A preempt resume mid-scatter replays like any decoding
                # survivor (the swap path itself may be what faulted).
                survivors.append(self._swap_survivor(rst.rec))
                continue
            # Restore-parked requests emitted nothing: plain re-queue.  The
            # host tier survives the reset, so the re-run's admission hits
            # it again instead of re-prefilling.
            survivors.append(_Survivor(
                request=rst.request, seed=self._resolve_seed(rst.request),
                num_prompt=len(rst.ids)))
        self._awaiting_restore = []
        for fs in self._awaiting_fetch:
            # Fetch-parked requests emitted nothing and hold no pages: a
            # plain re-queue; the blocks the worker staged stay in the host
            # tier for the re-run (a worker still fetching finishes into it
            # harmlessly).
            survivors.append(_Survivor(request=fs.request, seed=fs.seed,
                                       num_prompt=len(fs.ids)))
        self._awaiting_fetch = []
        # Preempted victims (spill in flight, or parked in host RAM) replay
        # rather than trust a snapshot that may share the fault's stream;
        # their SwapStore bytes come back.
        for sw in self._swap_pending:
            survivors.append(self._swap_survivor(sw.rec))
            self._dropped_copies.extend(sw.copies())
        self._swap_pending = []
        for rid_sw, rec_sw in self._swapped.items():
            self._swap.discard(rid_sw)
            survivors.append(self._swap_survivor(rec_sw))
        self._swapped.clear()
        if self._swap is not None:
            self.metrics.prefix_cache_usage_bytes.set(self._swap.bytes_used,
                                                      tier="swap")
        self._slots.clear()
        self._prefilling.clear()
        self._pending_admits.clear()
        self._pending_n = 0
        self.metrics.num_requests_running.set(0)

        # ---- quarantine / abort / keep ---------------------------------
        with self._abort_lock:
            aborted = set(self._aborted)
        keep: list[_Survivor] = []
        seen: set[str] = set()
        err = f"engine_fault: {phase}/{kind}"
        for sv in survivors:
            rid = sv.request.request_id
            if rid in seen:
                continue
            seen.add(rid)
            if rid in aborted:
                # Abort raced the fault: honor it instead of replaying.
                with self._abort_lock:
                    self._aborted.discard(rid)
                self._fail_survivor(sv, "abort", None)
                continue
            if self._fault_counts.get(rid, 0) > self._fault_retries:
                # The culprit fails ALONE: finish_reason="error" maps to
                # an OpenAI-style 500 at the HTTP layer.
                self.metrics.requests_quarantined_total.inc(1)
                with logctx.bound(rid):
                    log.warning("quarantining %s after %d faults (%s)", rid,
                                self._fault_counts[rid], err)
                self.trace.attach_tail(rid, flight_tail)
                self.trace.evt(rid, "quarantined", "I", err)
                self._fail_survivor(sv, "error", err)
                continue
            keep.append(sv)

        # ---- re-admit survivors ----------------------------------------
        # BEFORE the device reset: if the rebuild itself faults, the
        # survivors ride the queue into the next recovery round instead of
        # vanishing with this frame's locals.  Nothing admits until
        # recovery returns, so ordering is otherwise free.
        replay_n = 0
        for sv in keep:
            req = sv.request
            rid = req.request_id
            gate = (req.outputs
                    if isinstance(req.outputs, _ReplayGate) else None)
            if sv.generated or gate is not None:
                # Token-replay resume by deterministic re-execution: wrap
                # (or restart) the emission gate, then re-run the request
                # from its prompt with its pinned seed; the gate drops the
                # already-delivered prefix and checks every regenerated
                # token.  Replayers jump the admission queue (the fair
                # queue's urgent lane): they were decoding before the
                # fault.
                if gate is None:
                    req.outputs = _ReplayGate(req.outputs, self, rid,
                                              sv.generated, sv.num_emitted)
                else:
                    gate.restart(sv.generated)
                self._replaying.add(rid)
                if sv.shape is not None:
                    self._replay_shape[rid] = sv.shape
                self.trace.evt(rid, "replay", "I", len(sv.generated))
                prio = req.params.priority - (1 << 20)
                replay_n += 1
            else:
                # Nothing emitted yet: plain re-queue (the pinned seed
                # makes the re-run byte-identical to a fault-free
                # admission).
                prio = req.params.priority
                self.metrics.requests_recovered_total.inc(1)
            with self._abort_lock:
                self._queued_rids.add(rid)
                self._queue_seq += 1
                seq = self._queue_seq
            self._queue.put((prio, seq, req))
        self._update_waiting()

        # ---- rebuild the device state in place -------------------------
        self._reset_device_state()
        self.trace.evt("", "recover", "E")
        # Assemble NOW so quarantined timelines are retained even if the
        # process dies before the collector's next pass.
        self.trace.flush()
        if not replay_n:
            self._finish_recovery()

    def _phase_culprits(self, phase: str):
        """Blast-radius attribution for a phase-scoped fault: the requests
        the failing operation was doing work for.  Guide-table uploads
        serve no specific request — nobody's retry budget burns for one."""
        if phase == "guide":
            return ()
        if phase == "model_switch":
            # The switch serves the requests parked for its target; nobody
            # else is in flight (switches run drained).
            return [req.request_id for req, want, _ in self._awaiting_model
                    if want == self._switch_target]
        if phase == "residency":
            # The span-streaming step works for the engaged slots alone.
            if self._residency is None:
                return ()
            return [self._slots[s].request.request_id
                    for s in self._residency.slots if s in self._slots]
        if phase == "preempt":
            # Every preempt site names its victim; an unattributed preempt
            # fault is host-side scheduling code: blame the swap traffic,
            # not the decoding slots.
            return ([sw.rec.request.request_id for sw in self._swap_pending]
                    + list(self._swapped)
                    + [r.request.request_id for r in self._awaiting_restore
                       if isinstance(r, _ResumeState)])
        rids = [st.request.request_id for st in self._slots.values()]
        if phase in ("mixed", "spec"):
            rids += [cs.request.request_id
                     for cs in self._prefilling.values()]
        return rids

    def _live_rids(self) -> set:
        """Request ids somewhere in the engine's in-flight structures
        (everything except the admission queue) — the abort-purge and
        replay-liveness universe."""
        live = {st.request.request_id for st in self._slots.values()}
        live |= {cs.request.request_id for cs in self._prefilling.values()}
        live |= {req.request_id for rec in self._pending_admits
                 for req, _, _ in rec[0]}
        live |= {req.request_id for req, _ in self._awaiting_guide}
        live |= {rec.request.request_id for rec in self._awaiting_restore}
        live |= {st.request.request_id for st in self._awaiting_fetch}
        live |= {req.request_id for req, _, _ in self._awaiting_model}
        live |= {sw.rec.request.request_id for sw in self._swap_pending}
        live |= set(self._swapped)
        return live

    def _fail_survivor(self, sv: _Survivor, reason: str,
                       error: str | None) -> None:
        rid = sv.request.request_id
        self._unpin_guide(sv.request)
        self._fault_counts.pop(rid, None)
        self._replaying.discard(rid)
        self._replay_shape.pop(rid, None)
        sv.request.outputs.put(RequestOutput(
            request_id=rid, token_ids=[], finished=True,
            finish_reason=reason, error=error,
            num_prompt_tokens=sv.num_prompt,
            num_generated_tokens=len(sv.generated)))
        if reason == "error":
            self.metrics.request_success_total.inc(reason="error")

    def _finish_recovery(self) -> None:
        dt = time.monotonic() - self._recover_t0
        self.metrics.engine_recovery_seconds.observe(dt)
        self._set_state("serving")
        log.info("recovery complete in %.3fs", dt)

    def _maybe_finish_recovery(self) -> None:
        """Close the recovery window once the last replaying request has
        re-registered into a decoding slot (or died on the way):
        engine_recovery_seconds measures fault -> every surviving stream
        decoding again."""
        if self._state != "recovering":
            return
        if self._replaying:
            # Drop replayers that went terminal without re-registering
            # (an abort or per-request rejection raced the re-run).
            live = self._live_rids()
            with self._abort_lock:
                live |= self._queued_rids
            self._replaying &= live
            for rid in set(self._replay_shape) - self._replaying - \
                    self._resuming:
                del self._replay_shape[rid]
            if self._replaying:
                return
        self._finish_recovery()

    def _blanket_abort(self, exc: Exception) -> None:
        """Last-resort path (recovery crash loop): fail EVERY in-flight
        request and rebuild — the behavior before recovery existed, kept
        as the backstop so an unattributable fault storm cannot spin
        forever."""
        log.error("engine step failed; aborting in-flight requests",
                  exc_info=exc)
        seen = set()
        for sv in getattr(exc, "survivors", ()):
            # Requests that lived only in the failing frames' locals.
            if sv.request.request_id not in seen:
                seen.add(sv.request.request_id)
                self._fail_survivor(sv, "abort", None)
        for slot in list(self._slots):
            self._finish(slot, "abort")
        for slot in list(self._prefilling):
            self._abort_prefill(slot)
        self._abort_pending_admits()
        self._abort_awaiting_restores()
        self._abort_awaiting_fetches()
        self._abort_awaiting_model()
        # Preempted victims fail too, and their SwapStore entries go with
        # them: swapped-out KV may carry the poison back on resume.
        self._abort_swapped()
        # Deep clean: cached prefix KV may itself be the poison.
        if self._prefix is not None:
            self._prefix.clear()
            self.metrics.prefix_cache_usage_bytes.set(0, tier="host")
        if self._host is not None:
            self._host.clear()
            self.metrics.prefix_cache_usage_bytes.set(0, tier="host")
        if self._disk is not None:
            # The disk tier too, files and all, or the poison would come
            # back with the next boot's scan.
            self._disk_spill_pending.clear()
            self._disk.clear()
            self.metrics.prefix_cache_usage_bytes.set(0, tier="disk")
        self._fault_counts.clear()
        self._consec_faults = 0
        self._reset_device_state()
        self._finish_recovery()

    def _reset_device_state(self) -> None:
        """Rebuild the device state IN PLACE after a fault (the reference
        builds a fresh cache because JAX donated the old one; on the card
        the pool is most of memory, so no second one is allocated).  The
        in-flight dispatches, spills and deferred admissions are dropped
        after their copies into pinned buffers have finished; the pool and
        its scales are zeroed (the bytes of a fresh pool), the allocator
        and the device index rebuilt empty, the sampling rows reset, the
        host mirrors parked.  The host prefix tier survives."""
        self._pipe_reset()
        self._spill_victims.clear()
        while self._spills:
            self._dropped_copies.append(self._spills.popleft()[1])
        for sw in self._swap_pending:
            self._dropped_copies.extend(sw.copies())
        self._swap_pending = []
        dropped, self._dropped_copies = self._dropped_copies, []
        for copy in dropped:
            copy.drop()
        for t in self.cache:
            if t is not None:
                t.zero_()
        if self._draft_cache is not None:
            # The draft's slot cache too (its rows are rewritten by every
            # registration's draft prefill; zeroed as a fresh cache is).
            for t in self._draft_cache:
                if t is not None:
                    t.zero_()
        n = self.ecfg.num_slots
        if self._paged:
            self._alloc = self._new_allocator(self._alloc.num_pages)
            self._tables[:] = 0
            self._slot_pages.clear()
            if self._residency is not None:
                # The windowed slots' stores hold the pre-reset streams;
                # their requests replay from the top.
                self._residency.slots.clear()
        sampler_mod.reset_sampling_state_(self._sampling, self.ecfg.seed)
        self._lengths[:] = self._park_sentinel() if self._paged else 0
        self._last_token[:] = 0
        # A fault between ``_free.pop()`` and registration would otherwise
        # leak the slot index.
        self._free = [s for s in range(n) if s not in self._slots]
        if self._sketch is not None:
            # The rebuilt index is empty: a new epoch makes routers drop
            # the pre-reset sketch at their next poll.
            self._sketch.bump_epoch()

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
        self._maybe_finish_recovery()
        if not self._armed:
            # Scaled to zero: no device state exists; the only work is
            # re-arming on demand.
            return self._step_disarmed(block_s)
        worked = False
        if self._idle_zero_s:
            worked = self._maybe_scale_to_zero()
            if not self._armed:
                return True
        self._ensure_guides_uploaded()
        if self._awaiting_guide:
            worked = self._service_awaiting_guides() or worked
            tg = time.monotonic()
            sec.inc(tg - t0, phase="guide_wait")
            t0 = tg
        if self._awaiting_model or self._model_loads or self._model_prefetch:
            # Multi-model parks: start or poll the next model's background
            # load, and switch contexts once it is resident and the engine
            # drained.  Never blocks: while the load streams, the resident
            # model keeps its pipeline (the fast path below).
            worked = self._issue_model_load() or worked
            tm = time.monotonic()
            sec.inc(tm - t0, phase="model_wait")
            t0 = tm
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
        if self._residency_active():
            # Windowed-residency slots decode span by span on the host loop
            # (cold pages rotate through staging while the resident spans
            # attend), ahead of the mixed dispatch, whose lanes they leave.
            worked = self._residency_step() or worked
            tw = time.monotonic()
            sec.inc(tw - t0, phase="residency")
            t0 = tw
        if self._awaiting_restore:
            # Restores whose scatter landed continue into the chunked path
            # (on exact host mirrors: the pipeline drained above).
            worked = self._resolve_restores() or worked
            tr = time.monotonic()
            sec.inc(tr - t0, phase="restore")
            t0 = tr
        if self._awaiting_fetch:
            # Disk and peer fetches whose worker finished re-enter the
            # admission match; those in flight stay parked.
            worked = self._resolve_fetches() or worked
            tq = time.monotonic()
            sec.inc(tq - t0, phase="fetch")
            t0 = tq
        if self._spills:
            worked = self._resolve_spills() or worked
        if self._disk_spill_pending:
            worked = self._drain_disk_spills() or worked
        self._queue_age_tick()
        if self._swap_pending or self._swapped or self._preempt_on:
            # Preemptive KV swap: harvest landed victim spills into the
            # SwapStore, serve aborts and resumes of swapped-out victims,
            # then seize slots for outranking queued requests — all before
            # the issue block, so a freed slot admits in this same step.
            tp = time.monotonic()
            if self._swap_pending:
                worked = self._resolve_preempt_swaps() or worked
            if self._swapped:
                worked = self._service_swapped() or worked
            worked = self._maybe_preempt() or worked
            t0 = time.monotonic()
            if t0 - tp > 1e-4:
                sec.inc(t0 - tp, phase="preempt")
        if self._mixed:
            # A speculative engine's dispatch is the speculative mixed step
            # (draft proposals, verify blocks and chunks in one batch).
            spec = self._draft_cfg is not None
            phase = "spec" if spec else "mixed"
            rec = None
            if self._slots or self._prefilling:
                rec = (self._issue_spec_mixed() if spec
                       else self._issue_mixed())
            t1 = time.monotonic()
            if rec is not None:
                sec.inc(t1 - t0, phase=phase)
            worked = self._admit() or worked
            t2 = time.monotonic()
            if t2 - t1 > 1e-4:
                sec.inc(t2 - t1, phase="admit")
            if rec is not None:
                if spec:
                    self._resolve_spec_mixed(rec, exclude_s=t2 - t1)
                else:
                    self._resolve_mixed(rec, exclude_s=t2 - t1)
                sec.inc(time.monotonic() - t2, phase=phase)
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
        if self._awaiting_restore or self._spills or self._swap_pending \
                or self._swapped or self._awaiting_model or self._model_loads \
                or self._awaiting_fetch:
            # They land on device (or loader-thread) time, not on queue
            # arrivals: poll again.
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
        # (bucket, replay shape) -> one-shot items; a replayer's batch is
        # padded back to its original admission's size.
        groups: dict[tuple[int, int], list] = {}
        try:
            while self._free:
                # Requests parked on a prefix restore hold pages for a slot
                # they have yet to take: they count against the free slots
                # (a preempt resume holds its slot already).
                if sum(len(v) for v in groups.values()) + sum(
                        isinstance(r, _RestoreState)
                        for r in self._awaiting_restore) >= len(self._free):
                    break
                try:
                    _, _, req = self._queue.get_nowait()
                except queue.Empty:
                    break
                try:
                    # Chaos hook at the fair queue's pick point: the popped
                    # request is the sole culprit AND a survivor (nothing
                    # was emitted: recovery re-queues it).
                    self._faults.fire("admit_fair")
                except Exception as e:
                    with self._abort_lock:
                        self._queued_rids.discard(req.request_id)
                    raise StepFault(
                        "admit_fair", faults_mod.classify(e),
                        culprits=[req.request_id],
                        survivors=[self._survivor_of(req)]) from e
                admitted = True
                pre = self._preadmit(req)
                if pre is not None:
                    key = (pre[2].shape[1], self._replay_admit_m(req))
                    groups.setdefault(key, []).append(pre)
            for (_, shape), items in groups.items():
                while items:
                    m = shape or next(x for x in self._admit_sizes
                                      if x <= len(items))
                    # Detach BEFORE issuing: a failing issue carries its
                    # own items as survivors.
                    batch = items[:m]
                    del items[:m]
                    rec = self._issue_admit_batch(batch)
                    self._pending_admits.append(rec)
                    self._pending_n += len(rec[0])
            if self._pending_admits:
                self._drain_ready_admits()
        except Exception as e:
            # Items not issued yet hold no slot and are registered nowhere
            # (invisible to the recovery snapshot): carry them on the
            # StepFault so recovery re-queues them.  (Issued batches are
            # deferred admissions, which the snapshot sees.)
            survivors = [self._survivor_of(req) for items in groups.values()
                         for req, _, _ in items]
            if isinstance(e, StepFault):
                e.survivors.extend(survivors)
                raise
            raise StepFault("admit", faults_mod.classify(e),
                            survivors=survivors) from e
        return admitted

    def _survivor_of(self, req: Request, num_prompt: int | None = None
                     ) -> _Survivor:
        """A request that emitted nothing yet, as a recovery survivor (a
        replayer keeps its original prefill's shape)."""
        return _Survivor(request=req, seed=self._resolve_seed(req),
                         num_prompt=len(req.prompt_ids) if num_prompt is None
                         else num_prompt,
                         shape=self._replay_shape.get(req.request_id))

    def _replay_admit_m(self, req: Request) -> int:
        """The one-shot batch size a replayer's admission pads to (0: not a
        replayer of a one-shot admission)."""
        shape = self._replay_shape.get(req.request_id)
        return shape.admit_m if shape is not None else 0

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
            items, slots, copy, *_ = self._pending_admits.popleft()
            self._dropped_copies.append(copy)
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
            self._queued_rids.discard(req.request_id)
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
            self.trace.evt(req.request_id, "shed", "I", round(waited, 3))
            req.outputs.put(RequestOutput(
                request_id=req.request_id, token_ids=[], finished=True,
                finish_reason="error",
                error=(f"shed_deadline: queued {waited:.2f}s, tier {tier} "
                       "ttft budget already unmeetable"),
                num_prompt_tokens=len(req.prompt_ids)))
            return None
        if isinstance(req.outputs, _ReplayGate):
            # Fault-recovery re-admission: a per-request injectable point
            # ("replay"), attributed to THIS request alone, carrying its
            # replay state.
            try:
                self._faults.fire("replay")
            except Exception as e:
                raise StepFault(
                    "replay", faults_mod.classify(e),
                    culprits=[req.request_id],
                    survivors=[_Survivor(
                        request=req, seed=self._resolve_seed(req),
                        num_prompt=len(req.prompt_ids),
                        generated=list(req.outputs.expect),
                        num_emitted=req.outputs.client_total,
                        shape=self._replay_shape.get(req.request_id))]
                ) from e
        want = req.model or self._primary_model
        if want != self.cfg.name or (self._switch_target is not None
                                     and self._switch_target != self.cfg.name):
            # The request targets a pool model that is not active, or a
            # switch away from the active model is committed (admitting
            # would keep the drain from converging): park it.  Before the
            # guide gate: a guide's pin belongs to its model's compiler.
            self._park_awaiting_model(req, want)
            return None
        if req.prefilled is not None:
            if req.params.guide is not None and \
                    self._gate_guide_or_fail(req, req.prefilled.num_prompt):
                return None
            self._admit_prefilled(req)
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
        if req.params.guide is not None and \
                self._gate_guide_or_fail(req, len(ids)):
            return None
        if self._prefix_hit(req, ids):
            return None
        if self._mixed or len(ids) > self._one_shot_limit():
            self._start_chunked(req, ids)
            return None
        return req, ids, self._pad_to_bucket(ids)

    def _gate_guide_or_fail(self, req: Request, num_prompt: int) -> bool:
        """The guide gate at admission: park while the guide compiles, fail
        on a compile error, else PIN the published guide for the request's
        life (eviction cannot repack the rows its slot decodes against).
        Returns True when the request was parked or failed here."""
        gate = self._gate_guide(req)
        if gate is None:
            return False
        if gate != "park":
            req.outputs.put(RequestOutput(
                request_id=req.request_id, token_ids=[], finished=True,
                finish_reason="error", error=f"guide_compile_failed: {gate}",
                num_prompt_tokens=num_prompt))
            log.info("rejected %s: guide compile failed: %s",
                     req.request_id, gate)
        return True

    def _prefix_hit(self, req: Request, ids: list[int]) -> bool:
        """Prefix reuse at admission (the reference's ``_preadmit``).  A
        paged pool matches the prompt's chained page digests against the
        device index, then the consecutive blocks after them against the
        host tier: a host hit parks the request on a restore, a device hit
        starts it chunked after its shared pages.  The slot cache matches
        its host prefix cache.  At least one tail token is always left to
        compute (its logits sample the first token).  Returns True when
        the request was started or parked here.  A replayer reuses no more
        than its original prefill did (``_ReplayShape``: none after a
        one-shot admission, ``chunk_start`` tokens after a chunked one),
        so that its prefill repeats the original's shapes: its own prompt
        pages, registered by the original, would start it later."""
        page = self._page
        shape = self._replay_shape.get(req.request_id)
        limit = None if shape is None else \
            0 if shape.admit_m else shape.chunk_start
        if self._paged:
            nfull = (len(ids) - 1) // page
            digests = chain_digests(ids, page, nfull) if nfull else []
            usable = digests if limit is None else digests[:limit // page]
            shared = self._alloc.match(usable)
            blocks = []
            if self._host is not None and len(shared) < len(usable):
                blocks = self._host.match_blocks(usable, len(shared))
            plen, hlen = len(shared) * page, len(blocks) * page
            self._alloc.record_query(len(ids), plen + hlen)
            self._count_prefix(len(ids), plen, hlen, self._alloc.hit_rate)
            covered = len(shared) + len(blocks)
            if covered < len(usable) and \
                    self._fetch_candidate(req, usable, covered):
                # The uncovered span is on the local disk or (by the
                # router's hint) on a peer: park for a fetch into the host
                # tier instead of prefilling it.  The device references
                # go back: the resolve matches afresh.
                self._alloc.decref(shared)
                self._issue_fetch(req, ids, usable, covered)
                return True
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
        if limit is not None:
            plen = min(plen, limit)
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
            shared = list(prefix_pages or ())
            try:
                self._faults.fire("pages")
                self._assign_slot_pages(slot, pages_needed(
                    len(ids), self.ecfg.steps_per_dispatch, self._page,
                    self._max_pages), head_pages=shared)
            except Exception as e:
                self._alloc.decref(shared)
                self._free.append(slot)
                raise StepFault(
                    "pages", faults_mod.classify(e),
                    culprits=[req.request_id],
                    survivors=[self._survivor_of(req)]) from e
        elif prefix_len:
            # Exactly the prefix's rows: eager PyTorch has no compiled
            # insert shapes to bound (the reference pads to a bucket).
            try:
                k, v = self._prefix.get(ids, prefix_len)
                tf.insert(self.cache, self._upload_tensor(k),
                          self._upload_tensor(v), slot)
            except Exception as e:
                self._free.append(slot)
                raise StepFault(
                    "chunk", faults_mod.classify(e),
                    culprits=[req.request_id],
                    survivors=[self._survivor_of(req)]) from e
        shape = self._replay_shape.get(req.request_id)
        plan = (list(shape.takes) if shape is not None
                and shape.chunk_start == prefix_len else [])
        self._prefilling[slot] = _ChunkState(request=req, ids=ids,
                                             pos=prefix_len,
                                             key=prng.np_prng_key(seed),
                                             digests=digests,
                                             start=prefix_len, plan=plan)
        self.trace.evt(req.request_id, "queue", "E")
        self.trace.evt(req.request_id, "prefill", "B", len(ids))
        # Length parked at the prompt's end: interleaved decode writes land
        # past every masked read until real decode overwrites them.
        self._lengths[slot] = len(ids)
        self._last_token[slot] = 0

    def _purge_stale_aborts(self, consumed=()) -> None:
        live = self._live_rids()
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
        self._faults.fire("pages")
        rows *= ahead + 1
        for slot in self._slots:
            if self._residency is not None and slot in self._residency.slots:
                # An engaged slot owns staging + hot-tail pages only; the
                # residency manager grows its tail itself.
                continue
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
        rows [M], host or device, already advanced by the first token).
        Host columns go up through ``_upload`` (no host sync)."""
        def up(x):
            return x if isinstance(x, torch.Tensor) else \
                self._upload(np.asarray(x))

        idx = up(np.asarray(slots, np.int64))
        temp = up(np.array([p.temperature for p in params], np.float32))
        top_p = up(np.array([p.top_p for p in params], np.float32))
        top_k = up(np.array([p.top_k for p in params], np.int32))
        if not any(_shapes(p) for p in params):
            self._sampling = sampler_mod.set_slots(
                self._sampling, idx, temp, top_p, top_k, keys,
                shaping=False)
            return
        c = self._shaping_cols(params, num_prompts)
        self._sampling = sampler_mod.set_slots(
            self._sampling, idx, temp, top_p, top_k, keys,
            up(np.array([p.presence_penalty for p in params], np.float32)),
            up(np.array([p.frequency_penalty for p in params], np.float32)),
            *(up(c[k]) for k in ("bias_ids", "bias_vals", "suppress_ids",
                                 "min_until", "guide")), up(guide_rows))

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

    @_scoped("guide")
    def _ensure_guides_uploaded(self) -> None:
        """Copy the compiler's tables to the device when its version bumped
        (guides compile on other threads; only this copy runs here)."""
        if self._guide_ver == self.guides.version:
            return
        self._faults.fire("guide")
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
            self.trace.evt(req.request_id, "park.guide", "B")
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
            self.trace.evt(req.request_id, "park.guide", "E")
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
            self._queued_rids.add(req.request_id)
            self._queue_seq += 1
            seq = self._queue_seq
        self._queue.put((req.params.priority, seq, req))

    def _requeue_awaiting_guide(self) -> None:
        """Send every guide-parked request back to the admission queue,
        where it re-ensures its guide: for a rebuild of the compiler (a
        context switch or resize) that drops the tickets they wait on."""
        for req, _ticket in self._awaiting_guide:
            self._requeue(req)
            self.trace.evt(req.request_id, "park.guide", "E")
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
        dropped).  A batch of replayers is padded with empty rows to their
        original admission's size, so that every product runs at the
        original batch's shape.  Returns the record for
        ``_resolve_admit_batch``."""
        m = len(items)
        mp = max([m] + [self._replay_admit_m(req) for req, _, _ in items])
        dev = self.device
        slots: list[int] = []
        try:
            self._faults.fire("admit")
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
            padded = [p for _, _, p in items]
            padded += [np.zeros_like(padded[0])] * (mp - m)
            tokens = torch.from_numpy(np.concatenate(padded)).to(dev)
            lengths = torch.tensor([len(ids) for _, ids, _ in items]
                                   + [1] * (mp - m),
                                   dtype=torch.int32, device=dev)
            params = [req.params for req, _, _ in items]
            logits, ks, vs = tf.prefill(self.params, self.cfg, tokens,
                                        lengths)
            if mp > m:
                logits, ks, vs = logits[:m], ks[:, :m], vs[:, :m]
            key_t = prng.key_tensor(keys, dev)
            firsts, lp, rows = self._sample_first(logits, params, key_t)
            if self._paged:
                tf.insert_pages_batch(self.cache, ks, vs, pages, n_pages)
            else:
                tf.insert_batch(self.cache, ks, vs, slots)
            self._set_slots(slots, params, prng.fold_in(key_t, 1),
                            [len(ids) for _, ids, _ in items], rows)
        except Exception as e:
            # None of the requests holds a registered slot, so the recovery
            # snapshot cannot see them: carry them as survivors (they
            # re-queue with their pinned seeds; the slot and page
            # bookkeeping is rebuilt by the recovery reset).
            survivors = [self._survivor_of(req) for req, _, _ in items]
            if isinstance(e, StepFault):
                e.survivors.extend(survivors)
                raise
            raise StepFault(
                "admit", faults_mod.classify(e),
                culprits=[req.request_id for req, _, _ in items],
                survivors=survivors) from e
        self.prefill_tokens_total += sum(len(ids) for _, ids, _ in items)
        for req, ids, _ in items:
            self.trace.evt(req.request_id, "queue", "E")
            self.trace.evt(req.request_id, "prefill", "B", len(ids))
        # Only the slot cache's single-prompt harvest reads the prompt's
        # K/V at resolve; anything else would hold them for nothing.
        kv = (ks, vs) if self._prefix is not None and m == 1 else None
        return items, slots, _HostCopy(firsts, lp, self._host_bufs), kv, mp

    def _resolve_admit_batch(self, rec) -> None:
        """Read an admission batch's first tokens and register its slots;
        a request aborted since the issue frees its slot instead.  Each
        registered prompt's full pages enter the device index (a paged
        pool), or a lone prompt's full blocks the host prefix cache (the
        slot cache), unless requests are waiting: the copy to the host
        would hold them up."""
        items, slots, copy, kv, mp = rec
        try:
            self._faults.fire("admit_resolve")
            firsts, lp_h = copy.result()
        except Exception as e:
            # The dispatch failed asynchronously: the requests hold slots
            # the recovery snapshot will not see (not registered); carry
            # them as survivors so they re-queue with their pinned seeds.
            self._dropped_copies.append(copy)
            raise StepFault(
                "admit_resolve", faults_mod.classify(e),
                culprits=[req.request_id for req, _, _ in items],
                survivors=[self._survivor_of(req)
                           for req, _, _ in items]) from e
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
                                self._first_lp(req.params, lp_h, i),
                                shape=_ReplayShape(admit_m=mp))
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
        rid = st.request.request_id
        self.trace.evt(rid, "chunk", "I", st.pos)
        padded = np.zeros((c,), np.int32)
        padded[:valid] = chunk
        dev = self.device
        try:
            self._faults.fire("chunk")
            tokens = torch.from_numpy(padded).to(dev)
            if self._paged:
                row = torch.from_numpy(self._tables[slot].copy()).to(dev)
                logits = tf.prefill_chunk_paged(self.params, self.cfg,
                                                self.cache, row, tokens,
                                                st.pos, valid)
            else:
                logits = tf.prefill_chunk(self.params, self.cfg, self.cache,
                                          slot, tokens, st.pos, valid)
        except Exception as e:
            # The chunk dispatch does work for exactly one sequence: the
            # fault is THIS request's, and it carries its replayable state.
            del self._prefilling[slot]
            raise StepFault(
                "chunk", faults_mod.classify(e), culprits=[rid],
                survivors=[self._survivor_of(st.request)]) from e
        self.prefill_tokens_total += valid
        st.pos += valid
        st.takes.append(valid)
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
                            self._first_lp(p, lp_h, 0), shape=_ReplayShape(
                                chunk_start=st.start, takes=tuple(st.takes)))
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

    @_scoped("decode")
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
        self._faults.fire("decode")
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

    @_scoped("decode")
    def _resolve_decode(self, rec, exclude_s: float = 0.0) -> None:
        """Read a decode dispatch's tokens (the host sync point) and fan
        them out to the slots of its snapshot.  ``exclude_s``, the
        overlapped admission's wall time, is not decode time (TPOT)."""
        snapshot, copy, t_issue = rec
        self._faults.fire("resolve")
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
        takes: dict[int, int] = {}
        # A replaying sequence cuts its prompt where its original prefill
        # did (_ReplayShape); the others share the rest of the budget.
        for slot, st in pre:
            if st.plan and budget > 0:
                take = min(st.plan[0], len(st.ids) - st.pos, budget)
                if take > 0:
                    takes[slot] = take
                    budget -= take
        free = [(slot, st) for slot, st in pre if not st.plan]
        quota = max(budget // max(len(free), 1), 1)
        for slot, st in free:
            if budget <= 0:
                break
            take = min(len(st.ids) - st.pos, quota, budget)
            if take > 0:
                takes[slot] = take
                budget -= take
        for slot, st in free:
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

    @_scoped("mixed")
    def _issue_mixed(self):
        """Build and run ONE mixed dispatch: every decoding slot's next
        token plus the round-robin chunk fill.  A decode lane computes
        exactly what the pipe step computes for it, whatever else the step
        carries (what token replay needs: on the card a GEMM's bits change
        with M): slot s decodes in row s of a ``num_slots``-row block, the
        other rows parked as the pipe step parks its dead lanes.  A step
        that carries prefill chunks appends them as a second block of the
        chunk budget's rows (the reference's ``num_slots`` + budget flat
        batch), and ``mixed_step`` runs every row-wise product on each
        block apart (``split``), with or without a decode lane in the
        first block; a decode-only step is the first block alone.  The
        padding rows write nothing and attend nothing.  Returns the
        record for ``_resolve_mixed`` or None when nothing needs the
        model."""
        self._abort_and_retire(2)
        if not self._slots and not self._prefilling:
            return None
        self._ensure_guides_uploaded()
        self._grow_slot_pages(1)
        self._faults.fire("decode")
        n = self.ecfg.num_slots
        dec_slots = list(self._slots)
        if self._residency is not None:
            # Engaged slots decode through _residency_step: the classic
            # attend needs the whole causal prefix resident.
            dec_slots = [s for s in dec_slots
                         if s not in self._residency.slots]
            if not dec_slots and not self._prefilling:
                return None
        a = self._mixed_arrays(n)
        for slot in dec_slots:
            a["tokens"][slot] = self._last_token[slot]
            a["token_slot"][slot] = slot
            a["token_pos"][slot] = self._lengths[slot]
            a["sample_src"][slot] = slot
            a["seq_q_start"][slot] = slot
            a["seq_q_len"][slot] = 1
            a["seq_pos_start"][slot] = self._lengths[slot]
        completing, chunk_take, split, qmax = self._fill_mixed(
            a, n, len(dec_slots))
        t0 = time.monotonic()
        d = {k: self._upload(v) for k, v in a.items()}
        logits = tf.mixed_step(
            self.params, self.cfg, self.cache,
            self._upload(self._tables), d["tokens"],
            d["token_slot"], d["token_pos"], d["sample_src"],
            d["seq_q_start"], d["seq_q_len"], d["seq_pos_start"], qmax=qmax,
            split=split)
        ids_dev, lp = self._sample_mixed(logits, dec_slots, completing)
        self.dispatches += 1
        self.chunk_dispatches += bool(chunk_take)
        self.shared_dispatches += bool(dec_slots and chunk_take)
        return dec_slots, completing, chunk_take, ids_dev, lp, t0

    def _mixed_arrays(self, rows: int) -> dict:
        """The host arrays of a mixed dispatch whose first block holds
        ``rows`` rows (the decode lanes, or the verify blocks), with the
        chunk budget's rows after it; every row starts as padding (its
        write dropped, nothing attended)."""
        n, t = self.ecfg.num_slots, rows + self._mixed_budget
        return dict(tokens=np.zeros((t,), np.int32),
                    token_slot=np.full((t,), -1, np.int32),
                    token_pos=np.full((t,), self._park_sentinel(), np.int32),
                    sample_src=np.zeros((n,), np.int32),
                    seq_q_start=np.zeros((n,), np.int32),
                    seq_q_len=np.zeros((n,), np.int32),
                    seq_pos_start=np.zeros((n,), np.int32))

    def _fill_mixed(self, a: dict, rows: int, dec_tokens: int):
        """Fill the chunk block after the first ``rows`` rows
        (``_fill_chunk_lanes``) and count the batch (``dec_tokens`` decode
        or verify tokens).  A step without chunks is cut to its first
        block, the pipe step's rows.  Returns (completing slots,
        [(slot, take)], the split: ``rows``, or None without chunks,
        qmax)."""
        completing, chunk_take, _ = self._fill_chunk_lanes(a, rows)
        split = rows if chunk_take else None
        if split is None:
            for key in ("tokens", "token_slot", "token_pos"):
                a[key] = a[key][:rows]
        qmax = max(int(a["seq_q_len"].max()), 1)
        n_chunk = sum(take for _, take in chunk_take)
        self.metrics.mixed_batch_tokens.observe(dec_tokens + n_chunk)
        if n_chunk:
            self.metrics.mixed_chunk_tokens_total.inc(n_chunk)
        self._mixed_grid_counters(a["seq_pos_start"], a["seq_q_len"], qmax)
        return completing, chunk_take, split, qmax

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

    @_scoped("mixed")
    def _resolve_mixed(self, rec, exclude_s: float = 0.0) -> None:
        """Host tail of a mixed dispatch: fan the decode tokens out,
        advance every prefilling sequence, promote completed prompts."""
        dec_slots, completing, chunk_take, ids_dev, lp, t_issue = rec
        self._faults.fire("resolve")
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
        self._advance_chunks(chunk_take, completing, ids, lp_h)

    def _advance_chunks(self, chunk_take: list, completing: list[int], ids,
                        lp_h) -> None:
        """The prefill tail of a mixed (or speculative mixed) dispatch:
        advance every sequence that took a chunk, then promote those whose
        prompt completed, with first token ``ids[slot]`` (and its logprob
        data, ``lp_h``)."""
        for slot, take in chunk_take:
            cs = self._prefilling[slot]
            cs.pos += take
            cs.takes.append(take)
            if cs.plan:
                cs.plan.pop(0)
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
                                self._first_lp(p, lp_h, slot),
                                shape=_ReplayShape(chunk_start=cs.start,
                                                   takes=tuple(cs.takes)))
            self._register_prompt_pages(cs.ids, self._slot_pages.get(slot, []),
                                        cs.digests)

    # ------------------------------------------------------------------
    # Speculative decoding: draft proposals verified as ragged lanes of the
    # mixed step
    # ------------------------------------------------------------------

    @_scoped("spec")
    def _issue_spec_mixed(self):
        """Build and run ONE speculative mixed dispatch (the reference's
        ``_issue_spec_mixed``), through ``spec_verify``: the draft's
        proposals for every slot, then one ``mixed_step`` in which every
        decoding slot owns a verify block of ``draft_len`` rows (its last
        token, then the proposals, put into the rows on the device), lane
        s in rows [s * draft_len, (s + 1) * draft_len) of a ``num_slots *
        draft_len`` block, and the round-robin chunk fill follows as a
        second block of
        the chunk budget's rows (``split``, as ``_issue_mixed`` splits):
        the verify block's bits are the pipe step's.  Speculating lanes
        advance 1..draft_len tokens (``speculative_accept``), the others
        one; a completing prompt samples its first token as in the mixed
        step.  Returns the record for ``_resolve_spec_mixed`` or None."""
        dk = self.ecfg.draft_len
        self._abort_and_retire(1 + dk)
        if not self._slots and not self._prefilling:
            return None
        self._ensure_guides_uploaded()
        self._grow_slot_pages(dk)
        self._faults.fire("spec")
        n = self.ecfg.num_slots
        spec_t = n * dk
        a = self._mixed_arrays(spec_t)
        feed = np.zeros((n,), np.int32)
        active = np.zeros((n,), bool)
        enable = np.zeros((n,), bool)
        dec_slots = list(self._slots)
        for slot in dec_slots:
            r0, ln = slot * dk, int(self._lengths[slot])
            a["token_slot"][r0: r0 + dk] = slot
            a["token_pos"][r0: r0 + dk] = np.arange(ln, ln + dk)
            a["seq_q_start"][slot] = r0
            a["seq_q_len"][slot] = dk
            a["seq_pos_start"][slot] = ln
            feed[slot] = self._last_token[slot]
            active[slot] = True
            enable[slot] = self._slots[slot].spec_ok
        completing, chunk_take, split, qmax = self._fill_mixed(
            a, spec_t, len(dec_slots) * dk)
        t0 = time.monotonic()
        d = {k: self._upload(v) for k, v in a.items()}
        feed_d, active_d = self._upload(feed), self._upload(active)
        lengths_d = self._upload(self._lengths)
        dec = [self._slots[s].request.params for s in dec_slots]
        gates = _lane_gates(dec, dec)
        sstate = self._sampling
        if gates.penalties:
            # Feed-time counting, in place: a disabled lane with penalties
            # advances one token a step.
            sampler_mod.count_tokens(sstate, feed_d, active_d)
        logits, vlogits, out, counts, self._sampling = spec_verify(
            self.params, self.cfg, self._draft_params, self._draft_cfg,
            self.cache, self._draft_cache, feed_d, lengths_d, sstate,
            self._upload(enable), active_d,
            self._guide_dev if gates.guide else None, gates, dk, dict(
                tables=self._upload(self._tables),
                token_slot=d["token_slot"], token_pos=d["token_pos"],
                sample_src=torch.cat([
                    torch.arange(spec_t, dtype=torch.int32,
                                 device=self.device), d["sample_src"]]),
                seq_q_start=d["seq_q_start"], seq_q_len=d["seq_q_len"],
                seq_pos_start=d["seq_pos_start"], qmax=qmax, split=split),
            chunk_tokens=None if split is None else d["tokens"][spec_t:])
        comp_ids = torch.zeros_like(counts)
        comp = [self._prefilling[s].request.params for s in completing]
        if completing:
            comp_ids = self._sample_completing(logits[spec_t:], completing)
        ids = torch.cat([out.T, counts[None], comp_ids[None].to(out.dtype)])
        lp = None
        if any(p.logprobs is not None for p in dec + comp):
            # Position 0 of a (never speculating) logprob lane, or a
            # completing lane's first token.
            ov = np.zeros((n,), bool)
            ov[completing] = True
            ov_d = self._upload(ov)
            lp = tuple(x[None].expand(dk + 2, *x.shape)
                       for x in sampler_mod.top_logprobs(
                           torch.where(ov_d[:, None], logits[spec_t:],
                                       vlogits[:, 0]),
                           torch.where(ov_d, comp_ids, out[:, 0])))
        self.dispatches += 1
        self.chunk_dispatches += bool(chunk_take)
        self.shared_dispatches += bool(dec_slots and chunk_take)
        return dec_slots, completing, chunk_take, ids, lp, t0

    def _sample_completing(self, logits: torch.Tensor,
                           completing: list[int]) -> torch.Tensor:
        """First tokens of the prompts completing in a speculative mixed
        dispatch, from their sample rows' ``logits`` [B, V], with the mixed
        step's override columns (``_lane_sampling`` of no decode lane);
        the state it draws with is not kept."""
        st, gates, _ = self._lane_sampling([], completing)
        lengths = self._upload(self._lengths) if gates.min_tokens else None
        ids, _ = sampler_mod.sample(
            logits, st, None, lengths,
            self._guide_dev if gates.guide else None, gates)
        return ids

    @_scoped("spec")
    def _resolve_spec_mixed(self, rec, exclude_s: float = 0.0) -> None:
        """Host tail of a speculative mixed dispatch: fan each decoding
        slot's accepted tokens out (1..draft_len), count the acceptance,
        advance the prefilling sequences and promote completed prompts."""
        dec_slots, completing, chunk_take, ids_dev, lp, t_issue = rec
        self._faults.fire("resolve")
        t0 = time.monotonic()
        ids, lp_h = _to_host(ids_dev, lp)    # the host sync point
        self.metrics.decode_resolve_wait_seconds_total.inc(
            time.monotonic() - t0, mode="sequential")
        dt = max(time.monotonic() - t_issue - exclude_s, 1e-6)
        dk = self.ecfg.draft_len
        tally = [0, 0]
        for slot in dec_slots:
            rows = None
            if lp_h is not None and \
                    self._slots[slot].request.params.logprobs is not None:
                rows = tuple(x[:1, slot] for x in lp_h)
            self._fanout_spec(slot, ids[:, slot], rows, dt, tally)
        self._count_spec(*tally)
        self._advance_chunks(chunk_take, completing, ids[dk + 1],
                             None if lp_h is None
                             else tuple(x[0] for x in lp_h))

    def _fanout_spec(self, slot: int, col, lp_rows, dt: float,
                     tally: list) -> None:
        """Fan one lane's speculative result out: ``col`` holds its block's
        draft_len tokens and then its accepted count (at least 1), of which
        that many tokens are real.  ``tally`` [speculating lanes, accepted
        proposals] collects the step's acceptance."""
        dk = self.ecfg.draft_len
        c = max(1, min(int(col[dk]), dk))
        if self._slots[slot].spec_ok:
            tally[0] += 1
            tally[1] += c - 1
            self.metrics.spec_decode_accepted_length.observe(c)
        self._fanout_decode_tokens(slot, [int(x) for x in col[:c]], lp_rows,
                                   dt)

    def _count_spec(self, n_spec: int, accepted: int) -> None:
        """The acceptance metrics of one speculative dispatch."""
        if not n_spec:
            return
        proposed = (self.ecfg.draft_len - 1) * n_spec
        m = self.metrics
        m.spec_decode_proposed_tokens_total.inc(proposed)
        m.spec_decode_accepted_tokens_total.inc(accepted)
        m.spec_decode_acceptance_rate.set(
            self._spec_accepted / max(self._spec_proposed, 1))

    # The reference's engine fields of the same names, read from the
    # counters: tests and chip_smoke.py compare them with the reference's
    # and take per-round differences.
    @property
    def _spec_proposed(self) -> int:
        """Draft tokens proposed to the verifier (speculating lanes)."""
        return int(self.metrics.spec_decode_proposed_tokens_total.total())

    @property
    def _spec_accepted(self) -> int:
        """Draft tokens the verifier accepted."""
        return int(self.metrics.spec_decode_accepted_tokens_total.total())

    def _draft_prefill(self, req: Request, slot: int) -> bool:
        """Speculative decoding: prefill the prompt into the draft's slot
        cache (one-shot, padded to its bucket, as the reference's
        ``draft_prefill_insert``).  Skipped for a prompt past the largest
        bucket (a one-shot draft prefill would stall the step chunking
        exists to bound): that lane then never speculates.  Returns whether
        the draft holds the prompt.  Nothing has been emitted yet, so a
        failure re-queues the request."""
        ids = list(req.prompt_ids)
        if not ids or len(ids) > self._buckets[-1]:
            return False
        try:
            padded = self._pad_to_bucket(ids)
            _, ks, vs = tf.prefill(
                self._draft_params, self._draft_cfg, self._upload(padded),
                self._upload(np.array([len(ids)], np.int32)))
            tf.insert_batch(self._draft_cache, ks, vs,
                            self._upload(np.array([slot], np.int64)))
        except Exception as e:
            raise StepFault(
                "admit", faults_mod.classify(e), culprits=[req.request_id],
                survivors=[self._survivor_of(req, len(ids))]) from e
        return True

    def _register_slot(self, req: Request, slot: int, first: int,
                       num_prompt: int, first_lp=None,
                       shape: _ReplayShape | None = None) -> None:
        p = req.params
        rid = req.request_id
        spec_ok = False
        if self._draft_cfg is not None and \
                self._draft_prefill(req, slot):
            spec_ok = not (_penalized(p) or p.logprobs is not None
                           or p.logit_bias or p.min_tokens)
        st = _Slot(request=req, num_prompt=num_prompt,
                   stop_col=sampler_mod.np_stop_col(self._stop_ids_for(p)),
                   dead_len=min(num_prompt + p.max_tokens - 1,
                                self.ecfg.max_cache_len - self._pipe_rows),
                   shape=shape, spec_ok=spec_ok)
        self._fault_counts.pop(rid, None)
        replaying = rid in self._replaying
        if replaying:
            # Token replay reached a decoding slot again: the stream is
            # live (the gate streams the continuation once the re-run
            # passes the delivered prefix).
            self._replaying.discard(rid)
            self._replay_shape.pop(rid, None)
            self.metrics.requests_recovered_total.inc(1)
        if rid in self._resuming:
            # A replay-mode preempt victim is back in a slot: the gate
            # drops the delivered prefix as for a fault replay, but it is
            # no recovery.
            self._resuming.discard(rid)
            self._replay_shape.pop(rid, None)
            self.trace.evt(rid, "park.preempt", "E")
            replaying = True
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
        if not replaying:
            # A replay's registration is not a first token: the client got
            # its first long ago.
            m.time_to_first_token_seconds.observe(ttft)
            m.ttft_seconds.observe(ttft, tier=self._slo.tier_of(p.priority))
            self._slo_burn_record(p.priority, ttft)
        if self.trace.enabled:
            self.trace.evt(rid, "prefill", "E")
            if not replaying:
                self.trace.evt(rid, "first_token", "I", ttft)
                tier = (self._slo.get(self._slo.tier_of(p.priority))
                        if self._slo else None)
                if (tier is not None and tier.ttft_ms is not None
                        and ttft * 1000.0 > tier.ttft_ms):
                    self.trace.evt(rid, "slo_violation", "I",
                                   (ttft * 1000.0, tier.ttft_ms))
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
        self.trace.evt("", "spill", "I", len(victims))
        g = self._spill_group
        for i in range(0, len(victims), g):
            grp = victims[i: i + g]
            self._faults.fire("spill")
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

    def _scatter_blocks(self, blocks: list) -> tuple[list[int], object]:
        """Allocate fresh pages for host page ``blocks`` and scatter them
        in (groups of ``_spill_group``, staged in pinned memory and
        uploaded without a host sync).  Returns (the pages, a CUDA event
        after the last scatter or None)."""
        pages = self._alloc.alloc(len(blocks))
        # Pages the allocation evicted from the device index spill before
        # the scatter, which may write those very pages.
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
        return pages, done

    def _issue_restore(self, req: Request, ids: list[int], digests: list,
                       shared: list[int], blocks: list) -> None:
        """A host-tier hit at admission: scatter the blocks into fresh
        pages (``_scatter_blocks``) and park the request until the last
        scatter's event has passed (``_resolve_restores``).  Decoding goes
        on meanwhile."""
        try:
            self._faults.fire("restore")
            pages, done = self._scatter_blocks(blocks)
        except Exception as e:
            # The page bookkeeping is rebuilt by the recovery reset; the
            # survivor re-queues with its pinned seed and its retry hits
            # the host tier again (the tier survives the reset).
            if isinstance(e, StepFault):
                raise
            raise StepFault(
                "restore", faults_mod.classify(e),
                culprits=[req.request_id],
                survivors=[self._survivor_of(req)]) from e
        self._awaiting_restore.append(_RestoreState(
            request=req, ids=ids, digests=digests, shared=shared,
            pages=pages, done=done, t0=time.monotonic()))
        self.trace.evt(req.request_id, "park.restore", "B", len(blocks))

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
        An abort while parked releases its pages.  A preempt resume needs
        no free slot (it holds one): once its scatter landed it registers
        (``_finish_resume``).  Returns True if any moved."""
        did = False
        still: list = []
        for rec in self._awaiting_restore:
            rid = rec.request.request_id
            with self._abort_lock:
                aborted = rid in self._aborted
                self._aborted.discard(rid)
            if isinstance(rec, _ResumeState):
                if aborted:
                    did = True
                    self._end_resume(rec)
                    continue
                if rec.done is not None and not rec.done.query():
                    still.append(rec)
                    continue
                did = True
                try:
                    self._faults.fire("preempt")
                except Exception as e:
                    # The resume serves this request alone; it replays.
                    raise StepFault(
                        "preempt", faults_mod.classify(e), culprits=[rid],
                        survivors=[self._swap_survivor(rec.rec)]) from e
                self._finish_resume(rec)
                continue
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
            try:
                self._faults.fire("restore")
            except Exception as e:
                # The unpark serves this request alone.  (Recovery's
                # snapshot of the parked list holds it too; survivors are
                # deduplicated by request id.)
                raise StepFault(
                    "restore", faults_mod.classify(e), culprits=[rid],
                    survivors=[self._survivor_of(rec.request)]) from e
            self.trace.evt(rid, "park.restore", "E")
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

    def _abort_awaiting_restores(self) -> None:
        """End every request parked on a restore or a preempt resume
        (engine exit, the blanket abort)."""
        for rec in self._awaiting_restore:
            if isinstance(rec, _ResumeState):
                self._end_resume(rec)
            else:
                self._end_restore(rec, "abort")
        self._awaiting_restore = []

    def _restore_ready_any(self) -> bool:
        """A prefix restore's scatter landed (it then needs a free
        slot)."""
        return any(rec.done is None or rec.done.query()
                   for rec in self._awaiting_restore
                   if isinstance(rec, _RestoreState))

    def _resume_ready_any(self) -> bool:
        """A preempt resume's scatter landed: it holds its slot already,
        so the pipelined path drains for it even with no slot free."""
        return any(rec.done is None or rec.done.query()
                   for rec in self._awaiting_restore
                   if isinstance(rec, _ResumeState))

    def _swap_ready_any(self) -> bool:
        """The oldest preempt spill's copies landed (harvests go in
        order)."""
        return bool(self._swap_pending) and self._swap_pending[0].ready()

    # ------------------------------------------------------------------
    # Disaggregated prefill/decode: the detached prefill and the prefilled
    # admission
    # ------------------------------------------------------------------

    def prefill_detached(self, prompt_ids: list[int],
                         params: SamplingParams) -> PrefilledState:
        """Prefill a prompt and sample its first token, and return the
        transferable state instead of inserting it here: the prefill
        server's call, from its threads, on an engine whose step loop never
        runs.  One-shot (``tf.prefill`` at the prompt's bucket, as the
        reference's detached prefill is whatever the scheduler), so a
        prompt past the largest bucket raises
        ``ContextLengthExceededError`` (HTTP 400).  The first token is
        drawn with ``key(seed)``; the decode side continues from
        ``fold_in(key(seed), 1)``.  A guide compiles here, outside the
        prefill lock, and stays pinned over the dispatch."""
        ids = list(prompt_ids)
        if not ids or len(ids) > self._one_shot_limit():
            raise ContextLengthExceededError(
                f"prompt has {len(ids)} tokens but the disaggregated "
                f"prefill limit is {self._one_shot_limit()}")
        pinned = False
        if params.guide is not None:
            self.guides.compile(*params.guide)
            self.guides.acquire(*params.guide)
            pinned = True
        try:
            with self._prefill_lock:
                self._request_seed += 1
                seed = params.seed if params.seed is not None \
                    else self._request_seed
                logits, ks, vs = tf.prefill(
                    self.params, self.cfg,
                    self._upload(self._pad_to_bucket(ids)),
                    self._upload(np.array([len(ids)], np.int32)))
                keys = self._upload(prng.np_prng_key(seed)[None].astype(
                    np.int64))
                firsts, lp, _ = self._sample_first(logits, [params], keys)
                first = int(firsts[0])
                first_lp = None
                if lp is not None:
                    clp, vals, lids = (x[0].cpu().numpy() for x in lp)
                    first_lp = self._lp_entry(clp, vals, lids,
                                              params.logprobs)
                gid, row0 = self._guide_cols(params)
                k, v = ks.cpu(), vs.cpu()
        finally:
            if pinned:
                self.guides.release(*params.guide)
        self.metrics.prompt_tokens_total.inc(len(ids))
        return PrefilledState(
            first_token=first, num_prompt=len(ids), seed=seed, k=k, v=v,
            first_lp=first_lp,
            guide_row=(self.guides.next_row(row0, first) - row0
                       if gid >= 0 else 0),
            prompt_ids=ids,
            kv_dtype=str(k.dtype).replace("torch.", ""))

    def _admit_prefilled(self, req: Request) -> None:
        """Admit a request whose prefill ran on another engine (the
        disaggregated decode side), on either scheduler: insert the
        transferred K/V (``tf.insert_pages`` into fresh pool pages, int8
        and int4 pools quantizing; ``tf.insert`` into the slot cache),
        write the slot's sampling row with the decode key
        ``fold_in(key(seed), 1)`` and the guide row rebased onto this
        engine's table, and register the slot with the transferred first
        token.  On a paged pool the prompt's full pages then enter the
        device index and are spilled to the host tier from the pool pages
        themselves (the pool-canonical bytes).  A logprob request whose
        state carries no first-token entry fails with
        ``logprobs_unavailable``; a prompt past the decode window is
        aborted.  The K/V stay on the request, so a fault re-queues it
        whole."""
        pf = req.prefilled
        p = req.params
        if p.logprobs is not None and pf.first_lp is None:
            self._unpin_guide(req)
            req.outputs.put(RequestOutput(
                request_id=req.request_id, token_ids=[], finished=True,
                finish_reason="error", error="logprobs_unavailable",
                num_prompt_tokens=pf.num_prompt))
            return
        if pf.num_prompt > self.max_prompt_len:
            self._unpin_guide(req)
            req.outputs.put(RequestOutput(
                request_id=req.request_id, token_ids=[], finished=True,
                finish_reason="abort", num_prompt_tokens=pf.num_prompt))
            return
        if req.params.seed is None:
            req.assigned_seed = pf.seed
        k, v = (torch.as_tensor(x) for x in (pf.k, pf.v))
        cap = self.ecfg.max_cache_len
        slot = self._free.pop()
        try:
            self._faults.fire("admit")
            k_d = self._upload_tensor(k[:, :, :cap].contiguous())
            v_d = self._upload_tensor(v[:, :, :cap].contiguous())
            if self._paged:
                n = -(-pf.num_prompt // self._page)
                row = self._assign_slot_pages(slot, n)
                tf.insert_pages(self.cache, k_d, v_d,
                                self._upload(row[:n].astype(np.int64)), n)
            else:
                tf.insert(self.cache, k_d, v_d, slot)
            gid, start = self._guide_cols(p)
            self._ensure_guides_uploaded()
            keys = self._upload(prng.np_prng_key(pf.seed)[None].astype(
                np.int64))
            self._set_slots([slot], [p], prng.fold_in(keys, 1),
                            [pf.num_prompt],
                            [start + pf.guide_row if gid >= 0 else 0])
        except Exception as e:
            raise StepFault(
                "admit", faults_mod.classify(e), culprits=[req.request_id],
                survivors=[_Survivor(request=req, seed=pf.seed,
                                     num_prompt=pf.num_prompt)]) from e
        self.trace.evt(req.request_id, "queue", "E")
        self.trace.evt(req.request_id, "prefill", "B", pf.num_prompt)
        self._register_slot(req, slot, pf.first_token, pf.num_prompt,
                            first_lp=pf.first_lp if p.logprobs is not None
                            else None)
        if self._paged and pf.prompt_ids:
            # Publish the transferred prefix: its full pages enter the
            # device index (tier 0) and go to the host tier, so a restart
            # or a later eviction keeps the prefill peer's work.
            ids = [int(t) for t in pf.prompt_ids]
            pages = list(self._slot_pages.get(slot, []))
            self._register_prompt_pages(ids, pages)
            if self._host is not None:
                nreg = min(len(ids) // self._page, len(pages))
                for d, pg in zip(chain_digests(ids, self._page, nreg),
                                 pages[:nreg]):
                    if not self._host.has(d):
                        self._spill_victims.append((d, pg))
                self._spill_flush()

    # ------------------------------------------------------------------
    # The fleet's prefix tiers: the disk tier, disk and peer fetch, block
    # export, and the routing sketch
    # ------------------------------------------------------------------

    def _drain_disk_spills(self) -> bool:
        """Hand the host tier's queued evictions to the disk writer
        (engine thread; no file IO).  A "disk_spill" fault has no culprit:
        a spill serves no request."""
        if self._disk is None or not self._disk_spill_pending:
            return False
        try:
            self._faults.fire("disk_spill")
        except Exception as e:
            if isinstance(e, StepFault):
                raise
            raise StepFault("disk_spill", faults_mod.classify(e)) from e
        n = 0
        while self._disk_spill_pending:
            digest, blk = self._disk_spill_pending.popleft()
            if self._disk.has(digest):
                continue
            try:
                self._disk_write_queue.put_nowait((digest, blk))
            except queue.Full as e:
                # Losing a spill costs one future prefill; blocking the
                # step loop would cost every stream in flight.
                faults_mod.swallowed("disk_spill.queue_full", e)
                self._disk_spill_pending.clear()
                break
            n += 1
        if n:
            self.trace.evt("", "disk_spill", "I", n)
        return n > 0

    def _flush_warm_to_disk(self) -> None:
        """Persist the warm prefixes: every page still in the device index
        (gathered as the spill path gathers) and every host-tier block go
        to the disk tier, synchronously (a graceful stop or a
        scale-to-zero: no step runs).  Best effort."""
        disk, host, alloc = self._disk, self._host, self._alloc
        if alloc is not None and self.cache is not None:
            victims = [(d, pg) for d, pg in alloc._index.items()
                       if not disk.has(d)]
            g = self._spill_group
            for i in range(0, len(victims), g):
                grp = victims[i: i + g]
                pages = [pg for _, pg in grp]
                try:
                    out = tf.gather_pool_pages(self.cache, self._upload(
                        np.asarray(pages, np.int64)))
                    arrays = [x.cpu() for x in out if x is not None]
                except Exception as e:
                    faults_mod.swallowed("disk_tier.flush", e)
                    continue
                names = ("k", "v", "k_scale", "v_scale")[:len(arrays)]
                for j, (d, _) in enumerate(grp):
                    disk.put(d, {n: a[:, j].clone()
                                 for n, a in zip(names, arrays)})
        if host is not None:
            digests, _ = host.snapshot()
            for d in digests:
                blk = None if disk.has(d) else host.peek(d)
                if blk is not None:
                    disk.put(d, blk)
        self._disk_stats.mirror()

    def _fetch_candidate(self, req: Request, digests: list,
                         covered: int) -> bool:
        """Can the disk tier or a peer extend this admission's coverage?
        Host probes only (the disk check is its in-memory index)."""
        if self._fetch_queue is None or self._host is None:
            return False
        if self._disk is not None and \
                self._disk.match_digests(digests, covered):
            return True
        return self._peer_fetch and bool(req.peer_hint or self._peer_addrs)

    def _issue_fetch(self, req: Request, ids: list[int], digests: list,
                     start: int) -> None:
        """Park an admission miss whose uncovered digests the disk tier or
        a peer may hold; the fetch worker stages them into the host tier.
        No pages are held across the park."""
        st = _FetchState(request=req, ids=ids, digests=digests, start=start,
                         peer=req.peer_hint or None,
                         seed=self._resolve_seed(req), t0=time.monotonic())
        self._awaiting_fetch.append(st)
        self._fetch_queue.put(st)
        self.trace.evt(req.request_id, "park.fetch", "B",
                       len(digests) - start)

    def _fetch_ready_any(self) -> bool:
        return bool(self._free) and any(st.done
                                        for st in self._awaiting_fetch)

    def _resolve_fetches(self) -> bool:
        """Unpark the fetches whose worker finished while a slot is free:
        the admission match runs again (the staged blocks now sit in the
        host tier) and the request goes on through the host-tier restore
        or the chunked path.  A fault here is the fetching request's alone
        (phase "peer_fetch"); an abort while parked just ends it."""
        did = False
        pending = self._awaiting_fetch
        i = 0
        while i < len(pending):
            st = pending[i]
            rid = st.request.request_id
            with self._abort_lock:
                aborted = rid in self._aborted
                self._aborted.discard(rid)
            if aborted:
                pending.pop(i)
                did = True
                self._unpin_guide(st.request)
                st.request.outputs.put(RequestOutput(
                    request_id=rid, token_ids=[], finished=True,
                    finish_reason="abort", num_prompt_tokens=len(st.ids)))
                continue
            if not st.done or not self._free:
                i += 1
                continue
            pending.pop(i)       # before the fault hook: recovery must not
            did = True           # count the request twice
            try:
                self._faults.fire("peer_fetch")
            except Exception as e:
                if isinstance(e, StepFault):
                    raise
                raise StepFault(
                    "peer_fetch", faults_mod.classify(e), culprits=[rid],
                    survivors=[_Survivor(request=st.request, seed=st.seed,
                                         num_prompt=len(st.ids))]) from e
            m, page = self.metrics, self._page
            if st.fetched_disk:
                m.prefix_peer_fetch_blocks_total.inc(st.fetched_disk,
                                                     source="disk")
                m.prefix_cache_hit_tokens_total.inc(st.fetched_disk * page,
                                                    tier="disk")
            if st.fetched_peer:
                m.prefix_peer_fetch_blocks_total.inc(st.fetched_peer,
                                                     source="peer")
                m.prefix_cache_hit_tokens_total.inc(st.fetched_peer * page,
                                                    tier="peer")
            if st.fetched_disk or st.fetched_peer:
                m.prefix_peer_fetch_seconds.observe(time.monotonic() - st.t0)
            self.trace.evt(rid, "park.fetch", "E",
                           st.fetched_disk + st.fetched_peer)
            self._admit_after_fetch(st)
        return did

    def _admit_after_fetch(self, st: _FetchState) -> None:
        """An unparked fetch through the admission match: the device run
        (it may have changed while parked), then the host tier (now
        holding the staged blocks), then the chunked tail.  An empty fetch
        is a plain chunked prefill: never worse than no fetch."""
        req, ids, digests = st.request, st.ids, st.digests
        shared = self._alloc.match(digests)
        blocks = self._host.match_blocks(digests, len(shared)) \
            if len(shared) < len(digests) else []
        if blocks:
            self._issue_restore(req, ids, digests, shared, blocks)
        elif shared:
            self._start_chunked(req, ids, prefix_len=len(shared) * self._page,
                                prefix_pages=shared, digests=digests)
        else:
            self._start_chunked(req, ids)

    def _abort_awaiting_fetches(self) -> None:
        """End every fetch-parked request (engine exit, the blanket
        abort)."""
        for st in self._awaiting_fetch:
            self._unpin_guide(st.request)
            st.request.outputs.put(RequestOutput(
                request_id=st.request.request_id, token_ids=[],
                finished=True, finish_reason="abort",
                num_prompt_tokens=len(st.ids)))
        self._awaiting_fetch = []

    def block_for_export(self, digest: bytes) -> dict | None:
        """One prefix block for a peer's ``GET /v1/cache/blocks/{digest}``
        (server threads): the host tier first, peeked (a remote read must
        not reorder this replica's recency), then the disk tier; None is
        a 404."""
        host = self._host
        if host is not None:
            blk = host.peek(digest)
            if blk is not None:
                return blk
        disk = self._disk
        return disk.get(digest) if disk is not None else None

    def cache_sketch(self) -> dict:
        """The payload of ``GET /v1/cache/sketch`` (server threads): built
        from the tiers' host-side membership snapshots, never from device
        data, and cached by the exporter until a membership or the epoch
        moves.  Scaled to zero, tier 0 is empty while the host and disk
        tiers stay advertised."""
        sk = self._sketch
        if sk is None:
            return {"enabled": False}
        alloc = self._alloc if self._armed else None
        device, dkey = [], (0, -1)
        if alloc is not None:
            device, ver = alloc.index_snapshot()
            # A fresh allocator (a reset, a switch) restarts its version.
            dkey = (id(alloc), ver)
        host_list, hver = (self._host.snapshot() if self._host is not None
                           else ([], -1))
        disk_list, dkver = (self._disk.snapshot() if self._disk is not None
                            else ([], -1))
        hits = self.metrics.prefix_cache_hit_tokens_total
        return sk.build(
            device, dkey, host_list, hver, disk=disk_list, disk_key=dkver,
            hit_tokens={"device": hits.get(tier="device"),
                        "host": hits.get(tier="host"),
                        "disk": hits.get(tier="disk")},
            query_tokens=self.metrics.prefix_cache_query_tokens_total.total(),
            extra={"model": self.cfg.name})

    def note_prompt_text(self, body: dict, ids) -> None:
        """Record a request's text-to-token digest alignment in the
        sketch's ledger (server threads; host hashing only)."""
        if self._sketch is None:
            return
        text = canonical_prompt_text(body)
        if text:
            self._sketch.link(text, ids)

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
        host-built mixed batch.  The gates are the pipelined path's.  Off
        for a speculative engine, as in the reference: at depth 0 it runs
        the host-built speculative step."""
        if self._pipe_depth or not self._sampler_fuse or not self._mixed \
                or self._draft_cfg is not None:
            return False
        return self._steady_ready()

    def _steady_ready(self) -> bool:
        """The steady-state gate shared by the pipelined and fused paths:
        live decoding slots, no prefill chunk and no deferred admission
        pending, no admission possible (a free slot and a waiting
        request), no landed host-tier restore with a free slot to take,
        every slot's stop set on the device, and no abort aimed at a live
        slot, no landed preempt spill or resume, no swapped-out victim
        with a free slot to resume into, and no preemption wanted (a
        port gate the reference lacks: a victim resumes as soon as a slot
        is free), and no slot decoding (or about to decode) through
        windowed residency, and no finished disk or peer fetch with a free
        slot to take.  The reference's wait for the pipe programs'
        ahead-of-time compile is left out: eager
        PyTorch has nothing to compile, and the kernels build at their
        first launch."""
        if not self._slots or self._prefilling or self._pending_admits:
            return False
        if self._residency_active():
            # Windowed-residency slots decode span by span on the host
            # loop: no steady-state program covers them.
            return False
        if self._awaiting_restore and self._free and \
                self._restore_ready_any():
            # A restore landed: drain so it can take a slot on exact host
            # mirrors (restores in flight keep the pipeline going).
            return False
        if self._fetch_ready_any():
            # A disk or peer fetch finished staging: drain so it re-enters
            # admission on exact mirrors (fetches in flight are the
            # worker's: the pipeline goes on).
            return False
        if self._free and not self._queue.empty():
            return False
        if self._swap_ready_any() or self._resume_ready_any():
            # A preempt spill's copies landed (its staging buffers hold
            # the victim's only KV copy), or a resume's scatter landed (its
            # slot registers): host mutations.  In-flight ones keep the
            # pipeline going.
            return False
        if self._swapped and self._free:
            # A swapped-out victim can resume into a free slot now.
            return False
        if self._preempt_wanted():
            # A queued request outranks a running one: drain so the
            # preemption runs on exact host mirrors, its gathers after the
            # last dispatch that writes the victim's rows.
            return False
        if any(st.stop_col is None for st in self._slots.values()):
            return False
        with self._abort_lock:
            if self._aborted and self._aborted & {
                    st.request.request_id for st in self._slots.values()}:
                return False
        return True

    @_scoped("decode")
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

    @_scoped("mixed")
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
        spec = self._draft_cfg is not None
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
        self._faults.fire("spec" if spec else "decode")
        if fresh:
            n = self.ecfg.num_slots
            alive = np.zeros((n,), bool)
            stop_ids = np.full((n, sampler_mod.STOP_IDS_MAX), -1, np.int32)
            dead_len = np.zeros((n,), np.int32)
            spec_col = np.zeros((n,), bool)
            for slot, st in self._slots.items():
                alive[slot] = True
                stop_ids[slot] = st.stop_col
                dead_len[slot] = st.dead_len
                spec_col[slot] = st.spec_ok
            state = (self._upload(self._last_token),
                     self._upload(self._lengths), self._upload(alive))
            # A speculative run also carries which lanes speculate.
            self._pipe_cols = (self._upload(stop_ids),
                               self._upload(dead_len)) + (
                (self._upload(spec_col),) if spec else ())
        else:
            state = self._pipe_state
        params = [st.request.params for st in self._slots.values()]
        gates = _lane_gates(params, params)
        want_lp = any(p.logprobs is not None for p in params)
        tables = self._upload(self._tables) if self._paged else None
        t0 = time.monotonic()
        self._pipe_seq += 1
        self.trace.evt("", "pipe", "B", self._pipe_seq)
        gtables = self._guide_dev if gates.guide else None
        tail = (self._sampling, tables, gtables, gates, want_lp,
                self._park_sentinel())
        if spec:
            toks, lp, *nxt, self._sampling = spec_pipe(
                self.params, self.cfg, self._draft_params, self._draft_cfg,
                self.cache, self._draft_cache, *state, *self._pipe_cols,
                *tail, k)
            self.dispatches += 1
        elif self._mixed:
            toks, lp, *nxt, self._sampling = mixed_pipe(
                self.params, self.cfg, self.cache, *state, *self._pipe_cols,
                *tail)
            self.dispatches += 1
        else:
            toks, lp, *nxt, self._sampling = decode_pipe(
                self.params, self.cfg, self.cache, *state, *self._pipe_cols,
                *tail, k)
            self.decode_dispatches += 1
            self.decode_steps += k
        self._pipe_state = tuple(nxt)
        copy = _HostCopy(toks, lp, self._host_bufs)
        snapshot = [(s, int(self._slot_gen[s])) for s in self._slots]
        self._pipe_inflight.append((snapshot, want_lp, copy, t0))
        occ = len(self._pipe_inflight)
        self.metrics.pipeline_depth_occupancy.observe(occ)
        if self._model_loads:
            # The switch-overlap proof: dispatches issued while another
            # model's weights stream, and the depth they kept.
            self._switch_stats["dispatches"] += 1
            self._switch_stats["max_depth"] = max(
                self._switch_stats["max_depth"], occ)
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
        try:
            self._faults.fire("resolve")
        except Exception:
            self._dropped_copies.append(copy)
            raise
        t0 = time.monotonic()
        toks, lp_h = copy.result()
        now = time.monotonic()
        self.metrics.decode_resolve_wait_seconds_total.inc(
            now - t0, mode="pipelined")
        self.trace.evt("", "pipe", "E", len(snapshot))
        # TPOT by resolve interarrival: in steady state one resolve lands
        # per dispatch, and the issue-to-resolve span covers the depth.
        last = self._pipe_last_resolve
        self._pipe_last_resolve = now
        dt = max(now - (t_issue if last is None else last), 1e-6)
        cols = toks.T.tolist()
        cap = self.ecfg.max_cache_len - self._pipe_rows
        spec = self._draft_cfg is not None
        tally = [0, 0]
        for slot, gen in snapshot:
            st = self._slots.get(slot)
            if st is None or int(self._slot_gen[slot]) != gen:
                continue
            rows = None
            if want_lp and st.request.params.logprobs is not None:
                rows = tuple(x[:, slot] for x in lp_h)
            if spec:
                # The block's accepted prefix only (its count is the
                # column's last entry).
                self._fanout_spec(slot, cols[slot], rows, dt, tally)
            else:
                self._fanout_decode_tokens(slot, cols[slot], rows, dt)
            if slot in self._slots and int(self._lengths[slot]) >= cap:
                self._finish(slot, "length")
        self._count_spec(*tally)

    @_scoped("decode")
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
        (their requests replay); their result copies go back to the pinned
        pool once they have finished."""
        while self._pipe_inflight:
            self._dropped_copies.append(self._pipe_inflight.popleft()[2])
        self._pipe_state = None
        self._pipe_cols = None
        self._pipe_last_resolve = None

    # ------------------------------------------------------------------
    # SLO-tiered preemptive KV swap (ARKS_PREEMPT)
    # ------------------------------------------------------------------
    # When a queued request's (aged) priority strictly outranks a running
    # request's and no slot is free, the scheduler seizes a victim slot.
    # Swap mode (a paged pool with the host tier): the victim's valid
    # pages, through the prefix spill's gather, and its sampler row (key,
    # penalty counts, DFA row) go to host RAM; a resume scatters them back
    # into a fresh slot and the stream continues bit for bit.  Replay mode
    # (the slot cache, the host tier off, a full budget): the victim
    # re-queues behind a _ReplayGate and re-runs from its prompt.
    #
    # The victim's slot is freed in the same step as its gathers: every
    # device op runs in order on one stream, so the gathers read the pages
    # before any later dispatch writes them, as ``_spill_flush``'s do.

    def _preempt_swap_capable(self) -> bool:
        """Swap mode: a paged pool with the host tier, whose budget the
        SwapStore shares, and no draft model (the draft's cache has no
        swap snapshot: a speculative engine preempts in replay mode)."""
        return self._swap is not None and self._draft_cfg is None

    @staticmethod
    def _swap_survivor(rec: _SwapRecord) -> _Survivor:
        """A preempted victim's replayable snapshot: a fault on the swap
        path turns it into an ordinary token replay."""
        return _Survivor(request=rec.request, seed=rec.seed,
                         num_prompt=rec.num_prompt,
                         generated=list(rec.generated),
                         num_emitted=rec.num_emitted, shape=rec.shape)

    def _swap_record(self, slot: int, n_pages: int) -> _SwapRecord:
        st = self._slots[slot]
        return _SwapRecord(
            request=st.request, num_prompt=st.num_prompt,
            generated=list(st.generated), num_emitted=st.num_emitted,
            logprobs=list(st.logprobs), seed=self._resolve_seed(st.request),
            length=int(self._lengths[slot]),
            last_token=int(self._last_token[slot]), stop_col=st.stop_col,
            dead_len=st.dead_len, n_pages=n_pages,
            priority=st.request.params.priority, t0=time.monotonic(),
            shape=st.shape)

    def _preempt_inflight(self) -> int:
        """Victims preempted and not yet back in a slot, in both modes (the
        ``ARKS_PREEMPT_MAX_INFLIGHT`` budget's count)."""
        if self._resuming:
            # Replay-mode victims leave at re-registration; those that
            # ended in the queue (an abort, a quarantine) must not hold
            # the budget.
            live = self._live_rids()
            with self._abort_lock:
                live |= self._queued_rids
            self._resuming &= live
        return (len(self._swap_pending) + len(self._swapped)
                + sum(isinstance(r, _ResumeState)
                      for r in self._awaiting_restore)
                + len(self._resuming))

    def _preempt_victims(self) -> list[int]:
        """Victim slots, best first: a strictly lower tier than the queue's
        (aged) head, the lowest tier first, then the least progress (the
        cheapest swap), then the most recent arrival.  Never a replaying
        or resuming slot (its stream is being verified), never one inside
        the cooldown."""
        head = self._queue.head_prio()
        if head is None:
            return []
        now = time.monotonic()
        cands = []
        for slot, st in self._slots.items():
            prio = st.request.params.priority
            rid = st.request.request_id
            if prio <= head or rid in self._replaying or \
                    rid in self._resuming:
                continue
            if self._residency is not None and slot in self._residency.slots:
                # An engaged slot's KV is split across the host store,
                # staging and tail: it finishes in place.
                continue
            if now - self._preempt_last.get(rid, -1e9) < \
                    self._preempt_cooldown_s:
                continue
            cands.append((-prio, len(st.generated),
                          -st.request.arrival_time, slot))
        cands.sort()
        return [c[-1] for c in cands]

    def _preempt_wanted(self) -> bool:
        """A host-only check, cheap enough for the pipelined path: a queued
        request outranks a running one, no slot is free, the budget has
        room."""
        if self._queue.empty() or self._free or not self._slots:
            return False
        if not self._preempt_on or self._state != "serving":
            return False
        if self._preempt_inflight() >= self._preempt_max:
            return False
        return bool(self._preempt_victims())

    def _maybe_preempt(self) -> bool:
        """Seize slots for outranking queued requests: one victim per
        queued request, within the in-flight budget."""
        if not self._preempt_wanted():
            return False
        budget = self._preempt_max - self._preempt_inflight()
        n = min(budget, self._queue.qsize())
        for slot in self._preempt_victims()[:n]:
            if self._preempt_swap_capable() and self._slot_pages.get(slot):
                self._issue_preempt_swap(slot)
            else:
                self._preempt_replay(slot)
        self._update_waiting()
        return True

    def _preempted(self, slot: int, rec: _SwapRecord, what) -> None:
        """The bookkeeping of a seized slot (the slot itself is freed by
        the caller)."""
        rid = rec.request.request_id
        tier = self._slo.tier_of(rec.priority)
        now = time.monotonic()
        # Entries past the cooldown no longer matter: drop them, so the map
        # holds only recent victims.
        self._preempt_last = {
            r: t for r, t in self._preempt_last.items()
            if now - t < self._preempt_cooldown_s}
        self._preempt_last[rid] = now
        self.trace.evt(rid, "park.preempt", "B", what)
        self.metrics.requests_preempted_total.inc(1, tier=tier)
        self.metrics.num_requests_running.set(len(self._slots))
        log.info("preempted %s (tier=%s, %s) for a higher tier", rid, tier,
                 f"{what} pages" if isinstance(what, int) else what)

    def _issue_preempt_swap(self, slot: int) -> None:
        """Swap mode, issue side: gather the victim's valid pages and its
        sampler row on the device and start their copies to pinned host
        memory (an event after them; no host wait), then free the slot.
        ``_resolve_preempt_swaps`` stores them once they have landed."""
        st = self._slots[slot]
        rid = st.request.request_id
        pages = self._slot_pages.get(slot, [])
        n_pages = min(-(-int(self._lengths[slot]) // self._page), len(pages))
        rec = self._swap_record(slot, n_pages)
        copies: list = []
        try:
            self._faults.fire("preempt")
            staged = []
            g = self._spill_group
            for i in range(0, n_pages, g):
                grp = pages[i: min(i + g, n_pages)]
                # A short group repeats a real page (one staging shape).
                pg = grp + [grp[0]] * (g - len(grp))
                out = tf.gather_pool_pages(
                    self.cache, self._upload(np.asarray(pg, np.int64)))
                copy = _PinnedCopy([x for x in out if x is not None],
                                   self._host_bufs)
                copies.append(copy)
                staged.append((len(grp), copy))
            row = _PinnedCopy(list(sampler_mod.slot_row(self._sampling,
                                                        slot)),
                              self._host_bufs)
        except Exception as e:
            # The victim is still registered: recovery snapshots it from
            # its slot and replays it.
            self._dropped_copies.extend(copies)
            if isinstance(e, StepFault):
                raise
            raise StepFault("preempt", faults_mod.classify(e),
                            culprits=[rid]) from e
        # The gathers are on the stream: the slot may be reused now.  The
        # guide pin stays: the snapshotted DFA row must stay valid.  The
        # victim is in the pending list before its slot goes, so a fault
        # in between leaves it where recovery finds it.
        self._swap_pending.append(_SwapState(rec=rec, staged=staged,
                                             row=row))
        self._slots.pop(slot)
        self._release_slot(slot, st.request, keep_guide=True)
        self._preempted(slot, rec, n_pages)

    def _preempt_replay(self, slot: int) -> None:
        """Replay mode: free the victim's slot and re-queue it behind a
        ``_ReplayGate``; it re-runs from its prompt (its prefill in the
        original's shapes) and the gate drops what its client holds."""
        st = self._slots[slot]
        rid = st.request.request_id
        try:
            self._faults.fire("preempt")
        except Exception as e:
            # Victim untouched: recovery snapshots it from its slot.
            raise StepFault("preempt", faults_mod.classify(e),
                            culprits=[rid]) from e
        rec = self._swap_record(slot, 0)
        # Queued before its slot goes: a fault in between leaves it where
        # it re-runs from.
        self._slots.pop(slot)
        self._preempt_requeue_replay(rec)
        self._release_slot(slot, st.request)
        self._preempted(slot, rec, "replay")

    def _preempt_requeue_replay(self, rec: _SwapRecord) -> None:
        """Re-queue a victim for re-execution at its OWN priority (unlike a
        fault's replayers it is not urgent: it was just outranked)."""
        req = rec.request
        rid = req.request_id
        gate = req.outputs if isinstance(req.outputs, _ReplayGate) else None
        if gate is None:
            req.outputs = _ReplayGate(req.outputs, self, rid, rec.generated,
                                      rec.num_emitted)
        else:
            gate.restart(rec.generated)
        self._resuming.add(rid)
        if rec.shape is not None:
            self._replay_shape[rid] = rec.shape
        self._requeue(req)

    def _resolve_preempt_swaps(self) -> bool:
        """Store the landed preempt spills in the SwapStore, oldest first,
        never waiting.  A harvest fault fails the victim alone into a
        token replay (these copies are its only KV); a refusal (the budget
        cannot hold it) sends it to replay mode without a fault."""
        did = False
        while self._swap_pending and self._swap_pending[0].ready():
            sw = self._swap_pending.pop(0)
            did = True
            rec = sw.rec
            rid = rec.request.request_id
            with self._abort_lock:
                aborted = rid in self._aborted
                self._aborted.discard(rid)
            if aborted:
                for copy in sw.copies():
                    copy.release()
                self._finish_swapped_abort(rec)
                continue
            try:
                self._faults.fire("preempt")
                blocks = []
                for n, copy in sw.staged:
                    arrays = copy.tensors()
                    names = ("k", "v", "k_scale", "v_scale")[:len(arrays)]
                    # Copies: the staging buffers go back to the pool.
                    blocks += [{nm: a[:, j].clone()
                                for nm, a in zip(names, arrays)}
                               for j in range(n)]
                key, counts, guide_row = sw.row.tensors()
                entry = {"blocks": blocks,
                         "key": key.numpy().astype(np.uint32),
                         "counts": counts.clone(),
                         "guide_row": int(guide_row)}
            except Exception as e:
                self._dropped_copies.extend(sw.copies())
                if isinstance(e, StepFault):
                    raise
                raise StepFault("preempt", faults_mod.classify(e),
                                culprits=[rid],
                                survivors=[self._swap_survivor(rec)]) from e
            for copy in sw.copies():
                copy.release()
            if self._swap.put(rid, entry):
                self._swapped[rid] = rec
                self.metrics.preempt_swap_seconds.observe(
                    time.monotonic() - rec.t0)
                self.metrics.prefix_cache_usage_bytes.set(
                    self._swap.bytes_used, tier="swap")
            else:
                log.warning("swap store refused %s (%d blocks); preempting "
                            "it in replay mode", rid, len(blocks))
                self._unpin_guide(rec.request)
                self._preempt_requeue_replay(rec)
        if did:
            self._update_waiting()
        return did

    def _service_swapped(self) -> bool:
        """Swapped-out victims: serve their aborts (the host bytes come
        back) and resume them, the best first (highest tier, earliest
        preempt), while the queue head does not strictly outrank them and
        the pool can give their pages."""
        did = False
        with self._abort_lock:
            hit = [rid for rid in self._swapped if rid in self._aborted]
            self._aborted -= set(hit)
        for rid in hit:
            rec = self._swapped.pop(rid)
            self._swap.discard(rid)
            self.metrics.prefix_cache_usage_bytes.set(self._swap.bytes_used,
                                                      tier="swap")
            self._finish_swapped_abort(rec)
            did = True
        while self._swapped and self._free:
            rid, rec = min(self._swapped.items(),
                           key=lambda kv: (kv[1].priority, kv[1].t0))
            head = self._queue.head_prio()
            if head is not None and head < rec.priority:
                break
            if self._alloc.free_pages + self._alloc.retained_pages < \
                    rec.n_pages:
                break  # pool pressure: wait for pages
            self._resume_swapped(rid)
            did = True
        if did:
            self._update_waiting()
        return did

    def _resume_swapped(self, rid: str) -> None:
        """Swap mode, resume side: take a free slot, scatter the victim's
        blocks into fresh pages (the host-tier restore's scatter), write
        its sampler row (key and DFA row through ``_set_slots``, then the
        counts, which ``_set_slots`` zeroes) and park it until the scatter
        has landed (``_finish_resume``)."""
        rec = self._swapped.pop(rid)
        entry = self._swap.pop(rid)
        self.metrics.prefix_cache_usage_bytes.set(self._swap.bytes_used,
                                                  tier="swap")
        slot = self._free.pop()
        p = rec.request.params
        try:
            self._faults.fire("preempt")
            pages, done = self._scatter_blocks(entry["blocks"])
            self._set_slots([slot], [p], self._upload(
                entry["key"].astype(np.int64)[None]), [rec.num_prompt],
                [entry["guide_row"]])
            self._sampling = sampler_mod.restore_counts(
                self._sampling, slot, self._upload_tensor(entry["counts"]))
        except Exception as e:
            self._free.append(slot)
            self._unpin_guide(rec.request)
            if isinstance(e, StepFault):
                raise
            raise StepFault("preempt", faults_mod.classify(e),
                            culprits=[rid],
                            survivors=[self._swap_survivor(rec)]) from e
        self._awaiting_restore.append(_ResumeState(
            rec=rec, slot=slot, pages=pages, done=done, t0=time.monotonic()))

    def _finish_resume(self, res: _ResumeState) -> None:
        """Swap mode, landing side: rebuild the victim's slot and host
        mirrors as the preemption recorded them.  No first token and no
        TTFT: the stream goes on at the next dispatch."""
        rec, slot = res.rec, res.slot
        self._assign_slot_pages(slot, len(res.pages), head_pages=res.pages)
        self._slot_gen[slot] += 1
        self._slots[slot] = _Slot(
            request=rec.request, num_prompt=rec.num_prompt,
            generated=list(rec.generated), logprobs=list(rec.logprobs),
            num_emitted=rec.num_emitted, stop_col=rec.stop_col,
            dead_len=rec.dead_len, shape=rec.shape)
        self._lengths[slot] = rec.length
        self._last_token[slot] = rec.last_token
        self.metrics.num_requests_running.set(len(self._slots))
        self.metrics.preempt_swap_seconds.observe(time.monotonic() - res.t0)
        self.trace.evt(rec.request.request_id, "park.preempt", "E")
        log.info("resumed %s after a preempt swap (slot %d, %d pages)",
                 rec.request.request_id, slot, len(res.pages))

    def _end_resume(self, res: _ResumeState) -> None:
        """Abort a victim whose resume never registered (its scatter was
        in flight): its pages go back, and so does its slot, with the
        shaping columns ``_resume_swapped`` wrote returned to their
        identity values, as ``_release_slot`` returns them: a later
        request that writes no shaping column must not inherit the
        victim's penalties, bias, min_tokens or guide (its restored counts
        then weigh nothing, and a shaping request's admission zeroes
        them)."""
        self._alloc.decref(res.pages)
        if _shapes(res.rec.request.params):
            self._sampling = sampler_mod.clear_slot_penalties(self._sampling,
                                                              res.slot)
        self._free.append(res.slot)
        self._finish_swapped_abort(res.rec)

    def _finish_swapped_abort(self, rec: _SwapRecord) -> None:
        """A preempted victim's client went away while its state was off
        the device."""
        self._unpin_guide(rec.request)
        rec.request.outputs.put(RequestOutput(
            request_id=rec.request.request_id, token_ids=[], finished=True,
            finish_reason="abort", num_prompt_tokens=rec.num_prompt,
            num_generated_tokens=len(rec.generated)))

    def _abort_swapped(self) -> None:
        """End every preempted victim not back in a slot (engine exit, the
        blanket abort) and release their host bytes."""
        for sw in self._swap_pending:
            self._dropped_copies.extend(sw.copies())
            self._finish_swapped_abort(sw.rec)
        self._swap_pending = []
        for rec in self._swapped.values():
            self._finish_swapped_abort(rec)
        self._swapped.clear()
        if self._swap is not None:
            self._swap.clear()
            self.metrics.prefix_cache_usage_bytes.set(0, tier="swap")

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

    def _release_slot(self, slot: int, req: Request,
                      keep_guide: bool = False) -> None:
        """Free the slot of ``req``.  A paged slot returns its pages and
        parks at the write-drop sentinel (its dispatch rows must never land
        in pages another slot may now own); a slot-cache slot keeps its
        length, as in the reference — its rows land in its own stripe.
        The request's guide pin is released, and a request that shaped its
        logits returns the slot's shaping columns to their identity
        values, so that later batches without such requests skip the
        passes.  A swapped-out victim ``keep_guide``s its pin: its
        snapshotted DFA row must stay valid until it resumes."""
        if not keep_guide:
            self._unpin_guide(req)
        if _shapes(req.params):
            self._sampling = sampler_mod.clear_slot_penalties(self._sampling,
                                                              slot)
        if self._paged:
            if self._residency is not None:
                # An engaged slot's pages are staging + tail (returned
                # below); its host store just drops.
                self._residency.release(slot)
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
        self.trace.evt(st.request.request_id, "finish", "I", reason)

    # ------------------------------------------------------------------
    # Multi-model serving (engine/model_pool.py)
    # ------------------------------------------------------------------

    def served_models(self) -> list[str]:
        """The model names this engine serves: the primary and every pool
        registration (the server routes a request's ``model`` field
        against this)."""
        names = [self._primary_model]
        if self.pool is not None:
            names += [n for n in self.pool.names() if n not in names]
        return names

    def register_model(self, model, model_path: str | None = None,
                       pinned: bool = False) -> None:
        """Register a secondary model with the pool.  ``model`` is a config
        name or a ModelConfig.  The loader reads real weights from
        ``model_path`` (``models/weights.py``, quantized on load as the
        primary's) and otherwise draws the SAME random init a single-model
        engine of this config boots with (``ecfg.seed``, quantized the
        same way), which is what makes pooled streams byte-identical to
        single-model ones.  Secondary models share the engine's
        tokenizer."""
        if self.pool is None:
            raise RuntimeError("engine has no model pool")
        from arks_tpu_torch.models.weights import load_params
        cfg2 = get_config(model) if isinstance(model, str) else model
        ecfg = self._primary_ecfg
        device = self.device

        def loader(cfg2=cfg2, model_path=model_path):
            return load_params(cfg2, model_path,
                               dtype=ecfg.dtype or cfg2.dtype,
                               weight_dtype=ecfg.weight_dtype, device=device,
                               seed=ecfg.seed)

        self.pool.register(cfg2.name, cfg2, model_path=model_path,
                           loader=loader, pinned=pinned)

    def _park_awaiting_model(self, req: Request, want: str) -> None:
        """Park a request until its model is active (like the guide and
        restore parks: abortable, failed on engine exit).  A request for an
        unknown model, or on an engine without a pool, fails at once."""
        if self.pool is None or not (want == self._primary_model
                                     or self.pool.has(want)):
            error = ("model_not_found" if self.pool is not None
                     else "multi_model_unsupported")
            req.outputs.put(RequestOutput(
                request_id=req.request_id, token_ids=[], finished=True,
                finish_reason="error", error=error,
                num_prompt_tokens=len(req.prompt_ids)))
            log.info("rejected %s: %s (model=%r)", req.request_id, error,
                     want)
            return
        self._awaiting_model.append((req, want, time.monotonic()))
        self.trace.evt(req.request_id, "park.model", "B", want)
        self._switch_t0.setdefault(want, time.monotonic())
        self._update_waiting()

    def _abort_awaiting_model(self) -> None:
        """Fail every model-parked request (engine exit, blanket abort): no
        scheduler remains to switch models for them."""
        for req, _want, _t in self._awaiting_model:
            req.outputs.put(RequestOutput(
                request_id=req.request_id, token_ids=[], finished=True,
                finish_reason="abort", num_prompt_tokens=len(req.prompt_ids)))
        self._awaiting_model = []
        self._update_waiting()

    def _fail_parked_for(self, want: str, error: str) -> None:
        """Fail the requests parked for ``want`` (its load failed or the
        pool cannot fit it); other models' parked requests stay."""
        keep = []
        for req, w, t in self._awaiting_model:
            if w != want:
                keep.append((req, w, t))
                continue
            self._fault_counts.pop(req.request_id, None)
            req.outputs.put(RequestOutput(
                request_id=req.request_id, token_ids=[], finished=True,
                finish_reason="error", error=error,
                num_prompt_tokens=len(req.prompt_ids)))
            self.metrics.request_success_total.inc(reason="error")
            log.info("rejected %s: %s", req.request_id, error)
        self._awaiting_model = keep
        self._switch_t0.pop(want, None)
        self._model_loads.pop(want, None)
        if self._switch_target == want:
            self._switch_target = None
        self._update_waiting()

    def _switch_due_policy(self, target: str) -> bool:
        """May a switch to ``target`` be committed now?  drain: as soon as
        the target is resident (running requests finish first; slots are
        never preempted).  timeslice: once the active model had its
        quantum, or has no runnable work left."""
        if self._switch_policy == "drain":
            return True
        return (time.monotonic() - self._slice_t0 >= self._switch_quantum
                or (not self._slots and not self._prefilling
                    and not self._pending_admits and self._queue.empty()))

    def _drained_for_switch(self) -> bool:
        """A switch swaps the per-model context wholesale, legal only when
        every scheduling member is at its empty state: no slots, prefills,
        deferred admissions, pipelined dispatches, spills, restores,
        preempted victims or queued requests (a committed target parks the
        queue through ``_preadmit`` first)."""
        return (not self._slots and not self._prefilling
                and not self._pending_admits and not self._pipe_inflight
                and self._pipe_state is None
                and not self._awaiting_restore and not self._spills
                and not self._swap_pending and not self._swapped
                and self._queue.empty())

    def _issue_model_load(self) -> bool:
        """Service the model park: consume aborts, start or poll the
        head-of-line model's background load (``pool.ensure``, which never
        blocks), commit a switch target by policy, park the admission
        queue once committed, and switch at the drained boundary."""
        worked = False
        with self._abort_lock:
            dead = {req.request_id for req, _, _ in self._awaiting_model
                    if req.request_id in self._aborted}
            self._aborted -= dead
        if dead:
            keep = []
            for req, want, t in self._awaiting_model:
                if req.request_id not in dead:
                    keep.append((req, want, t))
                    continue
                req.outputs.put(RequestOutput(
                    request_id=req.request_id, token_ids=[], finished=True,
                    finish_reason="abort",
                    num_prompt_tokens=len(req.prompt_ids)))
            self._awaiting_model = keep
            self._update_waiting()
            worked = True
        # Prefetch hints from add_request: start the load while the request
        # still waits in the queue.  Errors surface when it parks.
        while self._model_prefetch:
            name = self._model_prefetch.pop()
            if name == self.cfg.name or not self.pool.has(name):
                continue
            try:
                got = self.pool.ensure(name)
            except (KeyError, PoolFullError):
                continue
            if isinstance(got, LoadTicket) and \
                    self._model_loads.get(name) is not got:
                self._model_loads[name] = got
                self._switch_t0.setdefault(name, got.t0)
                self._switch_stats = {"dispatches": 0, "max_depth": 0}
                worked = True
        if not self._awaiting_model:
            self._switch_target = None
            for name, t in list(self._model_loads.items()):
                if t.event.is_set():
                    self._model_loads.pop(name, None)
                    self._switch_t0.pop(name, None)
            return worked
        target = self._switch_target or self._awaiting_model[0][1]
        if target == self.cfg.name:
            # The target became active while these waited: re-queue them.
            self._switch_target = None
            self._unpark_for(target)
            return True
        try:
            got = self.pool.ensure(target)
        except KeyError as e:
            self._fail_parked_for(target, f"model_not_found: {e}")
            return True
        except PoolFullError as e:
            self._pool_full(target, f"model_pool_exhausted: {e}")
            return True
        resident = not isinstance(got, LoadTicket)
        if not resident:
            if self._model_loads.get(target) is not got:
                self._model_loads[target] = got
                self._switch_t0.setdefault(target, got.t0)
                self._switch_stats = {"dispatches": 0, "max_depth": 0}
                worked = True
            if got.event.is_set():
                self._model_loads.pop(target, None)
                if got.error and "model_pool_exhausted" in got.error:
                    self._pool_full(target, got.error)
                    return True
                if got.error:
                    self._fail_parked_for(
                        target, f"model_load_failed: {got.error}")
                    return True
                resident = True
        else:
            self._model_loads.pop(target, None)
        if not resident:
            return worked
        if self._switch_target is None and self._switch_due_policy(target):
            self._switch_target = target
            worked = True
        if self._switch_target != target:
            return worked
        # Committed: every request the queue still holds parks (for its
        # own model), so the queue empties for the drained check below.
        while True:
            try:
                _, _, req = self._queue.get_nowait()
            except queue.Empty:
                break
            pre = self._preadmit(req)
            if pre is not None:
                self._resolve_admit_batch(self._issue_admit_batch([pre]))
            worked = True
        if self._drained_for_switch():
            self._switch_to(target)
            worked = True
        return worked

    def _pool_full(self, target: str, error: str) -> None:
        """The pool cannot fit ``target``.  When the active model is an
        unpinned secondary, its own reference is what holds the room: step
        back to the primary (a committed switch, at the next drained
        boundary), which releases it to the LRU, and the target's load
        retries from there.  Otherwise the requests parked for the target
        fail (``model_pool_exhausted``: 503 with Retry-After)."""
        if self.pool.entry(self.cfg.name).pinned:
            self._fail_parked_for(target, error)
            return
        if self._switch_target is None:
            log.info("model %s does not fit beside the active %s; stepping "
                     "back to %s first", target, self.cfg.name,
                     self._primary_model)
            self._switch_target = self._primary_model

    def _unpark_for(self, name: str) -> None:
        """Re-queue every request parked for ``name``."""
        keep = []
        for req, want, t in self._awaiting_model:
            if want != name:
                keep.append((req, want, t))
                continue
            self._requeue(req)
            self.trace.evt(req.request_id, "park.model", "E")
        self._awaiting_model = keep
        self._switch_t0.pop(name, None)
        self._update_waiting()

    def _switch_fault(self, name: str, e: Exception) -> StepFault:
        """The StepFault of a failed switch: the requests parked for the
        target are its culprits (their retry budgets burn; over budget they
        fail alone) and its survivors (nothing was emitted: recovery
        re-queues them and the switch retries when they park again)."""
        self._switch_target = None
        self._switch_t0.pop(name, None)
        survivors, keep = [], []
        for req, want, t in self._awaiting_model:
            if want != name:
                keep.append((req, want, t))
                continue
            survivors.append(_Survivor(
                request=req, seed=self._resolve_seed(req),
                num_prompt=len(req.prompt_ids)))
        self._awaiting_model = keep
        self._update_waiting()
        return StepFault("model_switch", faults_mod.classify(e),
                         culprits=[sv.request.request_id for sv in survivors],
                         survivors=survivors)

    def _switch_to(self, name: str) -> None:
        """Activate pool model ``name`` at a drained boundary: save the
        active model's context (every ``_model_attr_names`` attribute:
        weights, pool, mirrors, guides, tiers), then restore ``name``'s
        saved context or build a fresh one on the pool's resident
        weights."""
        t0 = time.monotonic()
        old = self.cfg.name
        try:
            self._faults.fire("model_switch")
            entry = self.pool.acquire(name)
        except Exception as e:
            raise self._switch_fault(name, e) from e
        if entry.ready is not None:
            # A background load's weights: this stream waits on the load
            # stream's event (on the device, not the host), and their
            # blocks are kept from reuse until this stream is done.
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(entry.ready)
            for t in tree_tensors(entry.params):
                t.record_stream(stream)
            entry.ready = None
        # Guide-parked requests belong to the old model's compiler: park
        # them on that model, so they re-admit (and re-ensure their guide)
        # after a switch back.
        for req, _ticket in self._awaiting_guide:
            self._awaiting_model.append((req, old, time.monotonic()))
        self._awaiting_guide = []
        ctx = {a: getattr(self, a) for a in self._model_attr_names}
        try:
            saved = self._model_ctxs.pop(name, None)
            if saved is not None:
                for a, v in saved.items():
                    setattr(self, a, v)
                # The pool may have reloaded the weights since an eviction
                # dropped this context: the pool's params are the truth.
                self.params = entry.params
            elif name == self._primary_model:
                ecfg2 = self._primary_ecfg
                dname = ecfg2.draft_model
                dcfg = self.pool.entry(dname).cfg if dname else None
                dparams = self.pool.params_of(dname) if dname else None
                self._init_model_state(entry.cfg, ecfg2, params=entry.params,
                                       draft_params=dparams, draft_cfg=dcfg)
            else:
                # A secondary model runs without a draft.
                ecfg2 = dataclasses.replace(self._primary_ecfg, model=name,
                                            draft_model=None)
                self._init_model_state(entry.cfg, ecfg2, params=entry.params)
        except Exception as e:
            # The old context back before faulting, so recovery rebuilds a
            # coherent device state.
            for a, v in ctx.items():
                setattr(self, a, v)
            self.pool.release(name)
            raise self._switch_fault(name, e) from e
        self._model_ctxs[old] = ctx
        self.pool.release(old)
        self._switch_target = None
        if self._sketch is not None:
            # Another model's pool: its blocks are other bytes.
            self._sketch.bump_epoch("model_switch")
        self._slice_t0 = time.monotonic()
        dt = time.monotonic() - self._switch_t0.pop(name, t0)
        self.metrics.model_switch_seconds.observe(dt)
        self.last_switch_stats = {
            "model": name, "from": old, "seconds": dt,
            "overlap_dispatches": self._switch_stats["dispatches"],
            "overlap_max_depth": self._switch_stats["max_depth"],
        }
        self.metrics.engine_config_info.set(1, **self.resolved_config)
        log.info("model switch %s -> %s in %.3fs (overlap: %d dispatches, "
                 "max pipeline depth %d)", old, name, dt,
                 self._switch_stats["dispatches"],
                 self._switch_stats["max_depth"])
        self._unpark_for(name)

    # ------------------------------------------------------------------
    # Scale-to-zero and re-arm (ARKS_ELASTIC_IDLE_ZERO_S)
    # ------------------------------------------------------------------
    # An engine idle for the window disarms: its weights, KV pool and
    # sampling rows drop (the card gets the bytes back), the host prefix
    # tier and swapped-out victims stay, and the first queue arrival
    # re-arms it.  Live resize is not served (a single-card engine).

    def set_rearm_loader(self, fn) -> None:
        """Install the re-arm weight source: ``fn(cfg) -> params`` (a
        checkpoint reload).  Without one, a re-arm takes the pool's loader
        of the active model when it has one, else the seed's init."""
        self._rearm_loader = fn

    @property
    def armed(self) -> bool:
        """False while scaled to zero (no device state exists)."""
        return self._armed

    def elastic_status(self) -> dict:
        """The operator's and readiness's view of the elastic state (any
        thread; plain attribute reads)."""
        return {
            "armed": self._armed,
            "shape": "tp1xdp1",
            "resize_inflight": False,
            "last_resize": None,
            "last_rearm": self.last_rearm_stats,
        }

    def _maybe_scale_to_zero(self) -> bool:
        """Track the idle window and disarm once the engine has been
        COMPLETELY quiet (no parked work, no spills, no loads) for all of
        it."""
        quiet = (self.idle and not self._spills and not self._model_loads
                 and not self._model_prefetch and self._state == "serving")
        if not quiet:
            self._idle_since = None
            return False
        now = time.monotonic()
        if self._idle_since is None:
            self._idle_since = now
            return False
        if now - self._idle_since < self._idle_zero_s:
            return False
        self._scale_to_zero()
        return True

    def _scale_to_zero(self) -> None:
        """Disarm an idle engine: drop the weights, the KV pool, the draft
        and the sampling rows, every saved model context and the pool's
        residency of the active model, and give the caching allocator's
        freed blocks back to the card.  The host tier and the swapped-out
        victims stay for the re-arm, and with a disk tier the warm prefixes
        are written there first (a drained boundary: the flush may wait
        for the card)."""
        if self._disk is not None:
            try:
                self._flush_warm_to_disk()
            except Exception as e:
                faults_mod.swallowed("scale_to_zero.flush", e)
        self.params = None
        self.cache = None
        self._sampling = None
        self._draft_params = None
        self._draft_cache = None
        self._alloc = None
        self._guide_dev = None
        self._model_ctxs.clear()
        if self.pool is not None:
            try:
                self.pool.scale_to_zero(self.cfg.name)
                if self._draft_cfg is not None:
                    self.pool.scale_to_zero(self._draft_cfg.name)
            except RuntimeError as e:
                faults_mod.swallowed("scale_to_zero.pool", e)
        if self.device.type == "cuda":
            # The cuBLAS workspaces live in the caching allocator too: a
            # workspace left in a segment keeps the whole segment reserved.
            clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
            if clear is not None:
                clear()
            torch.cuda.empty_cache()
        if self._sketch is not None:
            # Tier 0 died with the pool (host and disk stay advertised).
            self._sketch.bump_epoch("scale_to_zero")
        self._armed = False
        self._zero_t0 = time.monotonic()
        self._idle_since = None
        self.metrics.engine_resizes_total.inc(1, mode="scale_to_zero",
                                              outcome="ok")
        log.info("idle %.1fs: scaled to zero (weights and device KV "
                 "dropped; the host tier stays)", self._idle_zero_s)

    def _step_disarmed(self, block_s: float) -> bool:
        """The step loop while scaled to zero: wait for demand (a queue
        arrival), then re-arm and re-queue it.  A failed re-arm retries on
        the next demand after a second's backoff; the engine stays
        disarmed rather than crash-loop."""
        try:
            prio, seq, demand = self._queue.get(timeout=block_s)
        except queue.Empty:
            return False
        if time.monotonic() - self._rearm_fail_t < 1.0:
            self._queue.put((prio, seq, demand))
            time.sleep(min(block_s, 0.1))
            return False
        self._rearm()
        self._queue.put((prio, seq, demand))
        return True

    def _rearm(self) -> bool:
        """Scale from zero: the weights back (the re-arm loader, else the
        pool's loader of the active model, else the seed's init) and the
        device context rebuilt at the same shape, with the host tier and
        any swapped-out victims carried across.  Rolls back and stays
        disarmed on failure."""
        t0 = time.monotonic()
        cfg, draft_cfg = self.cfg, self._draft_cfg
        keep = {"host": self._host, "swap": self._swap,
                "swapped": self._swapped, "disk": self._disk,
                "disk_write_queue": self._disk_write_queue,
                "disk_writer": self._disk_writer,
                "fetch_queue": self._fetch_queue,
                "disk_stats": self._disk_stats}
        ctx = {a: getattr(self, a) for a in self._model_attr_names}
        streamed = self._rearm_loader is not None
        try:
            params = draft_params = None
            if self._rearm_loader is not None:
                params = self._rearm_loader(cfg)
            elif self.pool is not None and self.pool.has(cfg.name) and \
                    self.pool.entry(cfg.name).loader is not None:
                params, streamed = self.pool.load(cfg.name), True
            if draft_cfg is not None and self.pool is not None and \
                    self.pool.has(draft_cfg.name) and \
                    self.pool.entry(draft_cfg.name).loader is not None:
                draft_params = self.pool.load(draft_cfg.name)
            self._init_model_state(cfg, self.ecfg, params=params,
                                   draft_params=draft_params,
                                   draft_cfg=draft_cfg, keep_tiers=keep)
        except Exception as e:
            for a, v in ctx.items():
                setattr(self, a, v)
            self._rearm_fail_t = time.monotonic()
            self.metrics.engine_resizes_total.inc(1, mode="rearm",
                                                  outcome="error")
            log.error("scale-from-zero re-arm failed: %s: %s",
                      type(e).__name__, e)
            # The engine stays disarmed and retries on the next demand: a
            # failed re-arm must not take the step thread down.
            faults_mod.swallowed("elastic.rearm", e)
            return False
        self._armed = True
        self._idle_since = None
        if self._sketch is not None:
            self._sketch.bump_epoch("rearm")
        if self.pool is not None:
            self.pool.adopt(cfg.name, cfg, self.params, pinned=True)
            if draft_cfg is not None:
                self.pool.adopt(draft_cfg.name, draft_cfg,
                                self._draft_params, pinned=True)
        dt = time.monotonic() - t0
        self.metrics.scale_from_zero_seconds.observe(dt)
        self.metrics.engine_resizes_total.inc(1, mode="rearm", outcome="ok")
        self.last_rearm_stats = {
            "seconds": dt, "shape": "tp1xdp1",
            "idle_seconds": t0 - self._zero_t0, "streamed": streamed,
        }
        self._issue_warmup_request()
        log.info("re-armed from zero in %.3fs (%s weights)", dt,
                 "streamed" if streamed else "re-init")
        return True

    def _issue_warmup_request(self) -> bool:
        """Queue one tiny greedy self-request after a re-arm, ahead of the
        demand that woke the engine (``ARKS_ELASTIC_WARMUP``): the kernels'
        first launches run on it.  Its output sinks (no client); its seed
        is fixed, so it takes no request seed from later requests."""
        if not self._elastic_warmup:
            return False
        self._warmup_seq += 1
        req = Request(
            request_id=f"__warmup__{self._warmup_seq}",
            prompt_ids=[min(3, self.cfg.vocab_size - 1)] * 4,
            params=SamplingParams(max_tokens=2, top_k=1, seed=0),
            outputs=_WarmupSink())
        self._requeue(req)
        return True

    # ------------------------------------------------------------------
    # Windowed residency (ARKS_RESIDENCY_WINDOW_PAGES)
    # ------------------------------------------------------------------

    def _residency_active(self) -> bool:
        """A slot decodes (or is about to) through windowed residency.  The
        margin drains the pipelined path a few tokens BEFORE a slot's page
        need crosses the window, so pipelined page growth never allocates
        past the resident budget while dispatches are in flight."""
        r = self._residency
        if r is None:
            return False
        if r.slots:
            return True
        margin = 1 + max(self._pipe_depth, 1)
        return any(pages_needed(int(self._lengths[s]), margin, self._page,
                                self._max_pages) > r.window
                   for s in self._slots)

    @_scoped("residency")
    def _residency_step(self) -> bool:
        """Advance every engaged slot one token: the span-streaming forward
        and the classic step's sampler tail (``_issue_residency``), then
        the host read of its token (the sync point) and the shared
        fan-out."""
        r = self._residency
        self._abort_and_retire(2)
        r.engage_pending()
        if not r.slots:
            return False
        self._faults.fire("residency")
        for slot in list(r.slots):
            if slot not in self._slots:
                r.release(slot)
                continue
            t0 = time.monotonic()
            ids_dev, lp = self._issue_residency(slot)
            ids, lp_h = _to_host(ids_dev, lp)
            rows = None
            if lp_h is not None:
                rows = tuple(x[slot: slot + 1] for x in lp_h)
            self._fanout_decode_tokens(slot, [int(ids[slot])], rows,
                                       max(time.monotonic() - t0, 1e-6))
        return True

    def _issue_residency(self, slot: int):
        """One engaged slot's token on the device, no host sync: the span
        chain's logits [num_slots, V] sampled as a decode lane of the
        classic mixed step (the same sampler on the same rows).  Returns
        (ids [B], None | logprob data)."""
        self._ensure_guides_uploaded()
        logits = self._residency.forward(slot)
        return self._sample_mixed(logits, [slot], [])


class _WarmupSink:
    """The outputs of the re-arm's warm-up request: discarded."""

    def put(self, item) -> None:
        pass

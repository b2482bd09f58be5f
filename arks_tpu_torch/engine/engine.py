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
  fans its tokens out — the reference's sequential order, the one it runs
  off its own accelerator.

The KV cache is the engine dtype, bf16 (also under an f32 engine, whose
attention reads it widened) or int8; a paged pool may also be int4, on either scheduler (the legacy one sends its int4 decode through
the mixed attention kernel, one query per slot).  Weights are the engine
dtype or int8 / int4 (``weight_dtype``); dense and MoE models alike.  Seeded sampling
draws the reference's threefry keys.  What the reference does and this
port does not — device prefix sharing, host/disk prefix tiers, pipelined
dispatch and the decode/admission overlap, speculative decoding, guided
decoding, penalties and logprobs, fault recovery, parallelism — is
rejected by ``EngineConfig.validate`` or ``add_request`` rather than
silently ignored.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import queue
import threading
import time

import numpy as np
import torch

from arks_tpu_torch.device import resolve_device
from arks_tpu_torch.engine import prng
from arks_tpu_torch.engine import sampler as sampler_mod
from arks_tpu_torch.engine.paged import PageAllocator, pages_needed
from arks_tpu_torch.engine.types import Request, RequestOutput
from arks_tpu_torch.models import moe
from arks_tpu_torch.models import quant
from arks_tpu_torch.models import transformer as tf
from arks_tpu_torch.models.config import ModelConfig

log = logging.getLogger("arks_tpu_torch.engine")


class ContextLengthExceededError(ValueError):
    """Prompt does not fit the serving window (HTTP 400
    ``context_length_exceeded`` — never silent truncation)."""


@dataclasses.dataclass
class EngineConfig:
    """The reference's engine fields that this slice serves or rejects.
    Values outside the slice raise in ``validate``."""

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
    raw = os.environ.get("ARKS_ADMIT_BATCH_SIZES") or "8,4,2,1"
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
    raw = os.environ.get("ARKS_MIXED_STEP") or "auto"
    if raw not in ("auto", "0", "1"):
        raise ValueError(f"ARKS_MIXED_STEP={raw!r}: expected auto, 0 or 1")
    return raw


@dataclasses.dataclass
class _Slot:
    request: Request
    num_prompt: int
    generated: list[int] = dataclasses.field(default_factory=list)
    num_emitted: int = 0


@dataclasses.dataclass
class _ChunkState:
    """A chunked prefill in progress (slot reserved, not yet decoding)."""

    request: Request
    ids: list[int]
    pos: int      # tokens already prefilled
    key: np.ndarray   # np_prng_key(seed): the first token's key


_UNSERVED = (("presence_penalty", 0.0, "penalties"),
             ("frequency_penalty", 0.0, "penalties"),
             ("logit_bias", (), "logit_bias"),
             ("logprobs", None, "logprobs"),
             ("min_tokens", 0, "min_tokens"),
             ("guide", None, "guided decoding"))


def unserved_params(p) -> str | None:
    """Name of the first sampling feature this slice does not serve."""
    for field, default, what in _UNSERVED:
        if getattr(p, field) != default:
            return what
    return None


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
            num_pages = n * self._max_pages
            self.cache = tf.init_paged_cache(
                cfg, num_pages, c, cache_dtype, self.device,
                quantized=quantized,
                kv_bits=4 if kv == "int4" else 8)
            self._alloc = PageAllocator(num_pages, c)
        else:
            self._max_pages = 0
            self.cache = tf.init_cache(cfg, n, engine_cfg.max_cache_len,
                                       cache_dtype, self.device,
                                       quantized=quantized)
            self._alloc = None
        self._mixed_budget = 0
        self._moe_grouped = False
        if self._mixed:
            budget = int(os.environ.get("ARKS_MIXED_CHUNK_TOKENS") or c)
            if budget < 1:
                raise ValueError(
                    f"ARKS_MIXED_CHUNK_TOKENS={budget}: must be >= 1")
            self._mixed_budget = min(budget, engine_cfg.max_cache_len)
            # The reference runs every mixed step at its padded flat batch
            # (num_slots + budget tokens), so its MoE dispatch is fixed per
            # engine; the port trims the batch but keeps that decision.
            self._moe_grouped = moe.use_grouped(n + self._mixed_budget)
        self._buckets = engine_cfg.resolve_buckets()
        self._admit_sizes = admit_batch_sizes()

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
        # Each slot's sampling row and decode key (registered slots' rows
        # are read), with a host copy of the temperatures.
        self._sampling = sampler_mod.init_slot_sampling(n, self.device)
        self._slot_temp = np.zeros((n,), np.float32)

        # Shared with caller threads.
        self._queue: queue.PriorityQueue = queue.PriorityQueue()
        self._queue_seq = 0
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

    # ------------------------------------------------------------------
    # Request API
    # ------------------------------------------------------------------

    @property
    def kv_quantized(self) -> bool:
        return self.cache.quantized

    @property
    def kv_bits(self) -> int:
        return self.cache.kv_bits

    @property
    def max_prompt_len(self) -> int:
        """Largest admissible prompt (the decode reserve kept)."""
        return self.ecfg.max_cache_len - self.ecfg.steps_per_dispatch - 1

    def add_request(self, request: Request) -> None:
        """Queue a request (any thread).  Sampling features this slice
        does not serve raise ValueError here, on the caller's thread."""
        what = unserved_params(request.params)
        if what is not None:
            raise ValueError(f"{what} is not served by this engine yet")
        if request.params.max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        with self._abort_lock:
            self._queue_seq += 1
            seq = self._queue_seq
        self._queue.put((request.params.priority, seq, request))

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
        return len(self._slots) + len(self._prefilling)

    @property
    def idle(self) -> bool:
        return (not self._slots and not self._prefilling
                and self._queue.empty())

    def _run(self) -> None:
        while self._running:
            try:
                self.step()
            except Exception as e:  # the loop must outlive one bad step
                log.exception("engine step failed")
                self._fail_all(f"engine_fault: {type(e).__name__}: {e}")

    def _fail_all(self, error: str) -> None:
        """After a failed step: end every in-flight request with an error
        and return its slot (the reference's fault recovery and replay are
        a later slice)."""
        for slot in list(self._slots):
            st = self._slots.pop(slot)
            self._release_slot(slot)
            st.request.outputs.put(RequestOutput(
                request_id=st.request.request_id, token_ids=[],
                finished=True, finish_reason="error", error=error,
                num_prompt_tokens=st.num_prompt))
        for slot in list(self._prefilling):
            cs = self._prefilling.pop(slot)
            self._release_slot(slot)
            cs.request.outputs.put(RequestOutput(
                request_id=cs.request.request_id, token_ids=[],
                finished=True, finish_reason="error", error=error,
                num_prompt_tokens=len(cs.ids)))

    # ------------------------------------------------------------------
    # Scheduler
    # ------------------------------------------------------------------

    def step(self, block_s: float = 0.05) -> bool:
        """One scheduler iteration; returns True if any work was done.

        Mixed: issue ONE mixed dispatch, admit waiting requests while it
        runs, then fan its tokens out.  Legacy, in the reference's
        sequential order: admit (one-shot batches run at once), advance
        one prefill chunk, then one K-step decode dispatch."""
        if self._mixed:
            rec = None
            if self._slots or self._prefilling:
                rec = self._issue_mixed()
            worked = self._admit()
            if rec is not None:
                self._resolve_mixed(rec)
                worked = True
        else:
            worked = self._admit()
            if self._prefilling:
                self._process_chunk()
                worked = True
            if self._slots:
                self._decode_dispatch()
                worked = True
        if worked:
            return True
        self._purge_stale_aborts()
        try:
            _, _, req = self._queue.get(timeout=block_s)
        except queue.Empty:
            return False
        pre = self._preadmit(req)
        if pre is not None:
            self._admit_batch([pre])
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
        bucket and admitted in batches of ``admit_batch_sizes``."""
        admitted = False
        groups: dict[int, list] = {}
        while self._free:
            if sum(len(v) for v in groups.values()) >= len(self._free):
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
                self._admit_batch(items[:m])
                del items[:m]
        return admitted

    def _preadmit(self, req: Request):
        """Aborts and rejects; chunked prompts start here.  Returns
        (req, ids, padded [1, bucket]) for a one-shot prompt, else None."""
        with self._abort_lock:
            if req.request_id in self._aborted:
                self._aborted.discard(req.request_id)
                req.outputs.put(RequestOutput(
                    request_id=req.request_id, token_ids=[], finished=True,
                    finish_reason="abort"))
                return None
        ids = list(req.prompt_ids)
        if not ids or len(ids) > self.max_prompt_len:
            req.outputs.put(RequestOutput(
                request_id=req.request_id, token_ids=[], finished=True,
                finish_reason="error", error="context_length_exceeded",
                num_prompt_tokens=len(ids)))
            log.info("rejected %s: prompt of %d tokens (limit %d)",
                     req.request_id, len(ids), self.max_prompt_len)
            return None
        if self._mixed or len(ids) > self._one_shot_limit():
            self._start_chunked(req, ids)
            return None
        return req, ids, self._pad_to_bucket(ids)

    def _one_shot_limit(self) -> int:
        return min(self._buckets[-1], self.max_prompt_len)

    def _pad_to_bucket(self, ids: list[int]) -> np.ndarray:
        """[1, bucket] zero-padded prompt at the smallest covering bucket."""
        bucket = next(b for b in self._buckets if b >= len(ids))
        padded = np.zeros((1, bucket), np.int32)
        padded[0, : len(ids)] = ids
        return padded

    def _assign_pages(self, slot: int, total: int) -> np.ndarray:
        """Allocate a slot's first ``total`` pages and write its
        zero-padded table row (returned)."""
        pages = self._alloc.alloc(total)
        self._slot_pages[slot] = pages
        self._tables[slot] = 0
        self._tables[slot, :total] = pages
        return self._tables[slot]

    def _start_chunked(self, req: Request, ids: list[int]) -> None:
        seed = self._resolve_seed(req)
        slot = self._free.pop()
        if self._paged:
            # Pages cover [0, len + K - 1] from the start: the legacy decode
            # loop writes this slot's garbage rows at len..len+K-1 while it
            # chunk-prefills, and they must land in pages it owns.
            self._assign_pages(slot, pages_needed(
                len(ids), self.ecfg.steps_per_dispatch, self._page,
                self._max_pages))
        self._prefilling[slot] = _ChunkState(request=req, ids=ids, pos=0,
                                             key=prng.np_prng_key(seed))
        # Length parked at the prompt's end: interleaved decode writes land
        # past every masked read until real decode overwrites them.
        self._lengths[slot] = len(ids)
        self._last_token[slot] = 0

    def _purge_stale_aborts(self, consumed=()) -> None:
        live = {st.request.request_id for st in self._slots.values()}
        live |= {cs.request.request_id for cs in self._prefilling.values()}
        with self._abort_lock:
            self._aborted -= set(consumed)
            if not live and self._queue.empty():
                self._aborted.clear()

    def _abort_prefill(self, slot: int) -> None:
        st = self._prefilling.pop(slot)
        self._release_slot(slot)
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

    def _grow_slot_pages(self, rows: int) -> None:
        for slot in self._slots:
            need = pages_needed(int(self._lengths[slot]), rows, self._page,
                                self._max_pages)
            row = self._slot_pages[slot]
            if len(row) < need:
                new = self._alloc.alloc(need - len(row))
                self._tables[slot, len(row): len(row) + len(new)] = new
                row.extend(new)

    def _set_slots(self, slots: list[int], params: list,
                   keys: torch.Tensor) -> None:
        """Write the slots' sampling rows: their request parameters and
        their decode keys ``keys`` [M, 2]."""
        temp = np.array([p.temperature for p in params], np.float32)
        top_p = np.array([p.top_p for p in params], np.float32)
        top_k = np.array([p.top_k for p in params], np.int32)
        self._sampling = sampler_mod.set_slots(self._sampling, slots, temp,
                                               top_p, top_k, keys)
        self._slot_temp[slots] = temp

    # ------------------------------------------------------------------
    # Legacy scheduler: one-shot admission, chunks, K-step decode
    # ------------------------------------------------------------------

    def _admit_batch(self, items: list) -> None:
        """Admit one-shot prompts of one bucket in one go (the reference's
        fused ``admit_batch``): prefill, first-token sample with each
        request's key, the cache insert and the slots' sampling rows with
        the decode keys fold_in(key, 1); then register the slots."""
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
                pages[i] = self._assign_pages(slot, int(n_pages[i]))
        tokens = torch.from_numpy(np.concatenate([p for _, _, p in items])
                                  ).to(dev)
        lengths = torch.tensor([len(ids) for _, ids, _ in items],
                               dtype=torch.int32, device=dev)
        params = [req.params for req, _, _ in items]
        logits, ks, vs = tf.prefill(self.params, self.cfg, tokens, lengths)
        key_t = prng.key_tensor(keys, dev)
        firsts = self._sample_first(logits, params, key_t)
        if self._paged:
            tf.insert_pages_batch(self.cache, ks, vs, pages, n_pages)
        else:
            tf.insert_batch(self.cache, ks, vs, slots)
        del ks, vs
        self._set_slots(slots, params, prng.fold_in(key_t, 1))
        for (req, ids, _), slot, first in zip(items, slots, firsts):
            with self._abort_lock:
                aborted = req.request_id in self._aborted
                self._aborted.discard(req.request_id)
            if aborted:
                self._release_slot(slot)
                req.outputs.put(RequestOutput(
                    request_id=req.request_id, token_ids=[], finished=True,
                    finish_reason="abort", num_prompt_tokens=len(ids)))
                continue
            self._register_slot(req, slot, first, len(ids))

    def _sample_first(self, logits: torch.Tensor, params: list,
                      keys: torch.Tensor) -> list[int]:
        """First tokens of prompts whose last logits are ``logits``
        [M, V], each drawn with its request's key (the reference's
        transient sampling state); the keys are not carried."""
        dev = self.device
        temp = torch.tensor([p.temperature for p in params],
                            dtype=torch.float32, device=dev)
        top_p = torch.tensor([p.top_p for p in params], dtype=torch.float32,
                             device=dev)
        top_k = torch.tensor([p.top_k for p in params], dtype=torch.int32,
                             device=dev)
        sampled = any(p.temperature > 0 for p in params)
        ids, _ = sampler_mod.sample(logits, temp, top_p, top_k,
                                    keys if sampled else None)
        return ids.cpu().tolist()

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
        first = self._sample_first(logits, [st.request.params], key)[0]
        del self._prefilling[slot]
        self._set_slots([slot], [st.request.params], prng.fold_in(key, 1))
        self._register_slot(st.request, slot, first, len(st.ids))

    def _decode_dispatch(self) -> None:
        """ONE fused K-step decode dispatch over every slot, then the host
        fan-out of its tokens to the slots registered at issue."""
        k_steps = self.ecfg.steps_per_dispatch
        self._abort_and_retire(1 + k_steps)
        if not self._slots:
            return
        if self._paged:
            self._grow_slot_pages(k_steps)
        snapshot = list(self._slots)
        dev = self.device
        tokens = torch.from_numpy(self._last_token.copy()).to(dev)
        lengths = torch.from_numpy(self._lengths.copy()).to(dev)
        tables = torch.from_numpy(self._tables.copy()).to(dev) \
            if self._paged else None
        sentinel = self._park_sentinel()
        # Keys are read (and advance for active slots) only when a
        # registered slot samples; a greedy slot's key is never used.
        sampled = bool((self._slot_temp[snapshot] > 0).any())
        st = self._sampling
        toks = []
        for _ in range(k_steps):
            logits = tf.decode_step(self.params, self.cfg, self.cache, tokens,
                                    lengths, tables)
            tokens, keys = sampler_mod.sample(
                logits, st.temperature, st.top_p, st.top_k,
                st.key if sampled else None, lengths < sentinel)
            if keys is not None:
                st = st._replace(key=keys)
            toks.append(tokens)
            lengths = lengths + 1
        self._sampling = st
        self.decode_dispatches += 1
        self.decode_steps += k_steps
        cols = torch.stack(toks).T.cpu().tolist()      # the host sync point
        for slot in snapshot:
            self._fanout_decode_tokens(slot, cols[slot])

    def _fanout_decode_tokens(self, slot: int, col: list[int]) -> None:
        """Append a dispatch's K tokens (stopping at a stop token or the
        max_tokens cutoff — the rest is overshoot no client sees), advance
        the host mirrors, and finish or stream the delta."""
        st = self._slots[slot]
        finished = False
        for tok in col:
            st.generated.append(tok)
            if (self._is_stop(st, tok)
                    or len(st.generated) >= st.request.params.max_tokens):
                finished = True
                break
        self._lengths[slot] += len(col)   # all K rows were written
        self._last_token[slot] = col[-1]
        if finished:
            self._finish(slot, self._finish_reason(st))
        else:
            self._emit_delta(st)

    def _emit_delta(self, st: _Slot) -> None:
        delta = st.generated[st.num_emitted:]
        st.num_emitted = len(st.generated)
        st.request.outputs.put(RequestOutput(
            request_id=st.request.request_id, token_ids=delta,
            num_prompt_tokens=st.num_prompt))

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
        """Per-lane sampling columns for the lanes that sample this step;
        other lanes are greedy and unread.  Decoding lanes draw with their
        slot key and carry it on; a completing lane draws its first token
        with its chunk key (the reference's override columns).  Returns
        (temperature, top_p, top_k, keys, active), with keys and active
        None when no lane samples: no key is read then, so none advances."""
        n = self.ecfg.num_slots
        temp = np.zeros((n,), np.float32)
        top_p = np.ones((n,), np.float32)
        top_k = np.zeros((n,), np.int32)
        lanes = [(s, self._slots[s].request.params) for s in dec_slots]
        lanes += [(s, self._prefilling[s].request.params) for s in completing]
        for slot, p in lanes:
            temp[slot] = p.temperature
            top_p[slot] = p.top_p
            top_k[slot] = p.top_k
        dev = self.device
        cols = tuple(torch.from_numpy(x).to(dev) for x in (temp, top_p, top_k))
        if not (temp > 0).any():
            return (*cols, None, None)
        override = np.zeros((n,), bool)
        ov_keys = np.zeros((n, 2), np.uint32)
        for slot in completing:
            override[slot] = True
            ov_keys[slot] = self._prefilling[slot].key
        active = np.zeros((n,), bool)
        active[dec_slots] = True
        keys = torch.where(torch.from_numpy(override).to(dev)[:, None],
                           prng.key_tensor(ov_keys, dev), self._sampling.key)
        return (*cols, keys, torch.from_numpy(active).to(dev))

    def _issue_mixed(self):
        """Build and run ONE mixed dispatch: every decoding slot's next
        token plus the round-robin chunk fill.  Returns the record for
        ``_resolve_mixed`` or None when nothing needs the model."""
        self._abort_and_retire(2)
        if not self._slots and not self._prefilling:
            return None
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
        dev = self.device
        d = {k: torch.from_numpy(v).to(dev) for k, v in a.items()}
        logits = tf.mixed_step(
            self.params, self.cfg, self.cache,
            torch.from_numpy(self._tables.copy()).to(dev), d["tokens"],
            d["token_slot"], d["token_pos"], d["sample_src"],
            d["seq_q_start"], d["seq_q_len"], d["seq_pos_start"], qmax=qmax,
            moe_grouped=self._moe_grouped)
        ids_dev, keys = sampler_mod.sample(
            logits, *self._lane_sampling(dec_slots, completing))
        if keys is not None:
            self._sampling = self._sampling._replace(key=keys)
        self.dispatches += 1
        self.shared_dispatches += bool(dec_slots and chunk_take)
        return dec_slots, completing, chunk_take, ids_dev

    def _resolve_mixed(self, rec) -> None:
        """Host tail of a mixed dispatch: fan the decode tokens out,
        advance every prefilling sequence, promote completed prompts."""
        dec_slots, completing, chunk_take, ids_dev = rec
        ids = ids_dev.cpu().numpy()    # the host sync point
        for slot in dec_slots:
            self._fanout_decode_tokens(slot, [int(ids[slot])])
        for slot, take in chunk_take:
            self._prefilling[slot].pos += take
        for slot in completing:
            cs = self._prefilling.pop(slot)
            # The decode key stream is the chunk key folded with 1.
            key = prng.key_tensor(cs.key[None], self.device)
            self._set_slots([slot], [cs.request.params], prng.fold_in(key, 1))
            self._register_slot(cs.request, slot, int(ids[slot]),
                                len(cs.ids))

    def _register_slot(self, req: Request, slot: int, first: int,
                       num_prompt: int) -> None:
        st = _Slot(request=req, num_prompt=num_prompt)
        st.generated.append(first)
        self._slots[slot] = st
        self._lengths[slot] = num_prompt
        self._last_token[slot] = first
        ttft = time.monotonic() - req.arrival_time
        if self._check_finished(slot):
            return
        st.num_emitted = 1
        req.outputs.put(RequestOutput(
            request_id=req.request_id, token_ids=[first],
            num_prompt_tokens=num_prompt, ttft_s=ttft))

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

    def _release_slot(self, slot: int) -> None:
        """Free the slot.  A paged slot returns its pages and parks at the
        write-drop sentinel (its dispatch rows must never land in pages
        another slot may now own); a slot-cache slot keeps its length, as
        in the reference — its rows land in its own stripe."""
        if self._paged:
            pages = self._slot_pages.pop(slot, [])
            if pages:
                self._alloc.decref(pages)
            self._lengths[slot] = self._park_sentinel()
        self._free.append(slot)

    def _finish(self, slot: int, reason: str) -> None:
        st = self._slots.pop(slot)
        self._release_slot(slot)
        gen = st.generated
        # The stop token itself is not part of the output.
        if reason == "stop" and gen and self._is_stop(st, gen[-1]):
            final_ids = gen[:-1]
        else:
            final_ids = gen[: st.request.params.max_tokens]
        st.request.outputs.put(RequestOutput(
            request_id=st.request.request_id,
            token_ids=final_ids[st.num_emitted:], finished=True,
            finish_reason=reason, num_prompt_tokens=st.num_prompt,
            num_generated_tokens=len(final_ids)))

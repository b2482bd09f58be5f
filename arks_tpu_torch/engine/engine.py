"""Continuous-batching inference engine — the port of the reference's
single-device main path (``arks_tpu/engine/engine.py``): a paged KV pool,
the mixed scheduler at pipeline depth 0, and the request API
(``add_request`` / ``step`` / ``start`` / ``stop``).

Each scheduler step is ONE ``mixed_step`` plus ``sample``: a flat token
batch carries every decoding slot's next token and up to the mixed token
budget (``ARKS_MIXED_CHUNK_TOKENS``, default the chunk) of prefill-chunk
tokens, spread round-robin over every prefilling sequence.  A sequence
whose prompt completes inside the batch samples its first token in the
same step.  Every prompt rides the chunked path; page size == chunk size.

The KV pool is bf16/f32 (the engine dtype), int8 or int4
(``kv_cache_dtype``).  Seeded sampling draws the reference's threefry
keys.  What the reference does and this slice does not — device prefix
sharing, host/disk prefix tiers, pipelined dispatch, quantized weights,
speculative decoding, guided decoding, penalties and logprobs, fault
recovery, parallelism — is rejected by ``EngineConfig.validate`` or
``add_request`` rather than silently ignored.
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
    # Decode rows reserved per slot past its prompt (the reference's fused
    # dispatch width): bounds the largest prompt at max_cache_len - K - 1.
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
    weight_dtype: str = "bf16"     # unquantized weights
    kv_layout: str = "auto"        # "auto" = "paged"
    seed: int = 0

    def validate(self) -> None:
        self.resolve_kv_cache_dtype()
        if self.weight_dtype != "bf16":
            raise NotImplementedError(
                f"weight_dtype={self.weight_dtype}: quantized weights arrive "
                "with the weight-quantization slice")
        if self.kv_layout == "slot":
            raise NotImplementedError(
                "kv_layout='slot' arrives with the slot-layout slice")
        if self.kv_layout not in ("auto", "paged"):
            raise ValueError(f"kv_layout={self.kv_layout!r}")
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
            raise ValueError("the mixed scheduler needs prefill_chunk >= 1")
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
        if cfg.num_experts:
            raise NotImplementedError("MoE models arrive with the MoE slice")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ecfg = engine_cfg
        self.tokenizer = tokenizer
        dtype = tf.torch_dtype(engine_cfg.dtype or cfg.dtype)
        self.params = params if params is not None else tf.init_params(
            cfg, engine_cfg.seed, dtype, self.device)

        # Chunk = page: the largest divisor of the cache length not above
        # the configured chunk, so every chunk's pages stay inside a slot's
        # table and a chunk never straddles a page boundary it cannot own.
        c = min(engine_cfg.prefill_chunk, engine_cfg.max_cache_len)
        while engine_cfg.max_cache_len % c:
            c -= 1
        self._page = c
        self._max_pages = engine_cfg.max_cache_len // c
        num_pages = engine_cfg.num_slots * self._max_pages
        kv = engine_cfg.resolve_kv_cache_dtype()
        if kv == "bf16" and dtype != torch.bfloat16:
            raise NotImplementedError(
                "a bf16 pool under a float32 engine: the attention kernel "
                "reads q and an unquantized pool in one dtype")
        self.cache = tf.init_paged_cache(
            cfg, num_pages, c, dtype, self.device,
            quantized=kv in ("int8", "int4"), kv_bits=4 if kv == "int4" else 8)
        self._alloc = PageAllocator(num_pages, c)
        budget = int(os.environ.get("ARKS_MIXED_CHUNK_TOKENS") or c)
        if budget < 1:
            raise ValueError(f"ARKS_MIXED_CHUNK_TOKENS={budget}: must be >= 1")
        self._mixed_budget = min(budget, engine_cfg.max_cache_len)

        # Host-authoritative scheduler state (engine thread only).
        n = engine_cfg.num_slots
        self._tables = np.zeros((n, self._max_pages), np.int32)
        self._lengths = np.full((n,), self._park_sentinel(), np.int32)
        self._last_token = np.zeros((n,), np.int32)
        self._slots: dict[int, _Slot] = {}
        self._prefilling: dict[int, _ChunkState] = {}
        self._slot_pages: dict[int, list[int]] = {}
        self._free: list[int] = list(range(n))
        self._request_seed = 0
        # Each slot's threefry key [n, 2] (decoding slots only are read).
        self._keys = torch.zeros((n, 2), dtype=torch.int64,
                                 device=self.device)

        # Shared with caller threads.
        self._queue: queue.PriorityQueue = queue.PriorityQueue()
        self._queue_seq = 0
        self._abort_lock = threading.Lock()
        self._aborted: set[str] = set()
        self._running = False
        self._thread: threading.Thread | None = None
        # Mixed dispatches issued (each runs every layer's two kernels once),
        # and those that carried decode and prefill-chunk tokens together.
        self.dispatches = 0
        self.shared_dispatches = 0

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
        """One scheduler iteration: issue ONE mixed dispatch, admit waiting
        requests while it runs, then fan its tokens out.  Returns True if
        any work was done."""
        rec = None
        if self._slots or self._prefilling:
            rec = self._issue_mixed()
        admitted = self._admit()
        if rec is not None:
            self._resolve_mixed(rec)
        if rec is not None or admitted:
            return True
        self._purge_stale_aborts()
        try:
            _, _, req = self._queue.get(timeout=block_s)
        except queue.Empty:
            return False
        self._preadmit(req)
        return True

    def _park_sentinel(self) -> int:
        """Write-drop position for parked slots: the kernels drop K/V
        writes at/beyond the table coverage."""
        return self._max_pages * self._page

    def _resolve_seed(self, req: Request) -> int:
        if req.params.seed is not None:
            return req.params.seed
        if req.assigned_seed is None:
            self._request_seed += 1
            req.assigned_seed = self._request_seed
        return req.assigned_seed

    def _admit(self) -> bool:
        admitted = False
        while self._free:
            try:
                _, _, req = self._queue.get_nowait()
            except queue.Empty:
                break
            admitted = True
            self._preadmit(req)
        return admitted

    def _preadmit(self, req: Request) -> None:
        with self._abort_lock:
            if req.request_id in self._aborted:
                self._aborted.discard(req.request_id)
                req.outputs.put(RequestOutput(
                    request_id=req.request_id, token_ids=[], finished=True,
                    finish_reason="abort"))
                return
        ids = list(req.prompt_ids)
        if not ids or len(ids) > self.max_prompt_len:
            req.outputs.put(RequestOutput(
                request_id=req.request_id, token_ids=[], finished=True,
                finish_reason="error", error="context_length_exceeded",
                num_prompt_tokens=len(ids)))
            log.info("rejected %s: prompt of %d tokens (limit %d)",
                     req.request_id, len(ids), self.max_prompt_len)
            return
        self._start_chunked(req, ids)

    def _start_chunked(self, req: Request, ids: list[int]) -> None:
        seed = self._resolve_seed(req)
        slot = self._free.pop()
        # Pages cover [0, len + K - 1] from the start, as in the reference.
        total = pages_needed(len(ids), self.ecfg.steps_per_dispatch,
                             self._page, self._max_pages)
        pages = self._alloc.alloc(total)
        self._slot_pages[slot] = pages
        self._tables[slot] = 0
        self._tables[slot, :total] = pages
        self._prefilling[slot] = _ChunkState(request=req, ids=ids, pos=0,
                                             key=prng.np_prng_key(seed))
        self._lengths[slot] = len(ids)
        self._last_token[slot] = 0

    def _purge_stale_aborts(self, consumed=()) -> None:
        live = {st.request.request_id for st in self._slots.values()}
        live |= {cs.request.request_id for cs in self._prefilling.values()}
        with self._abort_lock:
            self._aborted -= set(consumed)
            if not live and self._queue.empty():
                self._aborted.clear()

    def _mixed_abort_and_retire(self) -> None:
        """Honor aborts for decoding and prefilling sequences, and retire
        slots whose next row would overflow the cache."""
        with self._abort_lock:
            aborted = set(self._aborted)
        consumed = set()
        for slot in list(self._slots):
            rid = self._slots[slot].request.request_id
            if rid in aborted:
                self._finish(slot, "abort")
                consumed.add(rid)
        for slot, st in list(self._prefilling.items()):
            rid = st.request.request_id
            if rid in aborted:
                del self._prefilling[slot]
                self._release_slot(slot)
                st.request.outputs.put(RequestOutput(
                    request_id=rid, token_ids=[], finished=True,
                    finish_reason="abort", num_prompt_tokens=len(st.ids)))
                consumed.add(rid)
        self._purge_stale_aborts(consumed)
        for slot in list(self._slots):
            if int(self._lengths[slot]) + 2 > self.ecfg.max_cache_len:
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
                           prng.key_tensor(ov_keys, dev), self._keys)
        return (*cols, keys, torch.from_numpy(active).to(dev))

    def _issue_mixed(self):
        """Build and run ONE mixed dispatch: every decoding slot's next
        token plus the round-robin chunk fill.  Returns the record for
        ``_resolve_mixed`` or None when nothing needs the model."""
        self._mixed_abort_and_retire()
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
        t0 = time.monotonic()
        logits = tf.mixed_step(
            self.params, self.cfg, self.cache,
            torch.from_numpy(self._tables.copy()).to(dev), d["tokens"],
            d["token_slot"], d["token_pos"], d["sample_src"],
            d["seq_q_start"], d["seq_q_len"], d["seq_pos_start"], qmax=qmax)
        ids_dev, keys = sampler_mod.sample(
            logits, *self._lane_sampling(dec_slots, completing))
        if keys is not None:
            self._keys = keys
        self.dispatches += 1
        self.shared_dispatches += bool(dec_slots and chunk_take)
        return dec_slots, completing, chunk_take, ids_dev, t0

    def _resolve_mixed(self, rec) -> None:
        """Host tail of a mixed dispatch: fan the decode tokens out,
        advance every prefilling sequence, promote completed prompts."""
        dec_slots, completing, chunk_take, ids_dev, _t0 = rec
        ids = ids_dev.cpu().numpy()    # the host sync point
        for slot in dec_slots:
            st = self._slots[slot]
            tok = int(ids[slot])
            st.generated.append(tok)
            self._lengths[slot] += 1
            self._last_token[slot] = tok
            if (self._is_stop(st, tok)
                    or len(st.generated) >= st.request.params.max_tokens):
                self._finish(slot, self._finish_reason(st))
            else:
                delta = st.generated[st.num_emitted:]
                st.num_emitted = len(st.generated)
                st.request.outputs.put(RequestOutput(
                    request_id=st.request.request_id, token_ids=delta,
                    num_prompt_tokens=st.num_prompt))
        for slot, take in chunk_take:
            self._prefilling[slot].pos += take
        for slot in completing:
            cs = self._prefilling.pop(slot)
            self._register_slot(cs, slot, int(ids[slot]))

    def _register_slot(self, cs: _ChunkState, slot: int, first: int) -> None:
        req = cs.request
        st = _Slot(request=req, num_prompt=len(cs.ids))
        # The decode key stream is the chunk key folded with 1.
        self._keys[slot] = prng.fold_in(
            prng.key_tensor(cs.key, self.device), 1)
        st.generated.append(first)
        self._slots[slot] = st
        self._lengths[slot] = len(cs.ids)
        self._last_token[slot] = first
        ttft = time.monotonic() - req.arrival_time
        if self._check_finished(slot):
            return
        st.num_emitted = 1
        req.outputs.put(RequestOutput(
            request_id=req.request_id, token_ids=[first],
            num_prompt_tokens=st.num_prompt, ttft_s=ttft))

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
        """Return the slot's pages and park it at the write-drop sentinel."""
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

#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``arks_tpu_torch``): drives its main
path on one NVIDIA GPU and holds every kernel of that path against its
plain PyTorch version.  Run from the repository root: ``python3 chip_smoke.py``.

Phases (any failure raises and exits non-zero):
  1. device   the card's name and power limit (nvidia-smi); no CUDA -> exit 2
  2. build    nvcc builds every kernel from arks_tpu_torch/csrc (timed)
  3. kernels  each kernel vs its plain version on the card at Qwen2.5-7B
              shapes (Hkv=4, G=7, D=128, page 256) on a mixed batch: 8
              decode lanes across page boundaries, prefill chunks of 256
              and 37 tokens (one starting mid-page), padding tokens and
              inactive lanes.  bf16 pool: the update, through both its
              entry points (the step's destinations from paged_write_rows,
              and write_idx / tables resolved in the kernel), must leave
              the pool bit-identical to the plain scatter; the bf16
              attention within 5e-3 of the plain version in bf16 and 1e-2
              of it in f32 on the same bf16 inputs; the f32 attention
              within 1e-5 of the plain version in f32.  int8 and int4
              pools: the quantized update, through both entry points,
              bit-identical to its plain version (values and scales; int4
              pair-mates in one dispatch and lone mates); the attention
              within 5e-3 of the plain version in bf16 and 1e-5 in f32.
              Rows no lane owns exactly zero.  The dense launch of the
              attention (ARKS_MIXED_GRID=dense) gives every row
              bit-identical to the ragged launch.  The reference's span and state arguments: each lane's pages cut
              at half, [0, k) with emit_state then [k, end) carrying it
              equal the single call bit for bit (bf16, int8 and int4
              pools, f32 q over bf16).  Then
              the threefry bits, keys and uniforms of 64 seeds on the card
              equal those on the CPU bit for bit.  Then the legacy
              scheduler's kernels: the slot cache [2, 8, 4, 4096, 128]
              (bf16, and int8 with scales) and a paged pool of 8 x 16
              pages of 256, slots at lengths across tile and page edges,
              an empty slot and a parked one (write index S, length
              S + 1).  kv_cache_update and kv_cache_update_quant leave
              the cache bit-identical to their plain versions, there and
              at Mixtral-8x7B's widths (Hkv 8, D 128: bf16 rows, f32 rows
              into the bf16 and the int8 cache, and a batch whose every
              write drops, which must change nothing);
              ragged_decode_attention and paged_decode_attention (split-KV:
              pieces of 256 positions and a combine launch) meet the
              attention limits above, their f32 kernels within 1e-5 of the
              plain split-and-combine (decode_attention_split_plain); the
              empty slot's output is zero.  Then the repaired faults: f32
              rows into bf16 (paged_kv_update through both entry points,
              kv_cache_update) bit-exact,
              f32 q over the bf16 pool and cache (the mixed, paged and
              slot decode attentions) within 1e-5, and grouped_matmul at
              K = 96 (bf16, int8, int4 group 32) and at Mixtral's gate
              with int4 group 32 within 1e-2 of the largest |out|.
  4. serve    the port's engine at Qwen2.5-7B full width (random bf16
              weights from a seed, 8 slots, max_cache_len 4096) behind its
              OpenAI server, once with a bf16 KV pool and once, on the same
              weights, with an int8 pool: completions (plain, SSE across
              two prefill chunks, repeated greedy, a seeded sampled request
              twice), chat, and concurrent requests that share
              dispatches.  Each run's counters are set to 0 just before it
              and read just after: its update kernel (paged_kv_update, or
              paged_kv_update_quant for int8) and paged_mixed_attention
              must each count num_layers x that run's mixed dispatches, the
              other kernels none.  On the bf16 engine, one mixed_step
              under ARKS_MIXED_GRID=dense equals the ragged one bit for
              bit and a greedy request gives the same tokens under both
              grids (the dense run counts the dense launch, num_layers x
              its dispatches).  Then the legacy scheduler on the same
              weights, three more engines: the slot cache in bf16 and in
              int8, and the paged int8 pool under ARKS_MIXED_STEP=0 — a
              one-shot prompt twice, a seeded request twice, a 1100-token
              prompt (chunked: past the largest bucket) over SSE, 8
              concurrent greedy streams.  Then a legacy paged int4 pool
              (its decode attention rides paged_mixed_attention, one query
              per slot): the one-shot prompt twice and the 8 streams.
              Each run's update and attention kernels must count
              num_layers x its decode steps, every other kernel none.
              Then an f32 engine at Qwen2.5-7B width cut to 2 layers over
              a bf16 cache: one greedy request on the mixed scheduler and
              on the legacy one (slot cache, and paged pool), each run's
              update and attention kernels counting num_layers x its
              dispatches or decode steps.
              The request surface (phase_surface), on the mixed bf16
              engine and on the legacy bf16 slot-cache engine, each run
              counted as above: logit_bias +100 pins its token, -100 moves
              the first token off the plain stream's, penalties 2.0 repeat
              no token more than the plain stream and change it (both
              under a +10 bias on one token, so the plain one repeats),
              min_tokens 16 holds a stop id back, logprobs (completions and
              chat) are the top-1, non-positive, descending and within 2e-3
              of log_softmax in f32 of their step's logits, guided_choice
              answers one of its strings, a JSON-mode guide and a forced
              tool call walk their DFAs (the call, under a +8 bias on
              "}", finishes and parses as the named function, also as the
              server's tool_calls), n 2 with a seed takes child seeds seed
              and seed + 1, echo leads with the prompt.  Then one decode step
              of 8 lanes at context 512 through the engine's own sampling
              code (phase_surface_step), every feature off and every
              feature on for every lane, beside the profile phases' step
              (argmax only): device µs and kernel launches per step; on
              the legacy engine the all-off step must issue the argmax
              step's aten ops, read in the same call.
              Every engine runs the reference's default shape
              (ARKS_PIPELINE_DEPTH 2, ARKS_SAMPLER_FUSE 1, the legacy
              decode/admission overlap on): each served run above must
              also have issued pipelined dispatches.  Then the engine
              shape itself (phase_pipeline): Qwen2.5-7B on the mixed bf16
              pool and the legacy bf16 slot cache at depth 0 (fusion off),
              depth 0 (fusion on, mixed only), depth 1 and depth 2 — one
              greedy stream, 8 greedy streams admitted together (every
              slot live in steady state) and 8 more traced over 16 steady
              steps: all streams equal across the configurations, the
              kernels counting num_layers x dispatches (decode steps),
              every pipelined issue under
              torch.cuda.set_sync_debug_mode("error") (no hidden host
              sync); decode tok/s at 1 and 8 streams, host ms per token,
              busy share and launches per step.
              Then prefix reuse (phase_prefix) on the same weights at
              depth 2, every call of the tiers' issue paths
              (_pipe_issue, _issue_restore, _spill_flush) under
              set_sync_debug_mode("error"): on the mixed bf16 pool a
              2,048-token prefix with 8 distinct 64-token tails, one at a
              time — the cold request's TTFT, then each warm one's, which
              prefills exactly its tail, every stream equal to a
              prefix-off engine's; then distinct 15-page prompts until the
              prefix leaves the device index, and the warm prompt again,
              restored from the host tier (2,048 host-hit tokens, the
              restored pages' bytes equal to the spilled ones, the same
              stream).  The same on mixed int8 and int4 pools and the
              legacy paged int8 pool (the prefix evicted by pool
              pressure), and the legacy slot bf16 cache's prefix cache
              (harvest, then a warm insert).  Each engine's kernels count
              num_layers x its dispatches (decode steps).
  5. parity   two mixed_steps through the kernels vs the same steps through
              impl="plain" at full width: logits within 10% of the largest
              |logit| in bf16 and within 5e-4 in f32, and the same argmax
              wherever the top-2 margin exceeds that tolerance — over all
              28 layers with a bf16/f32 pool, over the first layer with an
              int8 and an int4 pool.  Over all 28 layers the quantized
              pools are read, not limited (see phase_parity): finite, and
              the same argmax wherever the margin exceeds 10%.  Then traced
              decode steps (bf16 and int8 pools): host time per step and
              the device's busy share.
  6. times    CUDA-event kernel times (L2 flushed before each launch) beside
              their bounds, the plain versions and one PyTorch library call
              computing the same function (none for the quantized update);
              the mixed attention also on the batch's 8 decode lanes
              alone, and split by the profiler into its piece kernel and
              its combine;
              int8/int4 attention beside SDPA over pre-gathered,
              pre-dequantized KV; the legacy kernels at phase 3's slot
              cache and pool beside SDPA with a length mask (decode
              attention: the profiler's device time counts the split and
              the combine launch) and index_put_ (the slot write);
              the four row writes (paged_kv_update, paged_kv_update_quant
              int8/int4, kv_cache_update, kv_cache_update_quant): cold
              time, the profiler's device time with L2 warm, the launch
              floor (an empty kernel timed both ways, beside the paged
              writes and again beside the slot writes) and the wrapper's
              host µs per call (median and least of 5 runs of 1000
              calls), the paged ones through both entry points;
              end-to-end decode tok/s and TTFT.
  7. moe      with ARKS_MOE_KERNEL=pallas: grouped_matmul (bf16, int8,
              int4 group 128) against its plain version at Mixtral-8x7B's
              gate [8, 4096, 14336] and down [8, 14336, 4096] shapes over
              528 routed rows (an empty expert, a 128-row group, a 1-row
              group), a decode step's 16 rows over 7 experts and a batch
              with a 65-row group, within 1e-2 of the largest |out|, tiles
              past the groups exactly zero, timed beside the bound, the
              plain version and torch._grouped_mm over dequantized bf16
              weights; then quantized qeinsum's routes through it
              (phase_moe_routes, int8 and int4): the dense MoE route at
              T = 8 over the 8 experts (gate and down) and the
              projections wq [4096, 4096] and wk [4096, 1024] over 8 and
              264 rows, each one launch within 1e-2 of the largest |out|
              of qeinsum_plain, timed beside that convert path and the
              byte bound, with the kernels each launches;
              Mixtral-8x7B served at full width and all 32 layers with
              random int8 weights (a bf16 pool of 8 slots x 4096, chunk
              256) at the default engine shape (depth 2, fusion on)
              through phase 4's requests, grouped_matmul counting 7 x
              num_layers x mixed dispatches (q, k, v, o and the FFN's
              three, grouped or dense), with peak device memory, and one
              traced mixed step; then 8 greedy streams at depth 2 on the
              same weights, every pipelined issue sync-checked, and the
              pipe step (8 tokens: the dense MoE route, as the
              reference's rule gives) beside the sequential one on the
              same lanes; a short batch with int4 weights; and
              mixed_step through the kernels vs impl="plain" over 2 layers
              (bf16 and int8 weights, 10% of the largest |logit|) and 1
              layer in f32 (5e-4).
  8. checkpoint and operability.  phase_checkpoint: this script writes a
              synthetic HF checkpoint in two safetensors shards (its own
              writer) to a temp directory it deletes: Qwen2.5-7B at full
              width, 2 layers, bf16; params_from_hf loads it in bf16 and
              with int8 quantize-on-load, each tree bit-exact against
              params_from_numpy (and quantize_params with the reference's
              jitted scales) of the same arrays; greedy completions
              served from the loaded engine equal an engine's on the
              bridged tree; then Mixtral-8x7B at full width, 1 layer,
              int8 on load (grouped_matmul runs).  Load seconds, GB/s,
              peak device memory (bound: the tree plus one full-width
              stacked leaf) and peak host RSS.  phase_operability, on
              Qwen2.5-7B bf16 at depth 2 with ARKS_QUEUE_MAX=4 and
              ARKS_QUEUE_TENANT_MAX=3: launches per steady step with the
              metrics within half a launch of those with inert metrics
              over 128-step windows (no added launch; the profiler may
              drop a window's first events); behind the server,
              every issue and admission under set_sync_debug_mode
              ("error"): /metrics counts N successes and the generated
              tokens, /readiness 200, a two-tenant flood gives 429 and
              503 with Retry-After and the survivors 200, drain() with
              two streams in flight turns readiness 503, refuses a new
              POST with 503 and lets both streams finish whole.
The line before the last is the kernels JSON (nine counterparts); the last
line is the device JSON.  A kernel's "launches" counts its launches in the
runs of the served path: phase 4's, the request surface's, the pipeline's,
prefix reuse's, operability's and the checkpoint-loaded engines' included
(the dense launch: its greedy run) and phase 7's (grouped_matmul, every
quantized product).
"""

from __future__ import annotations

import collections
import dataclasses
import http.client
import json
import math
import subprocess
import sys
import threading
import time

import numpy as np

MODEL = "qwen2.5-7b"
MOE_MODEL = "mixtral-8x7b"
SEED = 0
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
PAGE, MAX_PAGES = 256, 16        # engine page (= chunk) and table width
UPDATE_SRC = "arks_tpu_torch/csrc/paged_kv_update.cu"
QUANT_SRC = "arks_tpu_torch/csrc/paged_kv_update_quant.cu"
ATTN_SRC = "arks_tpu_torch/csrc/paged_mixed_attention.cu"
DECODE_SRC = "arks_tpu_torch/csrc/decode_attention.cu"
SLOT_UPDATE_SRC = "arks_tpu_torch/csrc/kv_cache_update.cu"
GROUPED_SRC = "arks_tpu_torch/csrc/grouped_matmul.cu"
SLOT_LEN = 4096                  # slot cache length (= MAX_PAGES * PAGE)
F32_LAYERS = 2                   # depth of phase 4's f32 engine (full width)
KV_BITS = {"int8": 8, "int4": 4}
# Attention, phase 3: the bf16 kernel vs the bf16 plain version (one bf16
# ulp at |x| < 1 is at most 3.9e-3) and vs the f32 plain version on the
# same bf16 inputs; the f32 kernel vs the f32 plain version.
ATTN_TOL_BF16, ATTN_TOL_F32, ATTN_TOL_F32_KERNEL = 5e-3, 1e-2, 1e-5


T_START = time.perf_counter()


def log(msg: str) -> None:
    """One line of the log, after the seconds since the script started."""
    print(f"{time.perf_counter() - T_START:7.1f}s {msg}", flush=True)


# ---------------------------------------------------------------------------
# Phase 1-2
# ---------------------------------------------------------------------------


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(smi)     # as nvidia-smi prints it: "<name>, <power limit> W"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()} "
        f"name {torch.cuda.get_device_name(0)}; tf32 off")
    return smi


def phase_build():
    from arks_tpu_torch.ops import _kernels
    t0 = time.perf_counter()
    logs = _kernels.build_all()
    secs = time.perf_counter() - t0
    for stem, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] {stem}: {line.strip()}")
    log(f"[build] {len(logs)} sources built with nvcc in {secs:.1f} s")
    return secs


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def kernel_batch(torch, dev, *, hkv=4, g=7, d=128, layers=2):
    """The mixed batch of phase 3 (numpy seed 0): lanes 0-7 decode at
    positions that sit on and across page boundaries, lane 8 a 256-token
    chunk from position 512, lane 9 a 37-token chunk from 300 (mid-page),
    lanes 10-11 inactive, then 5 padding tokens."""
    rng = np.random.default_rng(SEED)
    decode = [255, 256, 511, 700, 1023, 1500, 2047, 3000]
    lanes = [(p, 1) for p in decode] + [(512, 256), (300, 37)]
    s = len(lanes) + 2
    slot, pos = [], []
    q_start = np.zeros(s, np.int32)
    q_len = np.zeros(s, np.int32)
    pos_start = np.zeros(s, np.int32)
    for lane, (p0, n) in enumerate(lanes):
        q_start[lane], q_len[lane], pos_start[lane] = len(slot), n, p0
        slot += [lane] * n
        pos += range(p0, p0 + n)
    n_pad = 5
    slot += [-1] * n_pad
    pos += [MAX_PAGES * PAGE] * n_pad
    n_pages = s * MAX_PAGES
    tables = rng.permutation(n_pages).reshape(s, MAX_PAGES).astype(np.int32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t = len(slot)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    b = dict(q=randn(t, hkv * g, d), k_new=randn(t, hkv, d),
             v_new=randn(t, hkv, d),
             k_pool=randn(layers, n_pages, hkv, PAGE, d),
             v_pool=randn(layers, n_pages, hkv, PAGE, d), layer=layers - 1)
    for name, arr in (("tables", tables), ("token_slot", slot),
                      ("token_pos", pos), ("seq_q_start", q_start),
                      ("seq_q_len", q_len), ("seq_pos_start", pos_start)):
        b[name] = torch.as_tensor(np.asarray(arr, np.int32), device=dev)
    cover = MAX_PAGES * PAGE
    b["tables_tok"] = b["tables"][b["token_slot"].clamp(min=0).long()]
    b["write_idx"] = torch.where(b["token_slot"] < 0,
                                 torch.full_like(b["token_pos"], cover),
                                 b["token_pos"])
    return b


def _same_bytes(torch, got, want) -> bool:
    return all(torch.equal(g.view(torch.uint8), w.view(torch.uint8))
               for g, w in zip(got, want, strict=True))


def _update_entries(pa, b):
    """The two entry points of an update kernel on phase 3's batch: the
    step's destinations (``dst``, what the served path launches) and
    write_idx / tables resolved in the kernel.  {name: (args, kwargs)}
    after the pools."""
    rows = (b["k_new"], b["v_new"])
    return {"dst": ((*rows, None, None, b["layer"]), dict(dst=b["dst"])),
            "write_idx/tables": ((*rows, b["write_idx"], b["tables_tok"],
                                  b["layer"]), {})}


def phase_kernels(torch, dev):
    from arks_tpu_torch.ops import paged_attention as pa
    b = kernel_batch(torch, dev)
    b["dst"] = pa.paged_write_rows(b["write_idx"], b["tables_tok"], PAGE,
                                   b["k_pool"].shape[1])
    upd_args = (b["k_new"], b["v_new"], b["write_idx"], b["tables_tok"],
                b["layer"])
    k_plain, v_plain = b["k_pool"].clone(), b["v_pool"].clone()
    pa.paged_kv_update(k_plain, v_plain, *upd_args, impl="plain")
    upd_err = 0.0
    for entry, (args, kw) in _update_entries(pa, b).items():
        k_kern, v_kern = b["k_pool"].clone(), b["v_pool"].clone()
        pa.paged_kv_update(k_kern, v_kern, *args, **kw)
        torch.cuda.synchronize()
        same = _same_bytes(torch, (k_kern, v_kern), (k_plain, v_plain))
        err = max((k_kern.float() - k_plain.float()).abs().max().item(),
                  (v_kern.float() - v_plain.float()).abs().max().item())
        upd_err = max(upd_err, err)
        log(f"[kernels] paged_kv_update through {entry}: pool bytes "
            f"bit-identical to the plain scatter: {same} (max abs err {err})")
        if not same:
            raise AssertionError(f"paged_kv_update ({entry}) differs from "
                                 "the plain scatter")

    lane = (b["tables"], b["seq_q_start"], b["seq_q_len"], b["seq_pos_start"],
            b["layer"])
    out_k = pa.paged_mixed_attention(b["q"], k_kern, v_kern, *lane)
    out_p = pa.paged_mixed_attention(b["q"], k_kern, v_kern, *lane,
                                     impl="plain")
    qf, kf, vf = b["q"].float(), k_kern.float(), v_kern.float()
    out_f = pa.paged_mixed_attention(qf, kf, vf, *lane, impl="plain")
    out_fk = pa.paged_mixed_attention(qf, kf, vf, *lane)
    torch.cuda.synchronize()
    err_bf16 = (out_k.float() - out_p.float()).abs().max().item()
    err_f32 = (out_k.float() - out_f).abs().max().item()
    err_f32k = (out_fk - out_f).abs().max().item()
    pad = b["token_slot"] < 0
    pad_max = max(out_k[pad].float().abs().max().item(),
                  out_fk[pad].abs().max().item())
    finite = bool(torch.isfinite(out_k.float()).all().item()
                  and torch.isfinite(out_fk).all().item())
    log(f"[kernels] paged_mixed_attention: bf16 kernel max abs err vs plain "
        f"bf16 {err_bf16:.3e} (tol {ATTN_TOL_BF16}), vs plain f32 "
        f"{err_f32:.3e} (tol {ATTN_TOL_F32}); f32 kernel vs plain f32 "
        f"{err_f32k:.3e} (tol {ATTN_TOL_F32_KERNEL}); rows no lane owns max "
        f"|x| {pad_max}; finite {finite}")
    if not (finite and err_bf16 <= ATTN_TOL_BF16 and err_f32 <= ATTN_TOL_F32
            and err_f32k <= ATTN_TOL_F32_KERNEL and pad_max == 0.0):
        raise AssertionError("paged_mixed_attention disagrees with its plain "
                             "version")
    # The dense launch: every row bit-identical to the ragged launch's.
    dense = [pa.paged_mixed_attention(q, kp, vp, *lane, grid="dense")
             for q, kp, vp in ((b["q"], k_kern, v_kern), (qf, kf, vf))]
    torch.cuda.synchronize()
    same = (torch.equal(dense[0].view(torch.int16), out_k.view(torch.int16))
            and torch.equal(dense[1].view(torch.int32),
                            out_fk.view(torch.int32)))
    log(f"[kernels] paged_mixed_attention_dense (bf16 and f32): every row "
        f"bit-identical to the ragged launch: {same}")
    if not same:
        raise AssertionError("the dense launch differs from the ragged one")
    del kf, vf, dense, k_plain, v_plain
    b["pools_before"] = b["k_pool"], b["v_pool"]
    b["k_pool"], b["v_pool"] = k_kern, v_kern
    return b, upd_err, err_bf16


def quant_pools(b, kv):
    """Phase 3's bf16 pools (as they were before phase 3's update)
    quantized per token as the served path stores them: int8 values (or
    int4, packed along the page axis) and f32 scales — pools that already
    hold data at realistic magnitudes."""
    from arks_tpu_torch.ops import paged_attention as pa
    out = {}
    for name, pool in zip(("k", "v"), b["pools_before"]):
        vals, scale = pa.quantize_kv(pool, qmax=7 if kv == "int4" else 127)
        out[f"{name}_pool"] = pa.pack_int4(vals, 3) if kv == "int4" else vals
        out[f"{name}_scale"] = scale
    return out


def phase_quant_kernels(torch, dev, b):
    """The quantized update and the int8/int4 attention streams against
    their plain versions on phase 3's batch.  Returns {kv: (pools, update
    error, bf16 attention error)}."""
    from arks_tpu_torch.ops import paged_attention as pa
    names = ("k_pool", "v_pool", "k_scale", "v_scale")
    upd = (b["k_new"], b["v_new"], b["write_idx"], b["tables_tok"],
           b["layer"])
    lane = (b["tables"], b["seq_q_start"], b["seq_q_len"], b["seq_pos_start"],
            b["layer"])
    pad = b["token_slot"] < 0
    res = {}
    for kv in KV_BITS:
        pools = quant_pools(b, kv)
        plain = [pools[k].clone() for k in names]
        pa.paged_kv_update_quant(*plain, *upd, impl="plain")
        upd_err = 0.0
        for entry, (args, kw) in _update_entries(pa, b).items():
            kern = [pools[k].clone() for k in names]
            pa.paged_kv_update_quant(*kern, *args, **kw)
            torch.cuda.synchronize()
            same = _same_bytes(torch, kern, plain)
            upd_err = max([upd_err] + [(g.float() - w.float()).abs().max()
                                       .item() for g, w in zip(kern, plain)])
            written = not torch.equal(kern[0], pools["k_pool"])
            log(f"[kernels] paged_kv_update_quant {kv} through {entry}: "
                f"values and scales bit-identical to the plain version: "
                f"{same} (max abs err {upd_err}); rows written: {written}")
            if not (same and written):
                raise AssertionError(f"paged_kv_update_quant ({kv}, {entry}) "
                                     "differs from its plain version")
        kp, vp, ks, vs = kern
        sc = dict(k_scale=ks, v_scale=vs)
        out_k = pa.paged_mixed_attention(b["q"], kp, vp, *lane, **sc)
        out_p = pa.paged_mixed_attention(b["q"], kp, vp, *lane, impl="plain",
                                         **sc)
        qf = b["q"].float()
        out_fk = pa.paged_mixed_attention(qf, kp, vp, *lane, **sc)
        out_fp = pa.paged_mixed_attention(qf, kp, vp, *lane, impl="plain",
                                          **sc)
        torch.cuda.synchronize()
        err_bf16 = (out_k.float() - out_p.float()).abs().max().item()
        err_f32 = (out_fk - out_fp).abs().max().item()
        pad_max = max(out_k[pad].float().abs().max().item(),
                      out_fk[pad].abs().max().item())
        finite = bool(torch.isfinite(out_k.float()).all().item()
                      and torch.isfinite(out_fk).all().item())
        log(f"[kernels] paged_mixed_attention {kv} pool: bf16 kernel max abs "
            f"err vs plain bf16 {err_bf16:.3e} (tol {ATTN_TOL_BF16}); f32 "
            f"kernel vs plain f32 {err_f32:.3e} (tol {ATTN_TOL_F32_KERNEL}); "
            f"rows no lane owns max |x| {pad_max}; finite {finite}")
        if not (finite and err_bf16 <= ATTN_TOL_BF16
                and err_f32 <= ATTN_TOL_F32_KERNEL and pad_max == 0.0):
            raise AssertionError(f"paged_mixed_attention ({kv} pool) "
                                 "disagrees with its plain version")
        res[kv] = (dict(zip(names, kern)), upd_err, err_bf16)
    return res


def phase_span_chain(torch, b, qres):
    """The reference's span and state arguments on phase 3's batch: each
    lane's pages are cut at k = half of them (at least 1); [0, k) with
    emit_state, then [k, end) carrying that state, must give the single
    call's output bit for bit (the pieces are pages, the fold a left fold)
    over the bf16 pool, the int8 and int4 pools, and with f32 q over the
    bf16 pool.  The emitted state's rows no lane owns are zero."""
    from arks_tpu_torch.ops import paged_attention as pa
    lane = (b["tables"], b["seq_q_start"], b["seq_q_len"],
            b["seq_pos_start"], b["layer"])
    pages = (b["seq_pos_start"] + b["seq_q_len"] + PAGE - 1) // PAGE
    split = torch.clamp(pages // 2, min=1).to(torch.int32)
    pad = b["token_slot"] < 0
    cases = {"bf16": (b["q"], b["k_pool"], b["v_pool"], {}),
             "f32 q over bf16": (b["q"].float(), b["k_pool"], b["v_pool"],
                                 {})}
    for kv, (pools, _, _) in qres.items():
        cases[kv] = (b["q"], pools["k_pool"], pools["v_pool"],
                     dict(k_scale=pools["k_scale"], v_scale=pools["v_scale"]))
    for name, (q, kp, vp, sc) in cases.items():
        whole = pa.paged_mixed_attention(q, kp, vp, *lane, **sc)
        state = pa.paged_mixed_attention(q, kp, vp, *lane, page_hi=split,
                                         emit_state=True, **sc)
        chained = pa.paged_mixed_attention(q, kp, vp, *lane, page_lo=split,
                                           carry_state=state, **sc)
        torch.cuda.synchronize()
        bits = torch.int16 if q.dtype == torch.bfloat16 else torch.int32
        same = torch.equal(chained.view(bits), whole.view(bits))
        pad_zero = not any(x[pad].any().item() for x in state)
        log(f"[kernels] paged_mixed_attention spans, {name}: [0, k) emitting "
            f"state then [k, end) carrying it equals the single call bit for "
            f"bit: {same}; state rows no lane owns zero: {pad_zero}")
        if not (same and pad_zero):
            raise AssertionError(f"span-chained attention ({name}) differs "
                                 "from the single call")


def phase_fault_kernels(torch, dev, b, lb):
    """The two faults the slice repairs, on the card.  An f32 engine over a
    bf16 cache: paged_kv_update and kv_cache_update round f32 rows to bf16
    bit for bit as their plain versions; paged_mixed_attention,
    paged_decode_attention and ragged_decode_attention with f32 q over the
    bf16 pool and cache within 1e-5 of their plain versions.  Then
    grouped_matmul at K = 96 (bf16, int8, int4 group 32) and at Mixtral's
    gate with int4 group 32, within GM_TOL of its plain version."""
    from arks_tpu_torch.models import quant
    from arks_tpu_torch.ops import moe_kernel as mk
    from arks_tpu_torch.ops import paged_attention as pa
    from arks_tpu_torch.ops import pallas_attention as pl
    rows = (b["k_new"].float() * 1.001, b["v_new"].float() / 3)
    upd = (*rows, b["write_idx"], b["tables_tok"], b["layer"])
    kern = [x.clone() for x in b["pools_before"]]
    kern_dst = [x.clone() for x in b["pools_before"]]
    plain = [x.clone() for x in b["pools_before"]]
    pa.paged_kv_update(*kern, *upd)
    pa.paged_kv_update(*kern_dst, *rows, None, None, b["layer"],
                       dst=b["dst"])
    pa.paged_kv_update(*plain, *upd, impl="plain")
    widx = lb["lengths"] - 1
    slot_k = [x.clone() for x in (lb["k_cache"], lb["v_cache"])]
    slot_p = [x.clone() for x in (lb["k_cache"], lb["v_cache"])]
    rows = [torch.randn(lb["q"].shape[0], lb["k_cache"].shape[2],
                        lb["k_cache"].shape[-1], device=dev) / 3
            for _ in range(2)]
    pl.kv_cache_update(*slot_k, *rows, widx, lb["layer"])
    pl.kv_cache_update(*slot_p, *rows, widx, lb["layer"], impl="plain")
    torch.cuda.synchronize()
    same = _same_bytes(torch, kern + kern_dst + slot_k,
                       plain + plain + slot_p)
    log(f"[kernels] f32 rows into bf16: paged_kv_update (through dst and "
        f"through write_idx/tables) and kv_cache_update bit-identical to "
        f"their plain versions: {same}")
    if not same:
        raise AssertionError("an update kernel's f32 -> bf16 rows differ")
    lane = (b["tables"], b["seq_q_start"], b["seq_q_len"], b["seq_pos_start"],
            b["layer"])
    qf, qd = b["q"].float(), lb["q"].float()
    checks = {
        "paged_mixed_attention": lambda impl: pa.paged_mixed_attention(
            qf, b["k_pool"], b["v_pool"], *lane, impl=impl),
        "paged_decode_attention": lambda impl: pa.paged_decode_attention(
            qd, lb["k_pool"], lb["v_pool"], lb["tables"],
            lb["paged_lengths"], lb["layer"], impl=impl),
        "ragged_decode_attention": lambda impl: pl.ragged_decode_attention(
            qd, lb["k_cache"], lb["v_cache"], lb["lengths"], lb["layer"],
            impl=impl)}
    for name, fn in checks.items():
        got, want = fn(None), fn("plain")
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        log(f"[kernels] {name}, f32 q over bf16: max abs err vs plain "
            f"{err:.3e} (tol {ATTN_TOL_F32_KERNEL})")
        if not (got.dtype == torch.float32 and err <= ATTN_TOL_F32_KERNEL):
            raise AssertionError(f"{name} (f32 over bf16) disagrees with its "
                                 "plain version")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    sizes = MOE_GROUPS
    gs = torch.as_tensor(sizes, device=dev)
    se = torch.repeat_interleave(torch.arange(len(sizes), device=dev), gs)
    for k, n, mode, group in ((96, 208, "bf16", 0), (96, 208, "int8", 0),
                              (96, 208, "int4", 32),
                              (4096, 14336, "int4", 32)):
        xs = torch.randn((sum(sizes), k), generator=gen,
                         device=dev).to(torch.bfloat16)
        xs_p, _, bexp = mk.pad_groups(xs, se, gs)
        w = torch.randn((len(sizes), k, n), generator=gen, device=dev) * 0.02
        kw = {}
        if mode == "bf16":
            w = w.to(torch.bfloat16)
        elif mode == "int8":
            qd = quant.quantize_tensor(w)
            w, kw = qd["q"], {"w_scale": qd["s"][:, 0, :].contiguous()}
        else:
            qd = quant.quantize_tensor_int4(w, group)
            w, kw = qd["q"], {"w_group_scale": qd["gs"]}
        got = mk.grouped_matmul(xs_p, w, bexp, rows_used=mk.rows_used(gs),
                                tile_rows=mk.tile_rows(gs, bexp.shape[0]),
                                **kw)
        want = mk.grouped_matmul(xs_p, w, bexp, impl="plain", **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        top = want.float().abs().max().item()
        log(f"[kernels] grouped_matmul K={k} N={n} {mode}"
            f"{f' group {group}' if group else ''}: max abs err {err:.3e} "
            f"of max |out| {top:.3e} (tol {GM_TOL['bf16']} of it)")
        if not err <= GM_TOL["bf16"] * top:
            raise AssertionError(f"grouped_matmul K={k} {mode} disagrees "
                                 "with its plain version")
        del xs, xs_p, w, got, want
    torch.cuda.empty_cache()


def phase_prng(torch, dev):
    """Threefry on the card against the CPU: split, fold_in, random_bits
    and uniform of 64 seeds (past 2**32 and negative ones included) bit for
    bit."""
    from arks_tpu_torch.engine import prng
    seeds = list(range(60)) + [2**32 + 3, 2**40, -1, -77]
    keys = prng.key_tensor(np.stack([prng.np_prng_key(x) for x in seeds]))
    checks = {
        "split": lambda k: prng.split(k, 3),
        "fold_in": lambda k: prng.fold_in(k, 1),
        "random_bits": lambda k: prng.random_bits(k, 257),
        "uniform": lambda k: prng.uniform(k, 257).view(torch.int32),
    }
    same = {name: bool(torch.equal(fn(keys.to(dev)).cpu(), fn(keys)))
            for name, fn in checks.items()}
    log(f"[prng] threefry on the card == on the CPU for {len(seeds)} seeds: "
        f"{same}")
    if not all(same.values()):
        raise AssertionError("threefry differs between the card and the CPU")


# ---------------------------------------------------------------------------
# Phase 3 (legacy): the slot cache's and the paged decode kernels
# ---------------------------------------------------------------------------


def slot_batch(torch, dev, *, hkv=4, g=7, d=128, layers=2):
    """Phase 3's legacy inputs (numpy seed 1): a bf16 slot cache
    [layers, 8, hkv, 4096, d] and a paged pool of 8 x 16 pages of 256 (the
    same kind of data), shuffled tables, q [8, hkv, g, d], new rows, the
    write indices (slot 4 parked at S) and the attention lengths: across
    64-token tiles and 256-token pages, slot 4 empty (0), slot 5 parked
    (S + 1), slot 7 full."""
    rng = np.random.default_rng(SEED + 1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    b = 8

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    i32 = dict(dtype=torch.int32, device=dev)
    lengths = [1, 255, 256, 257, 0, SLOT_LEN + 1, 2049, SLOT_LEN]
    return dict(
        q=randn(b, hkv, g, d), k_new=randn(b, hkv, d), v_new=randn(b, hkv, d),
        k_cache=randn(layers, b, hkv, SLOT_LEN, d),
        v_cache=randn(layers, b, hkv, SLOT_LEN, d),
        k_pool=randn(layers, b * MAX_PAGES, hkv, PAGE, d),
        v_pool=randn(layers, b * MAX_PAGES, hkv, PAGE, d),
        tables=torch.as_tensor(rng.permutation(b * MAX_PAGES).reshape(
            b, MAX_PAGES).astype(np.int32), device=dev),
        write_idx=torch.tensor([0, 254, 255, 256, SLOT_LEN, 63, 2048,
                                SLOT_LEN - 1], **i32),
        lengths=torch.tensor(lengths, **i32),
        # Paged: the parked slot attends nothing (its write index is past
        # the table's coverage).
        paged_lengths=torch.tensor([n if n <= SLOT_LEN else 0
                                    for n in lengths], **i32),
        layer=layers - 1)


def _int8(pa, pools):
    """bf16 pools quantized per token as the served path stores them:
    (k values, v values, k scales, v scales)."""
    (kq, ks), (vq, vs) = (pa.quantize_kv(x) for x in pools)
    return kq, vq, ks, vs


def _attn_check(torch, what, got, want_bf16, want_f32, got_f32, empty,
                cross=True):
    """The attention limits of phase 3 (``cross``: the bf16 kernel against
    the f32 plain version too, as for bf16 caches); returns the bf16
    error."""
    err_bf16 = (got.float() - want_bf16.float()).abs().max().item()
    err_f32 = (got.float() - want_f32).abs().max().item() if cross else 0.0
    err_f32k = (got_f32 - want_f32).abs().max().item()
    zero = max(got[empty].float().abs().max().item(),
               got_f32[empty].abs().max().item())
    finite = bool(torch.isfinite(got.float()).all().item()
                  and torch.isfinite(got_f32).all().item())
    cross_msg = (f", vs plain f32 {err_f32:.3e} (tol {ATTN_TOL_F32})"
                 if cross else "")
    log(f"[kernels] {what}: bf16 kernel max abs err vs plain bf16 "
        f"{err_bf16:.3e} (tol {ATTN_TOL_BF16}){cross_msg}; f32 kernel vs "
        f"plain f32 {err_f32k:.3e} (tol {ATTN_TOL_F32_KERNEL}); empty slot "
        f"max |x| {zero}; finite {finite}")
    if not (finite and err_bf16 <= ATTN_TOL_BF16 and err_f32 <= ATTN_TOL_F32
            and err_f32k <= ATTN_TOL_F32_KERNEL and zero == 0.0):
        raise AssertionError(f"{what} disagrees with its plain version")
    return err_bf16


def _split_check(torch, what, got_f, split_f, lengths, cover, hkv):
    """The f32 kernel against ``decode_attention_split_plain`` (its
    256-position pieces and their combine) within ATTN_TOL_F32_KERNEL; logs
    the CTAs that work (pieces below each slot's length) of the grid."""
    from arks_tpu_torch.ops import paged_attention as pa
    err = (got_f - split_f).abs().max().item()
    n = np.minimum(lengths.cpu().numpy().astype(np.int64), cover)
    working = int((-(-n // pa.DECODE_SPLIT)).sum()) * hkv
    log(f"[kernels] {what} split-KV: f32 kernel vs the plain split-and-"
        f"combine {err:.3e} (tol {ATTN_TOL_F32_KERNEL}); {working} working "
        f"CTAs of a grid of {len(n) * hkv * pa.decode_splits(cover)}")
    if not err <= ATTN_TOL_F32_KERNEL:
        raise AssertionError(f"{what} disagrees with its split plain version")


def _slot_writes_wide(torch, dev, pl):
    """kv_cache_update and kv_cache_update_quant against their plain
    versions at Mixtral-8x7B's KV widths (Hkv 8, D 128) on a slot cache of
    8 slots x 4096: bf16 rows into the bf16 cache, f32 rows into it and
    into the int8 cache, each at slot_batch's write indices and at indices
    that all drop (past S or negative).  Every byte and scale must equal
    the plain version's; the all-dropped batch must change nothing."""
    from arks_tpu_torch.ops import paged_attention as pa
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    hkv, d, nb = 8, 128, 8
    cache = [torch.randn((2, nb, hkv, SLOT_LEN, d), generator=gen,
                         device=dev).to(torch.bfloat16) for _ in range(2)]
    quant = _int8(pa, cache)
    rows = [torch.randn((nb, hkv, d), generator=gen, device=dev) * 3
            for _ in range(2)]
    i32 = dict(dtype=torch.int32, device=dev)
    batches = {"edges and a parked slot": torch.tensor(
                   [0, 254, 255, 256, SLOT_LEN, 63, 2048, SLOT_LEN - 1], **i32),
               "every write dropped": torch.tensor(
                   [SLOT_LEN, SLOT_LEN + 1, -1, SLOT_LEN, 2 ** 31 - 1, -5,
                    SLOT_LEN, SLOT_LEN + 7], **i32)}
    cases = [("kv_cache_update", "bf16 rows", pl.kv_cache_update, cache,
              [x.to(torch.bfloat16) for x in rows]),
             ("kv_cache_update", "f32 rows into bf16", pl.kv_cache_update,
              cache, rows),
             ("kv_cache_update_quant", "f32 rows into int8",
              pl.kv_cache_update_quant, quant, rows)]
    for name, what, fn, base, new in cases:
        for tag, widx in batches.items():
            kern = [x.clone() for x in base]
            plain = [x.clone() for x in base]
            fn(*kern, *new, widx, 1)
            fn(*plain, *new, widx, 1, impl="plain")
            torch.cuda.synchronize()
            same = _same_bytes(torch, kern, plain)
            changed = not _same_bytes(torch, kern[:1], base[:1])
            dropped = tag == "every write dropped"
            log(f"[kernels] {name} at Hkv {hkv}, D {d} ({what}, {tag}): "
                f"bytes bit-identical to the plain version: {same}; cache "
                f"changed: {changed}")
            if not same or changed == dropped:
                raise AssertionError(f"{name} ({what}, {tag}) differs from "
                                     "its plain version")
            del kern, plain


def phase_legacy_kernels(torch, dev):
    """The four legacy kernels against their plain versions on
    ``slot_batch``, and the two slot writes at Mixtral's widths
    (``_slot_writes_wide``).  Returns (batch, {name: max abs err})."""
    from arks_tpu_torch.ops import paged_attention as pa
    from arks_tpu_torch.ops import pallas_attention as pl
    b = slot_batch(torch, dev)
    layer, empty = b["layer"], 4
    rows = (b["k_new"], b["v_new"], b["write_idx"], layer)
    errs = {}

    kern = [b["k_cache"].clone(), b["v_cache"].clone()]
    plain = [b["k_cache"].clone(), b["v_cache"].clone()]
    pl.kv_cache_update(*kern, *rows)
    pl.kv_cache_update(*plain, *rows, impl="plain")
    torch.cuda.synchronize()
    same = all(torch.equal(x.view(torch.int16), y.view(torch.int16))
               for x, y in zip(kern, plain))
    kept = torch.equal(kern[0][:, 4], b["k_cache"][:, 4])
    errs["kv_cache_update"] = max((x.float() - y.float()).abs().max().item()
                                  for x, y in zip(kern, plain))
    log(f"[kernels] kv_cache_update: cache bytes bit-identical to the plain "
        f"version: {same}; parked slot untouched: {kept}")
    if not (same and kept):
        raise AssertionError("kv_cache_update differs from its plain version")
    del kern, plain

    q, qf = b["q"], b["q"].float()
    args = (b["lengths"], layer)
    kc, vc = b["k_cache"], b["v_cache"]
    got = pl.ragged_decode_attention(q, kc, vc, *args)
    want = pl.ragged_decode_attention(q, kc, vc, *args, impl="plain")
    kf, vf = kc.float(), vc.float()
    want_f = pl.ragged_decode_attention(qf, kf, vf, *args, impl="plain")
    got_f = pl.ragged_decode_attention(qf, kf, vf, *args)
    split_f = pa.decode_attention_split_plain(qf, kf[layer], vf[layer],
                                              b["lengths"])
    torch.cuda.synchronize()
    del kf, vf
    errs["ragged_decode_attention"] = _attn_check(
        torch, "ragged_decode_attention (bf16 slot cache)", got, want,
        want_f, got_f, empty)
    _split_check(torch, "ragged_decode_attention", got_f, split_f,
                 b["lengths"], SLOT_LEN, q.shape[1])

    quant = list(_int8(pa, (kc, vc)))
    kern = [x.clone() for x in quant]
    plain = [x.clone() for x in quant]
    pl.kv_cache_update_quant(*kern, *rows)
    pl.kv_cache_update_quant(*plain, *rows, impl="plain")
    torch.cuda.synchronize()
    same = all(torch.equal(x.view(torch.int8), y.view(torch.int8))
               for x, y in zip(kern, plain))
    written = not torch.equal(kern[0], quant[0])
    errs["kv_cache_update_quant"] = max(
        (x.float() - y.float()).abs().max().item()
        for x, y in zip(kern, plain))
    log(f"[kernels] kv_cache_update_quant: values and scales bit-identical "
        f"to the plain version: {same}; rows written: {written}")
    if not (same and written):
        raise AssertionError("kv_cache_update_quant differs from its plain "
                             "version")
    sc = dict(k_scale=kern[2], v_scale=kern[3])
    got = pl.ragged_decode_attention(q, kern[0], kern[1], *args, **sc)
    want = pl.ragged_decode_attention(q, kern[0], kern[1], *args,
                                      impl="plain", **sc)
    got_f = pl.ragged_decode_attention(qf, kern[0], kern[1], *args, **sc)
    want_f = pl.ragged_decode_attention(qf, kern[0], kern[1], *args,
                                        impl="plain", **sc)
    torch.cuda.synchronize()
    _attn_check(torch, "ragged_decode_attention (int8 slot cache)", got,
                want, want_f, got_f, empty, cross=False)
    b["slot_int8"] = kern
    del plain, quant
    _slot_writes_wide(torch, dev, pl)

    pargs = (b["tables"], b["paged_lengths"], layer)
    kp, vp = b["k_pool"], b["v_pool"]
    got = pa.paged_decode_attention(q, kp, vp, *pargs)
    want = pa.paged_decode_attention(q, kp, vp, *pargs, impl="plain")
    kf, vf = kp.float(), vp.float()
    want_f = pa.paged_decode_attention(qf, kf, vf, *pargs, impl="plain")
    got_f = pa.paged_decode_attention(qf, kf, vf, *pargs)
    split_f = pa.decode_attention_split_plain(
        qf, *(pa.paged_gather_kv(x, b["tables"], layer) for x in (kf, vf)),
        b["paged_lengths"])
    torch.cuda.synchronize()
    del kf, vf
    errs["paged_decode_attention"] = _attn_check(
        torch, "paged_decode_attention (bf16 pool)", got, want, want_f,
        got_f, empty)
    _split_check(torch, "paged_decode_attention", got_f, split_f,
                 b["paged_lengths"], SLOT_LEN, q.shape[1])
    pq = _int8(pa, (kp, vp))
    sc = dict(k_scale=pq[2], v_scale=pq[3])
    got = pa.paged_decode_attention(q, pq[0], pq[1], *pargs, **sc)
    want = pa.paged_decode_attention(q, pq[0], pq[1], *pargs, impl="plain",
                                     **sc)
    got_f = pa.paged_decode_attention(qf, pq[0], pq[1], *pargs, **sc)
    want_f = pa.paged_decode_attention(qf, pq[0], pq[1], *pargs,
                                       impl="plain", **sc)
    torch.cuda.synchronize()
    _attn_check(torch, "paged_decode_attention (int8 pool)", got, want,
                want_f, got_f, empty, cross=False)
    b["paged_int8"] = pq
    return b, errs


# ---------------------------------------------------------------------------
# Phase 4: the served path
# ---------------------------------------------------------------------------


def _counted():
    """Every kernel wrapper of the port, by name."""
    from arks_tpu_torch.ops import moe_kernel as mk
    from arks_tpu_torch.ops import paged_attention as pa
    from arks_tpu_torch.ops import pallas_attention as pl
    return {"paged_kv_update": pa.paged_kv_update,
            "paged_kv_update_quant": pa.paged_kv_update_quant,
            "paged_mixed_attention": pa.paged_mixed_attention,
            "paged_mixed_attention_dense": pa.paged_mixed_attention_dense,
            "grouped_matmul": mk.grouped_matmul,
            "paged_decode_attention": pa.paged_decode_attention,
            "kv_cache_update": pl.kv_cache_update,
            "kv_cache_update_quant": pl.kv_cache_update_quant,
            "ragged_decode_attention": pl.ragged_decode_attention}


def _reset_counts():
    for fn in _counted().values():
        fn.launches = 0


def _read_counts():
    return {name: fn.launches for name, fn in _counted().items()}


def _request(port, path, body, stream=False):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
    t0 = time.perf_counter()
    conn.request("POST", path, json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    if not stream:
        data = json.loads(resp.read())
        conn.close()
        return resp.status, data, None, time.perf_counter() - t0
    frames, t_first = [], None
    for raw in resp:
        line = raw.decode().strip()
        if not line.startswith("data: "):
            continue
        if line == "data: [DONE]":
            break
        if t_first is None:
            t_first = time.perf_counter() - t0
        frames.append(json.loads(line[6:]))
    conn.close()
    return resp.status, frames, t_first, time.perf_counter() - t0


def _stream_summary(frames):
    text = "".join(f["choices"][0].get("text")
                   or f["choices"][0].get("delta", {}).get("content") or ""
                   for f in frames if f["choices"])
    finish = [f["choices"][0]["finish_reason"] for f in frames
              if f["choices"] and f["choices"][0]["finish_reason"]]
    usage = [f["usage"] for f in frames if f.get("usage")]
    return text, finish, usage


def _check_usage(what, usage, prompt_len, max_tokens, finish):
    ok = (usage["prompt_tokens"] == prompt_len
          and usage["total_tokens"] == usage["prompt_tokens"]
          + usage["completion_tokens"]
          and (usage["completion_tokens"] == max_tokens if finish == "length"
               else finish == "stop"
               and usage["completion_tokens"] <= max_tokens))
    log(f"[serve] {what}: finish {finish}, usage {usage}")
    if not ok:
        raise AssertionError(f"{what}: usage/finish_reason inconsistent")


def _pool_bytes(cache):
    return sum(x.numel() * x.element_size() for x in cache
               if x is not None)


def phase_serve(torch, dev, kv="bf16", params=None, engine=None):
    """The served path with a ``kv`` pool ("bf16" or "int8"), on ``params``
    (random weights from SEED when None), or on a built ``engine`` (the
    Mixtral engines of phase 7).  Returns (engine, results)."""
    from arks_tpu_torch.engine import EngineConfig, InferenceEngine
    from arks_tpu_torch.engine.tokenizer import ByteTokenizer
    from arks_tpu_torch.models import get_config
    from arks_tpu_torch.server import OpenAIServer

    if engine is None:
        t0 = time.perf_counter()
        engine = InferenceEngine(get_config(MODEL), EngineConfig(
            model=MODEL, num_slots=8, max_cache_len=MAX_PAGES * PAGE,
            prefill_chunk=PAGE, dtype="bfloat16", kv_cache_dtype=kv,
            seed=SEED), ByteTokenizer(), params=params, device=dev)
        torch.cuda.synchronize()
        log(f"[serve {kv}] {MODEL} engine up in "
            f"{time.perf_counter() - t0:.1f} s: "
            f"{sum(x.numel() for x in _leaves(engine.params)) / 1e9:.2f}B "
            f"params bf16, {kv} pool {tuple(engine.cache.k.shape)} "
            f"{engine.cache.k.dtype}, K+V pool {_pool_bytes(engine.cache)} B "
            f"(scales included), {torch.cuda.memory_allocated() / 2**30:.1f} "
            "GiB allocated")
    cfg, model = engine.cfg, engine.ecfg.model
    tag = f"[serve {kv}]" if model == MODEL else \
        f"[serve {model} {engine.ecfg.weight_dtype}]"
    res = {"pool_bytes": _pool_bytes(engine.cache)}
    server = OpenAIServer(engine, model, host="127.0.0.1", port=0)
    server.start(background=True)
    engine.start()
    port = server.port
    tok = engine.tokenizer
    try:
        # Warm-up request (first cuBLAS/kernel calls), outside the counts.
        st, data, _, _ = _request(port, "/v1/completions", {
            "prompt": "warm up", "max_tokens": 4, "temperature": 0})
        if st != 200:
            raise AssertionError(f"warm-up failed: {st} {data}")

        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        d0, shared0 = engine.dispatches, engine.shared_dispatches
        p0 = engine.pipe_dispatches

        prompt = "The port serves OpenAI completions on the card."
        body = {"prompt": prompt, "max_tokens": 24, "temperature": 0}
        st, data, _, secs = _request(port, "/v1/completions", body)
        if st != 200:
            raise AssertionError(f"completion: HTTP {st} {data}")
        text1 = data["choices"][0]["text"]
        _check_usage(f"{kv} completion", data["usage"],
                     len(tok.encode(prompt)), 24,
                     data["choices"][0]["finish_reason"])
        st, data2, _, _ = _request(port, "/v1/completions", body)
        if st != 200 or data2["choices"][0]["text"] != text1:
            raise AssertionError("a repeated greedy completion differs")
        log(f"{tag} repeated greedy completion identical ({len(text1)} "
            "chars)")
        seeded = {"prompt": prompt, "max_tokens": 12, "temperature": 0.9,
                  "top_p": 0.95, "top_k": 50, "seed": 2**33 + 11,
                  "ignore_eos": True}
        texts = []
        for _ in range(2):
            st, data3, _, _ = _request(port, "/v1/completions", seeded)
            if st != 200:
                raise AssertionError(f"seeded completion: HTTP {st} {data3}")
            texts.append(data3["choices"][0]["text"])
        log(f"{tag} seeded sampled completion identical twice: "
            f"{texts[0] == texts[1]}")
        if texts[0] != texts[1]:
            raise AssertionError("a seeded request gave two different "
                                 "streams")

        long_ids = [int(x) for x in
                    np.random.default_rng(SEED).integers(2, 258, 300)]
        st, frames, ttft, secs = _request(port, "/v1/completions", {
            "prompt": long_ids, "max_tokens": 32, "temperature": 0,
            "ignore_eos": True, "stream": True,
            "stream_options": {"include_usage": True}}, stream=True)
        text, finish, usage = _stream_summary(frames)
        if st != 200 or len(finish) != 1 or len(usage) != 1:
            raise AssertionError(f"SSE completion: HTTP {st}, {finish}")
        _check_usage(f"{kv} SSE completion (300-token prompt, 2 chunks)",
                     usage[0], 300, 32, finish[0])
        res["ttft_300_s"] = ttft

        msgs = [{"role": "user", "content": "Say something about pages."}]
        st, data, _, _ = _request(port, "/v1/chat/completions", {
            "messages": msgs, "max_tokens": 16, "temperature": 0})
        if st != 200 or data["choices"][0]["message"]["role"] != "assistant":
            raise AssertionError(f"chat: HTTP {st} {data}")
        _check_usage(f"{kv} chat completion", data["usage"],
                     len(tok.apply_chat_template(msgs)), 16,
                     data["choices"][0]["finish_reason"])

        # Concurrency: a long decode, then a long prompt arriving while it
        # decodes — its chunks ride the decode lane's dispatches.
        out = {}

        def run(key, body):
            out[key] = _request(port, "/v1/completions", body)

        a = threading.Thread(target=run, args=("decode", {
            "prompt": "decode lane", "max_tokens": 48, "temperature": 0,
            "ignore_eos": True}))
        a.start()
        time.sleep(0.5)
        bth = threading.Thread(target=run, args=("prefill", {
            "prompt": long_ids * 2, "max_tokens": 8, "temperature": 0.8,
            "top_p": 0.9, "top_k": 40, "seed": 7, "ignore_eos": True}))
        bth.start()
        a.join(900)
        bth.join(900)
        for key, n_prompt, n_max in (("decode", len(tok.encode("decode lane")),
                                      48), ("prefill", 600, 8)):
            st, data, _, _ = out[key]
            if st != 200:
                raise AssertionError(f"concurrent {key}: HTTP {st} {data}")
            _check_usage(f"{kv} concurrent {key}", data["usage"], n_prompt,
                         n_max,
                         data["choices"][0]["finish_reason"])
        shared = engine.shared_dispatches - shared0
        log(f"{tag} dispatches carrying decode and prefill tokens: {shared}")
        if shared < 1:
            raise AssertionError("decode and prefill never shared a dispatch")

        dispatches = engine.dispatches - d0
        pipe = engine.pipe_dispatches - p0
        launches = _read_counts()
        want = cfg.num_layers * dispatches
        update = "paged_kv_update_quant" if engine.kv_quantized \
            else "paged_kv_update"
        expected = {name: want if name in (update, "paged_mixed_attention")
                    else 0 for name in launches}
        expected["grouped_matmul"] = _gm_per_layer(
            engine, engine._moe_grouped) * want
        log(f"{tag} of those, pipelined dispatches {pipe} (depth "
            f"{engine._pipe_depth}, fused {engine.sampler_fused_dispatches}"
            f", occupancy {dict(sorted(engine.pipe_occupancy.items()))})")
        if engine._pipe_depth and not pipe:
            raise AssertionError(f"{tag} no pipelined dispatch at depth "
                                 f"{engine._pipe_depth}")
        log(f"{tag} mixed dispatches {dispatches}, launches {launches}, "
            f"expected {expected} ({cfg.num_layers} layers)")
        if launches != expected or dispatches == 0:
            raise AssertionError("kernel launch counts != layers x dispatches")
        res["launches"] = launches

        # End-to-end decode rate: one stream, then 8 concurrent.
        st, frames, t_first, secs = _request(port, "/v1/completions", {
            "prompt": "tok/s", "max_tokens": 128, "temperature": 0,
            "ignore_eos": True, "stream": True,
            "stream_options": {"include_usage": True}}, stream=True)
        n = _stream_summary(frames)[2][0]["completion_tokens"]
        res["decode_tok_s_b1"] = (n - 1) / (secs - t_first)
        threads = [threading.Thread(target=run, args=(f"b{i}", {
            "prompt": f"lane {i}", "max_tokens": 128, "temperature": 0,
            "ignore_eos": True})) for i in range(8)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(900)
        wall = time.perf_counter() - t0
        total = sum(out[f"b{i}"][1]["usage"]["completion_tokens"]
                    for i in range(8))
        res["decode_tok_s_b8"] = total / wall
        res["peak_bytes"] = torch.cuda.max_memory_allocated()
        log(f"{tag} decode {res['decode_tok_s_b1']:.1f} tok/s at batch 1, "
            f"{res['decode_tok_s_b8']:.1f} tok/s aggregate at batch 8 "
            f"({total} tokens in {wall:.2f} s incl. prefill); TTFT of the "
            f"300-token prompt {res['ttft_300_s'] * 1e3:.1f} ms (first SSE "
            f"frame); peak device memory while serving {res['peak_bytes']} B "
            "(torch.cuda.max_memory_allocated)")
    finally:
        server.stop()
        engine.stop()
    return engine, res


def _legacy_seeded_and_long(tag, port, prompt, layout, kv, res):
    """Phase 4's legacy runs, continued: a seeded sampled request twice and
    a 1100-token prompt (chunked: past the largest bucket) over SSE."""
    out = {}

    def run(key, body, stream=False):
        out[key] = _request(port, "/v1/completions", body, stream)

    seeded = {"prompt": prompt, "max_tokens": 12, "temperature": 0.9,
              "top_p": 0.95, "top_k": 50, "seed": 2**33 + 11,
              "ignore_eos": True}
    texts = []
    for i in range(2):
        run(f"seeded{i}", seeded)
        if out[f"seeded{i}"][0] != 200:
            raise AssertionError(f"{tag} seeded: {out[f'seeded{i}']}")
        texts.append(out[f"seeded{i}"][1]["choices"][0]["text"])
    log(f"{tag} repeated greedy identical; seeded sampled completion "
        f"identical twice: {texts[0] == texts[1]}")
    if texts[0] != texts[1]:
        raise AssertionError(f"{tag} a seeded request gave two streams")

    long_ids = [int(x) for x in
                np.random.default_rng(SEED + 2).integers(2, 258, 1100)]
    st, frames, ttft, _ = _request(port, "/v1/completions", {
        "prompt": long_ids, "max_tokens": 16, "temperature": 0,
        "ignore_eos": True, "stream": True,
        "stream_options": {"include_usage": True}}, stream=True)
    text, finish, usage = _stream_summary(frames)
    if st != 200 or len(finish) != 1 or len(usage) != 1:
        raise AssertionError(f"{tag} SSE completion: HTTP {st}, {finish}")
    _check_usage(f"{layout} {kv} SSE completion (1100-token prompt, "
                 "chunked)", usage[0], 1100, 16, finish[0])
    res["ttft_1100_s"] = ttft


def phase_serve_legacy(torch, dev, layout, kv, params, surface=False):
    """The legacy scheduler served on ``params``: the slot cache
    (``layout`` "slot") or the paged pool under ARKS_MIXED_STEP=0, with a
    ``kv`` cache ("bf16" or "int8"; "int4" on the paged pool, whose decode
    rides paged_mixed_attention: there a one-shot prompt twice and the 8
    concurrent streams only).  With ``surface``, then phase_surface on the
    same engine and server, and (engine stopped) phase_surface_step beside
    phase_decode_profile's step on its weights.  Returns its results."""
    import os

    from arks_tpu_torch.engine import EngineConfig, InferenceEngine
    from arks_tpu_torch.engine.tokenizer import ByteTokenizer
    from arks_tpu_torch.models import get_config
    from arks_tpu_torch.server import OpenAIServer

    cfg = get_config(MODEL)
    tag = f"[serve {layout} {kv}]"
    os.environ["ARKS_MIXED_STEP"] = "0"
    try:
        t0 = time.perf_counter()
        engine = InferenceEngine(cfg, EngineConfig(
            model=MODEL, num_slots=8, max_cache_len=SLOT_LEN,
            prefill_chunk=PAGE, dtype="bfloat16", kv_cache_dtype=kv,
            kv_layout=layout, seed=SEED), ByteTokenizer(), params=params,
            device=dev)
    finally:
        del os.environ["ARKS_MIXED_STEP"]
    if engine._mixed or engine._paged != (layout == "paged"):
        raise AssertionError(f"{tag}: not the legacy scheduler")
    torch.cuda.synchronize()
    res = {"pool_bytes": _pool_bytes(engine.cache)}
    log(f"{tag} legacy engine up in {time.perf_counter() - t0:.1f} s: cache "
        f"{type(engine.cache).__name__} {tuple(engine.cache.k.shape)} "
        f"{engine.cache.k.dtype}, K+V {res['pool_bytes']} B (scales "
        f"included), {torch.cuda.memory_allocated() / 2**30:.1f} GiB "
        "allocated")
    server = OpenAIServer(engine, MODEL, host="127.0.0.1", port=0)
    server.start(background=True)
    engine.start()
    port = server.port
    tok = engine.tokenizer
    out = {}

    def run(key, body, stream=False):
        out[key] = _request(port, "/v1/completions", body, stream)

    try:
        run("warm", {"prompt": "warm up", "max_tokens": 4, "temperature": 0})
        if out["warm"][0] != 200:
            raise AssertionError(f"{tag} warm-up failed: {out['warm']}")
        _reset_counts()
        s0, d0 = engine.decode_steps, engine.decode_dispatches
        p0 = engine.pipe_dispatches

        prompt = "The legacy scheduler serves the slot cache on the card."
        body = {"prompt": prompt, "max_tokens": 24, "temperature": 0}
        texts = []
        for i in range(2):
            run(f"greedy{i}", body)
            st, data = out[f"greedy{i}"][:2]
            if st != 200:
                raise AssertionError(f"{tag} completion: HTTP {st} {data}")
            texts.append(data["choices"][0]["text"])
        _check_usage(f"{layout} {kv} one-shot completion", data["usage"],
                     len(tok.encode(prompt)), 24,
                     data["choices"][0]["finish_reason"])
        if texts[0] != texts[1]:
            raise AssertionError(f"{tag} a repeated greedy completion "
                                 "differs")
        if kv == "int4":
            log(f"{tag} repeated greedy identical")
            res["ttft_1100_s"] = None
        else:
            _legacy_seeded_and_long(tag, port, prompt, layout, kv, res)

        threads = [threading.Thread(target=run, args=(f"b{i}", {
            "prompt": f"lane {i} of the legacy scheduler", "max_tokens": 32,
            "temperature": 0, "ignore_eos": True})) for i in range(8)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(900)
        wall = time.perf_counter() - t0
        for i in range(8):
            st, data = out[f"b{i}"][:2]
            if st != 200:
                raise AssertionError(f"{tag} concurrent {i}: HTTP {st}")
            _check_usage(f"{layout} {kv} concurrent {i}", data["usage"],
                         len(tok.encode(f"lane {i} of the legacy scheduler")),
                         32, data["choices"][0]["finish_reason"])
        res["decode_tok_s_b8"] = 8 * 32 / wall

        steps = engine.decode_steps - s0
        launches = _read_counts()
        update = "kv_cache_update" if layout == "slot" else "paged_kv_update"
        if kv != "bf16":
            update += "_quant"
        attn = "ragged_decode_attention" if layout == "slot" \
            else "paged_decode_attention" if kv != "int4" \
            else "paged_mixed_attention"
        expected = {name: cfg.num_layers * steps if name in (update, attn)
                    else 0 for name in launches}
        log(f"{tag} decode dispatches {engine.decode_dispatches - d0}, decode "
            f"steps {steps}, launches {launches}, expected {expected}; 8 "
            f"streams {res['decode_tok_s_b8']:.1f} tok/s aggregate ({wall:.2f}"
            f" s incl. prefill); TTFT of the 1100-token prompt "
            f"{res['ttft_1100_s']} s")
        pipe = engine.pipe_dispatches - p0
        log(f"{tag} of those, pipelined dispatches {pipe} (depth "
            f"{engine._pipe_depth}, occupancy "
            f"{dict(sorted(engine.pipe_occupancy.items()))})")
        if launches != expected or steps == 0:
            raise AssertionError(f"{tag} launch counts != layers x decode "
                                 "steps")
        if engine._pipe_depth and not pipe:
            raise AssertionError(f"{tag} no pipelined dispatch at depth "
                                 f"{engine._pipe_depth}")
        res["launches"] = launches
        if surface:
            res["surface"] = phase_surface(torch, dev, engine,
                                           f"legacy {layout} {kv}", port)[0]
    finally:
        server.stop()
        engine.stop()
    if surface:
        res["step"] = step = phase_surface_step(torch, dev, engine)
        diff = (step["off"][3] - step["argmax"][3]) + \
            (step["argmax"][3] - step["off"][3])
        log(f"{tag} decode step launches: every feature off "
            f"{step['off'][2]:.2f}, the argmax step "
            f"{step['argmax'][2]:.2f}; every feature on {step['on'][2]:.2f}; "
            f"aten ops per dispatch, off {sum(step['off'][3].values())} vs "
            f"the argmax step's {sum(step['argmax'][3].values())}, differing in "
            f"{dict(diff) or 'none'}")
        if diff:
            raise AssertionError(f"{tag} the all-off decode step issues "
                                 "other ops than the argmax step")
    del engine
    torch.cuda.empty_cache()
    return res


def phase_serve_f32(torch, dev):
    """An f32 engine at Qwen2.5-7B width, cut to F32_LAYERS layers (random
    f32 weights from SEED), over a bf16 cache — the reference stores bf16
    whatever the engine dtype.  One greedy request through the server on
    each scheduler: the mixed one (paged pool), the legacy one on the slot
    cache and on the paged pool (ARKS_MIXED_STEP=0).  Each run's counters
    are set to 0 before its request: its update and attention kernels must
    count num_layers x its mixed dispatches or decode steps, the others
    none.  Returns the launch counts of the three runs, summed."""
    import os

    from arks_tpu_torch.engine import EngineConfig, InferenceEngine
    from arks_tpu_torch.engine.tokenizer import ByteTokenizer
    from arks_tpu_torch.models import get_config
    from arks_tpu_torch.models import transformer as tf
    from arks_tpu_torch.server import OpenAIServer

    cfg = dataclasses.replace(get_config(MODEL), num_layers=F32_LAYERS)
    params = tf.init_params(cfg, SEED, torch.float32, dev)
    total = {}
    for sched, layout in (("mixed", "paged"), ("legacy", "slot"),
                          ("legacy", "paged")):
        tag = f"[serve f32 {sched} {layout}]"
        if sched == "legacy":
            os.environ["ARKS_MIXED_STEP"] = "0"
        try:
            engine = InferenceEngine(cfg, EngineConfig(
                model=MODEL, num_slots=8, max_cache_len=SLOT_LEN,
                prefill_chunk=PAGE, dtype="float32", kv_cache_dtype="bf16",
                kv_layout=layout, seed=SEED), ByteTokenizer(), params=params,
                device=dev)
        finally:
            os.environ.pop("ARKS_MIXED_STEP", None)
        if engine._mixed != (sched == "mixed") or \
                engine.cache.k.dtype != torch.bfloat16:
            raise AssertionError(f"{tag}: not an f32 engine over a bf16 "
                                 "cache on that scheduler")
        server = OpenAIServer(engine, MODEL, host="127.0.0.1", port=0)
        server.start(background=True)
        engine.start()
        try:
            _reset_counts()
            d0, s0 = engine.dispatches, engine.decode_steps
            prompt = "An f32 engine reads its bf16 cache widened."
            st, data, _, secs = _request(server.port, "/v1/completions", {
                "prompt": prompt, "max_tokens": 16, "temperature": 0})
            if st != 200:
                raise AssertionError(f"{tag} completion: HTTP {st} {data}")
            _check_usage(f"f32 {sched} {layout} greedy completion",
                         data["usage"], len(engine.tokenizer.encode(prompt)),
                         16, data["choices"][0]["finish_reason"])
            launches = _read_counts()
            if sched == "mixed":
                n = engine.dispatches - d0
                names = ("paged_kv_update", "paged_mixed_attention")
            else:
                n = engine.decode_steps - s0
                names = ("kv_cache_update", "ragged_decode_attention") \
                    if layout == "slot" else ("paged_kv_update",
                                              "paged_decode_attention")
            expected = {k: cfg.num_layers * n if k in names else 0
                        for k in launches}
            log(f"{tag} {cfg.num_layers} layers, cache "
                f"{tuple(engine.cache.k.shape)} {engine.cache.k.dtype}: "
                f"{len(data['choices'][0]['text'])} chars in {secs:.2f} s; "
                f"{n} {'dispatches' if sched == 'mixed' else 'decode steps'}"
                f", launches {launches}, expected {expected}")
            if launches != expected or n == 0:
                raise AssertionError(f"{tag} launch counts != layers x "
                                     "steps")
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
        finally:
            server.stop()
            engine.stop()
        del engine
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# Phase 4, continued: the request surface (penalties, bias, min_tokens,
# logprobs, guides, tools, n, echo)
# ---------------------------------------------------------------------------

SURFACE_TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "Weather of a city",
    "parameters": {"type": "object", "properties": {
        "city": {"type": "string"}}, "required": ["city"]}}},
                 {"type": "function", "function": {"name": "add"}}]
LP_TOL = 2e-3      # a served logprob vs log_softmax of its step's logits


def _engine_run(engine, ids, **kw):
    """One request straight to the running engine: (token ids, the final
    output, logprob entries)."""
    from arks_tpu_torch.engine import Request, SamplingParams
    req = Request(f"surface-{time.perf_counter_ns()}", list(ids),
                  SamplingParams(**kw))
    engine.add_request(req)
    toks, lps = [], []
    while True:
        out = req.outputs.get(timeout=900)
        toks += out.token_ids
        lps += out.logprobs or []
        if out.finished:
            return toks, out, lps


def _walks(guides, guide, toks) -> bool:
    """Whether every prefix of ``toks`` walks ``guide``'s DFA without a
    dead transition (eos into the terminal row included)."""
    g = guides.lookup(*guide)
    row = g.start_row
    for t in toks:
        if guides.trans[row, guides.class_ids[g.guide_id, t]] < 0:
            return False
        row = guides.next_row(row, t)
    return True


class _LogprobSpy:
    """Records, for the one request in flight, log_softmax in f32 of each
    step's logits at the chosen token (the engine thread calls
    ``sampler.top_logprobs`` on every step that serves logprobs)."""

    def __init__(self, torch, engine):
        from arks_tpu_torch.engine import sampler
        self.torch, self.engine, self.sampler = torch, engine, sampler
        self.orig = sampler.top_logprobs
        self.values: list[float] = []

    def __enter__(self):
        def spy(logits, chosen):
            out = self.orig(logits, chosen)
            if logits.shape[0] == 1:
                lane = 0
            else:
                (lane,) = set(self.engine._slots) | set(
                    self.engine._prefilling)
            lp = self.torch.log_softmax(logits[lane].float(), dim=-1)
            self.values.append(lp[int(chosen[lane])].item())
            return out
        self.sampler.top_logprobs = spy
        return self

    def __exit__(self, *exc):
        self.sampler.top_logprobs = self.orig


def phase_surface(torch, dev, engine, tag, port=None):
    """Every request-level feature once on ``engine`` (phase 4's mixed
    bf16 engine, or its legacy bf16 slot-cache engine with its server on
    ``port``), each checked:
      a) logit_bias {T: 100}, greedy: every token is T;
      b) logit_bias {T0: -100} on the plain greedy stream's first token
         T0: the first token is no longer T0;
      c) presence and frequency penalties 2.0, greedy, 32 tokens: no token
         repeats more often than in the plain greedy stream, which it no
         longer equals (both streams carry a +10 bias on one token, so
         that the plain stream repeats: a random-weight model does not);
      d) min_tokens 16 with stop_token_ids [T0]: no stop (and no T0)
         before token 16;
      e) logprobs 5 (completions) and logprobs true, top_logprobs 5 (chat),
         greedy: the chosen logprob is the top-1 (chat: equal to the first
         of its 5; completions, whose top dict merges tokens of one text:
         at least every value), values <= 0 and descending, each chosen
         within LP_TOL of log_softmax in f32 of its step's logits;
      f) guided_choice ["alpha", "beta"]: one of the two, finish "stop";
      g) a JSON-mode guide, 48 tokens: every prefix walks the port's DFA;
      h) a named tool_choice (with a +8 bias on "}", so that a
         random-weight model closes its arguments): the output walks the
         forced guide's DFA, finishes, and parses as that function
         (engine and HTTP: finish "tool_calls");
      i) n 2 with a seed: two choices, usage of both, child seeds seed and
         seed + 1;
      j) echo: the text starts with the prompt.
    The counts are set to 0 before and read after: the update and
    attention kernels of the engine's scheduler count num_layers x its
    dispatches (or decode steps), the others none.  Returns (its launch
    counts, the guide compile seconds)."""
    from arks_tpu_torch.server import OpenAIServer
    from arks_tpu_torch.server import tools

    tok, cfg = engine.tokenizer, engine.cfg
    server = None
    if port is None:
        server = OpenAIServer(engine, MODEL, host="127.0.0.1", port=0)
        server.start(background=True)
        engine.start()
        port = server.port
    checks = {}

    def check(name, ok, detail):
        log(f"[surface {tag}] {name}: {'ok' if ok else 'FAILED'} ({detail})")
        checks[name] = ok

    try:
        _reset_counts()
        d0, s0 = engine.dispatches, engine.decode_steps
        prompt = "The request surface of the port, on the card."
        ids = tok.encode(prompt)
        # a) a +100 bias pins its token.
        t_a = tok.encode("a")[0]
        got, fin, _ = _engine_run(engine, ids, max_tokens=8, temperature=0,
                                  logit_bias=((t_a, 100.0),))
        check("a logit_bias +100", got == [t_a] * 8 and t_a not in
              cfg.eos_token_ids, f"{got}, finish {fin.finish_reason}")
        # c) penalties.  A random-weight model repeats no token in 32
        # greedy steps, so both streams carry the same +10 bias on one
        # token: the plain stream repeats it, the penalties must not.
        p_ids = tok.encode(f"{prompt} Again and again.")
        bias = ((tok.encode("r")[0], 10.0),)
        plain, _, _ = _engine_run(engine, p_ids, max_tokens=32,
                                  temperature=0, ignore_eos=True,
                                  logit_bias=bias)
        pen, _, _ = _engine_run(engine, p_ids, max_tokens=32, temperature=0,
                                ignore_eos=True, logit_bias=bias,
                                presence_penalty=2.0, frequency_penalty=2.0)
        rep_plain = max(plain.count(t) for t in plain)
        rep_pen = max(pen.count(t) for t in pen)
        check("c penalties 2.0", rep_pen <= rep_plain and pen != plain,
              f"most repeats {rep_pen} vs plain {rep_plain} (a +10 bias on "
              f"token {bias[0][0]} in both); "
              f"{sum(a != b for a, b in zip(pen, plain))} of 32 tokens "
              "differ")
        # b) a -100 bias on the plain (unbiased) stream's first token.
        t0 = _engine_run(engine, p_ids, max_tokens=4, temperature=0,
                         ignore_eos=True)[0][0]
        got, _, _ = _engine_run(engine, p_ids, max_tokens=4, temperature=0,
                                ignore_eos=True, logit_bias=((t0, -100.0),))
        check("b logit_bias -100", got[0] != t0,
              f"first token {got[0]}, plain {t0}")
        # d) min_tokens holds the stop id back.
        got, fin, _ = _engine_run(engine, p_ids, max_tokens=24,
                                  temperature=0, min_tokens=16,
                                  stop_token_ids=(t0,))
        check("d min_tokens 16", len(got) >= 16 and t0 not in got[:16],
              f"{len(got)} tokens, finish {fin.finish_reason}, stop id "
              f"{t0} first at {got.index(t0) if t0 in got else None}")
        # e) logprobs, completions and chat.
        for kind, path, body in (
                ("completions", "/v1/completions", {
                    "prompt": prompt, "max_tokens": 8, "temperature": 0,
                    "logprobs": 5}),
                ("chat", "/v1/chat/completions", {
                    "messages": [{"role": "user", "content": prompt}],
                    "max_tokens": 8, "temperature": 0, "logprobs": True,
                    "top_logprobs": 5})):
            with _LogprobSpy(torch, engine) as spy:
                st, data, _, _ = _request(port, path, body)
            lp = data["choices"][0].get("logprobs") if st == 200 else None
            if kind == "chat":
                # Exact: top-5 lists in order, the chosen equal to the first.
                chosen = [e["logprob"] for e in lp["content"]]
                tops = [[t["logprob"] for t in e["top_logprobs"]]
                        for e in lp["content"]]
                top1 = all(c == t[0] and len(t) == 5
                           for c, t in zip(chosen, tops))
            else:
                # A dict by token text: byte-level ids past the byte range
                # decode to shared texts, so entries may merge; the chosen
                # one is at least every listed value.
                chosen = lp["token_logprobs"]
                tops = [sorted(t.values(), reverse=True)
                        for t in lp["top_logprobs"]]
                top1 = all(c >= t[0] for c, t in zip(chosen, tops))
            err = max(abs(a - b) for a, b in zip(chosen, spy.values))
            ok = (len(chosen) == 8 and len(spy.values) >= 8 and top1
                  and all(v <= 0 for t in tops for v in t)
                  and all(c <= 0 for c in chosen)
                  and all(t == sorted(t, reverse=True) for t in tops)
                  and all(len(t) >= 1 for t in tops) and err <= LP_TOL)
            check(f"e logprobs {kind}", ok, f"chosen {chosen[:3]}..., "
                  f"max |served - log_softmax f32| {err:.2e} (limit "
                  f"{LP_TOL}), top-5 of token 0 {tops[0]}")
        # f) guided_choice through the server.
        t_c = time.perf_counter()
        st, data, _, _ = _request(port, "/v1/completions", {
            "prompt": prompt, "max_tokens": 16, "temperature": 0,
            "guided_choice": ["alpha", "beta"]})
        secs = {"choice": time.perf_counter() - t_c}
        ch = data["choices"][0] if st == 200 else {}
        check("f guided_choice", ch.get("text") in ("alpha", "beta")
              and ch.get("finish_reason") == "stop",
              f"HTTP {st}, {ch.get('text')!r}, finish "
              f"{ch.get('finish_reason')}")
        # g) JSON mode, every prefix on the DFA.
        t_c = time.perf_counter()
        got, fin, _ = _engine_run(engine, ids, max_tokens=48,
                                  temperature=0, guide=("json", ""))
        secs["json"] = time.perf_counter() - t_c
        check("g json_object", _walks(engine.guides, ("json", ""), got),
              f"{len(got)} tokens, finish {fin.finish_reason}: "
              f"{tok.decode(got)[:60]!r}")
        # h) a forced (named) tool call.  A random-weight model wanders
        # inside a string argument for ever: a +8 bias on "}" closes the
        # arguments (the guide, applied last, still rules every token).
        msgs = [{"role": "user", "content": "Weather in Paris?"}]
        choice = {"type": "function", "function": {"name": "get_weather"}}
        guide = tools.forced_call_guide(SURFACE_TOOLS, choice)
        close = tok.encode("}")[0]
        t_c = time.perf_counter()
        got, fin, _ = _engine_run(
            engine, tok.apply_chat_template(msgs, tools=SURFACE_TOOLS),
            max_tokens=96, temperature=0, guide=guide,
            logit_bias=((close, 8.0),))
        secs["tool"] = time.perf_counter() - t_c
        calls = tools.parse_tool_calls(tok.decode(got))[1] \
            if fin.finish_reason == "stop" else None
        st, data, _, _ = _request(port, "/v1/chat/completions", {
            "messages": msgs, "tools": SURFACE_TOOLS, "tool_choice": choice,
            "max_tokens": 96, "temperature": 0,
            "logit_bias": {str(close): 8}})
        ch = data["choices"][0] if st == 200 else {}
        served = [c["function"]["name"] for c in
                  ch.get("message", {}).get("tool_calls") or []]
        check("h named tool_choice", _walks(engine.guides, guide, got)
              and calls is not None
              and [c["function"]["name"] for c in calls] == ["get_weather"]
              and st == 200 and ch["finish_reason"] == "tool_calls"
              and served == ["get_weather"],
              f"{len(got)} tokens, finish {fin.finish_reason}, parsed "
              f"{calls and calls[0]['function']}; HTTP {st} finish "
              f"{ch.get('finish_reason')} calls {served}")
        # i) n 2 with a seed: the server's child seeds.
        seeds = []
        add = engine.add_request

        def spy_add(req):
            seeds.append(req.params.seed)
            return add(req)

        engine.add_request = spy_add
        try:
            st, data, _, _ = _request(port, "/v1/completions", {
                "prompt": prompt, "n": 2, "seed": 7, "temperature": 0.9,
                "max_tokens": 12, "ignore_eos": True})
        finally:
            del engine.add_request
        usage = data.get("usage", {})
        check("i n 2 seeded", st == 200 and len(data["choices"]) == 2
              and seeds == [7, 8] and usage.get("completion_tokens") == 24
              and usage.get("prompt_tokens") == 2 * len(ids),
              f"HTTP {st}, child seeds {seeds}, usage {usage}")
        # j) echo.
        st, data, _, _ = _request(port, "/v1/completions", {
            "prompt": prompt, "echo": True, "max_tokens": 6,
            "temperature": 0})
        text = data["choices"][0]["text"] if st == 200 else ""
        check("j echo", text.startswith(prompt) and len(text) > len(prompt),
              f"HTTP {st}, {len(text)} chars")

        launches = _read_counts()
        if engine._mixed:
            n = engine.dispatches - d0
            names = ("paged_kv_update", "paged_mixed_attention")
        else:
            n = engine.decode_steps - s0
            names = ("kv_cache_update", "ragged_decode_attention")
        expected = {k: cfg.num_layers * n if k in names else 0
                    for k in launches}
        log(f"[surface {tag}] {n} {'dispatches' if engine._mixed else 'decode steps'}"
            f", launches {launches}, expected {expected}; guide compile + "
            f"request s: {', '.join(f'{k} {v:.1f}' for k, v in secs.items())}")
        if launches != expected or n == 0:
            raise AssertionError(f"[surface {tag}] launch counts != layers x "
                                 "steps")
    finally:
        if server is not None:
            server.stop()
            engine.stop()
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"[surface {tag}] failed: {failed}")
    return launches, secs


def _profile_step(torch, fn, steps_per_call):
    """(host ms, device µs, kernel launches, aten ops) per step of ``fn``
    (one call = ``steps_per_call`` steps, synchronised): host clock over
    4 calls after 2 warm-ups; device time and launches from profiler
    windows of one call, each opened with a synchronise and a 0.2 s
    pause, the one that saw the most device events of three (the
    profiler's device trace misses events now and then: on the H100 the
    first kernels of a window, a few of 7,300, or ~40% of a 22,000-kernel
    window); the aten ops the host issued (a Counter by name, per call),
    which the host records in full."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / (4 * steps_per_call) * 1e3
    best, ops = (0.0, 0), None
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            time.sleep(0.2)
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        seen = (sum(e.self_device_time_total for e in kernels),
                sum(e.count for e in kernels))
        if seen[1] > best[1]:
            best = seen
        ops = ops or collections.Counter({
            e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU
            and e.key.startswith("aten::")})
    return (wall_ms, best[0] / steps_per_call, best[1] / steps_per_call,
            ops)


def phase_surface_step(torch, dev, engine, lanes=8, ctx=512):
    """One decode step of ``lanes`` lanes at context ``ctx`` through the
    engine's own sampling code, every feature off (plain greedy requests)
    and every feature on for every lane (seeded sampling, presence and
    frequency penalties, a logit_bias, a holding min_tokens, a JSON-mode
    guide, logprobs 5): the legacy engine's ``_decode_loop`` (K decode_steps
    on its slot cache, then the one host copy) or, on the mixed engine,
    phase_step_profile's mixed_step then ``_sample_mixed`` and the host
    copy.  Beside them "argmax": the same step sampled as the profile
    phases sample it (phase_decode_profile's, phase_step_profile's:
    argmax alone), measured the same way.  The engine is stopped; its
    sampling rows are set as admission sets them.  Returns
    {"argmax"|"off"|"on": (host ms, device µs, launches, aten ops) per
    step}."""
    from arks_tpu_torch.engine import Request, SamplingParams, prng
    from arks_tpu_torch.engine import engine as engine_mod
    from arks_tpu_torch.engine import sampler
    from arks_tpu_torch.models import transformer as tf
    cfg = engine.cfg
    guide = ("json", "")
    engine.guides.compile(*guide)
    engine._ensure_guides_uploaded()
    start = engine.guides.lookup(*guide).start_row
    kinds = {
        "off": SamplingParams(max_tokens=64, temperature=0.0),
        "on": SamplingParams(
            max_tokens=64, temperature=0.8, top_p=0.9, top_k=40, seed=3,
            presence_penalty=0.5, frequency_penalty=0.5,
            logit_bias=((99, 1.5), (100, -2.0)), min_tokens=32, logprobs=5,
            guide=guide)}
    i32 = dict(dtype=torch.int32, device=dev)
    slots = list(range(lanes))
    kinds = {"argmax": kinds["off"], **kinds}
    out = {}
    for kind, p in kinds.items():
        keys = prng.fold_in(prng.key_tensor(np.stack(
            [prng.np_prng_key(i) for i in slots]), dev), 1)
        engine._set_slots(slots, [p] * lanes, keys, [ctx] * lanes,
                          [start if p.guide else 0] * lanes)
        engine._slots = {i: engine_mod._Slot(
            request=Request(f"step-{i}", [1], p), num_prompt=ctx)
            for i in slots}
        engine._lengths[:] = ctx
        engine._last_token[:] = 5
        if engine._mixed:
            maxp = ctx // PAGE + 1
            cache = tf.init_paged_cache(cfg, lanes * maxp, PAGE,
                                        torch.bfloat16, dev)
            ar = torch.arange(lanes, **i32)
            args = (torch.arange(lanes * maxp, **i32).reshape(lanes, maxp),
                    torch.full((lanes,), 5, **i32), ar,
                    torch.full((lanes,), ctx, **i32), ar, ar,
                    torch.ones(lanes, **i32), torch.full((lanes,), ctx, **i32))

            def fn(kind=kind):
                logits = tf.mixed_step(engine.params, cfg, cache, *args,
                                       qmax=1,
                                       moe_grouped=engine._moe_grouped)
                if kind == "argmax":
                    return _greedy(sampler, logits).cpu().numpy()
                return engine_mod._to_host(*engine._sample_mixed(
                    logits, slots, []))
            steps = 1
        elif kind == "argmax":
            def fn():
                toks = torch.full((lanes,), 5, **i32)
                lengths = torch.full((lanes,), ctx, **i32)
                out = []
                for _ in range(engine.ecfg.steps_per_dispatch):
                    logits = tf.decode_step(engine.params, cfg, engine.cache,
                                            toks, lengths)
                    toks = _greedy(sampler, logits)
                    out.append(toks)
                    lengths = lengths + 1
                return torch.stack(out).cpu().numpy()
            steps = engine.ecfg.steps_per_dispatch
        else:
            def fn():
                ids, lp = engine._decode_loop(
                    torch.full((lanes,), 5, **i32),
                    torch.full((lanes,), ctx, **i32), None, [p] * lanes)
                return engine_mod._to_host(ids, lp)
            steps = engine.ecfg.steps_per_dispatch
        try:
            out[kind] = _profile_step(torch, fn, steps)
        finally:
            engine._slots = {}
            engine._sampling = sampler.clear_slot_penalties(engine._sampling,
                                                            slots)
        if engine._mixed:
            del cache
    sched = "mixed" if engine._mixed else "legacy slot"
    for kind, (wall, dev_us, launches, _) in out.items():
        what = ("the profile phases' step (argmax only)" if kind == "argmax"
                else f"every feature {kind}")
        log(f"[surface step] {sched}, {lanes} lanes at context {ctx}, {what}"
            f": {wall:.2f} ms host clock per step, device "
            + (f"{dev_us:.1f} us, {launches:.2f} kernel launches per step"
               if dev_us else "time not measured"))
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The steady-state engine shape: pipelined dispatch, sampler fusion
# ---------------------------------------------------------------------------


PIPE_TOKENS = 64           # greedy tokens per stream, 8-stream runs
PIPE_TOKENS_B1 = 32        # greedy tokens of the one-stream run
PIPE_WINDOW = 16           # decode steps per timed / traced window
# (tag, ARKS_PIPELINE_DEPTH, ARKS_SAMPLER_FUSE); fusion applies to mixed
# engines only, so the legacy engine runs the first, third and fourth.
PIPE_CONFIGS = (("depth 0, fusion off", "0", "0"),
                ("depth 0, fusion on", "0", "1"),
                ("depth 1", "1", "1"), ("depth 2", "2", "1"))


def _pipe_engine(torch, dev, params, sched, depth, fuse):
    """A Qwen2.5-7B engine on ``params`` (bf16, 8 slots x 4096, chunk 256):
    the mixed scheduler on a bf16 pool or the legacy one on the bf16 slot
    cache, at pipeline depth ``depth`` with fusion ``fuse``."""
    import os

    from arks_tpu_torch.engine import EngineConfig, InferenceEngine
    from arks_tpu_torch.engine.tokenizer import ByteTokenizer
    from arks_tpu_torch.models import get_config
    old = {k: os.environ.get(k) for k in ("ARKS_PIPELINE_DEPTH",
                                          "ARKS_SAMPLER_FUSE")}
    os.environ.update(ARKS_PIPELINE_DEPTH=depth, ARKS_SAMPLER_FUSE=fuse)
    try:
        engine = InferenceEngine(get_config(MODEL), EngineConfig(
            model=MODEL, num_slots=8, max_cache_len=MAX_PAGES * PAGE,
            prefill_chunk=PAGE, dtype="bfloat16", kv_cache_dtype="bf16",
            kv_layout="paged" if sched == "mixed" else "slot", seed=SEED),
            ByteTokenizer(), params=params, device=dev)
    finally:
        _restore_env(os, old)
    if engine._mixed != (sched == "mixed"):
        raise AssertionError(f"[pipeline {sched}] wrong scheduler")
    return engine


def _restore_env(os, old: dict) -> None:
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


class _NoSync:
    """Wraps the engine's issue paths ``names`` (by default
    ``_pipe_issue``) in torch.cuda.set_sync_debug_mode("error"): any host
    sync while one runs raises (and fails the phase); counts the calls it
    watched, in all (``issues``) and by name (``calls``)."""

    def __init__(self, torch, engine, names=("_pipe_issue",)):
        self.torch, self.engine, self.names = torch, engine, names
        self.issues = 0
        self.calls = collections.Counter()

    def _wrap(self, name):
        orig = getattr(self.engine, name)

        def checked(*args, **kw):
            cuda = self.torch.cuda
            prev = cuda.get_sync_debug_mode()
            cuda.set_sync_debug_mode("error")
            try:
                return orig(*args, **kw)
            finally:
                cuda.set_sync_debug_mode(prev)
                self.issues += 1
                self.calls[name] += 1
        return checked

    def __enter__(self):
        for name in self.names:
            setattr(self.engine, name, self._wrap(name))
        return self

    def __exit__(self, *exc):
        # Drop the instance attributes (the class's methods show again):
        # assigning the bound methods back would make a reference cycle
        # that keeps the engine, and its cache, alive until a GC pass.
        for name in self.names:
            delattr(self.engine, name)


def _pipe_batch(torch, engine, prompts, max_tokens, window=False,
                window_steps=None):
    """One greedy request per prompt, added together and driven by
    ``engine.step()`` from this thread until the engine is idle.  Returns
    (streams, decode seconds: from the step at which the last stream got
    its first token to the end, and with ``window``, once every stream
    has decoded 4 scheduler steps: (host ms per scheduler step over
    synchronised steps covering PIPE_WINDOW decode steps, or
    ``window_steps`` scheduler steps, then device µs and kernel launches
    per scheduler step from torch.profiler over the next as many, and
    those launches by kernel name))."""
    import queue

    from torch.profiler import ProfilerActivity, profile

    from arks_tpu_torch.engine import Request, SamplingParams
    tok = engine.tokenizer
    reqs = [Request(f"pipe-{i}-{time.perf_counter_ns()}", tok.encode(p),
                    SamplingParams(max_tokens=max_tokens, temperature=0,
                                   ignore_eos=True))
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.add_request(r)
    streams = {r.request_id: [] for r in reqs}
    fins, t_first, since, win = {}, None, 0, None

    def drain():
        for r in reqs:
            while True:
                try:
                    o = r.outputs.get_nowait()
                except queue.Empty:
                    break
                streams[r.request_id] += o.token_ids
                if o.finished:
                    fins[r.request_id] = o.finish_reason

    for _ in range(100_000):
        engine.step(block_s=0.001)
        drain()
        if t_first is None and all(streams.values()):
            t_first = time.perf_counter()
        if t_first is not None:
            since += 1
        if window and win is None and since == 4:
            steps = window_steps or PIPE_WINDOW // engine._pipe_rows
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                engine.step(block_s=0.001)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) / steps * 1e3
            # Device activity only: the host's ~17,000 aten ops a step
            # would take the profiler longer to record than the window.
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(steps):
                    engine.step(block_s=0.001)
                torch.cuda.synchronize()
            kernels = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            win = (host_ms, sum(e.self_device_time_total for e in kernels)
                   / steps, sum(e.count for e in kernels) / steps,
                   collections.Counter({e.key: e.count for e in kernels}))
            drain()
        if engine.idle and len(fins) == len(reqs):
            break
    secs = time.perf_counter() - t_first
    bad = {k: (len(v), fins.get(k)) for k, v in streams.items()
           if len(v) != max_tokens or fins.get(k) != "length"}
    if bad:
        raise AssertionError(f"[pipeline] streams cut short: {bad}")
    return [streams[r.request_id] for r in reqs], secs, win


def phase_pipeline(torch, dev, params):
    """The reference's default engine shape on Qwen2.5-7B at full width
    (``params``: phase 4's bf16 weights), on the mixed scheduler (bf16
    pool) and the legacy one (bf16 slot cache), at each of PIPE_CONFIGS:
    a warm-up request, then one greedy stream of PIPE_TOKENS_B1 tokens
    and 8 greedy streams of PIPE_TOKENS admitted together (prompts of 22
    bytes, so all 8 complete their prefill in one step and every slot is
    live in steady state), then the same 8 again, traced in steady
    state.
    Checks: every run's streams equal the first configuration's; the
    8-stream run's update and attention kernels count num_layers x its
    dispatches (decode steps on the legacy engine), the others none; the
    pipelined runs issued pipe dispatches (the fused run only fused ones)
    with occupancy at most the depth, each issue under
    torch.cuda.set_sync_debug_mode("error") (no hidden host sync).
    Reports decode tok/s at 1 and 8 streams, host ms per token, the
    device busy share and kernel launches per scheduler step over
    PIPE_WINDOW steady decode steps, and the phase's seconds.  Returns
    {"launches": summed counts, "rows": {(sched, tag): numbers}}."""
    t_phase = time.perf_counter()
    prompts = [f"lane {i} of the pipeline" for i in range(8)]
    total = collections.Counter()
    rows = {}
    for sched in ("mixed", "legacy"):
        base = None
        for tag, depth, fuse in PIPE_CONFIGS:
            if sched == "legacy" and tag == "depth 0, fusion on":
                continue
            name = f"[pipeline {sched} {tag}]"
            engine = _pipe_engine(torch, dev, params, sched, depth, fuse)
            cfg = engine.cfg
            _pipe_batch(torch, engine, ["warm up"], 8)
            one, secs1, _ = _pipe_batch(torch, engine, prompts[:1],
                                        PIPE_TOKENS_B1)
            _reset_counts()
            d0, s0, p0, f0 = (engine.dispatches, engine.decode_steps,
                              engine.pipe_dispatches,
                              engine.sampler_fused_dispatches)
            with _NoSync(torch, engine) as nosync:
                eight, secs8, _ = _pipe_batch(torch, engine, prompts,
                                              PIPE_TOKENS)
            launches = _read_counts()
            n = (engine.dispatches - d0 if sched == "mixed"
                 else engine.decode_steps - s0)
            pipe = engine.pipe_dispatches - p0
            fused = engine.sampler_fused_dispatches - f0
            update, attn = (("paged_kv_update", "paged_mixed_attention")
                            if sched == "mixed" else
                            ("kv_cache_update", "ragged_decode_attention"))
            expected = {k: cfg.num_layers * n if k in (update, attn) else 0
                        for k in launches}
            traced, _, win = _pipe_batch(torch, engine, prompts,
                                         PIPE_TOKENS, window=True)
            streams = one + eight
            base = base or streams
            per_tok, per_tok1 = PIPE_TOKENS - 1, PIPE_TOKENS_B1 - 1
            host_ms, dev_us, kern, _ = win
            row = dict(tok_s_b1=per_tok1 / secs1,
                       tok_s_b8=8 * per_tok / secs8,
                       ms_per_tok_b1=secs1 / per_tok1 * 1e3,
                       ms_per_tok_b8=secs8 / per_tok * 1e3,
                       step_host_ms=host_ms, step_device_ms=dev_us / 1e3,
                       busy=dev_us / 1e3 / host_ms if dev_us else None,
                       launches_per_step=kern, pipe=pipe, fused=fused,
                       occupancy=dict(sorted(engine.pipe_occupancy.items())),
                       resolve_wait_s=engine.decode_resolve_wait_s)
            rows[(sched, tag)] = row
            log(f"{name} decode {row['tok_s_b1']:.1f} tok/s at 1 stream "
                f"({row['ms_per_tok_b1']:.2f} ms/token), "
                f"{row['tok_s_b8']:.1f} tok/s aggregate at 8 "
                f"({row['ms_per_tok_b8']:.2f} ms/token per stream); steady "
                f"step (8 live slots, {engine._pipe_rows} token(s) each): "
                f"host {host_ms:.2f} ms, device "
                + (f"{dev_us / 1e3:.2f} ms, busy share {row['busy']:.3f}, "
                   f"{kern:.1f} launches" if dev_us else "not measured")
                + f"; pipe dispatches {pipe} (fused {fused}), occupancy "
                f"{row['occupancy']}, sync-checked issues {nosync.issues}, "
                f"resolve wait {row['resolve_wait_s']:.3f} s; launches "
                f"{launches}, expected {expected}")
            same = traced == eight
            ok = (streams == base and same
                  and launches == expected and n > 0
                  and nosync.issues >= pipe
                  and (pipe > 0) == (depth != "0" or (
                      fuse == "1" and sched == "mixed"))
                  and fused == (pipe if depth == "0" else 0)
                  and max(engine.pipe_occupancy, default=0) <= max(
                      int(depth), 1))
            if not ok:
                raise AssertionError(
                    f"{name} streams equal {streams == base}, traced "
                    f"{same}, launches {launches == expected}")
            total.update(launches)
            del engine
            torch.cuda.empty_cache()
        log(f"[pipeline {sched}] streams equal across "
            f"{len(PIPE_CONFIGS) - (sched == 'legacy')} configurations")
    log(f"[pipeline] phase took {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=dict(total), rows=rows)


def phase_pipe_step_profile(torch, dev, engine):
    """The pipe step (``mixed_pipe``: B = 8 lanes, an MoE model's dispatch
    by its rule on 8 tokens) beside the sequential mixed step (the
    engine's fixed dispatch) on the same 8 lanes at context 512, greedy,
    in one call: (host ms, device ms, launches) per step of each, from
    ``_profile_step``."""
    from arks_tpu_torch.engine import engine as engine_mod
    from arks_tpu_torch.engine import sampler
    from arks_tpu_torch.models import moe
    from arks_tpu_torch.models import transformer as tf
    cfg, lanes, ctx = engine.cfg, 8, 512
    maxp = ctx // PAGE + 1
    cache = tf.init_paged_cache(cfg, lanes * maxp, PAGE, torch.bfloat16, dev)
    i32 = dict(dtype=torch.int32, device=dev)
    ar = torch.arange(lanes, **i32)
    tables = torch.arange(lanes * maxp, **i32).reshape(lanes, maxp)
    tokens = torch.full((lanes,), 5, **i32)
    lengths = torch.full((lanes,), ctx, **i32)
    alive = torch.ones(lanes, dtype=torch.bool, device=dev)
    stop = torch.full((lanes, sampler.STOP_IDS_MAX), -1, **i32)
    dead = torch.full((lanes,), 4096, **i32)
    state = sampler.init_sampling_state(lanes, SEED, cfg.vocab_size, dev)

    def seq():
        logits = tf.mixed_step(engine.params, cfg, cache, tables, tokens, ar,
                               lengths, ar, ar, torch.ones(lanes, **i32),
                               lengths, qmax=1,
                               moe_grouped=engine._moe_grouped)
        return _greedy(sampler, logits).cpu()

    def pipe():
        out = engine_mod.mixed_pipe(
            engine.params, cfg, cache, tokens, lengths, alive, stop, dead,
            state, tables, None, sampler.OFF, False, 4096)
        return out[0].cpu()

    res = {}
    for name, fn in (("sequential", seq), ("pipe", pipe)):
        wall, dev_us, kern, _ = _profile_step(torch, fn, 1)
        res[name] = (wall, dev_us / 1e3, kern)
    log(f"[pipe step] {engine.ecfg.model} {engine.ecfg.weight_dtype} "
        f"weights, 8 lanes at context {ctx}: sequential mixed step (MoE "
        f"grouped {engine._moe_grouped}) host {res['sequential'][0]:.2f} ms,"
        f" device {res['sequential'][1]:.2f} ms, "
        f"{res['sequential'][2]:.0f} launches; pipe step (MoE grouped "
        f"{moe.use_grouped(lanes)}) host {res['pipe'][0]:.2f} ms, device "
        f"{res['pipe'][1]:.2f} ms, {res['pipe'][2]:.0f} launches")
    del cache
    torch.cuda.empty_cache()
    return res


def phase_pipeline_moe(torch, dev, params):
    """One short batch on Mixtral-8x7B (``params``: phase 7's int8
    weights) at pipeline depth 2: 8 greedy streams of 16 tokens admitted
    together, every pipelined issue under
    torch.cuda.set_sync_debug_mode("error"); its steady steps run the pipe
    step, whose MoE FFN takes the dense route (8 tokens, the reference's
    rule) through the grouped matmul.  Then that pipe step beside the
    sequential mixed step on the same lanes (``phase_pipe_step_profile``).
    Returns the numbers."""
    engine, _ = _moe_engine(torch, dev, "int8", params=params)
    tag = f"[pipeline {MOE_MODEL} int8]"
    prompts = [f"expert lane {i} of 8" for i in range(8)]
    _pipe_batch(torch, engine, prompts[:1], 4)
    _reset_counts()
    p0, d0 = engine.pipe_dispatches, engine.dispatches
    with _NoSync(torch, engine) as nosync:
        _, secs, _ = _pipe_batch(torch, engine, prompts, 16)
    pipe, n = engine.pipe_dispatches - p0, engine.dispatches - d0
    launches = _read_counts()
    # The pipe steps' dense route launches as many as the grouped steps.
    want = {"paged_kv_update": engine.cfg.num_layers * n,
            "paged_mixed_attention": engine.cfg.num_layers * n,
            "grouped_matmul": _gm_per_layer(engine, True)
            * engine.cfg.num_layers * n}
    got = {k: launches[k] for k in want}
    res = dict(tok_s_b8=8 * 15 / secs, pipe=pipe, dispatches=n,
               occupancy=dict(sorted(engine.pipe_occupancy.items())))
    log(f"{tag} 8 greedy streams of 16 tokens at depth 2: {res['tok_s_b8']:.1f}"
        f" tok/s decode; {n} mixed dispatches, {pipe} pipelined (occupancy "
        f"{res['occupancy']}), sync-checked issues {nosync.issues}; "
        f"launches {got}, expected {want}")
    if not pipe or got != want or nosync.issues < pipe:
        raise AssertionError(f"{tag} pipelined dispatches or launch counts")
    res["step"] = phase_pipe_step_profile(torch, dev, engine)
    del engine
    torch.cuda.empty_cache()
    return res


def _gm_per_layer(engine, grouped):
    """grouped_matmul launches per layer of one forward: every quantized
    product (q, k, v, o, the FFN's three, a shared expert's three) takes
    qeinsum's grouped route, whichever MoE dispatch runs; with unquantized
    weights only an MoE FFN's grouped dispatch launches it.  Every
    dispatch of a served engine is counted the same (``_moe_grouped``
    decides the sequential mixed step; the pipe step's dense route
    launches as many)."""
    cfg = engine.cfg
    if engine.ecfg.weight_dtype == "bf16":
        return 3 if cfg.num_experts and grouped else 0
    return 7 + (3 if cfg.shared_expert_intermediate_size else 0)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# Phase 5: one mixed_step, kernels vs plain
# ---------------------------------------------------------------------------


def phase_parity(torch, dev, engine):
    """Two mixed steps (a 300-token chunk crossing a page + a short chunk,
    then a decode lane, the rest of that chunk and a new one) through the
    kernels and through impl="plain", in bf16 on the engine's weights and in
    f32 on an f32 copy of them, over a bf16/f32, an int8 and an int4 pool.
    All: the same argmax wherever the top-2 margin exceeds the tolerance.

    f32 is the tight check: within 5e-4 absolute (6.6e-5 measured on an H100).  bf16
    is a loose one: within 10% of the largest |logit|.  The kernel rounds p
    to bf16 before normalising, as the reference kernel does; the oracle
    rounds the normalised probabilities; 28 random layers amplify the
    difference.  At 5% one H100 run passed with 0.297 against a limit of
    0.308, so the limit is 10%; at that width no lane's top-2 margin exceeds
    it, and the argmax clause holds only in f32.

    With a quantized pool each path quantizes the K/V rows it writes (and
    the oracle folds the v scale after normalising, the kernel before: a
    by-design difference, ROADMAP queue 3).  Over the first layer both
    paths quantize identical rows, so the limits above hold (H100: f32
    about 1e-5).  From the second layer on the rows differ by the rounding
    of the first layer's attention, a value on a rounding edge lands one
    quantization step apart on the two paths, and random layers amplify
    that: over 28 layers, f32 1.3e-2 to 2.1e-2 with int8 and 6.8e-2 to
    9.9e-2 with int4, and bf16 int4 up to 16% of the largest |logit|
    (readings on an H100 80GB HBM3 at 700 W).  So the quantized pools are
    held to the limits over the first layer, and over all layers read with
    the argmax clause at a 10% margin."""
    from arks_tpu_torch.models import transformer as tf
    cfg = engine.cfg
    one = dataclasses.replace(cfg, num_layers=1)
    worst = {}
    for dtype, rel, abs_tol in ((torch.bfloat16, 0.10, 0.0),
                                (torch.float32, 0.0, 5e-4)):
        params = engine.params if dtype == torch.bfloat16 else {
            k: ({n: w.float() for n, w in v.items()} if isinstance(v, dict)
                else v.float()) for k, v in engine.params.items()}
        first = {k: ({n: w[:1] for n, w in v.items()} if isinstance(v, dict)
                     else v) for k, v in params.items()}
        name = str(dtype).split(".")[1]
        worst[f"{name} unquantized"] = _parity_steps(
            torch, dev, tf, cfg, params, dtype, rel, abs_tol, None)
        for kv in KV_BITS:
            worst[f"{name} {kv} 1 layer"] = _parity_steps(
                torch, dev, tf, one, first, dtype, rel, abs_tol, kv)
            worst[f"{name} {kv} {cfg.num_layers} layers, read"] = \
                _parity_steps(torch, dev, tf, cfg, params, dtype, 0.10, 0.0,
                              kv, limit=False)
        for layout, kv, c, p in (("slot", None, cfg, params),
                                 ("slot", "int8", one, first),
                                 ("paged", None, cfg, params)):
            worst[f"decode_step {layout} {name} {kv or 'unquantized'} "
                  f"{c.num_layers} layer(s)"] = _decode_parity(
                torch, dev, tf, c, p, dtype, rel, abs_tol, layout, kv)
        del params, first
        torch.cuda.empty_cache()
    return worst


def _parity_steps(torch, dev, tf, cfg, params, dtype, rel, abs_tol, kv,
                  limit=True, moe_grouped=None):
    maxp, n_pages = 3, 9
    tables = torch.arange(n_pages, dtype=torch.int32,
                          device=dev).reshape(3, maxp)
    rng = np.random.default_rng(SEED + 5)
    p0 = rng.integers(2, cfg.vocab_size, 300)     # crosses a page
    p1 = rng.integers(2, cfg.vocab_size, 40)

    def batch(lanes):
        tokens, slot, pos = [], [], []
        qs, ql, ps, src = (np.zeros(3, np.int32) for _ in range(4))
        for lane, ids, start in lanes:
            qs[lane], ql[lane], ps[lane] = len(tokens), len(ids), start
            tokens += [int(x) for x in ids]
            slot += [lane] * len(ids)
            pos += range(start, start + len(ids))
            src[lane] = len(tokens) - 1
        tokens += [0, 0]
        slot += [-1, -1]
        pos += [maxp * PAGE] * 2
        arrs = (tokens, slot, pos, src, qs, ql, ps)
        return [torch.as_tensor(np.asarray(a, np.int32), device=dev)
                for a in arrs]

    steps = [batch([(0, p0, 0), (1, p1[:24], 0)]),
             batch([(0, [11], 300), (1, p1[24:], 24), (2, p1[:7], 0)])]
    caches = {impl: tf.init_paged_cache(
        cfg, n_pages, PAGE, dtype, dev, quantized=kv is not None,
        kv_bits=KV_BITS.get(kv, 8)) for impl in ("kernel", "plain")}
    worst = 0.0
    for i, args in enumerate(steps):
        routes = {}
        logits = {}
        for impl in ("kernel", "plain"):
            with _recorded_routing(routes.setdefault(impl, [])):
                logits[impl] = tf.mixed_step(params, cfg, caches[impl],
                                             tables, *args, impl=impl,
                                             moe_grouped=moe_grouped)
        k, p = logits["kernel"], logits["plain"]
        tol = rel * p.abs().max().item() + abs_tol
        clean = _same_routing(torch, routes, args[3])
        err = (k - p)[clean].abs().max().item() if clean.any() else 0.0
        top2 = p.topk(2, dim=-1).values
        wide = ((top2[:, 0] - top2[:, 1]) > tol) & clean
        agree = bool((k.argmax(-1) == p.argmax(-1))[wide].all().item())
        finite = bool(torch.isfinite(k).all().item())
        if routes["kernel"]:
            log(f"[parity] step {i} MoE routing: {_flips(torch, routes)} "
                f"(token, layer) pairs routed to other experts on the two "
                f"paths; "
                f"lanes whose sampled token was routed alike in every layer "
                f"(held below): {clean.nonzero().flatten().tolist()} of 3")
            if not clean.any():
                raise AssertionError("no lane was routed alike on both paths")
        wq = params["layers"]["wq"]
        weights = (", int4 weights" if "gs" in wq else ", int8 weights") \
            if isinstance(wq, dict) else ""
        log(f"[parity] {dtype} {kv or 'unquantized'} pool{weights}, "
            f"{cfg.num_layers} layer(s), step {i}: max |logit diff| "
            f"{err:.3e} ({'limit' if limit else 'argmax margin'} "
            f"{tol:.3e}; max |logit| {p.abs().max().item():.3f}), argmax "
            f"agrees on the {int(wide.sum())} of 3 lanes with margin > tol: "
            f"{agree}; finite {finite}")
        if not ((err <= tol or not limit) and agree and finite):
            raise AssertionError("mixed_step through the kernels disagrees "
                                 "with the plain path")
        worst = max(worst, err)
    return worst


class _recorded_routing:
    """Within the block, every MoE routing decision (``router_topk``'s
    expert ids, one [T, k] tensor per layer) is appended to ``into``."""

    def __init__(self, into):
        self.into = into

    def __enter__(self):
        from arks_tpu_torch.models import moe
        self.real = moe.router_topk

        def record(logits, cfg):
            vals, idx = self.real(logits, cfg)
            self.into.append(idx.sort(dim=-1).values)
            return vals, idx
        moe.router_topk = record

    def __exit__(self, *exc):
        from arks_tpu_torch.models import moe
        moe.router_topk = self.real


def _flips(torch, routes):
    return sum(int((a != b).any(dim=-1).sum().item())
               for a, b in zip(routes["kernel"], routes["plain"]))


def _same_routing(torch, routes, sample_src):
    """[lanes] bool: the lane's sampled token took the same top-k experts
    on both paths in every layer.  Top-k routing is discontinuous: where
    two experts' router probabilities nearly tie, the paths' last-bit
    differences (bf16 rounding of the attention, the sums' order) can pick
    another expert, which changes that token's output by a whole expert's
    contribution — a property of the model, not an error of a kernel, so
    the limit holds the lanes routed alike.  Dense models: every lane."""
    clean = torch.ones(sample_src.shape[0], dtype=torch.bool,
                       device=sample_src.device)
    for a, b in zip(routes["kernel"], routes["plain"]):
        clean &= (a == b).all(dim=-1)[sample_src.long()]
    return clean


def _decode_parity(torch, dev, tf, cfg, params, dtype, rel, abs_tol, layout,
                   kv):
    """Three decode_steps through the kernels and through impl="plain"
    after prefilled prompts of 300 and 40 tokens (slots 0 and 1; slot 2
    parked), on the slot cache (1024 rows) or a paged pool (page 256):
    logits of the live slots within the tolerance, the same argmax wherever
    the top-2 margin exceeds it.  Returns the worst |logit diff|."""
    rng = np.random.default_rng(SEED + 6)
    tokens = np.zeros((2, 320), np.int32)
    tokens[0, :300] = rng.integers(2, cfg.vocab_size, 300)
    tokens[1, :40] = rng.integers(2, cfg.vocab_size, 40)
    i32 = dict(dtype=torch.int32, device=dev)
    logits0, ks, vs = tf.prefill(params, cfg, torch.as_tensor(tokens,
                                                              device=dev),
                                 torch.tensor([300, 40], **i32))
    quant = kv is not None
    caches, tables = {}, None
    for impl in ("kernel", "plain"):
        if layout == "slot":
            c = tf.init_cache(cfg, 3, 1024, dtype, dev, quantized=quant)
            tf.insert_batch(c, ks, vs, [0, 1])
            sentinel = 1024
        else:
            c = tf.init_paged_cache(cfg, 12, PAGE, dtype, dev,
                                    quantized=quant)
            tables = torch.arange(12, **i32).reshape(3, 4)
            tf.insert_pages_batch(c, ks, vs, tables[:2, :2], [2, 1])
            sentinel = 4 * PAGE
        caches[impl] = c
    del ks, vs
    toks = torch.cat([logits0.argmax(-1).to(torch.int32),
                      torch.zeros(1, **i32)])
    lengths = torch.tensor([300, 40, sentinel], **i32)
    worst = 0.0
    for i in range(3):
        out = {impl: tf.decode_step(params, cfg, caches[impl], toks, lengths,
                                    tables, impl=impl)
               for impl in ("kernel", "plain")}
        k, p = out["kernel"][:2], out["plain"][:2]
        tol = rel * p.abs().max().item() + abs_tol
        err = (k - p).abs().max().item()
        top2 = p.topk(2, dim=-1).values
        wide = (top2[:, 0] - top2[:, 1]) > tol
        agree = bool((k.argmax(-1) == p.argmax(-1))[wide].all().item())
        finite = bool(torch.isfinite(k).all().item())
        log(f"[parity] decode_step {layout} {dtype} {kv or 'unquantized'}, "
            f"{cfg.num_layers} layer(s), step {i}: max |logit diff| "
            f"{err:.3e} (limit {tol:.3e}), argmax agrees on the "
            f"{int(wide.sum())} of 2 live slots with margin > tol: {agree}; "
            f"finite {finite}")
        if not (err <= tol and agree and finite):
            raise AssertionError("decode_step through the kernels disagrees "
                                 "with the plain path")
        worst = max(worst, err)
        toks = out["plain"].argmax(-1).to(torch.int32)
        lengths = lengths + torch.tensor([1, 1, 0], **i32)
    return worst


def _greedy(sampler, logits):
    """Greedy ids through a tree's sampler: its all-off gate (state unread),
    or, in trees older than the request surface, its
    (logits, temperature, top_p, top_k) form."""
    if hasattr(sampler, "OFF"):
        return sampler.sample(logits, None, gates=sampler.OFF)[0]
    return sampler.sample(logits, None, None, None)[0]


def phase_decode_profile(torch, dev, engine, kv="bf16"):
    """Where a legacy decode dispatch's time goes: K = 4 decode_steps, each
    sampling greedily, over 8 slots at context 512 of a bf16 (or, with
    ``kv="int8"``, int8) slot cache, on the engine's weights: host time
    per step (synchronised) and the device's kernel time from
    torch.profiler, as phase_step_profile reads the mixed step.  Returns
    (host ms per step, device ms per step or None, {kernel: us per step}
    for the slot write and the decode attention, kernel launches per
    step)."""
    from torch.profiler import ProfilerActivity, profile

    from arks_tpu_torch.engine import sampler
    from arks_tpu_torch.models import transformer as tf
    cfg, lanes, ctx, k_steps = engine.cfg, 8, 512, 4
    cache = tf.init_cache(cfg, lanes, 1024, torch.bfloat16, dev,
                          quantized=kv == "int8")
    i32 = dict(dtype=torch.int32, device=dev)

    def dispatch():
        toks = torch.full((lanes,), 5, **i32)
        lengths = torch.full((lanes,), ctx, **i32)
        out = []
        for _ in range(k_steps):
            logits = tf.decode_step(engine.params, cfg, cache, toks, lengths)
            toks = _greedy(sampler, logits)
            out.append(toks)
            lengths = lengths + 1
        return torch.stack(out).cpu()

    for _ in range(2):
        dispatch()
    torch.cuda.synchronize()
    n = 4
    t0 = time.perf_counter()
    for _ in range(n):
        dispatch()
    wall_ms = (time.perf_counter() - t0) / (n * k_steps) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dispatch()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels) / k_steps
    launches = sum(e.count for e in kernels) / k_steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    legacy = [e for e in kernels if "kv_cache_update" in e.key
              or "decode_attention" in e.key]
    top += [e for e in legacy if e not in top]
    log(f"[profile] legacy decode dispatch, {kv} slot cache, {lanes} slots at "
        f"context {ctx}, K={k_steps}: {wall_ms:.2f} ms host clock per step "
        f"({lanes / wall_ms * 1e3:.1f} tok/s), device kernel time "
        + (f"{dev_us / 1e3:.2f} ms/step, busy share "
           f"{dev_us / 1e3 / wall_ms:.3f}, {launches:.0f} kernel launches "
           "per step" if dev_us else "not measured"))
    for e in top:
        log(f"[profile]   {e.key[:60]:60s} "
            f"{e.self_device_time_total / k_steps:9.1f} us/step "
            f"x{e.count // k_steps}")
    del cache
    torch.cuda.empty_cache()
    return (wall_ms, dev_us / 1e3 if dev_us else None,
            {e.key: e.self_device_time_total / k_steps for e in legacy},
            launches)


def phase_step_profile(torch, dev, engine, kv=None):
    """Where a decode step's time goes: one mixed_step + greedy sample over
    8 decode lanes at context 512 on the engine's weights and a bf16 (or
    ``kv``) pool, timed on the host clock (synchronised) and traced with
    torch.profiler for the device's kernel time.  Device busy share =
    summed device kernel time / wall."""
    from torch.profiler import ProfilerActivity, profile

    from arks_tpu_torch.engine import sampler
    from arks_tpu_torch.models import transformer as tf
    cfg, lanes, ctx = engine.cfg, 8, 512
    maxp = ctx // PAGE + 1
    cache = tf.init_paged_cache(cfg, lanes * maxp, PAGE, torch.bfloat16, dev,
                                quantized=kv is not None,
                                kv_bits=KV_BITS.get(kv, 8))
    i32 = dict(dtype=torch.int32, device=dev)
    ar = torch.arange(lanes, **i32)
    args = (torch.arange(lanes * maxp, **i32).reshape(lanes, maxp),
            torch.full((lanes,), 5, **i32), ar, torch.full((lanes,), ctx, **i32),
            ar, ar, torch.ones(lanes, **i32), torch.full((lanes,), ctx, **i32))

    def step():
        logits = tf.mixed_step(engine.params, cfg, cache, *args, qmax=1,
                               moe_grouped=engine._moe_grouped)
        return _greedy(sampler, logits).cpu()

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    n = 10
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
    # Device-side events only (CPU ops also carry their kernels' time).
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels) / 3
    launches = sum(e.count for e in kernels) / 3
    weight_bytes = sum(x.numel() * x.element_size()
                       for x in _leaves(engine.params))
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    top += [e for e in kernels if e not in top and (
        "paged_kv_update" in e.key or "mixed_attention" in e.key
        or "grouped_matmul" in e.key)]
    grouped_us = sum(e.self_device_time_total for e in kernels
                     if "grouped_matmul" in e.key) / 3
    log(f"[profile] {engine.ecfg.model} "
        f"{engine.ecfg.weight_dtype} weights, decode step, {kv or 'bf16'} "
        f"pool, {lanes} lanes at context {ctx}: "
        f"{wall_ms:.2f} ms host clock ({lanes / wall_ms * 1e3:.1f} tok/s), "
        f"device kernel time "
        + (f"{dev_us / 1e3:.2f} ms/step, busy share "
           f"{dev_us / 1e3 / wall_ms:.3f}, {launches:.0f} kernel launches "
           "per step" if dev_us else "not measured")
        + f"; weight-read bound {bound_ms:.2f} ms ({weight_bytes} B)")
    for e in top:
        log(f"[profile]   {e.key[:60]:60s} {e.self_device_time_total / 3:9.1f}"
            f" us/step x{e.count // 3}")
    if cfg.num_experts:
        log(f"[profile]   grouped_matmul (all launches) {grouped_us:.1f} "
            "us/step")
    return wall_ms, dev_us / 1e3 if dev_us else None, launches


# ---------------------------------------------------------------------------
# Phase 6: kernel times
# ---------------------------------------------------------------------------


SPIN_CYCLES = 200_000    # ~100 us of GPU clock at the H100's 1.98 GHz


def _time_ms(torch, fn, iters=20, warmup=3):
    """Mean CUDA-event time of fn() over ``iters`` launches, with a 256 MiB
    write before each so L2 (50 MB) holds none of its inputs — the served
    path streams 15 GB of weights between two calls of a kernel.  A GPU
    spin between the write and the start event keeps the card busy while
    the host runs the wrapper and queues its launch, so a kernel's time is
    its time on the device, not the wrapper's host-side checks (a chain of
    small ops that outruns the spin still counts its host gaps)."""
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def _attn_bytes(b, q_len, kv_elem_bytes, scale_bytes=0):
    """Bytes attention must move for the lanes of ``q_len``: the lane view
    (3 int32 per lane), each active lane's table entries for its pages,
    its K/V prefix [0, pos_start + q_len) once per KV head (values of
    ``kv_elem_bytes`` each, plus ``scale_bytes`` of scales per token), q
    read and out written once (bf16)."""
    t, h, d = b["q"].shape
    hkv = b["k_pool"].shape[2]
    ps = b["seq_pos_start"].cpu().numpy().astype(np.int64)
    ends = np.where(q_len > 0, ps + q_len, 0)
    return int(3 * len(q_len) * 4 + int((-(-ends // PAGE)).sum()) * 4
               + int(ends.sum()) * hkv * (d * kv_elem_bytes + scale_bytes) * 2
               + 2 * int(q_len.sum()) * h * d * 2)


def _sdpa_inputs(torch, b):
    """SDPA's inputs for phase 3's active lanes: q [S', H, Qmax, D], the
    lanes' page tables cut to the longest causal end, and the causal mask.
    The yardstick attends a KV gathered (and head-expanded) beforehand."""
    t, h, d = b["q"].shape
    dev = b["q"].device
    ql = b["seq_q_len"].cpu().numpy().astype(np.int64)
    ps = b["seq_pos_start"].cpu().numpy().astype(np.int64)
    ends = np.where(ql > 0, ps + ql, 0)
    act = torch.as_tensor(np.nonzero(ql)[0], device=dev)
    qmax = int(ql.max())
    kv_len = int(math.ceil(ends.max() / PAGE) * PAGE)
    tab = b["tables"][act][:, : kv_len // PAGE]
    ar = torch.arange(qmax, device=dev)
    span = b["seq_q_start"][act].long()[:, None] + ar
    qg = b["q"][span.clamp(max=t - 1)].permute(0, 2, 1, 3).contiguous()
    qpos = b["seq_pos_start"][act].long()[:, None] + ar
    mask = (torch.arange(kv_len, device=dev)[None, None, :]
            <= qpos[:, :, None])[:, None]
    return qg, tab, mask, qmax


def _bound(nbytes, flops):
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flop_ms = flops / BF16_FLOPS * 1e3
    return dict(bound_ms=max(byte_ms, flop_ms),
                bound_by="bytes" if byte_ms >= flop_ms else "operations")


def _attn_flops(b):
    h, d = b["q"].shape[1:]
    ql = b["seq_q_len"].cpu().numpy().astype(np.int64)
    ps = b["seq_pos_start"].cpu().numpy().astype(np.int64)
    pairs = sum(int(np.sum(np.arange(p, p + n) + 1)) for p, n in zip(ps, ql))
    return 4 * h * d * pairs


def _device_us(torch, fn, kernel, n=5, tries=3):
    """Mean device time of the CUDA kernels whose name holds ``kernel``
    per call of fn(), from a torch.profiler trace of ``n`` calls; a trace
    that shows none of them is taken again, up to ``tries`` times (None if
    every trace shows no device time)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and kernel in e.key)
        if us:
            return us / n
    return None


UPDATE_HOST_CALLS = 1000


def _host_us(torch, fn, n=UPDATE_HOST_CALLS, rounds=5):
    """Host µs per call of fn(): time.perf_counter over ``n`` calls with no
    synchronisation inside — the wrapper's checks, its arguments and the
    launch's enqueue, while the card runs behind — over ``rounds`` such
    runs: (median, least).  The host is shared, so other work only adds
    to a run; the least is the wrapper's own cost."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        per_call.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    per_call.sort()
    return per_call[rounds // 2], per_call[0]


def _update_times(torch, entries, kernel):
    """An update kernel's numbers per entry point ({name: fn}): the cold
    time (``_time_ms``, L2 flushed), the profiler's device µs (L2 warm)
    and the host µs per call."""
    return {e: dict(ms=_time_ms(torch, fn), dev_us=_device_us(torch, fn,
                                                               kernel),
                    host_us=_host_us(torch, fn))
            for e, fn in entries.items()}


def _host_fmt(host):
    return f"host {host[0]:.2f} us per call (median; least {host[1]:.2f})"


def _fmt_entries(per):
    return "; ".join(
        f"through {e}: {t['ms'] * 1e3:.2f} us cold, {t['dev_us']} us on the "
        f"device (profiler, L2 warm), {_host_fmt(t['host_us'])}"
        for e, t in per.items())


def phase_times(torch, b):
    from arks_tpu_torch.ops import paged_attention as pa
    t, h, d = b["q"].shape
    hkv = b["k_pool"].shape[2]
    el = 2                                           # bf16 bytes
    k_pool, v_pool, layer = b["k_pool"], b["v_pool"], b["layer"]
    upd = (b["k_new"], b["v_new"], b["write_idx"], b["tables_tok"], layer)
    keep = b["token_slot"] >= 0
    n_valid = int(keep.sum().item())

    # paged_kv_update: read every write_idx, and for each valid token its
    # one table entry and its K and V rows; write those rows once.  Padding
    # tokens stop at their write_idx.
    upd_bytes = t * 4 + n_valid * 4 + 2 * (2 * n_valid * hkv * d * el)
    sel = keep.nonzero().squeeze(1)
    idx = b["write_idx"][sel].long()
    page_i = b["tables_tok"][sel].long().gather(1, (idx // PAGE)[:, None])[:, 0]
    off_i = idx % PAGE
    # Library yardstick: index_put_ of the valid rows (pool viewed as
    # [L, N, P, Hkv, D] so the row index leads), one call each for K and V.
    kv_sel, vv_sel = b["k_new"][sel], b["v_new"][sel]
    k_rows = k_pool[layer].transpose(1, 2)
    v_rows = v_pool[layer].transpose(1, 2)

    def lib_upd():
        k_rows.index_put_((page_i, off_i), kv_sel)
        v_rows.index_put_((page_i, off_i), vv_sel)
    # The launch floor: an empty kernel timed the same ways.
    floor_ms = _time_ms(torch, lambda: torch.cuda._sleep(0))
    floor_dev_us = _device_us(torch, lambda: torch.cuda._sleep(0),
                              "spin_kernel")
    per = _update_times(torch, {
        e: (lambda a=a, k=k: pa.paged_kv_update(k_pool, v_pool, *a, **k))
        for e, (a, k) in _update_entries(pa, b).items()},
        "paged_kv_update_kernel")
    upd_times = dict(
        ms=per["dst"]["ms"], entries=per, floor_ms=floor_ms,
        floor_dev_us=floor_dev_us,
        plain_ms=_time_ms(torch, lambda: pa.paged_kv_update(
            k_pool, v_pool, *upd, impl="plain")),
        library_ms=_time_ms(torch, lib_upd), **_bound(upd_bytes, 0))

    # paged_mixed_attention; flops 4*D per (query head, query, key) pair
    # over the causal span.
    ql = b["seq_q_len"].cpu().numpy().astype(np.int64)
    attn_bytes = _attn_bytes(b, ql, el)
    attn_flops = _attn_flops(b)
    lane = (b["tables"], b["seq_q_start"], b["seq_q_len"], b["seq_pos_start"],
            layer)
    # Library yardstick: SDPA over the gathered KV of the active lanes.
    qg, tab, mask, qmax = _sdpa_inputs(torch, b)
    g = h // hkv                                        # GQA, expanded here
    kg = pa.paged_gather_kv(k_pool, tab, layer).repeat_interleave(g, dim=1)
    vg = pa.paged_gather_kv(v_pool, tab, layer).repeat_interleave(g, dim=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # The kernel with its work list prepared once, as mixed_step does for
    # all layers of a step; the wrapper building it per call is timed too.
    work = pa.mixed_work(*lane[:4], page=PAGE, hkv=hkv, qmax=qmax)
    wrapper_ms = _time_ms(torch, lambda: pa.paged_mixed_attention(
        b["q"], k_pool, v_pool, *lane))
    attn_times = dict(
        ms=_time_ms(torch, lambda: pa.paged_mixed_attention(
            b["q"], k_pool, v_pool, *lane, work=work)),
        plain_ms=_time_ms(torch, lambda: pa.paged_mixed_attention(
            b["q"], k_pool, v_pool, *lane, impl="plain"), iters=5),
        library_ms=_time_ms(torch, lambda: sdpa(qg, kg, vg, attn_mask=mask)),
        **_bound(attn_bytes, attn_flops))

    dense_work = pa.mixed_work(*lane[:4], page=PAGE, hkv=hkv, qmax=qmax,
                               grid="dense")
    dense_times = dict(attn_times, ms=_time_ms(
        torch, lambda: pa.paged_mixed_attention(b["q"], k_pool, v_pool,
                                                *lane, work=dense_work)))
    # A decode-only batch (the 8 decode lanes alone) for the record.
    dec = b["seq_q_len"].clone()
    dec[8:] = 0
    dec_work = pa.mixed_work(b["tables"], b["seq_q_start"], dec,
                             b["seq_pos_start"], page=PAGE, hkv=hkv, qmax=1)
    dec_ms = _time_ms(torch, lambda: pa.paged_mixed_attention(
        b["q"], k_pool, v_pool, b["tables"], b["seq_q_start"], dec,
        b["seq_pos_start"], layer, work=dec_work))
    dec_bytes = _attn_bytes(b, np.where(np.arange(len(ql)) < 8, ql, 0), el)
    ps = b["seq_pos_start"].cpu().numpy()
    # The profiler's split of a call: the piece kernel and the combine.
    split = {}
    for name, fn in (("mixed batch", lambda: pa.paged_mixed_attention(
            b["q"], k_pool, v_pool, *lane, work=work)),
            ("decode-only", lambda: pa.paged_mixed_attention(
                b["q"], k_pool, v_pool, b["tables"], b["seq_q_start"], dec,
                b["seq_pos_start"], layer, work=dec_work))):
        split[name] = tuple(_device_us(torch, fn, k) for k in (
            "mixed_attention_tc_kernel", "mixed_attention_combine_kernel"))
    log(f"[times] paged_kv_update {_fmt_entries(per)}; launch floor "
        f"(empty kernel) {floor_ms * 1e3:.2f} us cold, {floor_dev_us} us on "
        f"the device; bound "
        f"{upd_times['bound_ms'] * 1e3:.3f} us, {upd_bytes} B; plain "
        f"{upd_times['plain_ms'] * 1e3:.1f} us, index_put_ x2 "
        f"{upd_times['library_ms'] * 1e3:.1f} us; T={t} tokens")
    log(f"[times] paged_mixed_attention {attn_times['ms'] * 1e3:.1f} us "
        f"(bound {attn_times['bound_ms'] * 1e3:.2f} us by "
        f"{attn_times['bound_by']}: {attn_bytes} B, {attn_flops:.3e} flop), "
        f"plain {attn_times['plain_ms'] * 1e3:.1f} us, SDPA on gathered KV "
        f"{attn_times['library_ms'] * 1e3:.1f} us; wrapper building its "
        f"work list per call {wrapper_ms * 1e3:.1f} us; the dense launch "
        f"{dense_times['ms'] * 1e3:.1f} us")
    log(f"[times] paged_mixed_attention decode-only (8 lanes, contexts "
        f"{(ps[:8] + 1).tolist()}): {dec_ms * 1e3:.1f} us (bound "
        f"{dec_bytes / HBM_BYTES_PER_S * 1e6:.2f} us by bytes)")
    for name, (piece, comb) in split.items():
        log(f"[times] paged_mixed_attention {name}, profiler (L2 warm): "
            f"pieces {piece} us, combine {comb} us on the device")
    return upd_times, attn_times, dense_times


def phase_quant_times(torch, b, qres):
    """The quantized update (bf16 rows into an int8 and an int4 pool) and
    the int8/int4 attention streams at phase 3's batch.  No single PyTorch
    call quantizes and scatters, so the update has no library time;
    attention's yardstick is SDPA over a KV gathered, dequantized to bf16
    and head-expanded beforehand."""
    from arks_tpu_torch.ops import paged_attention as pa
    t, h, d = b["q"].shape
    hkv = b["k_pool"].shape[2]
    g = h // hkv
    layer = b["layer"]
    upd = (b["k_new"], b["v_new"], b["write_idx"], b["tables_tok"], layer)
    keep = b["token_slot"] >= 0
    n_valid = int(keep.sum().item())
    idx = b["write_idx"][keep].long()
    pages = b["tables_tok"][keep].long().gather(1, (idx // PAGE)[:, None])[:, 0]
    lane = (b["tables"], b["seq_q_start"], b["seq_q_len"], b["seq_pos_start"],
            layer)
    ql = b["seq_q_len"].cpu().numpy().astype(np.int64)
    qg, tab, mask, qmax = _sdpa_inputs(torch, b)
    work = pa.mixed_work(*lane[:4], page=PAGE, hkv=hkv, qmax=qmax)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    upd_t, attn_t = {}, {}
    for kv, (pools, _, _) in qres.items():
        kp, vp, ks, vs = (pools[k] for k in ("k_pool", "v_pool", "k_scale",
                                             "v_scale"))
        # Update: every write_idx; per valid token one table entry, its
        # bf16 K and V rows read, its values and f32 scales written.  An
        # int4 write merges into a byte its pair-mate may share: each byte
        # row touched is read and written once.
        if kv == "int8":
            out_bytes = 2 * n_valid * hkv * (d + 4)
        else:
            rows = torch.unique(pages * PAGE + idx % PAGE // 2).numel()
            out_bytes = 2 * (2 * rows * hkv * d // 2) + 2 * n_valid * hkv * 4
        nbytes = t * 4 + n_valid * 4 + 2 * n_valid * hkv * d * 2 + out_bytes
        per = _update_times(torch, {
            e: (lambda a=a, k=k: pa.paged_kv_update_quant(kp, vp, ks, vs, *a,
                                                          **k))
            for e, (a, k) in _update_entries(pa, b).items()},
            "paged_kv_update_quant_kernel")
        upd_t[kv] = dict(
            ms=per["dst"]["ms"], entries=per,
            plain_ms=_time_ms(torch, lambda: pa.paged_kv_update_quant(
                kp, vp, ks, vs, *upd, impl="plain")),
            library_ms=None, **_bound(nbytes, 0))
        int4 = kv == "int4"
        deq = [(pa.gather_pool(pool, tab, layer, int4).float()
                * pa.paged_gather_kv(sc, tab, layer)[..., None])
               .to(torch.bfloat16).repeat_interleave(g, dim=1)
               for pool, sc in ((kp, ks), (vp, vs))]
        sc = dict(k_scale=ks, v_scale=vs)
        a_bytes = _attn_bytes(b, ql, 0.5 if int4 else 1, 4)
        attn_t[kv] = dict(
            ms=_time_ms(torch, lambda: pa.paged_mixed_attention(
                b["q"], kp, vp, *lane, work=work, **sc)),
            plain_ms=_time_ms(torch, lambda: pa.paged_mixed_attention(
                b["q"], kp, vp, *lane, impl="plain", **sc), iters=5),
            library_ms=_time_ms(torch, lambda: sdpa(qg, *deq,
                                                    attn_mask=mask)),
            **_bound(a_bytes, _attn_flops(b)))
        log(f"[times] paged_kv_update_quant {kv}: {_fmt_entries(per)}; "
            f"bound {upd_t[kv]['bound_ms'] * 1e3:.3f} us by bytes, "
            f"{nbytes} B; plain {upd_t[kv]['plain_ms'] * 1e3:.1f} us; T={t}")
        log(f"[times] paged_mixed_attention {kv} pool: "
            f"{attn_t[kv]['ms'] * 1e3:.1f} us (bound "
            f"{attn_t[kv]['bound_ms'] * 1e3:.2f} us by "
            f"{attn_t[kv]['bound_by']}, {a_bytes} B), plain "
            f"{attn_t[kv]['plain_ms'] * 1e3:.1f} us, SDPA on gathered, "
            f"dequantized KV {attn_t[kv]['library_ms'] * 1e3:.1f} us")
    return upd_t, attn_t


def _decode_bytes(lengths, cap, hkv, d, h, elem, scale_bytes=0,
                  tables=False):
    """Bytes a decode attention must move: per slot its K and V prefix
    [0, min(len, cap)) once per KV head (``elem`` bytes a value plus
    ``scale_bytes`` of scales per token), its table entries when paged,
    its length, q read and out written once (bf16)."""
    n = np.minimum(np.asarray(lengths, np.int64), cap)
    pages = int((-(-n // PAGE)).sum()) if tables else 0
    return int(n.sum() * hkv * (d * elem + scale_bytes) * 2 + pages * 4
               + len(n) * 4 + 2 * len(n) * h * d * 2)


def phase_legacy_times(torch, b):
    """The four legacy kernels at phase 3's slot cache and pool: CUDA-event
    times beside the bound, the plain version and a library call (SDPA
    with a length mask over the contiguous or pre-gathered KV, bf16 and
    head-expanded; two index_put_ for the slot write; none for the
    quantized write), and profiler device µs."""
    from arks_tpu_torch.ops import paged_attention as pa
    from arks_tpu_torch.ops import pallas_attention as pl
    q, layer = b["q"], b["layer"]
    nb, hkv, g, d = q.shape
    h = hkv * g
    kc, vc = b["k_cache"], b["v_cache"]
    widx = b["write_idx"]
    rows = (b["k_new"], b["v_new"], widx, layer)
    keep = (widx < SLOT_LEN).nonzero().squeeze(1)
    n_valid = int(keep.numel())
    idx = widx[keep].long()
    hk = torch.arange(hkv, device=q.device)
    kl, vl = kc[layer], vc[layer]
    kn, vn = b["k_new"][keep], b["v_new"][keep]

    def lib_upd():
        kl.index_put_((keep[:, None], hk[None, :], idx[:, None]), kn)
        vl.index_put_((keep[:, None], hk[None, :], idx[:, None]), vn)
    out = {}
    # The launch floor, measured beside the two writes: an empty kernel
    # timed cold and by the profiler.
    empty = lambda: torch.cuda._sleep(0)  # noqa: E731
    floor = (_time_ms(torch, empty), _device_us(torch, empty, "spin_kernel"))
    upd_bytes = nb * 4 + 2 * 2 * n_valid * hkv * d * 2
    out["kv_cache_update"] = dict(
        ms=_time_ms(torch, lambda: pl.kv_cache_update(kc, vc, *rows)),
        plain_ms=_time_ms(torch, lambda: pl.kv_cache_update(
            kc, vc, *rows, impl="plain")),
        library_ms=_time_ms(torch, lib_upd), **_bound(upd_bytes, 0),
        dev_us=_device_us(torch, lambda: pl.kv_cache_update(kc, vc, *rows),
                          "kv_cache_update_kernel"),
        host_us=_host_us(torch, lambda: pl.kv_cache_update(kc, vc, *rows)),
        nbytes=upd_bytes)
    sq = b["slot_int8"]
    q_bytes = nb * 4 + 2 * n_valid * hkv * d * 2 + 2 * n_valid * hkv * (d + 4)
    out["kv_cache_update_quant"] = dict(
        ms=_time_ms(torch, lambda: pl.kv_cache_update_quant(*sq, *rows)),
        plain_ms=_time_ms(torch, lambda: pl.kv_cache_update_quant(
            *sq, *rows, impl="plain")),
        library_ms=None, **_bound(q_bytes, 0),
        dev_us=_device_us(torch, lambda: pl.kv_cache_update_quant(*sq, *rows),
                          "kv_cache_update_quant_kernel"),
        host_us=_host_us(torch, lambda: pl.kv_cache_update_quant(*sq,
                                                                 *rows)),
        nbytes=q_bytes)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs = q.reshape(nb, h, 1, d)
    lens = b["lengths"].cpu().numpy()
    plens = b["paged_lengths"].cpu().numpy()
    flops = 4 * h * d * int(np.minimum(lens, SLOT_LEN).sum())
    pflops = 4 * h * d * int(plens.sum())

    def mask(n):
        return (torch.arange(SLOT_LEN, device=q.device)[None, :]
                < torch.as_tensor(np.minimum(n, SLOT_LEN),
                                  device=q.device)[:, None])[:, None, None]
    slot_mask, paged_mask = mask(lens), mask(plens)
    kx = kl.repeat_interleave(g, dim=1)
    vx = vl.repeat_interleave(g, dim=1)
    args = (b["lengths"], layer)
    for name, kv in (("ragged_decode_attention", "bf16"),
                     ("ragged_decode_attention int8", "int8")):
        if kv == "bf16":
            caches, sc, el, sb = (kc, vc), {}, 2, 0
            lk, lv = kx, vx
        else:
            caches = sq[:2]
            sc, el, sb = dict(k_scale=sq[2], v_scale=sq[3]), 1, 4
            lk, lv = ((x[layer].float() * s_[layer][..., None]).to(
                torch.bfloat16).repeat_interleave(g, dim=1)
                for x, s_ in ((sq[0], sq[2]), (sq[1], sq[3])))
        nbytes = _decode_bytes(lens, SLOT_LEN, hkv, d, h, el, sb)
        out[name] = dict(
            ms=_time_ms(torch, lambda: pl.ragged_decode_attention(
                q, *caches, *args, **sc)),
            plain_ms=_time_ms(torch, lambda: pl.ragged_decode_attention(
                q, *caches, *args, impl="plain", **sc), iters=5),
            library_ms=_time_ms(torch, lambda: sdpa(qs, lk, lv,
                                                    attn_mask=slot_mask)),
            **_bound(nbytes, flops),
            dev_us=_device_us(torch, lambda: pl.ragged_decode_attention(
                q, *caches, *args, **sc), "decode_attention_"),
            nbytes=nbytes)
        del lk, lv
    del kx, vx
    pargs = (b["tables"], b["paged_lengths"], layer)
    pq = b["paged_int8"]
    for name, kv in (("paged_decode_attention", "bf16"),
                     ("paged_decode_attention int8", "int8")):
        if kv == "bf16":
            pools, sc, el, sb = (b["k_pool"], b["v_pool"]), {}, 2, 0
            gk, gv = (pa.paged_gather_kv(x, b["tables"], layer)
                      .repeat_interleave(g, dim=1) for x in pools)
        else:
            pools = pq[:2]
            sc, el, sb = dict(k_scale=pq[2], v_scale=pq[3]), 1, 4
            gk, gv = ((pa.paged_gather_kv(x, b["tables"], layer).float()
                       * pa.paged_gather_kv(s_, b["tables"], layer)[..., None])
                      .to(torch.bfloat16).repeat_interleave(g, dim=1)
                      for x, s_ in ((pq[0], pq[2]), (pq[1], pq[3])))
        nbytes = _decode_bytes(plens, SLOT_LEN, hkv, d, h, el, sb,
                               tables=True)
        out[name] = dict(
            ms=_time_ms(torch, lambda: pa.paged_decode_attention(
                q, *pools, *pargs, **sc)),
            plain_ms=_time_ms(torch, lambda: pa.paged_decode_attention(
                q, *pools, *pargs, impl="plain", **sc), iters=5),
            library_ms=_time_ms(torch, lambda: sdpa(qs, gk, gv,
                                                    attn_mask=paged_mask)),
            **_bound(nbytes, pflops),
            dev_us=_device_us(torch, lambda: pa.paged_decode_attention(
                q, *pools, *pargs, **sc), "decode_attention_"),
            nbytes=nbytes)
        del gk, gv
    for name, t in out.items():
        lib = (f"{t['library_ms'] * 1e3:.1f} us" if t["library_ms"]
               is not None else "none")
        extra = (f"; launch floor {floor[0] * 1e3:.2f} us cold / {floor[1]} "
                 f"us warm, {_host_fmt(t['host_us'])}" if "host_us" in t
                 else f"; lengths {lens.tolist()}")
        log(f"[times] {name}: {t['ms'] * 1e3:.2f} us (profiler: "
            f"{t['dev_us']} us on the device; bound {t['bound_ms'] * 1e3:.3f}"
            f" us by {t['bound_by']}, {t['nbytes']} B), plain "
            f"{t['plain_ms'] * 1e3:.1f} us, library {lib}{extra}")
    return out


def log_row_writes(upd_t, qupd_t, lt):
    """One line per row-write kernel (#2, #3 int8 and int4, #7, #8) on the
    served path's entry point: the cold time (L2 flushed), the profiler's
    device time (L2 warm), the launch floor (an empty kernel timed both
    ways) and the wrapper's host µs per call."""
    rows = {"paged_kv_update": upd_t["entries"]["dst"],
            **{f"paged_kv_update_quant {kv}": t["entries"]["dst"]
               for kv, t in qupd_t.items()},
            "kv_cache_update": lt["kv_cache_update"],
            "kv_cache_update_quant": lt["kv_cache_update_quant"]}
    for name, t in rows.items():
        log(f"[times] row write {name}: cold {t['ms'] * 1e3:.2f} us, warm "
            f"{t['dev_us']} us (profiler), launch floor "
            f"{upd_t['floor_ms'] * 1e3:.2f} us cold / "
            f"{upd_t['floor_dev_us']} us warm, {_host_fmt(t['host_us'])}")


# ---------------------------------------------------------------------------
# Prefix reuse: the device index, the host tier, the slot cache's prefix
# cache (Qwen2.5-7B at full width)
# ---------------------------------------------------------------------------


PREFIX_LEN, PREFIX_TAIL, PREFIX_TOKENS = 2048, 64, 16
# Every path that issues work for the tiers, held sync-free.
PREFIX_ISSUES = ("_pipe_issue", "_issue_restore", "_spill_flush")


def _prefix_engine(torch, dev, params, kv="bf16", layout="paged",
                   mixed=True, off=False):
    """A Qwen2.5-7B engine on ``params`` (8 slots x 4096, chunk = page =
    256, the default depth 2): the mixed scheduler on a ``kv`` pool, or
    the legacy one on a paged pool (``mixed`` False) or the slot cache.
    Prefix reuse at its defaults (256 MB of retention pages, a 256 MB host
    tier, or the slot cache's 256 MB prefix cache); ``off``: none at all
    (no retention, no host tier, the device index never matching)."""
    import os

    from arks_tpu_torch.engine import EngineConfig, InferenceEngine
    from arks_tpu_torch.engine.tokenizer import ByteTokenizer
    from arks_tpu_torch.models import get_config
    old = {k: os.environ.get(k) for k in ("ARKS_MIXED_STEP",
                                          "ARKS_PREFIX_HOST_MB")}
    os.environ["ARKS_MIXED_STEP"] = "1" if mixed else "0"
    if off:
        os.environ["ARKS_PREFIX_HOST_MB"] = "0"
    try:
        engine = InferenceEngine(get_config(MODEL), EngineConfig(
            model=MODEL, num_slots=8, max_cache_len=MAX_PAGES * PAGE,
            prefill_chunk=PAGE, dtype="bfloat16", kv_cache_dtype=kv,
            kv_layout=layout, seed=SEED,
            **({"prefix_cache_mb": 0} if off else {})),
            ByteTokenizer(), params=params, device=dev)
    finally:
        _restore_env(os, old)
    if off:
        engine._alloc.match = lambda digests: []
    return engine


def _prefix_run(torch, engine, ids, max_tokens=PREFIX_TOKENS):
    """One greedy request alone, driven by ``engine.step()`` from this
    thread: (tokens, TTFT seconds on the host clock, prompt tokens the
    model computed for it)."""
    import queue

    from arks_tpu_torch.engine import Request, SamplingParams
    req = Request(f"prefix-{time.perf_counter_ns()}", list(ids),
                  SamplingParams(max_tokens=max_tokens, temperature=0,
                                 ignore_eos=True))
    p0 = engine.prefill_tokens_total
    t0 = time.perf_counter()
    engine.add_request(req)
    toks, ttft, done = [], None, False
    for _ in range(100_000):
        engine.step(block_s=0.001)
        while True:
            try:
                out = req.outputs.get_nowait()
            except queue.Empty:
                break
            if ttft is None and out.token_ids:
                ttft = time.perf_counter() - t0
            toks += out.token_ids
            done = done or out.finished
        if done and engine.idle:
            break
    if not done or len(toks) != max_tokens:
        raise AssertionError(f"[prefix] a request ended short: {len(toks)}")
    return toks, ttft, engine.prefill_tokens_total - p0


def _settle_spills(engine):
    """Step the idle engine until every spill copy has landed in the host
    tier (a spill lands on device time)."""
    for _ in range(10_000):
        if not engine._spills:
            return
        engine.step(block_s=0.001)
    raise AssertionError("[prefix] spills never landed")


def _evict_prefix(engine, digests):
    """Pool pressure without churn: allocate every free page and as many
    more as the index retains, which evicts (and spills) the LRU pages --
    the prefix's -- then give the allocation back."""
    alloc = engine._alloc
    grab = alloc.alloc(alloc.free_pages + alloc.retained_pages)
    engine._spill_flush()
    alloc.decref(grab)
    if any(d in alloc._index for d in digests):
        raise AssertionError("[prefix] the prefix survived the eviction")


def _spilled(engine, digests, tag):
    """Copies of the host tier's blocks of ``digests`` (all must be
    there)."""
    host = [engine._host.peek(d) for d in digests]
    if any(b is None for b in host):
        raise AssertionError(f"{tag} a page was not spilled to the host tier")
    return [{k: v.clone() for k, v in b.items()} for b in host]


def _same_pages(torch, engine, digests, host, tag):
    """The device index's pages of ``digests`` (restored) against the
    spilled blocks ``host``, bit for bit; returns the pages compared."""
    pages = engine._alloc.match(digests)
    try:
        if len(pages) != len(digests):
            raise AssertionError(f"{tag} restored pages not in the index")
        names = ("k", "v", "k_scale", "v_scale")
        for pg, blk in zip(pages, host):
            for name, arr in zip(names, engine.cache):
                if name in blk and not torch.equal(arr[:, pg].cpu(),
                                                   blk[name]):
                    raise AssertionError(f"{tag} restored {name} bytes differ")
    finally:
        engine._alloc.decref(pages)
    return len(pages)


def _prefix_counts(engine, launches, d0, s0):
    """The served kernels' expected counts on ``engine`` since dispatch
    and decode-step marks ``d0``/``s0`` (every other kernel none)."""
    layers = engine.cfg.num_layers
    quant = engine.kv_quantized
    if engine._mixed:
        n = layers * (engine.dispatches - d0)
        want = {"paged_kv_update_quant" if quant else "paged_kv_update": n,
                "paged_mixed_attention": n}
    else:
        n = layers * (engine.decode_steps - s0)
        slot = not engine._paged
        want = {("kv_cache_update" if slot else "paged_kv_update")
                + ("_quant" if quant else ""): n,
                "ragged_decode_attention" if slot
                else "paged_decode_attention": n}
    return {k: want.get(k, 0) for k in launches}


def phase_prefix(torch, dev, params):
    """Prefix reuse on Qwen2.5-7B at full width (``params``: phase 4's bf16
    weights), at the default depth 2, every call of the tiers' issue paths
    (PREFIX_ISSUES) under torch.cuda.set_sync_debug_mode("error"):
    - the mixed bf16 engine: a 2,048-token prefix (8 pages) with 8
      distinct 64-token tails, one request at a time: the cold request's
      TTFT, then each warm one's, which must prefill exactly its tail;
      every stream equal to a prefix-off engine's (no retention, no host
      tier, the device index never matching).  Then distinct prompts of
      15 full pages until the prefix leaves the device index (spilled to
      the host tier), and the first warm prompt again: restored from the
      host tier (2,048 host-hit tokens, the tail prefilled, the same
      stream), the restored pages' bytes equal to the spilled ones;
    - mixed int8 and int4 pools, and the legacy scheduler on a paged int8
      pool (ARKS_MIXED_STEP=0): cold, warm (a device hit), then the prefix
      evicted by pool pressure (``_evict_prefix``) and restored, bytes and
      streams checked as above;
    - the legacy slot bf16 cache: the cold prompt harvested into its
      prefix cache, the warm one inserted from it, the tail prefilled.
    Each engine's kernels count num_layers x its dispatches (decode
    steps).  Returns {"launches": summed counts, "rows": numbers}."""
    from arks_tpu_torch.engine.paged import chain_digests
    from arks_tpu_torch.models import get_config
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 11)
    vocab = get_config(MODEL).vocab_size
    prefix = [int(x) for x in rng.integers(2, vocab, PREFIX_LEN)]
    tails = [[int(x) for x in rng.integers(2, vocab, PREFIX_TAIL)]
             for _ in range(8)]
    prompts = [prefix + t for t in tails]
    digests = chain_digests(prefix, PAGE, PREFIX_LEN // PAGE)
    total = collections.Counter()
    rows = {}

    # The prefix-off oracle first (same weights, same one-at-a-time order).
    off = _prefix_engine(torch, dev, params, off=True)
    _prefix_run(torch, off, [5] * 40, 2)
    oracle = []
    for p in prompts:
        toks, _, n = _prefix_run(torch, off, p)
        if n != len(p):
            raise AssertionError("[prefix off] a prompt was not prefilled "
                                 "whole")
        oracle.append(toks)
    del off
    torch.cuda.empty_cache()

    tag = "[prefix mixed bf16]"
    engine = _prefix_engine(torch, dev, params)
    _prefix_run(torch, engine, [5] * 40, 2)       # warm-up
    _reset_counts()
    d0, s0 = engine.dispatches, engine.decode_steps
    with _NoSync(torch, engine, PREFIX_ISSUES) as nosync:
        toks, ttft_cold, n_cold = _prefix_run(torch, engine, prompts[0])
        streams, ttfts, tails_done = [toks], [], [n_cold]
        for p in prompts[1:]:
            toks, ttft, n = _prefix_run(torch, engine, p)
            streams.append(toks)
            ttfts.append(ttft)
            tails_done.append(n)
        dev_hits = engine.prefix_cache_hit_tokens_total["device"]
        churn = 0
        while any(d in engine._alloc._index for d in digests):
            churn += 1
            if churn > 16:
                raise AssertionError(f"{tag} churn never evicted the prefix")
            ids = [int(x) for x in rng.integers(2, vocab, 15 * PAGE + 1)]
            _prefix_run(torch, engine, ids, 2)
        _settle_spills(engine)
        host = _spilled(engine, digests, tag)
        h0 = engine.prefix_cache_hit_tokens_total["host"]
        r0 = engine.prefix_restore_blocks_total
        toks, ttft_restored, n_restored = _prefix_run(torch, engine,
                                                      prompts[0])
        host_hits = engine.prefix_cache_hit_tokens_total["host"] - h0
        same_pages = _same_pages(torch, engine, digests, host, tag)
    launches = _read_counts()
    want = _prefix_counts(engine, launches, d0, s0)
    # What the bus gives a restore: the spilled blocks' bytes uploaded
    # from pinned memory, by CUDA events.
    nbytes = sum(v.nbytes for blk in host for v in blk.values())
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    h2d_ms = _time_ms(torch, lambda: pinned.to(dev, non_blocking=True),
                      iters=5, warmup=1)
    del pinned
    row = dict(ttft_cold_ms=ttft_cold * 1e3,
               ttft_warm_ms=[t * 1e3 for t in ttfts],
               ttft_restored_ms=ttft_restored * 1e3,
               prefilled=tails_done, prefilled_restored=n_restored,
               device_hit_tokens=dev_hits, host_hit_tokens=host_hits,
               churn_requests=churn,
               spilled=engine.prefix_spill_blocks_total,
               restored=engine.prefix_restore_blocks_total - r0,
               restore_ms=[s * 1e3 for s in engine.prefix_restore_seconds],
               restore_bytes=nbytes, h2d_ms=h2d_ms,
               pool_pages=engine._alloc.num_pages,
               checked_issues=dict(nosync.calls))
    rows["mixed bf16"] = row
    log(f"{tag} TTFT cold {row['ttft_cold_ms']:.1f} ms ({len(prompts[0])} "
        f"tokens, prefilled {n_cold}); warm "
        + ", ".join(f"{t:.1f}" for t in row["ttft_warm_ms"])
        + f" ms (prefilled {tails_done[1:]}); device-hit tokens {dev_hits}; "
        f"churn {churn} prompts of {15 * PAGE + 1} tokens, {row['spilled']} pages "
        f"spilled; restored from the host tier: TTFT "
        f"{row['ttft_restored_ms']:.1f} ms, host-hit tokens {host_hits}, "
        f"prefilled {n_restored}, {row['restored']} pages in "
        f"{row['restore_ms']} ms ({nbytes} B; a pinned upload of as many "
        f"bytes {h2d_ms:.2f} ms), bytes equal {same_pages} pages; streams "
        f"equal the prefix-off engine's "
        f"{streams == oracle and toks == oracle[0]}; pool "
        f"{row['pool_pages']} pages; sync-checked calls {row['checked_issues']}"
        f"; launches {launches}, expected {want}")
    ok = (streams == oracle and toks == oracle[0]
          and tails_done == [len(prompts[0])] + [PREFIX_TAIL] * 7
          and dev_hits == 7 * PREFIX_LEN and host_hits == PREFIX_LEN
          and n_restored == PREFIX_TAIL and row["restored"] == 8
          and same_pages == 8 and launches == want
          and nosync.calls["_issue_restore"] >= 1
          and nosync.calls["_spill_flush"] >= 1)
    if not ok:
        raise AssertionError(f"{tag} prefix reuse failed its checks")
    total.update(launches)
    del engine
    torch.cuda.empty_cache()

    for kv, layout, mixed in (("int8", "paged", True), ("int4", "paged", True),
                              ("int8", "paged", False),
                              ("bf16", "slot", False)):
        sched = "mixed" if mixed else "legacy"
        tag = f"[prefix {sched} {layout} {kv}]"
        engine = _prefix_engine(torch, dev, params, kv, layout, mixed)
        _prefix_run(torch, engine, [5] * 40, 2)       # warm-up
        _reset_counts()
        d0, s0 = engine.dispatches, engine.decode_steps
        with _NoSync(torch, engine, PREFIX_ISSUES) as nosync:
            cold, ttft_cold, n_cold = _prefix_run(torch, engine, prompts[0])
            warm, ttft_warm, n_warm = _prefix_run(torch, engine, prompts[1])
            ok = n_cold == len(prompts[0]) and n_warm == PREFIX_TAIL
            res = dict(ttft_cold_ms=ttft_cold * 1e3,
                       ttft_warm_ms=ttft_warm * 1e3, prefilled_warm=n_warm)
            if layout == "paged":
                _evict_prefix(engine, digests)
                _settle_spills(engine)
                host = _spilled(engine, digests, tag)
                again, _, n_again = _prefix_run(torch, engine, prompts[0])
                res.update(prefilled_restored=n_again,
                           same_pages=_same_pages(torch, engine, digests,
                                                  host, tag))
                ok = ok and again == cold and n_again == PREFIX_TAIL and \
                    res["same_pages"] == 8 and \
                    nosync.calls["_issue_restore"] >= 1
        launches = _read_counts()
        want = _prefix_counts(engine, launches, d0, s0)
        ok = ok and launches == want
        res.update(checked_issues=dict(nosync.calls),
                   hits=dict(engine.prefix_cache_hit_tokens_total))
        rows[f"{sched} {layout} {kv}"] = res
        log(f"{tag} TTFT cold {res['ttft_cold_ms']:.1f} ms, warm "
            f"{res['ttft_warm_ms']:.1f} ms; {res}; launches {launches}, "
            f"expected {want}")
        if not ok:
            raise AssertionError(f"{tag} prefix reuse failed its checks")
        total.update(launches)
        del engine
        torch.cuda.empty_cache()
    log(f"[prefix] phase took {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=dict(total), rows=rows)


# ---------------------------------------------------------------------------
# Phase 7: the MoE path (Mixtral-8x7B, int8 / int4 weights)
# ---------------------------------------------------------------------------


# One Mixtral mixed step routes 264 tokens x top-2 = 528 rows over its 8
# experts; this split holds an empty expert, a group of exactly 128 rows
# and a 1-row group.
MOE_GROUPS = [128, 0, 1, 97, 88, 70, 80, 64]
# A decode step of 8 lanes routes 16 rows over 7 experts (Tp 1152): every
# tile holds 1-4 real rows.  MOE_CROSS_GROUPS holds a 65-row group, one row
# past the kernel's 64-row block.
MOE_DECODE_GROUPS = [3, 1, 2, 4, 0, 2, 2, 2]
MOE_CROSS_GROUPS = [65, 0, 3, 64, 0, 0, 1, 0]
MOE_BATCHES = {"528-row": MOE_GROUPS, "decode": MOE_DECODE_GROUPS,
               "65-row": MOE_CROSS_GROUPS}
# grouped_matmul in bf16 against its plain version: both accumulate in
# f32 (in another order, over K up to 14336) and round the output to bf16
# once, so they differ by about one bf16 step of the output: 1e-2 of the
# largest |out| (0.39% is one step at the top of a binade).  f32 (parity
# only): 1e-5.
GM_TOL = {"bf16": 1e-2, "f32": 1e-5}
WEIGHT_ELEM_BYTES = {"bf16": 2, "int8": 1, "int4": 0.5}


def _moe_weight(torch, dev, mode, shape, gen):
    """An expert weight [X, K, N] drawn from ``gen`` (normal x 0.02, bf16),
    then int8 / packed int4 (group 128): (w, scale kwargs, the bf16
    weight the library call multiplies by)."""
    from arks_tpu_torch.models import quant
    w = torch.empty(shape, dtype=torch.bfloat16, device=dev)
    for e in range(shape[0]):
        w[e] = torch.randn(shape[1:], generator=gen, device=dev) * 0.02
    if mode == "bf16":
        return w, {}, w
    if mode == "int8":
        qd = quant.quantize_tensor(w)
        kw = {"w_scale": qd["s"][:, 0, :].contiguous()}
    else:
        qd = quant.quantize_tensor_int4(w, 128)
        kw = {"w_group_scale": qd["gs"]}
    del w
    return qd["q"], kw, quant.dequantize(qd, torch.bfloat16)


def _grouped_library(torch, xs, w, sizes):
    """One PyTorch call computing the grouped product on the unpadded
    sorted rows: ``torch._grouped_mm`` where this torch has it for the
    card, else a per-expert ``torch.matmul`` loop.  Returns (fn, name)."""
    offs = torch.as_tensor(np.cumsum(sizes), dtype=torch.int32,
                           device=xs.device)
    if hasattr(torch, "_grouped_mm"):
        try:
            torch._grouped_mm(xs, w, offs=offs)
            torch.cuda.synchronize()
            return (lambda: torch._grouped_mm(xs, w, offs=offs),
                    "torch._grouped_mm")
        except (RuntimeError, TypeError, NotImplementedError) as e:
            log(f"[moe kernels] torch._grouped_mm refused: {e}")
    starts = np.concatenate([[0], np.cumsum(sizes)])

    def loop():
        return [xs[starts[i]:starts[i + 1]] @ w[i]
                for i in range(len(sizes)) if sizes[i]]
    return loop, "per-expert torch.matmul loop"


def phase_moe_kernels(torch, dev):
    """grouped_matmul (bf16, int8, int4 with group 128) against its plain
    version at Mixtral-8x7B's gate/up shape [8, 4096, 14336] and down shape
    [8, 14336, 4096] over three batches padded to 128-row tiles: a mixed
    step's MOE_GROUPS, a decode step's MOE_DECODE_GROUPS and
    MOE_CROSS_GROUPS (65 rows: past one 64-row block).  Each launch passes
    rows_used and tile_rows, as grouped_ffn does; tiles past the groups
    must come out exactly zero.  Times by CUDA events (L2 flushed) beside
    the bound, the plain version and the library call.  Returns
    {(batch, shape, mode): record}."""
    from arks_tpu_torch.models import get_config
    from arks_tpu_torch.ops import moe_kernel as mk
    cfg = get_config(MOE_MODEL)
    e, fm, nx = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    out = {}
    for shape, (k, n) in (("gate", (e, fm)), ("down", (fm, e))):
        batches = []
        for batch, sizes in MOE_BATCHES.items():
            t = sum(sizes)
            gs = torch.as_tensor(sizes, device=dev)
            se = torch.repeat_interleave(torch.arange(nx, device=dev), gs)
            xs = torch.randn((t, k), generator=gen, device=dev).to(
                torch.bfloat16)
            xs_p, _, bexp = mk.pad_groups(xs, se, gs)
            used = mk.rows_used(gs)
            rows = mk.tile_rows(gs, bexp.shape[0])
            batches.append((batch, sizes, xs, xs_p, bexp, used, rows))
        for mode in ("bf16", "int8", "int4"):
            w, kw, wd = _moe_weight(torch, dev, mode, (nx, k, n), gen)
            for batch, sizes, xs, xs_p, bexp, used, rows in batches:
                out[(batch, shape, mode)] = _moe_kernel_case(
                    torch, mk, batch, shape, mode, sizes, xs, xs_p, bexp,
                    used, rows, w, kw, wd)
            del w, kw, wd
            torch.cuda.empty_cache()
        del batches
    return out


def _moe_kernel_case(torch, mk, batch, shape, mode, sizes, xs, xs_p, bexp,
                     used, rows, w, kw, wd):
    """One grouped_matmul batch of phase_moe_kernels: the check against the
    plain version, then the times."""
    t, tp = sum(sizes), xs_p.shape[0]
    nx, n = w.shape[0], w.shape[-1]
    k = xs.shape[1]
    n_used = int(used.item())
    routed = sum(1 for x in sizes if x)

    def kern():
        return mk.grouped_matmul(xs_p, w, bexp, rows_used=used, tile_rows=rows,
                                 **kw)
    got = kern()
    want = mk.grouped_matmul(xs_p, w, bexp, impl="plain", **kw)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    finite = bool(torch.isfinite(got.float()).all().item())
    zeros = not bool(got[n_used:].any().item())
    tag = f"grouped_matmul {mode} {shape} {batch}"
    log(f"[moe kernels] {tag} [{nx}, {k}, {n}], Tp {tp} ({t} routed rows "
        f"{sizes}, tile rows {rows.tolist()}): max abs err vs plain "
        f"{err:.3e} (tol {GM_TOL['bf16']} x max |out| {top:.3f}); tiles "
        f"past the groups zero {zeros}; finite {finite}")
    if not (finite and zeros and err <= GM_TOL["bf16"] * top):
        raise AssertionError(f"{tag} disagrees with its plain version")
    scale_bytes = {"bf16": 0, "int8": n * 4, "int4": (k // 128) * n * 4}[mode]
    # The routed rows of xs, the routed experts' weights and scales, the
    # tile maps, and the whole [Tp, N] output.
    nbytes = int(t * k * 2 + routed * (k * n * WEIGHT_ELEM_BYTES[mode]
                                       + scale_bytes)
                 + 2 * bexp.numel() * 4 + 4 + tp * n * 2)
    lib, lib_name = _grouped_library(torch, xs, wd, sizes)
    rec = dict(
        ms=_time_ms(torch, kern),
        plain_ms=_time_ms(torch, lambda: mk.grouped_matmul(
            xs_p, w, bexp, impl="plain", **kw), iters=3, warmup=1),
        library_ms=_time_ms(torch, lib), library=lib_name,
        max_abs_err=err, nbytes=nbytes, **_bound(nbytes, 2 * t * k * n))
    log(f"[times] {tag}: {rec['ms'] * 1e3:.1f} us (bound "
        f"{rec['bound_ms'] * 1e3:.1f} us by {rec['bound_by']}: {nbytes} B, "
        f"{2 * t * k * n:.3e} flop; {rec['bound_ms'] / rec['ms']:.2f} of "
        f"it), plain {rec['plain_ms'] * 1e3:.1f} us, {lib_name} on "
        f"dequantized bf16 weights {rec['library_ms'] * 1e3:.1f} us")
    return rec


def _kernels_per_call(torch, fn, calls=10, tries=4):
    """Kernels one call of ``fn`` launches, from the profiler's device
    trace: windows of ``calls`` calls, the one that saw the most events
    (the trace drops the first events of a window now and then, which
    would empty a window of a single short call), rounded up per call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    best = 0
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        best = max(best, sum(
            e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA))
    return -(-best // calls)


def phase_moe_routes(torch, dev):
    """qeinsum's grouped routes (kernel #9, no new kernel) at Mixtral-8x7B
    shapes with int8 and int4 (group 128) weights: the dense MoE route's
    two products at T = 8 over the 8 experts (every expert over the same
    rows: gate/up [8, 4096, 14336], down [8, 14336, 4096]), and the
    projections wq [4096, 4096] and wk [4096, 1024] over 8 and 264 rows
    (one group).  Each within GM_TOL of the largest |out| of
    ``qeinsum_plain`` (the convert, matmul and scale it replaces), one
    grouped_matmul launch a call; timed by CUDA events beside the convert
    path and the byte bound, with the kernels each form launches (from
    the profiler: the route may take at most two more than the convert
    path).  Returns {(route, mode): record}."""
    from arks_tpu_torch.models import get_config
    from arks_tpu_torch.models import quant
    from arks_tpu_torch.ops import moe_kernel as mk
    cfg = get_config(MOE_MODEL)
    e, fm, nx = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts
    kvd = cfg.num_kv_heads * cfg.head_dim
    routes = [("dense gate T=8", "...e,xef->...xf", (8, e), (nx, e, fm)),
              ("dense down T=8", "...xf,xfe->...xe", (8, nx, fm),
               (nx, fm, e)),
              ("wq T=8", "...e,eq->...q", (8, e), (e, cfg.q_dim)),
              ("wq T=264", "...e,eq->...q", (264, e), (e, cfg.q_dim)),
              ("wk T=8", "...e,ek->...k", (8, e), (e, kvd)),
              ("wk T=264", "...e,ek->...k", (264, e), (e, kvd))]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 9)
    out = {}
    for name, eq, xshape, wshape in routes:
        x = torch.randn(xshape, generator=gen, device=dev).to(torch.bfloat16)
        w = torch.empty(wshape, dtype=torch.bfloat16, device=dev)
        for i in range(w.shape[0] if len(wshape) == 3 else 1):
            part = w[i] if len(wshape) == 3 else w
            part.copy_(torch.randn(part.shape, generator=gen, device=dev)
                       * 0.02)
        for mode in ("int8", "int4"):
            leaf = quant.quantize_tensor(w) if mode == "int8" else \
                quant.quantize_tensor_int4(w, 128)
            before = mk.grouped_matmul.launches
            got = quant.qeinsum(eq, x, leaf)
            calls = mk.grouped_matmul.launches - before
            want = quant.qeinsum(eq, x, leaf, impl="plain")
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            top = want.float().abs().max().item()
            finite = bool(torch.isfinite(got.float()).all().item())
            k, n = wshape[-2], wshape[-1]
            groups = wshape[0] if len(wshape) == 3 else 1
            t = xshape[0]
            scale = n * 4 if mode == "int8" else (k // 128) * n * 4
            nbytes = int(groups * (k * n * WEIGHT_ELEM_BYTES[mode] + scale)
                         + t * (groups if eq.startswith("...xf") else 1)
                         * k * 2 + t * groups * n * 2)
            flops = 2 * t * k * n * groups
            launches = {
                tag: _kernels_per_call(torch, fn) for tag, fn in (
                    ("route", lambda: quant.qeinsum(eq, x, leaf)),
                    ("convert", lambda: quant.qeinsum(eq, x, leaf,
                                                      impl="plain")))}
            rec = dict(ms=_time_ms(torch, lambda: quant.qeinsum(eq, x, leaf)),
                       plain_ms=_time_ms(torch, lambda: quant.qeinsum(
                           eq, x, leaf, impl="plain")),
                       max_abs_err=err, launches=launches, nbytes=nbytes,
                       **_bound(nbytes, flops))
            out[(name, mode)] = rec
            log(f"[moe routes] {name} {mode} {eq} x {tuple(xshape)} w "
                f"{tuple(wshape)}: max abs err vs qeinsum_plain {err:.3e} "
                f"(tol {GM_TOL['bf16']} x max |out| {top:.3f}); finite "
                f"{finite}; grouped_matmul calls {calls}; "
                f"{rec['ms'] * 1e3:.1f} us (bound {rec['bound_ms'] * 1e3:.1f}"
                f" us by {rec['bound_by']}: {nbytes} B; "
                f"{rec['bound_ms'] / rec['ms']:.2f} of it), the convert path "
                f"{rec['plain_ms'] * 1e3:.1f} us; kernels per call "
                f"{launches['route']:.0f} vs {launches['convert']:.0f}")
            if not (finite and calls == 1 and err <= GM_TOL["bf16"] * top
                    and 0 < launches["route"] <= launches["convert"] + 2):
                raise AssertionError(f"[moe routes] {name} {mode} failed "
                                     "its checks")
            del leaf
        del x, w
        torch.cuda.empty_cache()
    return out


def _moe_engine(torch, dev, weight_dtype, params=None):
    """A Mixtral-8x7B engine (8 slots x 4096, chunk 256, bf16 pool) with
    ``weight_dtype`` weights (drawn from SEED, or ``params``), at the
    default engine shape (depth 2, fusion on): its steady steps take the
    8-token pipe step, whose MoE FFN is the dense route (the reference's
    rule), through the grouped matmul like every quantized product."""
    from arks_tpu_torch.engine import EngineConfig, InferenceEngine
    from arks_tpu_torch.engine.tokenizer import ByteTokenizer
    from arks_tpu_torch.models import get_config
    cfg = get_config(MOE_MODEL)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, EngineConfig(
        model=MOE_MODEL, num_slots=8, max_cache_len=MAX_PAGES * PAGE,
        prefill_chunk=PAGE, dtype="bfloat16", kv_cache_dtype="bf16",
        weight_dtype=weight_dtype, seed=SEED), ByteTokenizer(),
        params=params, device=dev)
    torch.cuda.synchronize()
    wbytes = sum(x.numel() * x.element_size() for x in _leaves(engine.params))
    log(f"[serve {MOE_MODEL} {weight_dtype}] engine up in "
        f"{time.perf_counter() - t0:.1f} s: weights {wbytes} B "
        f"({weight_dtype}; embedding int8, router and norms bf16), bf16 "
        f"pool {tuple(engine.cache.k.shape)}, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated, "
        f"MoE dispatch grouped {engine._moe_grouped} (num_slots + chunk = "
        f"{8 + engine._mixed_budget} tokens)")
    if not engine._moe_grouped:
        raise AssertionError("the Mixtral engine's mixed steps do not group")
    return engine, wbytes


def phase_serve_moe_short(torch, dev, engine):
    """A short batch on a Mixtral engine (the int4 one): one greedy
    completion twice in a row (identical), then 8 concurrent greedy streams
    of 16 tokens, with the kernel counts of that run.  (A prompt repeated
    inside the concurrent batch need not repeat its tokens: cuBLAS picks
    its GEMM by the batch's token count, so the same row rounds
    differently in another batch, and random weights leave near-ties.)"""
    from arks_tpu_torch.server import OpenAIServer
    cfg = engine.cfg
    tag = f"[serve {MOE_MODEL} {engine.ecfg.weight_dtype}]"
    server = OpenAIServer(engine, MOE_MODEL, host="127.0.0.1", port=0)
    server.start(background=True)
    engine.start()
    port = server.port
    try:
        st, data, _, _ = _request(port, "/v1/completions", {
            "prompt": "warm up", "max_tokens": 4, "temperature": 0})
        if st != 200:
            raise AssertionError(f"warm-up failed: {st} {data}")
        _reset_counts()
        d0 = engine.dispatches
        out = {}

        def run(key, body):
            out[key] = _request(port, "/v1/completions", body)
        bodies = {f"b{i}": {"prompt": f"expert lane {i}" * (1 + i),
                            "max_tokens": 16, "temperature": 0,
                            "ignore_eos": True} for i in range(8)}
        run("first", bodies["b3"])
        run("again", bodies["b3"])
        threads = [threading.Thread(target=run, args=item)
                   for item in bodies.items()]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(900)
        wall = time.perf_counter() - t0
        for key, (st, data, _, _) in out.items():
            if st != 200 or data["usage"]["completion_tokens"] != 16:
                raise AssertionError(f"{tag} {key}: HTTP {st} {data}")
        same = (out["again"][1]["choices"][0]["text"]
                == out["first"][1]["choices"][0]["text"])
        dispatches = engine.dispatches - d0
        launches = _read_counts()
        want = cfg.num_layers * dispatches
        expected = {name: 0 for name in launches}
        expected.update(paged_kv_update=want, paged_mixed_attention=want,
                        grouped_matmul=_gm_per_layer(engine, True) * want)
        log(f"{tag} a greedy completion twice in a row identical {same}; "
            f"8 concurrent greedy streams of 16 tokens in {wall:.2f} s "
            f"({8 * 16 / wall:.1f} tok/s incl. prefill); mixed dispatches "
            f"{dispatches}, launches {launches}, expected {expected}")
        if launches != expected or dispatches == 0 or not same:
            raise AssertionError(f"{tag} launch counts or repeated stream")
        return dict(launches=launches, tok_s=8 * 16 / wall)
    finally:
        server.stop()
        engine.stop()


def phase_moe_parity(torch, dev):
    """mixed_step through the kernels (ARKS_MOE_KERNEL=pallas: the grouped
    matmul and the attention kernels) against the same steps through
    impl="plain" (their plain versions) at Mixtral width, over 2 layers
    with bf16 and with int8 weights (limit 10% of the largest |logit|, as
    phase 5), and over 1 layer in f32 (5e-4).  Both steps group, as every
    step of the served engine does.  The limits hold every lane whose
    sampled token took the same experts on both paths in every layer
    (``_same_routing``); the (token, layer) pairs routed apart are
    counted and logged."""
    from arks_tpu_torch.models import get_config
    from arks_tpu_torch.models import transformer as tf
    cfg = get_config(MOE_MODEL)
    worst = {}
    for layers, dtype, bits, rel, abs_tol in (
            (2, torch.bfloat16, 0, 0.10, 0.0), (2, torch.bfloat16, 8, 0.10, 0.0),
            (1, torch.float32, 0, 0.0, 5e-4)):
        c = dataclasses.replace(cfg, num_layers=layers)
        params = tf.init_params(c, SEED + 7, dtype, dev, bits=bits)
        name = f"{str(dtype).split('.')[1]} {'int8' if bits else 'unquantized'} weights"
        worst[f"{name}, {layers} layer(s)"] = _parity_steps(
            torch, dev, tf, c, params, dtype, rel, abs_tol, None,
            moe_grouped=True)
        del params
        torch.cuda.empty_cache()
    return worst


# ---------------------------------------------------------------------------
# The dense launch of the mixed attention (ARKS_MIXED_GRID=dense)
# ---------------------------------------------------------------------------


def phase_moe(torch, dev):
    """Phase 7, with ARKS_MOE_KERNEL=pallas: the grouped-matmul kernel at
    Mixtral shapes; Mixtral-8x7B served at full width and depth with int8
    weights (phase 4's requests and counts) and traced for one step; a
    short batch with int4 weights; mixed_step parity over cut depth."""
    import os
    os.environ["ARKS_MOE_KERNEL"] = "pallas"
    gm = phase_moe_kernels(torch, dev)
    routes = phase_moe_routes(torch, dev)
    engine, wbytes = _moe_engine(torch, dev, "int8")
    init_peak = torch.cuda.max_memory_allocated()
    serve = phase_serve(torch, dev, "bf16", engine=engine)[1]
    serve.update(weight_bytes=wbytes, init_peak_bytes=init_peak)
    phase_step_profile(torch, dev, engine)
    params = engine.params
    del engine
    torch.cuda.empty_cache()
    serve["pipeline"] = phase_pipeline_moe(torch, dev, params)
    del params
    torch.cuda.empty_cache()
    engine, wbytes4 = _moe_engine(torch, dev, "int4")
    short = phase_serve_moe_short(torch, dev, engine)
    short["weight_bytes"] = wbytes4
    del engine
    torch.cuda.empty_cache()
    worst = phase_moe_parity(torch, dev)
    log(f"[parity] {MOE_MODEL} worst |logit diff| {worst}")
    log(f"[serve {MOE_MODEL}] int8 weights ({wbytes} B): decode "
        f"{serve['decode_tok_s_b1']:.1f} tok/s at batch 1, "
        f"{serve['decode_tok_s_b8']:.1f} at batch 8, TTFT 300 tokens "
        f"{serve['ttft_300_s'] * 1e3:.1f} ms, peak device memory "
        f"{serve['peak_bytes']} B serving, {init_peak} B at init; int4 "
        f"weights ({wbytes4} B): {short['tok_s']:.1f} tok/s over the short "
        "batch")
    return gm, routes, serve, short


def _with_grid(grid, fn):
    import os
    old = os.environ.get("ARKS_MIXED_GRID")
    os.environ["ARKS_MIXED_GRID"] = grid
    try:
        return fn()
    finally:
        if old is None:
            os.environ.pop("ARKS_MIXED_GRID")
        else:
            os.environ["ARKS_MIXED_GRID"] = old


def phase_dense_grid(torch, dev, engine):
    """ARKS_MIXED_GRID=dense on the bf16 Qwen2.5-7B engine: one mixed_step
    (a 300-token chunk crossing a page beside a 40-token one) under the
    dense launch against the same step under the ragged one — logits equal
    bit for bit; then one greedy request under each grid, driven on the
    engine, with identical tokens; the dense run's counts are read (the
    dense launch num_layers x its dispatches, the ragged launch none).
    Returns the dense launch count."""
    from arks_tpu_torch.engine import Request, SamplingParams
    from arks_tpu_torch.models import transformer as tf
    cfg = engine.cfg
    rng = np.random.default_rng(SEED + 8)
    p0 = [int(x) for x in rng.integers(2, cfg.vocab_size, 300)]
    p1 = [int(x) for x in rng.integers(2, cfg.vocab_size, 40)]
    i32 = dict(dtype=torch.int32, device=dev)
    tables = torch.arange(6, **i32).reshape(2, 3)
    args = [torch.as_tensor(np.asarray(a, np.int32), device=dev) for a in (
        p0 + p1, [0] * 300 + [1] * 40, list(range(300)) + list(range(40)),
        [299, 339], [0, 300], [300, 40], [0, 0])]

    def step():
        cache = tf.init_paged_cache(cfg, 6, PAGE, torch.bfloat16, dev)
        return tf.mixed_step(engine.params, cfg, cache, tables, *args)
    logits = {g: _with_grid(g, step) for g in ("ragged", "dense")}
    torch.cuda.synchronize()
    same = torch.equal(logits["ragged"], logits["dense"])
    log(f"[dense grid] mixed_step logits under the dense launch equal the "
        f"ragged launch's bit for bit: {same} (max |diff| "
        f"{(logits['ragged'] - logits['dense']).abs().max().item()})")
    if not same:
        raise AssertionError("the dense launch changed mixed_step's logits")

    def greedy():
        req = Request("dense-grid", p0[:120], SamplingParams(
            max_tokens=24, temperature=0.0, ignore_eos=True))
        engine.add_request(req)
        for _ in range(1000):
            engine.step(block_s=0.01)
            if engine.idle:
                break
        ids = []
        while True:
            out = req.outputs.get(timeout=60)
            ids += out.token_ids
            if out.finished:
                return ids
    ragged = _with_grid("ragged", greedy)
    _reset_counts()
    d0 = engine.dispatches
    dense = _with_grid("dense", greedy)
    launches = _read_counts()
    dispatches = engine.dispatches - d0
    want = cfg.num_layers * dispatches
    expected = {name: 0 for name in launches}
    expected.update(paged_kv_update=want, paged_mixed_attention_dense=want)
    log(f"[dense grid] greedy request (120-token prompt, 24 tokens) under "
        f"each grid: identical {dense == ragged} ({len(dense)} tokens); "
        f"dense run: {dispatches} dispatches, launches {launches}")
    if dense != ragged or len(dense) != 24 or launches != expected:
        raise AssertionError("the dense launch changed the greedy stream or "
                             "its launch counts")
    return launches["paged_mixed_attention_dense"]


# ---------------------------------------------------------------------------
# Phase 8: weights from a checkpoint; the operator's surface
# ---------------------------------------------------------------------------


CKPT_LAYERS = {MODEL: 2, MOE_MODEL: 1}   # depth cut for the smoke's disk
CKPT_TOKENS = 16                          # greedy tokens per served request
OPS_TOKENS = 16                           # tokens per counted request
OPS_QUEUE_MAX, OPS_TENANT_MAX = 4, 3      # the flood's bounds
OPS_HOLD_TOKENS = 128                     # the slot-holding streams
OPS_DRAIN_TOKENS = 48                     # streams in flight at the drain
OPS_WINDOW = 128                          # steps a launch-count window
ST_DTYPES = {"bfloat16": "BF16", "float32": "F32"}


def _write_safetensors(torch, path, tensors: dict) -> int:
    """``tensors`` (CPU) as one safetensors file, written here so the script
    needs no safetensors package: an 8-byte little-endian header length,
    the JSON header, the raw bytes.  Returns the bytes written."""
    import struct
    header, off = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": ST_DTYPES[str(t.dtype).split(".")[1]],
                        "shape": list(t.shape), "data_offsets": [off, off + n]}
        off += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            f.write(memoryview(t.contiguous().view(torch.uint8).numpy()))
    return 8 + len(blob) + off


def _hf_checkpoint(torch, dev, cfg):
    """Random HF-named tensors for ``cfg`` ([out, in] matrices, bf16, drawn
    on the card from SEED, kept on the CPU)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 17)
    e, v, qd, kvd = cfg.hidden_size, cfg.vocab_size, cfg.q_dim, cfg.kv_dim

    def r(*shape, base=0.0):
        x = torch.randn(shape, generator=gen, device=dev).mul_(0.02)
        return x.add_(base).to(torch.bfloat16).cpu()

    t = {"model.embed_tokens.weight": r(v, e),
         "model.norm.weight": r(e, base=1.0)}
    if not cfg.tie_word_embeddings:
        t["lm_head.weight"] = r(v, e)
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = r(e, base=1.0)
        t[p + "post_attention_layernorm.weight"] = r(e, base=1.0)
        for proj, n in (("q", qd), ("k", kvd), ("v", kvd)):
            t[p + f"self_attn.{proj}_proj.weight"] = r(n, e)
            if cfg.qkv_bias:
                t[p + f"self_attn.{proj}_proj.bias"] = r(n)
        t[p + "self_attn.o_proj.weight"] = r(e, qd)
        if cfg.num_experts:
            fm, b = cfg.moe_intermediate_size, p + "block_sparse_moe."
            t[b + "gate.weight"] = r(cfg.num_experts, e)
            for x in range(cfg.num_experts):
                t[b + f"experts.{x}.w1.weight"] = r(fm, e)
                t[b + f"experts.{x}.w3.weight"] = r(fm, e)
                t[b + f"experts.{x}.w2.weight"] = r(e, fm)
        else:
            f = cfg.intermediate_size
            t[p + "mlp.gate_proj.weight"] = r(f, e)
            t[p + "mlp.up_proj.weight"] = r(f, e)
            t[p + "mlp.down_proj.weight"] = r(e, f)
    return t


def _reference_tree(cfg, t) -> dict:
    """The reference's layout of the same tensors (projections [in, out],
    layers stacked), as f32 numpy arrays holding the bf16 values exactly."""
    def a(name, tr=False):
        x = t[name].float()
        return (x.T if tr else x).contiguous().numpy()

    def stack(fmt, tr=False):
        return np.stack([a(fmt.format(i), tr) for i in range(cfg.num_layers)])

    p = "model.layers.{}."
    layers = {"attn_norm": stack(p + "input_layernorm.weight"),
              "mlp_norm": stack(p + "post_attention_layernorm.weight")}
    for leaf, proj in (("wq", "q"), ("wk", "k"), ("wv", "v"), ("wo", "o")):
        layers[leaf] = stack(p + f"self_attn.{proj}_proj.weight", True)
    if cfg.qkv_bias:
        for leaf, proj in (("bq", "q"), ("bk", "k"), ("bv", "v")):
            layers[leaf] = stack(p + f"self_attn.{proj}_proj.bias")
    if cfg.num_experts:
        b = p + "block_sparse_moe."
        layers["router"] = stack(b + "gate.weight", True)
        for leaf, w in (("w_gate", "w1"), ("w_up", "w3"), ("w_down", "w2")):
            layers[leaf] = np.stack([np.stack([
                a(f"model.layers.{i}.block_sparse_moe.experts.{x}.{w}.weight",
                  True) for x in range(cfg.num_experts)])
                for i in range(cfg.num_layers)])
    else:
        for leaf, proj in (("w_gate", "gate"), ("w_up", "up"),
                           ("w_down", "down")):
            layers[leaf] = stack(p + f"mlp.{proj}_proj.weight", True)
    tree = {"embed": a("model.embed_tokens.weight"), "layers": layers,
            "final_norm": a("model.norm.weight")}
    if not cfg.tie_word_embeddings:
        tree["lm_head"] = a("lm_head.weight", True)
    return tree


def _rss_bytes() -> int:
    import os
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def _timed_load(torch, dev, cfg, path, weight_dtype, disk_bytes):
    """``params_from_hf`` timed (synchronised), with its peak device memory
    above what was allocated before it and its peak host RSS above the
    RSS before it (sampled every 2 ms)."""
    from arks_tpu_torch.models.weights import params_from_hf
    torch.cuda.synchronize()
    base_dev = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    base_rss = _rss_bytes()
    peak_rss, stop = [base_rss], threading.Event()

    def sample():
        while not stop.is_set():
            peak_rss[0] = max(peak_rss[0], _rss_bytes())
            time.sleep(0.002)

    th = threading.Thread(target=sample, daemon=True)
    th.start()
    t0 = time.perf_counter()
    params = params_from_hf(cfg, path, "bfloat16", weight_dtype, dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    stop.set()
    th.join()
    tree = sum(x.numel() * x.element_size() for x in _leaves(params))
    return params, dict(seconds=secs, gb_s=disk_bytes / secs / 1e9,
                        tree_bytes=tree,
                        peak_dev=torch.cuda.max_memory_allocated() - base_dev,
                        peak_rss=peak_rss[0] - base_rss)


def _same_tree(torch, got, want, what) -> None:
    g, w = list(_leaves(got)), list(_leaves(want))
    if len(g) != len(w) or not all(
            a.dtype == b.dtype and a.shape == b.shape and torch.equal(
                a.view(torch.uint8), b.view(torch.uint8))
            for a, b in zip(g, w)):
        raise AssertionError(f"[checkpoint] {what}: the loaded tree is not "
                             "the numpy bridge's bit for bit")


def _served_streams(torch, dev, cfg, params, weight_dtype, prompts, tag):
    """Greedy completions, one at a time, through an OpenAIServer on an
    engine built on ``params``.  Returns (texts with usage, counts)."""
    from arks_tpu_torch.engine import EngineConfig, InferenceEngine
    from arks_tpu_torch.engine.tokenizer import ByteTokenizer
    from arks_tpu_torch.server import OpenAIServer
    engine = InferenceEngine(cfg, EngineConfig(
        model=cfg.name, num_slots=8, max_cache_len=MAX_PAGES * PAGE,
        prefill_chunk=PAGE, dtype="bfloat16", kv_cache_dtype="bf16",
        weight_dtype=weight_dtype, seed=SEED), ByteTokenizer(),
        params=params, device=dev)
    server = OpenAIServer(engine, cfg.name, host="127.0.0.1", port=0)
    server.start(background=True)
    engine.start()
    try:
        _reset_counts()
        out = []
        for p in prompts:
            st, data, _, _ = _request(server.port, "/v1/completions", {
                "prompt": p, "max_tokens": CKPT_TOKENS, "temperature": 0,
                "ignore_eos": True})
            if st != 200:
                raise AssertionError(f"[checkpoint] {tag}: HTTP {st} {data}")
            out.append((data["choices"][0]["text"],
                        data["usage"]["completion_tokens"]))
        counts = _read_counts()
    finally:
        server.stop()
        engine.stop()
    del engine
    return out, counts


def phase_checkpoint(torch, dev):
    """Weights from a local HF checkpoint (``models/weights.py``):
    Qwen2.5-7B at full width, 2 layers, bf16 (two shards), loaded in bf16
    and with int8 quantize-on-load, and Mixtral-8x7B at full width, 1
    layer, int8 on load.  Each loaded tree equals ``params_from_numpy`` (and
    ``quantize_params``, the reference's jitted scales) of the same arrays
    bit for bit; greedy streams served from the loaded engine equal those
    of an engine on the bridged tree.  Load seconds, GB/s from the files
    (written just before, so read from the page cache), peak device
    memory above the tree plus one full-width stacked leaf bound, and peak
    host RSS."""
    import dataclasses as dc
    import shutil
    import tempfile

    from arks_tpu_torch.models import get_config
    from arks_tpu_torch.models import quant
    from arks_tpu_torch.models.weights import params_from_numpy
    prompts = ["Weights come from a checkpoint on disk.",
               "A second request on the loaded engine."]
    res, launches = {}, collections.Counter()
    t_phase = time.perf_counter()
    for model, modes in ((MODEL, ("bf16", "int8")), (MOE_MODEL, ("int8",))):
        cfg = dc.replace(get_config(model), num_layers=CKPT_LAYERS[model])
        d = tempfile.mkdtemp(prefix="arks-ckpt-")
        try:
            t0 = time.perf_counter()
            hf = _hf_checkpoint(torch, dev, cfg)
            names = sorted(hf)
            disk = sum(_write_safetensors(
                torch, f"{d}/model-{i + 1:05d}-of-00002.safetensors",
                {n: hf[n] for n in names[i::2]}) for i in range(2))
            log(f"[checkpoint] {model} at full width, {cfg.num_layers} "
                f"layer(s): {len(hf)} tensors, {disk} B in 2 shards, "
                f"written in {time.perf_counter() - t0:.1f} s")
            want = params_from_numpy(_reference_tree(cfg, hf), cfg, dev,
                                     "bfloat16")
            stacked = max(x.numel() for x in _leaves(want)) * 2
            del hf
            for mode in modes:
                want_m = want if mode == "bf16" else \
                    quant.quantize_params(want, bits=8, recip=True)
                if mode != "bf16":
                    torch.cuda.synchronize()
                got, r = _timed_load(torch, dev, cfg, d, mode, disk)
                _same_tree(torch, got, want_m, f"{model} {mode}")
                bound = r["tree_bytes"] + stacked
                log(f"[checkpoint] {model} {mode}: loaded in "
                    f"{r['seconds']:.2f} s ({r['gb_s']:.2f} GB/s from the "
                    f"files), tree {r['tree_bytes']} B, peak device "
                    f"{r['peak_dev']} B against the bound {bound} B (tree + "
                    f"one full-width stacked leaf of {stacked} B), peak host "
                    f"RSS +{r['peak_rss']} B; bit-exact against the bridge")
                if r["peak_dev"] > bound:
                    raise AssertionError(
                        f"[checkpoint] {model} {mode}: peak device memory "
                        f"{r['peak_dev']} B over the bound {bound} B")
                res[(model, mode)] = r
                serve = (model, mode) in ((MODEL, "bf16"), (MOE_MODEL,
                                                             "int8"))
                if serve:
                    a, ca = _served_streams(torch, dev, cfg, got, mode,
                                            prompts, f"{model} loaded")
                    b, _ = _served_streams(torch, dev, cfg, want_m, mode,
                                           prompts, f"{model} bridged")
                    if a != b or any(n != CKPT_TOKENS for _, n in a):
                        raise AssertionError(
                            f"[checkpoint] {model} {mode}: served streams "
                            f"differ: {a} vs {b}")
                    need = ("grouped_matmul",) if cfg.num_experts else \
                        ("paged_kv_update", "paged_mixed_attention")
                    if any(not ca[k] for k in need):
                        raise AssertionError(
                            f"[checkpoint] {model}: kernels not launched "
                            f"serving the loaded engine: {ca}")
                    launches.update(ca)
                    log(f"[checkpoint] {model} {mode}: {len(prompts)} "
                        f"greedy completions of {CKPT_TOKENS} tokens from "
                        f"the loaded engine equal the bridged engine's; "
                        f"launches {dict(ca)}")
                del got, want_m
                torch.cuda.empty_cache()
            del want
            torch.cuda.empty_cache()
        finally:
            shutil.rmtree(d, ignore_errors=True)
    log(f"[checkpoint] phase took {time.perf_counter() - t_phase:.1f} s")
    return res, launches


class _InertMetrics:
    """Stands in for ``EngineMetrics``: every family takes every update
    and does nothing (the launch-count control)."""

    def __getattr__(self, name):
        return self

    def __call__(self, *args, **kw):
        return self


def _metric_value(text: str, key: str) -> float:
    for line in text.splitlines():
        if line.startswith(key + " "):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    try:
        return resp.status, json.loads(raw), dict(resp.getheaders())
    except ValueError:
        return resp.status, raw.decode(), dict(resp.getheaders())


def _post_h(port, body, headers):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
    conn.request("POST", "/v1/completions", json.dumps(body),
                 dict({"Content-Type": "application/json"}, **headers))
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    return resp.status, data, dict(resp.getheaders())


def _steady_launches(torch, engine):
    """(host ms per steady scheduler step over OPS_WINDOW synchronised
    steps, kernel launches per step over a profiler window of as many, and
    those launches by kernel name), 8 streams at depth 2.  The window is
    long, so the events a profiler drops at a window's start move the mean
    by a fraction of a launch."""
    _, _, win = _pipe_batch(torch, engine, [
        f"steady window stream {j}" for j in range(8)],
        2 * OPS_WINDOW + 32, window=True, window_steps=OPS_WINDOW)
    return win[0], win[2], win[3]


def phase_operability(torch, dev, params, step_launches):
    """The operator's surface on Qwen2.5-7B bf16 at the default engine
    shape (depth 2), ``ARKS_QUEUE_MAX`` / ``ARKS_QUEUE_TENANT_MAX`` set.
    First, driven from this thread: host ms and launches per steady step
    with the metrics and the fair queue, then with inert metrics, each
    over a 128-step window — under half a launch a step apart and no
    kernel name launched only with the metrics, so they add no kernel;
    the host ms of both are reported.  Then behind the server, with every issue and admission
    under set_sync_debug_mode("error"): N requests give
    request_success_total N and generation_tokens_total the streamed
    tokens less the N first ones (the reference's rule); /readiness 200
    with its admission block; a two-tenant flood over the bounds gives 429
    (tenant) and 503 (global) with Retry-After, the survivors 200; drain()
    with streams in flight: readiness 503, a new POST 503, every stream
    whole, then the server stops (the drain time)."""
    import os

    from arks_tpu_torch.engine import EngineConfig, InferenceEngine
    from arks_tpu_torch.engine.tokenizer import ByteTokenizer
    from arks_tpu_torch.models import get_config
    from arks_tpu_torch.server import OpenAIServer
    t_phase = time.perf_counter()
    old = {k: os.environ.get(k) for k in ("ARKS_QUEUE_MAX",
                                          "ARKS_QUEUE_TENANT_MAX")}
    os.environ["ARKS_QUEUE_MAX"] = str(OPS_QUEUE_MAX)
    os.environ["ARKS_QUEUE_TENANT_MAX"] = str(OPS_TENANT_MAX)
    try:
        engine = InferenceEngine(get_config(MODEL), EngineConfig(
            model=MODEL, num_slots=8, max_cache_len=MAX_PAGES * PAGE,
            prefill_chunk=PAGE, dtype="bfloat16", kv_cache_dtype="bf16",
            seed=SEED), ByteTokenizer(), params=params, device=dev)
    finally:
        _restore_env(os, old)
    if engine._pipe_depth != 2 or engine._queue.max_total != OPS_QUEUE_MAX:
        raise AssertionError("[operability] not the default engine shape "
                             "with the flood's bounds")
    res = {}
    # The 8-stream windows put 8 requests at once: unbounded meanwhile.
    q = engine._queue
    q.max_total = q.max_tenant = 0
    _pipe_batch(torch, engine, ["warm"] * 8, 8)
    host_real, with_metrics, names_real = _steady_launches(torch, engine)
    real = engine.metrics
    engine.metrics = _InertMetrics()
    try:
        host_inert, inert, names_inert = _steady_launches(torch, engine)
    finally:
        engine.metrics = real
        q.max_total, q.max_tenant = OPS_QUEUE_MAX, OPS_TENANT_MAX
    log(f"[operability] launches per steady step (8 streams, depth 2): "
        f"{with_metrics:.2f} with the metrics and the fair queue, "
        f"{inert:.2f} with inert metrics; the model step of "
        f"phase_step_profile {step_launches:.0f}")
    log(f"[operability] host ms per steady step: {host_real:.3f} with the "
        f"metrics and the fair queue, {host_inert:.3f} with inert metrics "
        f"({host_real - host_inert:+.3f} ms, "
        f"{(host_real / host_inert - 1) * 100:+.1f}%)")
    moved = {k: names_real[k] - names_inert[k]
             for k in names_real | names_inert
             if names_real[k] != names_inert[k]}
    if moved:
        log(f"[operability] launches by kernel name, metrics less inert, "
            f"over the window: {moved}")
    # The profiler drops a window's first events now and then (fewer,
    # never more: ~24 in a window in the runs so far, 0.2 a step here); one
    # added kernel a step would add a whole launch to the mean, and a
    # rarer one a name that only the window with the metrics shows.
    only_real = sorted(set(names_real) - set(names_inert))
    if abs(with_metrics - inert) >= 0.5 or only_real:
        raise AssertionError(f"[operability] the metrics change the kernel "
                             f"launches per step (only with them: "
                             f"{only_real})")
    res["launches_per_step"] = (with_metrics, inert)
    res["host_ms_per_step"] = (host_real, host_inert)

    server = OpenAIServer(engine, MODEL, host="127.0.0.1", port=0)
    server.start(background=True)
    engine.start()
    port = server.port
    guard = _NoSync(torch, engine, ("_pipe_issue", "_issue_mixed",
                                    "_admit"))
    try:
        with guard:
            deadline = time.monotonic() + 60
            while _get(port, "/readiness")[0] != 200:
                if time.monotonic() > deadline:
                    raise AssertionError("[operability] never ready")
                time.sleep(0.05)
            st, ready, _ = _get(port, "/readiness")
            if set(ready) != {"status", "admission", "slo_burn"} or \
                    ready["admission"]["queue_max"] != OPS_QUEUE_MAX:
                raise AssertionError(f"[operability] readiness {ready}")
            _reset_counts()
            text0 = _get(port, "/metrics")[1]
            n, got = 6, []
            for wave in range(2):       # 3 at once: inside the bounds
                threads = []
                for i in range(3 * wave, 3 * wave + 3):
                    body = {"prompt": f"operability request {i}",
                            "max_tokens": OPS_TOKENS + i, "temperature": 0,
                            "ignore_eos": True}
                    th = threading.Thread(target=lambda b=body: got.append(
                        _post_h(port, b, {})))
                    th.start()
                    threads.append(th)
                for th in threads:
                    th.join(600)
            if sorted(g[0] for g in got) != [200] * n:
                raise AssertionError(f"[operability] requests: {got}")
            streamed = sum(g[1]["usage"]["completion_tokens"] for g in got)
            text1 = _get(port, "/metrics")[1]
            key_ok = 'request_success_total{reason="length"}'
            succ = _metric_value(text1, key_ok) - _metric_value(text0, key_ok)
            gen = (_metric_value(text1, "generation_tokens_total")
                   - _metric_value(text0, "generation_tokens_total"))
            log(f"[operability] /metrics after {n} requests: "
                f"request_success_total +{succ:.0f}, "
                f"generation_tokens_total +{gen:.0f} ({streamed} streamed, "
                f"{n} of them first tokens)")
            if succ != n or gen != streamed - n:
                raise AssertionError("[operability] /metrics disagrees with "
                                     "the served requests")
            res["counts"] = _read_counts()

            # The flood: 8 long streams hold every slot, then two tenants.
            holds, held = [], []
            for i in range(8):           # one at a time: inside the bounds
                th = threading.Thread(target=lambda i=i: held.append(_post_h(
                    port, {"prompt": f"hold slot {i}",
                           "max_tokens": OPS_HOLD_TOKENS, "temperature": 0,
                           "ignore_eos": True}, {})))
                th.start()
                holds.append(th)
                deadline = time.monotonic() + 120
                while engine.num_running < i + 1 or \
                        not engine._queue.empty():
                    if time.monotonic() > deadline:
                        raise AssertionError("[operability] slots never "
                                             "filled")
                    time.sleep(0.005)
            flood, queued = [], []

            def queue_one(tenant):
                th = threading.Thread(target=lambda: flood.append(_post_h(
                    port, {"prompt": f"flood {tenant}", "max_tokens": 8,
                           "temperature": 0, "ignore_eos": True},
                    {"x-arks-tenant": tenant})))
                th.start()
                queued.append(th)
                until = time.monotonic() + 30
                while engine._queue.qsize() < len(queued):
                    if time.monotonic() > until:
                        raise AssertionError("[operability] not queued")
                    time.sleep(0.005)

            for _ in range(OPS_TENANT_MAX):
                queue_one("tenant-a")
            st_t, err_t, h_t = _post_h(port, {"prompt": "one more",
                                              "max_tokens": 8},
                                       {"x-arks-tenant": "tenant-a"})
            for _ in range(OPS_QUEUE_MAX - OPS_TENANT_MAX):
                queue_one("tenant-b")
            st_g, err_g, h_g = _post_h(port, {"prompt": "one more",
                                              "max_tokens": 8},
                                       {"x-arks-tenant": "tenant-b"})
            log(f"[operability] flood: tenant bound -> {st_t} "
                f"{err_t['error']['code']} Retry-After "
                f"{h_t.get('Retry-After')}; global bound -> {st_g} "
                f"{err_g['error']['code']} Retry-After "
                f"{h_g.get('Retry-After')}")
            if not (st_t == 429 and err_t["error"]["code"] ==
                    "tenant_queue_full" and int(h_t["Retry-After"]) >= 1
                    and h_t.get("x-arks-tenant") == "tenant-a"
                    and st_g == 503 and err_g["error"]["code"] ==
                    "queue_full" and int(h_g["Retry-After"]) >= 1):
                raise AssertionError("[operability] the flood's refusals")
            for th in holds + queued:
                th.join(900)
            if sorted(f[0] for f in flood + held) != \
                    [200] * (OPS_QUEUE_MAX + 8):
                raise AssertionError(f"[operability] survivors: {flood}")

            # Drain with streams in flight.
            frames = [[] for _ in range(2)]

            def stream(i):
                frames[i] = _request(port, "/v1/completions", {
                    "prompt": f"drain stream {i}",
                    "max_tokens": OPS_DRAIN_TOKENS, "temperature": 0,
                    "ignore_eos": True, "stream": True,
                    "stream_options": {"include_usage": True}},
                    stream=True)

            streams = [threading.Thread(target=stream, args=(i,))
                       for i in range(2)]
            for th in streams:
                th.start()
            deadline = time.monotonic() + 120
            while engine.num_running < 2:
                if time.monotonic() > deadline:
                    raise AssertionError("[operability] streams never ran")
                time.sleep(0.005)
            t_drain = time.perf_counter()
            drainer = threading.Thread(target=server.drain, args=(120.0,))
            drainer.start()
            while not server.draining:
                time.sleep(0.001)
            st_r = _get(port, "/readiness")[0]
            st_p, err_p, _ = _post_h(port, {"prompt": "late"}, {})
            for th in streams:
                th.join(300)
            drainer.join(300)
            drain_s = time.perf_counter() - t_drain
            whole = [fr[0] == 200 and _stream_summary(fr[1])[1] == ["length"]
                     and _stream_summary(fr[1])[2][0]["completion_tokens"]
                     == OPS_DRAIN_TOKENS for fr in frames]
            log(f"[operability] drain with 2 streams in flight: readiness "
                f"{st_r}, new POST {st_p} ({err_p['error']['message']}), "
                f"streams whole {whole}, server stopped after "
                f"{drain_s:.2f} s")
            if st_r != 503 or st_p != 503 or not all(whole):
                raise AssertionError("[operability] the drain")
            res["drain_s"] = drain_s
    finally:
        server.stop()
        engine.stop()
    log(f"[operability] every issue and admission ({guard.issues}: "
        f"{dict(guard.calls)}) passed set_sync_debug_mode('error'); phase "
        f"took {time.perf_counter() - t_phase:.1f} s")
    del engine
    return res


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    phase_device(torch)
    phase_build()
    b, upd_err, attn_err = phase_kernels(torch, dev)
    qres = phase_quant_kernels(torch, dev, b)
    phase_span_chain(torch, b, qres)
    phase_prng(torch, dev)
    lb, legacy_err = phase_legacy_kernels(torch, dev)
    phase_fault_kernels(torch, dev, b, lb)
    engine, serve = phase_serve(torch, dev)
    dense_launches = phase_dense_grid(torch, dev, engine)
    surface, _ = phase_surface(torch, dev, engine, "mixed bf16")
    surface_step = phase_surface_step(torch, dev, engine)
    params = engine.params
    del engine
    torch.cuda.empty_cache()
    pipeline = phase_pipeline(torch, dev, params)
    prefix = phase_prefix(torch, dev, params)
    legacy = {(layout, kv): phase_serve_legacy(
        torch, dev, layout, kv, params, surface=(layout, kv) == ("slot",
                                                                 "bf16"))
        for layout, kv in (("slot", "bf16"), ("slot", "int8"),
                           ("paged", "int8"), ("paged", "int4"))}
    engine, serve8 = phase_serve(torch, dev, "int8", params)
    f32 = phase_serve_f32(torch, dev)
    log(f"[serve] bf16 vs int8 pool on the same weights: K+V pool bytes "
        f"{serve['pool_bytes']} vs {serve8['pool_bytes']}; decode tok/s "
        f"batch 1 {serve['decode_tok_s_b1']:.1f} vs "
        f"{serve8['decode_tok_s_b1']:.1f}, batch 8 "
        f"{serve['decode_tok_s_b8']:.1f} vs {serve8['decode_tok_s_b8']:.1f}; "
        f"TTFT 300 tokens {serve['ttft_300_s'] * 1e3:.1f} vs "
        f"{serve8['ttft_300_s'] * 1e3:.1f} ms")
    worst = phase_parity(torch, dev, engine)
    log(f"[parity] worst |logit diff| per dtype and pool {worst}")
    step_launches = [phase_step_profile(torch, dev, engine, kv)[2]
                     for kv in (None, "int8")][0]
    for kv in ("bf16", "int8"):
        phase_decode_profile(torch, dev, engine, kv)
    phase_pipe_step_profile(torch, dev, engine)
    del engine
    torch.cuda.empty_cache()
    ops = phase_operability(torch, dev, params, step_launches)
    del params
    torch.cuda.empty_cache()
    upd_t, attn_t, dense_t = phase_times(torch, b)
    qupd_t, qattn_t = phase_quant_times(torch, b, qres)
    lt = phase_legacy_times(torch, lb)
    log_row_writes(upd_t, qupd_t, lt)
    quant_err = qres["int8"][1]
    del b, lb, qres
    torch.cuda.empty_cache()
    ckpt, ckpt_n = phase_checkpoint(torch, dev)
    gm, routes, moe_serve, moe_short = phase_moe(torch, dev)
    gm_row = gm[("528-row", "gate", "int8")]
    slot16, slot8 = legacy[("slot", "bf16")], legacy[("slot", "int8")]
    paged8, paged4 = legacy[("paged", "int8")], legacy[("paged", "int4")]
    pipe_n = collections.Counter(pipeline["launches"])
    pipe_n.update(prefix["launches"])     # served at the defaults, as are
    pipe_n.update(ops["counts"])          # the operability engine and the
    pipe_n.update(ckpt_n)                 # checkpoint-loaded ones
    attn_launches = (serve["launches"]["paged_mixed_attention"]
                     + serve8["launches"]["paged_mixed_attention"]
                     + paged4["launches"]["paged_mixed_attention"]
                     + f32["paged_mixed_attention"]
                     + surface["paged_mixed_attention"]
                     + pipe_n["paged_mixed_attention"])
    for (sched, tag), row in pipeline["rows"].items():
        log(f"[pipeline table] {sched} {tag}: " + ", ".join(
            f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items()))
    for tag, row in prefix["rows"].items():
        log(f"[prefix table] {tag}: {json.dumps(row)}")
    for (route, mode), rec in routes.items():
        log(f"[routes table] {route} {mode}: kernel {rec['ms'] * 1e3:.1f} us"
            f", convert path {rec['plain_ms'] * 1e3:.1f} us, bound "
            f"{rec['bound_ms'] * 1e3:.1f} us ({rec['bound_by']}), kernels "
            f"per call {rec['launches']['route']:.0f} vs "
            f"{rec['launches']['convert']:.0f}, max abs err "
            f"{rec['max_abs_err']:.3e}")
    log(f"[surface step] every feature off / on, per decode step: mixed "
        f"{surface_step['off'][1]:.1f} / {surface_step['on'][1]:.1f} us "
        f"device, {surface_step['off'][2]:.2f} / {surface_step['on'][2]:.2f}"
        f" launches; legacy slot {slot16['step']['off'][1]:.1f} / "
        f"{slot16['step']['on'][1]:.1f} us, {slot16['step']['off'][2]:.2f} "
        f"/ {slot16['step']['on'][2]:.2f} launches (the argmax step "
        f"{slot16['step']['argmax'][2]:.2f})")
    kernels = [
        dict(name="paged_kv_update", route="cuda", source=UPDATE_SRC,
             replaces="arks_tpu/ops/paged_attention.py:1127",
             launches=(serve["launches"]["paged_kv_update"]
                       + f32["paged_kv_update"]
                       + surface["paged_kv_update"]
                       + pipe_n["paged_kv_update"]),
             max_abs_err=upd_err, **upd_t),
        dict(name="paged_mixed_attention", route="cuda", source=ATTN_SRC,
             replaces="arks_tpu/ops/paged_attention.py:761",
             launches=attn_launches, max_abs_err=attn_err, **attn_t),
        dict(name="paged_kv_update_quant", route="cuda", source=QUANT_SRC,
             replaces="arks_tpu/ops/paged_attention.py:1215",
             launches=(serve8["launches"]["paged_kv_update_quant"]
                       + paged8["launches"]["paged_kv_update_quant"]
                       + paged4["launches"]["paged_kv_update_quant"]
                       + pipe_n["paged_kv_update_quant"]),
             max_abs_err=quant_err, **qupd_t["int8"]),
        dict(name="paged_decode_attention", route="cuda", source=DECODE_SRC,
             replaces="arks_tpu/ops/paged_attention.py:388",
             launches=(paged8["launches"]["paged_decode_attention"]
                       + f32["paged_decode_attention"]
                       + pipe_n["paged_decode_attention"]),
             max_abs_err=legacy_err["paged_decode_attention"],
             **lt["paged_decode_attention"]),
        dict(name="ragged_decode_attention", route="cuda", source=DECODE_SRC,
             replaces="arks_tpu/ops/pallas_attention.py:58",
             launches=(slot16["launches"]["ragged_decode_attention"]
                       + slot8["launches"]["ragged_decode_attention"]
                       + f32["ragged_decode_attention"]
                       + slot16["surface"]["ragged_decode_attention"]
                       + pipe_n["ragged_decode_attention"]),
             max_abs_err=legacy_err["ragged_decode_attention"],
             **lt["ragged_decode_attention"]),
        dict(name="kv_cache_update", route="cuda", source=SLOT_UPDATE_SRC,
             replaces="arks_tpu/ops/pallas_attention.py:241",
             launches=(slot16["launches"]["kv_cache_update"]
                       + f32["kv_cache_update"]
                       + slot16["surface"]["kv_cache_update"]
                       + pipe_n["kv_cache_update"]),
             max_abs_err=legacy_err["kv_cache_update"],
             **lt["kv_cache_update"]),
        dict(name="kv_cache_update_quant", route="cuda",
             source=SLOT_UPDATE_SRC,
             replaces="arks_tpu/ops/pallas_attention.py:354",
             launches=(slot8["launches"]["kv_cache_update_quant"]
                       + pipe_n["kv_cache_update_quant"]),
             max_abs_err=legacy_err["kv_cache_update_quant"],
             **lt["kv_cache_update_quant"]),
        dict(name="paged_mixed_attention_dense", route="cuda",
             source=ATTN_SRC,
             replaces="arks_tpu/ops/paged_attention.py:675",
             launches=dense_launches, max_abs_err=attn_err, **dense_t),
        dict(name="grouped_matmul", route="cuda", source=GROUPED_SRC,
             replaces="arks_tpu/ops/moe_kernel.py:81",
             launches=(moe_serve["launches"]["grouped_matmul"]
                       + moe_short["launches"]["grouped_matmul"]
                       + ckpt_n["grouped_matmul"]),
             **gm_row),
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for (model, mode), r in ckpt.items():
        log(f"[checkpoint table] {model} {mode}: load {r['seconds']:.2f} s, "
            f"{r['gb_s']:.2f} GB/s, tree {r['tree_bytes']} B, peak device "
            f"+{r['peak_dev']} B, peak host RSS +{r['peak_rss']} B")
    log(f"[operability table] launches per steady step "
        f"{ops['launches_per_step'][0]:.2f} with metrics, "
        f"{ops['launches_per_step'][1]:.2f} inert; host ms per steady step "
        f"{ops['host_ms_per_step'][0]:.3f} with metrics, "
        f"{ops['host_ms_per_step'][1]:.3f} inert; drain "
        f"{ops['drain_s']:.2f} s")
    log(f"[done] all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys}
                                  for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

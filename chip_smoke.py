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
              num_layers x (mixed dispatches + those that carried prefill
              chunks, which run a decode block and a chunk block) (q, k,
              v, o and the FFN's three, grouped or dense), with peak
              device memory, and one
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
              and of those with request tracing off over 128-step windows
              (no added launch; the profiler may drop a window's first
              events); behind the server,
              every issue and admission under set_sync_debug_mode
              ("error"): /metrics counts N successes and the generated
              tokens, /readiness 200, a two-tenant flood gives 429 and
              503 with Retry-After and the survivors 200, drain() with
              two streams in flight turns readiness 503, refuses a new
              POST with 503 and lets both streams finish whole; the
              engine is then freed by del, with no GC pass.
  9. recovery fault isolation and token replay on Qwen2.5-7B bf16 at full
              width (phase_recovery), 8 streams of 64 tokens, greedy and
              seeded sampling, every dispatch issue sync-checked: on the
              mixed bf16 paged engine at depths 0 and 2 and the legacy
              bf16 slot engine at depth 0, decode:5:runtime gives every
              stream of the fault-free run (a divergence must come as a
              replay_diverged error) and decode:5:runtime,
              replay:1:runtime quarantines exactly one; recovery seconds
              and the peak device memory across a recovery against a
              fault-free run's; admit_resolve:1:oom re-queues (legacy); a
              restore fault on a host-tier hit is blamed on the restoring
              request alone and fails no stream, the replayed bystander's
              whole stream equal to the fault-free round's (mixed, depth
              2); a decode lane's logits are bit-equal in the pipe step
              and in the classic mixed step with a prefill chunk beside it
              (its decode block split from the chunk block); every
              engine is freed by del, with no GC pass (what holds one
              that is not is logged, and the phase fails); the tracer's
              events per steady step
              and ns per evt (phase_operability holds the launches per
              steady step with tracing off to those with it on, by kernel
              name); a profiler window holds the port's kernels and the
              arks_step annotations; in subprocesses (2 layers), a hang
              past a 2 s ARKS_DISPATCH_DEADLINE_S (the exit timed from the
              hang's start) and a device-side assert
              inside a step each end in exit 70 with readiness 503
              "wedged", the assert's requests in flight answered 500
              engine_fault.
 10. preemption (phase_preempt) on Qwen2.5-7B bf16 at full width, the SLO
              ladder latency:ttft_ms=300,batch:, ARKS_PREFIX_HOST_MB=1024,
              ARKS_PREEMPT_MAX_INFLIGHT=2: 8 batch-tier streams of
              512-token prompts and 96 tokens (greedy, seeded, one with
              penalties, one guided), then 2 latency-tier arrivals
              (64-token prompts, 32 tokens) after 16 decode dispatches,
              which seize running slots.  ARKS_PREEMPT=0 is the baseline;
              swap mode at depths 0 and 2, an int8 pool (its own
              baseline), replay mode on the legacy bf16 slot cache (its
              own baseline), preempt:1:runtime and an abort of a swapped
              victim each give every stream of their baseline (the
              aborted one a prefix), no replay_diverged, 2 preemptions a
              round, the fault blamed on the victim alone, no host bytes
              left, no host sync on any issue; logs preempt_swap_seconds
              by leg, bytes per victim, the arrivals' median TTFT on and
              off, the peak device memory, and launches per steady step
              with ARKS_PREEMPT 0 and 1 by kernel name.
 11. speculative decoding (phase_spec) on Qwen2.5-7B bf16 at full width
              with a self-draft on the same weights (draft_len 4): 8
              batch-tier streams (greedy and seeded) and 2 latency-tier
              arrivals; the target alone, the spec engine at depths 2 and
              0, with spec:5:runtime and with ARKS_PREEMPT=1 (replay
              mode) each give the depth-2 baseline's streams whole, an
              int8 pool round; greedy spec streams equal the target's or
              leave it first at a top-2 gap below SPEC_GAP_BOUND; every
              issue sync-checked; each round's kernels count num_layers x
              dispatches (the verify block) and num_layers x draft_len x
              dispatches (the draft's slot writes and decode attention).
              An f32 self-draft (2 layers) equals the target-only engine
              with acceptance >= 0.95.  Qwen2.5-1.5B with a Qwen2.5-0.5B
              draft served through the server's build_engine (head_dim
              64, G 7 on the slot kernels; G 6 on the mixed attention).
              Logs acceptance, accepted length, a spec step beside a pipe
              step, tok/s on and off, draft cache bytes, peak memory.
 12. the weight pool (phase_pool) on Qwen2.5-7B bf16 (the pinned primary,
              8 slots x 4096, depth 2) with Qwen2.5-1.5B and Qwen2.5-0.5B
              registered, ARKS_MODEL_POOL_HBM_MB from the trees' bytes so
              that 7B + 1.5B fit and the three do not: rounds of 4 greedy
              and 4 seeded streams to 7B, 1.5B, 0.5B, 1.5B, 7B, each
              arriving while the one before decodes; the 1.5B evicted and
              back as a cold start; every stream equal, bit for bit and cut
              alike, to its single-model engine's; every issue
              sync-checked; switch seconds, the dispatches during each
              load, resident bytes beside memory_allocated, peak memory.
              The server's entry: --extra-model, --model-pool-hbm-mb and a
              pinned --draft-model in the pool, /v1/models with the arks
              blocks, a request to the extra model, 404 for an unknown one.
 13. scale-to-zero (phase_zero) on the same engine shape with
              ARKS_ELASTIC_IDLE_ZERO_S=1 behind the server: after a greedy
              and a seeded request the engine disarms, memory_allocated
              and memory_reserved fall by at least its weights plus its
              K+V pool, readiness 503 "scaled to zero (disarmed)",
              /v1/elastic/status armed false; the same requests re-arm it
              and give the same streams; the steady step's launches after
              the re-arm within half a launch of phase_operability's.
 14. windowed residency (phase_residency) on Qwen2.5-7B bf16, one slot,
              ARKS_RESIDENCY_WINDOW_PAGES=6 (1,536 tokens), a 1,200-token
              prompt and 512 tokens: greedy with logprobs at depth 2 (bf16
              pool), seeded at depth 0 (bf16), greedy with logprobs at
              depth 2 (int8), each equal bit for bit (logprobs included)
              to a control with the window off; spans and prefetched
              pages, host and device ms and launches of a windowed token
              beside a control token, its host-to-device copy time and
              overlap, the host store's bytes, peak memory.
 15. disaggregation (phase_disagg) on Qwen2.5-7B at full width and
              depth: the prefill server a child process (``python -m
              arks_tpu_torch.server --disaggregation-mode prefill``), the
              DecodeServer here, bf16 then int8 pool, depth 2, eight
              requests of 100-1,024 tokens (greedy, seeded, logprobs, a
              guide) concurrently with every issue and prefilled admission
              under the sync guard: each served stream equals the same
              pulled state's stream in process bit for bit, each prompt's
              full pool pages equal insert_pages of the received K/V byte
              for byte, greedy streams keep the near-tie rule against the
              unified engine's; bytes per transfer, pull seconds, TTFTs.
 16. the fleet's prefix tiers (phase_fleet) on Qwen2.5-7B: replica B
              restores a 1,024-token prefix from replica A over GET
              /v1/cache/blocks/ (x-arks-peer-hint), its pages A's bytes
              and its stream A's warm stream; A's sketch lists the warm
              digests at tier 0; a disk-tier engine rebuilt on its
              directory serves the prefix from disk (tier="disk" hits,
              the warm stream), and scale-to-zero leaves its warm blocks
              on disk.
 17. training (phase_train, after phase 7, ARKS_MOE_KERNEL=auto: the
              grouped matmul has no backward) in f32 from seed-drawn
              weights on a seeded ByteTokenizer corpus packed by
              PackedDataset: (a) Qwen2.5-1.5B at full width and depth,
              8 x 512 tokens, AdamW lr 1e-4, 8 steps (losses, CUDA-event
              ms, tok/s, peak memory beside the 24.70 GB state; the loss
              falls); one step profiled (aten-level launches); the
              training forward's last-position logits against prefill's
              (1e-5 of max |logit|); a second run's first four losses
              bit-identical; a save at step 2, a restore into a fresh
              state (peak within the state + its largest leaf + 64 MiB)
              whose next two losses and final leaves (params, moments,
              count) equal the uninterrupted run's bit for bit.  (b)
              Qwen2-57B-A14B at full widths, 1 layer, 4 x 512, 3 steps
              twice (losses bit-identical and falling; the first step's
              gradients nonzero on the router, the shared expert and its
              gate, and on exactly the experts that received rows).  (c)
              ``python -m arks_tpu_torch.train --model qwen2.5-0.5b``
              without --device, 6 steps with checkpoints every 3, then
              12 resumed from step 6.  None of the nine kernels launches.
 18. the operator and the gateway (phase_operator, last): this process
              runs the port's build_manager over a LocalProcessDriver and
              its Gateway, and applies examples/quickstart/
              quickstart_torch.yaml: two ``python -m arks_tpu_torch.server``
              replicas of Qwen2.5-7B at full width and depth (random
              weights from SEED, 8 slots x 1024) on this card behind a
              token (RPM 20) and a Quota.  Both reach Running and the
              Endpoint lists both; each says (GET /v1/device) it serves on
              the CUDA device in the driver's process holding at least
              its weight bytes; eight greedy requests through the gateway
              (4 completions, 4 chats, 4 streamed) equal, but for ids and
              timestamps, the same requests sent straight to the replica
              that served each (its finished-request counter), and the
              replicas' kernel counters moved; the Quota's usage is the
              sum of the responses' usage; the request past the RPM limit
              gets 429 and moves no replica's counter; --num-slots 8 -> 6
              rolls the replicas one at a time while a client through the
              gateway sees every request finish whole and the old
              replicas exit 0 after their drain; deleting the Application
              stops both and the card's free memory comes back within
              1 GiB.  TTFT and total time of a 32-token stream through the
              gateway and direct (medians of 5), each replica's time to
              Running and the roll's time are logged.
 19. a DisaggregatedApplication behind the port's router (phase_router,
              last): the same build_manager and Gateway (on the native
              counter store and SSE scanner, built with g++ there) apply
              examples/quickstart/disaggregated_torch.yaml: one prefill
              and two decode replicas of Qwen2.5-7B at full width and
              depth and ``python -m arks_tpu_torch.router --policy
              cache_aware``, on this card.  The three components and the
              app reach Running; the discovery file lists the prefill and
              both decode addresses; the Endpoint routes to the router's
              Service and its readiness is 200; eight greedy requests
              (4 completions, 4 chats, 4 streamed, top-2 logprobs) go
              gateway -> router -> decode, the K/V pulled from the prefill
              replica, and each equals the same request sent straight to
              the decode replica that served it under phase_disagg's
              near-tie rule; both decode replicas' #1 and #2 counters
              moved; a 768-token prefix in token ids with 6 distinct
              32-token tails, one after another: after the first, each
              lands on the decode replica that holds the prefix, which
              the router counts as 5 sketch hits of 3 device blocks; the
              request past the RPM limit gets 429 from the native store
              and moves no replica's or router's counter; deleting the
              app stops the four processes and the card's memory comes
              back.  Logs seconds to Running per component, TTFT and
              total of a 32-token stream through gateway -> router and
              direct (medians of 5), the bytes and seconds of a pull.
phase_pipeline, phase_recovery's engines, the preemption rounds (not
their steady window) and phase_spec run Qwen2.5-7B at full width cut to
its first CUT_LAYERS (4) of 28 layers, phase_residency to RES_LAYERS (3):
their checks hold engines of one shape against each other, and the cut
keeps the script well inside its time limit.
The line before the last is the kernels JSON (nine counterparts); the last
line is the device JSON.  A kernel's "launches" counts its launches in the
runs of the served path: phase 4's, the request surface's, the pipeline's,
prefix reuse's, operability's, the recovery phase's (its replays
included), the preemption phase's, the speculative phase's (the draft's
slot-cache kernels), the pool's, scale-to-zero's, residency's (its span
chains), the disaggregated decode engines' and the fleet replicas', the
operator's and the router phase's replicas' over their eight gateway
requests (read from each replica's GET /v1/device before and after), and
the checkpoint-loaded engines'
included
(the dense launch: its greedy run) and phase 7's (grouped_matmul, every
quantized product).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import http.client
import json
import logging
import math
import subprocess
import sys
import threading
import time
import weakref

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
# Qwen2.5-7B cut in depth (its first layers, full width) for the phases
# whose checks compare engines of one shape with each other, so that the
# whole script stays well inside its time limit.
CUT_LAYERS = 4
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


def _reset_counts():
    from arks_tpu_torch.ops import kernel_wrappers
    for fn in kernel_wrappers().values():
        fn.launches = 0


def _read_counts():
    from arks_tpu_torch.ops import kernel_launches
    return kernel_launches()


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
        p0, marks0 = engine.pipe_dispatches, _marks(engine)

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
        expected["grouped_matmul"] = _gm_launches(engine, marks0)
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


# Names the profiler's own summaries leave out (torch.autograd.profiler's
# _filter_name).
_UNLISTED_OPS = frozenset(("aten::is_leaf", "aten::output_nr",
                           "aten::_version"))


def _trace_counts(torch, prof, bracket=False):
    """A finished profiler window read from its raw trace results: (device
    events by name, their device µs, the host's aten ops by name) — what
    ``key_averages`` sums, without the per-event records it builds first
    (tens of seconds for a window of 10^5 kernels).  With ``bracket``,
    only the device events that start between the window's two marker
    kernels (``_window_marker``) count."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    kern, ops, us = collections.Counter(), collections.Counter(), 0.0
    events = list(prof.profiler.kineto_results.events())
    lo, hi = None, None
    if bracket:
        marks = sorted(ev.start_ns() for ev in events
                       if ev.device_type() == cuda
                       and MARKER_KERNEL in ev.name())
        if len(marks) != 2:
            raise AssertionError(f"the profiler's trace holds {len(marks)} "
                                 f"window markers, not 2")
        lo, hi = marks
    for ev in events:
        dt, name = ev.device_type(), ev.name()
        if dt == cuda:
            if lo is not None and not lo < ev.start_ns() < hi:
                continue
            kern[name] += 1
            us += (ev.end_ns() - ev.start_ns()) / 1e3
        elif dt == cpu and name.startswith("aten::") and \
                name not in _UNLISTED_OPS:
            ops[name] += 1
    return kern, us, ops


# A window's marker: the kernel ``torch.cuda._sleep`` launches, which the
# port never launches.
MARKER_KERNEL = "spin_kernel"


def _window_marker(torch):
    """One marker kernel on the current stream: the port's steps issue on
    that stream, so every kernel a step launches after it starts after it
    on the device."""
    torch.cuda._sleep(1)


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
        kern, us, aten = _trace_counts(torch, prof)
        seen = (us, sum(kern.values()))
        if seen[1] > best[1]:
            best = seen
        ops = ops or aten
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
                                       qmax=1)
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


def _pipe_engine(torch, dev, params, sched, depth, fuse, cfg=None):
    """A Qwen2.5-7B engine on ``params`` (``cfg``, by default the full
    model; bf16, 8 slots x 4096, chunk 256): the mixed scheduler on a bf16
    pool or the legacy one on the bf16 slot cache, at pipeline depth
    ``depth`` with fusion ``fuse``."""
    import os

    from arks_tpu_torch.engine import EngineConfig, InferenceEngine
    from arks_tpu_torch.engine.tokenizer import ByteTokenizer
    from arks_tpu_torch.models import get_config
    old = {k: os.environ.get(k) for k in ("ARKS_PIPELINE_DEPTH",
                                          "ARKS_SAMPLER_FUSE")}
    os.environ.update(ARKS_PIPELINE_DEPTH=depth, ARKS_SAMPLER_FUSE=fuse)
    try:
        engine = InferenceEngine(cfg or get_config(MODEL), EngineConfig(
            model=MODEL, num_slots=8, max_cache_len=MAX_PAGES * PAGE,
            prefill_chunk=PAGE, dtype="bfloat16", kv_cache_dtype="bf16",
            kv_layout="paged" if sched == "mixed" else "slot", seed=SEED),
            ByteTokenizer(), params=params, device=dev)
    finally:
        _restore_env(os, old)
    if engine._mixed != (sched == "mixed"):
        raise AssertionError(f"[pipeline {sched}] wrong scheduler")
    return engine


def _cut_model(params, layers=None):
    """(config, params) of MODEL cut to its first ``layers`` (default
    CUT_LAYERS) layers: the published widths, the stacked layer leaves
    sliced (views, no copy)."""
    from arks_tpu_torch.models import get_config
    layers = layers or CUT_LAYERS

    def cut(x):
        return {k: v[:layers] for k, v in x.items()} \
            if isinstance(x, dict) else x[:layers]

    cfg = dataclasses.replace(get_config(MODEL), num_layers=layers)
    return cfg, dict(params, layers={k: cut(v) for k, v in
                                     params["layers"].items()})


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
                window_steps=None, lead_in=0):
    """One greedy request per prompt, added together and driven by
    ``engine.step()`` from this thread until the engine is idle.  Returns
    (streams, decode seconds: from the step at which the last stream got
    its first token to the end, and with ``window``, once every stream
    has decoded 4 scheduler steps: (host ms per scheduler step over
    synchronised steps covering PIPE_WINDOW decode steps, or
    ``window_steps`` scheduler steps, then device µs and kernel launches
    per scheduler step from torch.profiler over the next as many, and
    those launches by kernel name)).  With ``lead_in``, the profiler
    records that many steps first and counts only the window's steps,
    between two marker kernels: the events the trace drops at a session's
    start fall in the lead-in."""
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
                for _ in range(lead_in):
                    engine.step(block_s=0.001)
                if lead_in:
                    _window_marker(torch)
                for _ in range(steps):
                    engine.step(block_s=0.001)
                if lead_in:
                    _window_marker(torch)
                torch.cuda.synchronize()
            kern, us, _ = _trace_counts(torch, prof, bracket=lead_in > 0)
            win = (host_ms, us / steps, sum(kern.values()) / steps, kern)
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
    """The reference's default engine shape on Qwen2.5-7B at full width,
    cut to CUT_LAYERS layers (``params``: phase 4's bf16 weights, their
    first layers), on the mixed scheduler (bf16
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
    cut_cfg, params = _cut_model(params)
    prompts = [f"lane {i} of the pipeline" for i in range(8)]
    total = collections.Counter()
    rows = {}
    for sched in ("mixed", "legacy"):
        base = None
        for tag, depth, fuse in PIPE_CONFIGS:
            if sched == "legacy" and tag == "depth 0, fusion on":
                continue
            name = f"[pipeline {sched} {tag}]"
            engine = _pipe_engine(torch, dev, params, sched, depth, fuse,
                                  cut_cfg)
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
    by its rule on 8 tokens) beside the sequential decode-only mixed step
    (the same rows and dispatch) on the same 8 lanes at context 512,
    greedy, in one call: (host ms, device ms, launches) per step of each,
    from ``_profile_step``."""
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
                               lengths, qmax=1)
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
        f"grouped {moe.use_grouped(lanes)}) host "
        f"{res['sequential'][0]:.2f} ms,"
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
    marks0 = _marks(engine)
    with _NoSync(torch, engine) as nosync:
        _, secs, _ = _pipe_batch(torch, engine, prompts, 16)
    pipe, n = engine.pipe_dispatches - p0, engine.dispatches - d0
    launches = _read_counts()
    want = {"paged_kv_update": engine.cfg.num_layers * n,
            "paged_mixed_attention": engine.cfg.num_layers * n,
            "grouped_matmul": _gm_launches(engine, marks0)}
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
    """grouped_matmul launches per layer of one forward over one row
    block: every quantized product (q, k, v, o, the FFN's three, a shared
    expert's three) takes qeinsum's grouped route, whichever MoE dispatch
    runs; with unquantized weights only an MoE FFN's grouped dispatch
    launches it."""
    cfg = engine.cfg
    if engine.ecfg.weight_dtype == "bf16":
        return 3 if cfg.num_experts and grouped else 0
    return 7 + (3 if cfg.shared_expert_intermediate_size else 0)


def _marks(engine):
    """The engine's mixed-dispatch counters: (all, with prefill chunks)."""
    return engine.dispatches, engine.chunk_dispatches


def _gm_launches(engine, marks0):
    """grouped_matmul launches of the mixed dispatches since ``marks0``
    (``_marks``): the decode block (num_slots rows, the pipe step's MoE
    dispatch) runs in every dispatch, the chunk block (the budget's rows,
    the rule on them) in every one that carries chunks."""
    from arks_tpu_torch.models import moe
    n, chunk = (a - b for a, b in zip(_marks(engine), marks0))
    return engine.cfg.num_layers * (
        n * _gm_per_layer(engine, moe.use_grouped(engine.ecfg.num_slots))
        + chunk * _gm_per_layer(engine,
                                moe.use_grouped(engine._mixed_budget)))


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
                  limit=True):
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
                                             tables, *args, impl=impl)
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
        logits = tf.mixed_step(engine.params, cfg, cache, *args, qmax=1)
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
    from arks_tpu_torch.models import get_config, moe
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
    grouped = moe.use_grouped(engine._mixed_budget)
    log(f"[serve {MOE_MODEL} {weight_dtype}] engine up in "
        f"{time.perf_counter() - t0:.1f} s: weights {wbytes} B "
        f"({weight_dtype}; embedding int8, router and norms bf16), bf16 "
        f"pool {tuple(engine.cache.k.shape)}, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated, "
        f"MoE dispatch of a chunk block grouped {grouped} "
        f"({engine._mixed_budget} rows; the decode block's 8 rows dense)")
    if not grouped:
        raise AssertionError("the Mixtral engine's chunk blocks do not "
                             "group")
    return engine, wbytes


def phase_serve_moe_short(torch, dev, engine):
    """A short batch on a Mixtral engine (the int4 one): one greedy
    completion twice in a row (identical), then 8 concurrent greedy streams
    of 16 tokens, with the kernel counts of that run.  (A prompt repeated
    inside the concurrent batch need not repeat its tokens: cuBLAS picks
    its GEMM by the batch's token count, so the same row rounds
    differently in another batch, and random weights leave near-ties.)"""
    from arks_tpu_torch.models import moe
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
        d0, marks0 = engine.dispatches, _marks(engine)
        out = {}

        def run(key, body):
            out[key] = _request(port, "/v1/completions", body)
        bodies = {f"b{i}": {"prompt": f"expert lane {i}" * (1 + i),
                            "max_tokens": 16, "temperature": 0,
                            "ignore_eos": True} for i in range(8)}
        with _moe_dispatches() as routes:
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
        # Each row block takes the reference's rule on its own rows: the
        # decode block (num_slots rows) as the pipe step, the chunk block
        # (the budget's rows) grouped.
        n, budget = engine.ecfg.num_slots, engine._mixed_budget
        want_routes = {(n, moe.use_grouped(n)),
                       (budget, moe.use_grouped(budget))}
        log(f"{tag} MoE FFN calls by (rows, grouped): {sorted(routes)}, "
            f"expected {sorted(want_routes)}")
        if routes != want_routes:
            raise AssertionError(f"{tag} MoE dispatch of a row block")
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
                        grouped_matmul=_gm_launches(engine, marks0))
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


@contextlib.contextmanager
def _moe_dispatches():
    """The set of (rows, grouped) of every MoE FFN call made inside, from
    any thread (the served engine's too)."""
    from arks_tpu_torch.models import moe
    seen = set()
    real = moe.moe_ffn

    def spy(x, *args, grouped, **kw):
        seen.add((x.numel() // x.shape[-1], grouped))
        return real(x, *args, grouped=grouped, **kw)

    moe.moe_ffn = spy
    try:
        yield seen
    finally:
        moe.moe_ffn = real


@contextlib.contextmanager
def _grouped_always():
    """Every MoE FFN call inside takes the grouped dispatch, whatever its
    rows (the rule's threshold set to one row)."""
    from arks_tpu_torch.models import moe
    old, moe.GROUPED_MIN_TOKENS = moe.GROUPED_MIN_TOKENS, 1
    try:
        yield
    finally:
        moe.GROUPED_MIN_TOKENS = old


def phase_moe_parity(torch, dev):
    """mixed_step through the kernels (ARKS_MOE_KERNEL=pallas: the grouped
    matmul and the attention kernels) against the same steps through
    impl="plain" (their plain versions) at Mixtral width, over 2 layers
    with bf16 and with int8 weights (limit 10% of the largest |logit|, as
    phase 5), and over 1 layer in f32 (5e-4).  Both steps take the
    grouped dispatch (``_grouped_always``; by the rule the 26-row step
    would not), the one the served engine's chunk blocks take.  The
    limits hold every lane whose
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
        with _grouped_always():
            worst[f"{name}, {layers} layer(s)"] = _parity_steps(
                torch, dev, tf, c, params, dtype, rel, abs_tol, None)
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
OPS_LEAD_IN = 4                           # profiled steps before it
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
    those launches by kernel name), 8 streams at depth 2.  The profiler
    drops a session's first events now and then (up to 81 of a 128-step
    window on the H100, up to 0.63 launches a step), so the window's
    steps are counted between markers after OPS_LEAD_IN steps: what they
    launched, whole."""
    _, _, win = _pipe_batch(torch, engine, [
        f"steady window stream {j}" for j in range(8)],
        2 * OPS_WINDOW + 32, window=True, window_steps=OPS_WINDOW,
        lead_in=OPS_LEAD_IN)
    return win[0], win[2], win[3]


def phase_operability(torch, dev, params, step_launches):
    """The operator's surface on Qwen2.5-7B bf16 at the default engine
    shape (depth 2), ``ARKS_QUEUE_MAX`` / ``ARKS_QUEUE_TENANT_MAX`` set.
    First, driven from this thread: host ms and launches per steady step
    with the metrics and the fair queue, then with inert metrics, each
    over a 128-step window — under half a launch a step apart and no
    kernel name launched only with the metrics, so they add no kernel;
    the host ms of both are reported; a third window with request
    tracing off, held to the first by the same rules (tracing adds no
    kernel).  Then behind the server, with every issue and admission
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
        # The same window with request tracing off (ARKS_TRACE=0's tracer).
        engine.metrics = real
        engine.trace.enabled = False
        host_untraced, untraced, names_untraced = _steady_launches(torch,
                                                                   engine)
    finally:
        engine.metrics = real
        engine.trace.enabled = True
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
    # The windows count their steps between markers, past the events the
    # profiler drops at a session's start (_steady_launches); windows still
    # differ by a few launches where their steps did other work.  One
    # added kernel a step would add a whole launch to the mean, and a
    # rarer one a name that only the window with the metrics shows.
    only_real = sorted(set(names_real) - set(names_inert))
    if abs(with_metrics - inert) >= 0.5 or only_real:
        raise AssertionError(f"[operability] the metrics change the kernel "
                             f"launches per step (only with them: "
                             f"{only_real})")
    res["launches_per_step"] = (with_metrics, inert)
    res["host_ms_per_step"] = (host_real, host_inert)
    res["steady_names"] = names_real
    traced_moved = {k: names_real[k] - names_untraced[k]
                    for k in names_real | names_untraced
                    if names_real[k] != names_untraced[k]}
    only_traced = sorted(set(names_real) - set(names_untraced))
    log(f"[operability] tracing on / off: launches per steady step "
        f"{with_metrics:.2f} / {untraced:.2f}, host ms per steady step "
        f"{host_real:.3f} / {host_untraced:.3f}; by kernel name, traced "
        f"less untraced, over the window: {traced_moved}; names only when "
        f"traced {only_traced}")
    if abs(with_metrics - untraced) >= 0.5 or only_traced:
        raise AssertionError("[operability] tracing changes the kernel "
                             "launches per step")
    res["trace_launches_per_step"] = (with_metrics, untraced)
    res["trace_host_ms_per_step"] = (host_real, host_untraced)

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
            if set(ready) != {"status", "sketch", "admission", "slo_burn",
                              "elastic"} or \
                    ready["sketch"]["enabled"] is not True or \
                    ready["admission"]["queue_max"] != OPS_QUEUE_MAX or \
                    ready["elastic"]["armed"] is not True:
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
    ref = weakref.ref(engine)
    del engine, guard, server
    res["freed_by_del"] = _freed_by_del(ref, "operability")
    return res



# ---------------------------------------------------------------------------
# Phase 9: fault isolation, token replay, the watchdog, tracing
# ---------------------------------------------------------------------------


REC_STREAMS, REC_TOKENS = 8, 64           # streams and tokens of a run
REC_ISSUES = ("_pipe_issue", "_issue_mixed", "_issue_decode")
REC_PROF_TOKENS = 12                       # tokens a stream in the window
REC_WINDOW = 32                            # steps a launch-count window
REC_CHILD_LAYERS = 2                       # depth cut of the subprocesses
REC_CHILD_TIMEOUT = 240
REC_DEADLINE_S = 2.0                       # the hang child's watchdog


class _SyncGuard(_NoSync):
    """``_NoSync`` that also records each host sync it caught: the
    recovery drive routes every exception into the engine's recovery, so a
    sync error must not pass for an injected fault."""

    def __init__(self, torch, engine, names):
        super().__init__(torch, engine, names)
        self.violations = []

    def _wrap(self, name):
        checked = super()._wrap(name)

        def recorded(*args, **kw):
            try:
                return checked(*args, **kw)
            except RuntimeError as e:
                if "synchronizing" in str(e):
                    self.violations.append(f"{name}: {e}")
                raise
        return recorded


def _rec_requests(engine, tag, tokens=REC_TOKENS):
    """REC_STREAMS requests of ``tokens`` tokens: even ones greedy, odd
    ones seeded sampling."""
    from arks_tpu_torch.engine import Request, SamplingParams
    tok = engine.tokenizer
    return [Request(f"{tag}-{i}", tok.encode(f"recovery stream {i}: the "
                                             f"quick brown fox {i * 7}"),
                    SamplingParams(max_tokens=tokens,
                                   temperature=0.0 if i % 2 == 0 else 0.8,
                                   top_k=50, seed=100 + i, ignore_eos=True))
            for i in range(REC_STREAMS)]


def _rec_drive(engine, reqs, late=(), hook=None, max_steps=20_000):
    """Add ``reqs`` (and ``late`` once a stream decodes) and drive the
    engine from this thread through its own step/recover contract until
    every request ended and the engine is idle and serving; ``hook`` runs
    after every step until it returns True.  Returns {rid: (tokens,
    finish reason, error)}."""
    import queue
    for r in reqs:
        engine.add_request(r)
    late = list(late)
    reqs = list(reqs) + late
    out = {r.request_id: [[], None, None] for r in reqs}

    def drain():
        for r in reqs:
            while True:
                try:
                    o = r.outputs.get_nowait()
                except queue.Empty:
                    break
                rec = out[r.request_id]
                rec[0] += o.token_ids
                if o.finished:
                    rec[1], rec[2] = o.finish_reason, o.error

    for _ in range(max_steps):
        try:
            engine.step(block_s=0.001)
            engine._consec_faults = 0
        except Exception as e:  # routed as the engine's run loop routes it
            engine._recover_from_fault(e)
        drain()
        if late and engine._slots:
            for r in late:
                engine.add_request(r)
            late = []
        if hook is not None and hook(engine):
            hook = None
        if (not late and all(v[1] for v in out.values()) and engine.idle
                and engine.state == "serving"):
            return {k: tuple(v) for k, v in out.items()}
    raise AssertionError(f"[recovery] requests never ended: "
                         f"{ {k: (len(v[0]), v[1]) for k, v in out.items()} }")


def _rec_metrics(engine):
    m = engine.metrics
    rs = m.engine_recovery_seconds._data.values()
    return dict(faults=m.engine_faults_total.total(),
                recovered=m.requests_recovered_total.total(),
                quarantined=m.requests_quarantined_total.total(),
                recoveries=sum(n for _, _, n in rs),
                recovery_s=sum(s for _, s, _ in rs))


def _rec_run(torch, engine, tag, inject=""):
    """One 8-stream run with ``inject`` armed: (streams by index, metric
    deltas, memory allocated before, peak during)."""
    from arks_tpu_torch.engine import faults
    engine._faults = faults.FaultInjector(inject)
    before = _rec_metrics(engine)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reqs = _rec_requests(engine, tag)
    got = _rec_drive(engine, reqs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    after = _rec_metrics(engine)
    delta = {k: after[k] - before[k] for k in after}
    return ([got[r.request_id] for r in reqs], delta, mem0, peak)


def _rec_engine(torch, dev, params, sched, depth, cfg=None):
    eng = _pipe_engine(torch, dev, params, sched, depth, "1", cfg)
    if eng.state != "serving" or not eng.trace.enabled \
            or eng._fault_retries != 1:
        raise AssertionError("[recovery] not the reference's defaults")
    return eng


def _rec_engine_checks(torch, engine, tag, res):
    """The fault-free run, ``decode:5:runtime`` (every stream equals it)
    and ``decode:5:runtime,replay:1:runtime`` (exactly one quarantined,
    the rest equal it)."""
    base, d0, mem0, peak0 = _rec_run(torch, engine, f"{tag}-base")
    if any(f != "length" or len(t) != REC_TOKENS for t, f, _ in base):
        raise AssertionError(f"[recovery {tag}] fault-free run cut short")
    if d0["faults"]:
        raise AssertionError(f"[recovery {tag}] a fault without injection")
    got, d1, mem1, peak1 = _rec_run(torch, engine, f"{tag}-dec",
                                    "decode:5:runtime")
    diverged = sum(e == "engine_fault: replay_diverged" for *_, e in got)
    same = sum(g == b for g, b in zip(got, base))
    log(f"[recovery {tag}] decode:5:runtime: {same}/{REC_STREAMS} streams "
        f"equal the fault-free run, replay_diverged {diverged}; faults "
        f"{d1['faults']:.0f}, recovered {d1['recovered']:.0f}, quarantined "
        f"{d1['quarantined']:.0f}; recovery {d1['recovery_s']:.4f} s; "
        f"device memory before {mem0} B, peak fault-free {peak0} B, before "
        f"{mem1} B, peak across the recovery {peak1} B "
        f"({(peak1 - peak0) / 2**20:+.2f} MiB)")
    res["diverged"] += diverged
    if d1["faults"] != 1 or d1["recoveries"] != 1 or d1["quarantined"]:
        raise AssertionError(f"[recovery {tag}] decode:5 counts {d1}")
    bad = [i for i, (g, b) in enumerate(zip(got, base))
           if g != b and g[2] != "engine_fault: replay_diverged"]
    if bad:
        raise AssertionError(f"[recovery {tag}] streams {bad} differ from "
                             "the fault-free run without a replay_diverged")
    res["recovery_s"].append((tag, d1["recovery_s"]))
    res["peak"].append((tag, mem1, peak0, peak1))
    got, d2, _, _ = _rec_run(torch, engine, f"{tag}-quar",
                             "decode:5:runtime,replay:1:runtime")
    quar = [i for i, (_, f, e) in enumerate(got)
            if f == "error" and e != "engine_fault: replay_diverged"]
    diverged = sum(e == "engine_fault: replay_diverged" for *_, e in got)
    res["diverged"] += diverged
    same = sum(g == b for g, b in zip(got, base))
    log(f"[recovery {tag}] decode:5:runtime,replay:1:runtime: quarantined "
        f"{quar} ({got[quar[0]][2] if quar else '-'}), {same} streams equal "
        f"the fault-free run, replay_diverged {diverged}; counts {d2}")
    if len(quar) != 1 or d2["quarantined"] != 1 or d2["faults"] != 2:
        raise AssertionError(f"[recovery {tag}] quarantine: {quar} {d2}")
    bad = [i for i, (g, b) in enumerate(zip(got, base)) if i not in quar
           and g != b and g[2] != "engine_fault: replay_diverged"]
    if bad or not got[quar[0]][2].startswith("engine_fault: replay/"):
        raise AssertionError(f"[recovery {tag}] survivors {bad} differ")
    if engine.state != "serving":
        raise AssertionError(f"[recovery {tag}] state {engine.state}")


def _rec_admit_oom(torch, engine, res):
    """``admit_resolve:1:oom`` on the legacy engine: the admission batch's
    requests re-queue (recovered, none quarantined) and every stream
    equals the fault-free run."""
    base, _, _, _ = _rec_run(torch, engine, "oom-base")
    got, d, _, _ = _rec_run(torch, engine, "oom", "admit_resolve:1:oom")
    kinds = dict(engine.metrics.engine_faults_total._values)
    log(f"[recovery legacy] admit_resolve:1:oom: counts {d}; faults by "
        f"label {kinds}; streams equal {got == base}")
    if (d["faults"] != 1 or d["quarantined"] or d["recovered"] < 1
            or got != base
            or engine.metrics.engine_faults_total.get(
                phase="admit_resolve", kind="oom") != 1):
        raise AssertionError(f"[recovery legacy] admit_resolve oom: {d}")
    res["diverged"] += sum(e == "engine_fault: replay_diverged"
                           for *_, e in got)


def _rec_restore(torch, engine, res):
    """A host-tier restore fault on the mixed engine: a two-page prefix is
    served, evicted to the host tier, then requested again beside a
    decoding stream, once without a fault and once with
    ``restore:1:runtime``.  The fault is blamed on the restoring request
    alone (phase "restore", no quarantine, no replay_diverged), and no
    stream fails: the restoring request's stream equals the fault-free
    round's, and the bystander's replay passes its gate (the tokens it had
    before the fault) and its whole stream equals the fault-free round's:
    its replay decodes in pipe steps where the original round decoded in
    classic mixed steps beside the restoring request's chunks, and a
    decode lane's bits are the same in both (``_rec_step_forms``)."""
    from arks_tpu_torch.engine import Request, SamplingParams
    from arks_tpu_torch.engine import faults
    from arks_tpu_torch.engine.paged import chain_digests
    rng = np.random.default_rng(SEED + 13)
    prefix = [int(x) for x in rng.integers(32, 120, 2 * PAGE)]
    digests = chain_digests(prefix, PAGE, 2)
    greedy = dict(max_tokens=16, temperature=0.0, ignore_eos=True)
    warm = Request("restore-warm", prefix + [65, 66, 67],
                   SamplingParams(**greedy))
    _rec_drive(engine, [warm])
    rounds = []
    for rnd, inject in enumerate(("", "restore:1:runtime")):
        _settle_spills(engine)
        _evict_prefix(engine, digests)
        _settle_spills(engine)
        if any(engine._host.peek(d) is None for d in digests):
            raise AssertionError("[recovery restore] prefix not spilled")
        engine._faults = faults.FaultInjector(inject)
        before = _rec_metrics(engine)
        by = Request(f"restore-by-{rnd}", engine.tokenizer.encode(
            "a bystander decodes while the prefix comes back"),
            SamplingParams(max_tokens=48, temperature=0.8, top_k=50,
                           seed=77, ignore_eos=True))
        victim = Request(f"restore-victim-{rnd}", prefix + [70, 71, 72, 73],
                         SamplingParams(**greedy))
        restored0 = engine.prefix_restore_blocks_total
        got = _rec_drive(engine, [by], late=[victim])
        after = _rec_metrics(engine)
        rounds.append((got[by.request_id], got[victim.request_id][:2],
                       {k: after[k] - before[k] for k in after},
                       engine.prefix_restore_blocks_total - restored0))
    (by0, v0, d0, r0), (by1, v1, d1, r1) = rounds
    label = engine.metrics.engine_faults_total.get(phase="restore",
                                                   kind="injected")
    same = next((j for j, (a, b) in enumerate(zip(by1[0], by0[0]))
                 if a != b), None)
    log(f"[recovery restore] host-tier hit beside a decoding stream: "
        f"restored blocks {r0} / {r1}; with restore:1:runtime faults "
        f"{d1['faults']:.0f} (phase restore: {label:.0f}), quarantined "
        f"{d1['quarantined']:.0f}; victim equal {v1 == v0}; bystander "
        f"replayed, finished {by1[1]} {by1[2]}, the whole stream equal to "
        f"the fault-free round's {by1 == by0} (first differing token index "
        f"{same})")
    if (r0 < 2 or r1 < 2 or d0["faults"] or d1["faults"] != 1 or label != 1
            or d1["quarantined"] or v0[1] != "length" or v1 != v0
            or by1[1:] != ("length", None) or by1 != by0):
        raise AssertionError(f"[recovery restore] {rounds}")
    res["restore_bystander_equal"] = by1 == by0


def _rec_step_forms(torch, engine, res):
    """A decode lane's bits in every step form, on the engine's weights
    at full depth: (1) logged: the bf16 GEMMs of a layer's shapes (q, o,
    gate/up, down, the unembed) at M rows against the same rows inside
    M = num_slots + budget, and where a prompt was cut into chunks; (2)
    asserted: a decode lane's logits from the pipe step's form (B rows,
    lane s in row s) equal, bit for bit, its logits from the classic mixed
    step with a prefill chunk beside it (the decode block of B rows, then
    the chunk block at row B: ``mixed_step``'s ``split``), as the engine
    lays them out; logged: the same step run as one block of num_slots +
    budget rows, which differs; (3) asserted: the chunk lane's logits
    from that step equal its logits from the same split step with no
    decode lane (an idle engine's chunk step).  The byte identity of a
    replay that decodes, or prefills, in other step forms than its
    original rests on (2) and (3)."""
    from arks_tpu_torch.models import transformer as tf
    cfg, params, dev = engine.cfg, engine.params, engine.device
    n, t_flat = engine.ecfg.num_slots, engine.ecfg.num_slots + \
        engine._mixed_budget
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sweep = {}
    for name, (k, m) in dict(q=(cfg.hidden_size, cfg.q_dim),
                             o=(cfg.q_dim, cfg.hidden_size),
                             up=(cfg.hidden_size, cfg.intermediate_size),
                             down=(cfg.intermediate_size, cfg.hidden_size),
                             unembed=(cfg.hidden_size, cfg.vocab_size)
                             ).items():
        x = torch.randn(t_flat, k, device=dev, dtype=torch.bfloat16,
                        generator=gen)
        w = torch.randn(k, m, device=dev, dtype=torch.bfloat16,
                        generator=gen) * 0.02
        ref = torch.einsum("...e,ef->...f", x, w)[:8]
        sweep[name] = [rows for rows in (8, 16, 32, 48, 64, 96, 128)
                       if not torch.equal(torch.einsum(
                           "...e,ef->...f", x[:rows].contiguous(), w)[:8],
                           ref)]
        del x, w, ref
    page = engine._page
    length, chunk_len = min(41, page // 2), min(32, page // 4)
    cache = tf.init_paged_cache(cfg, n, page, torch.bfloat16, dev)
    tables = torch.arange(n, dtype=torch.int32, device=dev).reshape(n, 1)
    rng = np.random.default_rng(SEED + 5)
    prompts = rng.integers(32, 120, (n, length))

    def step(lanes, rows, qmax, chunk=None, split=None):
        a = dict(tokens=np.zeros(rows, np.int32),
                 token_slot=np.full(rows, -1, np.int32),
                 token_pos=np.full(rows, page, np.int32),
                 sample_src=np.zeros(n, np.int32),
                 seq_q_start=np.zeros(n, np.int32),
                 seq_q_len=np.zeros(n, np.int32),
                 seq_pos_start=np.zeros(n, np.int32))
        seqs = [(s, [7 + s], length) for s in lanes]
        if chunk is not None:
            seqs.append(chunk)
        t = 0
        for s, toks, pos in seqs:
            q = len(toks)
            if q > 1 and split is not None:
                t = split       # the chunk block starts after the lanes
            a["tokens"][t:t + q] = toks
            a["token_slot"][t:t + q] = s
            a["token_pos"][t:t + q] = np.arange(pos, pos + q)
            a["seq_q_start"][s], a["seq_q_len"][s] = t, q
            a["seq_pos_start"][s], a["sample_src"][s] = pos, t + q - 1
            t += q
        b = {k: torch.from_numpy(v).to(dev) for k, v in a.items()}
        return tf.mixed_step(params, cfg, cache, tables, b["tokens"],
                             b["token_slot"], b["token_pos"],
                             b["sample_src"], b["seq_q_start"],
                             b["seq_q_len"], b["seq_pos_start"], qmax=qmax,
                             split=split)

    for s in range(n):
        step([], t_flat, length, chunk=(s, prompts[s], 0))
    chunk = (n - 1, prompts[n - 1][:chunk_len], length + 1)
    pipe7 = step(range(n - 1), n, 1)
    beside = step(range(n - 1), t_flat, chunk_len, chunk=chunk, split=n)
    unsplit = step(range(n - 1), t_flat, chunk_len, chunk=chunk)
    pipe7_again = step(range(n - 1), n, 1)
    no_lanes = step([], t_flat, chunk_len, chunk=chunk, split=n)
    # One prompt prefilled in two chunks, cut at two places (slots 0 and
    # 1 of a second pool, the same tokens): the first chunk one full
    # q-block (32 rows) of it, or a full block and a part of the next.
    cut_cache = tf.init_paged_cache(cfg, n, page, torch.bfloat16, dev)
    cache, keep = cut_cache, cache
    cuts = (32, 36) if length > 36 else (length // 2, length // 2 + 2)
    for s, c in enumerate(cuts):
        step([], t_flat, c, chunk=(s, prompts[0][:c], 0))
    tail = step([], t_flat, length, chunk=(0, prompts[0][cuts[0]:], cuts[0]))
    tail1 = step([], t_flat, length, chunk=(1, prompts[0][cuts[1]:], cuts[1]))
    cache = keep
    forms = dict(
        prompt_cut_at_two_places=not torch.equal(tail[0], tail1[1]),
        pipe_vs_split_beside_a_chunk=[
            s for s in range(n - 1) if not torch.equal(pipe7[s], beside[s])],
        pipe_vs_pipe_again=[s for s in range(n - 1)
                            if not torch.equal(pipe7[s], pipe7_again[s])],
        pipe_vs_one_block_beside_a_chunk=[
            s for s in range(n - 1)
            if not torch.equal(pipe7[s], unsplit[s])],
        chunk_without_lanes_vs_beside_lanes=not torch.equal(
            no_lanes[n - 1], beside[n - 1]))
    log(f"[recovery step forms] rows (of the first 8) whose bits differ "
        f"from the same rows in a {t_flat}-row GEMM, by M: {sweep}; lanes "
        f"whose logits differ: {forms}")
    res["step_forms"] = dict(gemm_m=sweep, lanes=forms)
    del cache, cut_cache
    if (forms["pipe_vs_split_beside_a_chunk"] or forms["pipe_vs_pipe_again"]
            or forms["chunk_without_lanes_vs_beside_lanes"]):
        raise AssertionError(
            "[recovery step forms] a decode lane's logits differ between "
            "the pipe step and the split step beside a chunk, or a chunk's "
            f"between that step and one with no decode lane: {forms}")


def _rec_profiler(torch, engine, tmpdir, res):
    """A profiler window of about REC_PROF_TOKENS steps opened and closed
    through the engine loop's thread: its trace holds the port's kernels
    and the arks_step annotations."""
    import os
    engine.start()
    try:
        r = engine.profiler.start(os.path.join(tmpdir, "window"))
        if not r.get("ok"):
            raise AssertionError(f"[recovery profiler] start: {r}")
        reqs = _rec_requests(engine, "prof", REC_PROF_TOKENS)
        for q in reqs:
            engine.add_request(q)
        for q in reqs:
            while not q.outputs.get(timeout=300).finished:
                pass
        stop = engine.profiler.stop()
    finally:
        engine.stop()
    if not stop.get("ok"):
        raise AssertionError(f"[recovery profiler] stop: {stop}")
    from arks_tpu_torch.obs.profiler import TRACE_FILE
    with open(os.path.join(stop["dir"], TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    names = collections.Counter(str(e.get("name", "")) for e in events)
    steps = sum(n for k, n in names.items() if k.startswith("arks_step"))
    ours = {k: n for k, n in names.items() if any(
        s in k for s in ("mixed_attention", "paged_kv_update",
                         "decode_attention", "kv_cache_update"))}
    log(f"[recovery profiler] window over {REC_PROF_TOKENS}-token streams: "
        f"{len(events)} events, {steps} arks_step annotations, the port's "
        f"kernels {ours}")
    if steps < REC_PROF_TOKENS // 2 or not ours:
        raise AssertionError("[recovery profiler] the window's trace lacks "
                             "the annotations or the port's kernels")
    res["profiler"] = (steps, sum(ours.values()))


def _rec_tracer_cost(torch, engine, res):
    """Events per steady step (the rings' indexes over a window) and ns
    per ``evt`` (a loop on a fresh tracer).  (Launches and host ms per
    steady step with tracing on and off: ``phase_operability``'s
    128-step windows.)"""
    from arks_tpu_torch.obs.trace import Tracer
    tr = engine.trace
    marks = []

    def window(e):
        # Steady once every slot decodes; 4 steps in, count a window.
        if len(e._slots) == REC_STREAMS or marks:
            marks.append(sum(r.idx for r in tr._rings))
        return len(marks) > 4 + REC_WINDOW

    _rec_drive(engine, _rec_requests(engine, "tracer", 2 * REC_WINDOW + 16),
               hook=window)
    if len(marks) <= 4 + REC_WINDOW:
        raise AssertionError("[recovery tracer] no steady window")
    per_step = (marks[4 + REC_WINDOW] - marks[4]) / REC_WINDOW
    probe = Tracer(enabled=True)
    n = 200_000
    t0 = time.perf_counter_ns()
    for _ in range(n):
        probe.evt("", "phase.decode", "B")
    ns = (time.perf_counter_ns() - t0) / n
    log(f"[recovery tracer] {per_step:.2f} events per steady step (depth "
        f"2, 8 streams), {ns:.1f} ns per evt: {per_step * ns / 1e3:.2f} us "
        f"a step")
    res["tracer"] = dict(events_per_step=per_step, ns_per_evt=ns)


def _rec_child_run(mode):
    """A subprocess of this script: ``hang`` (a decode dispatch hangs past
    a 2 s watchdog deadline) or ``sticky`` (a device-side assert inside a
    step).  Returns (exit code, the child's report, its seconds)."""
    import os
    env = dict(os.environ)
    if mode == "hang":
        env.update(ARKS_FAULT_INJECT="decode:3:hang", ARKS_FAULT_HANG_S="60",
                   ARKS_DISPATCH_DEADLINE_S=str(REC_DEADLINE_S))
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, __file__, "--recovery-child", mode],
                       capture_output=True, text=True, env=env,
                       timeout=REC_CHILD_TIMEOUT)
    secs = time.perf_counter() - t0
    report = None
    for line in p.stdout.splitlines():
        if line.startswith("{\"child\""):
            report = json.loads(line)
    if report is None:
        log(f"[recovery child {mode}] stdout tail: {p.stdout[-2000:]}")
        log(f"[recovery child {mode}] stderr tail: {p.stderr[-3000:]}")
    return p.returncode, report, secs


def recovery_child(mode: str, device: str = "cuda") -> int:
    """The subprocess side of ``_rec_child_run``: Qwen2.5-7B at full width
    cut to REC_CHILD_LAYERS layers behind the port's server; two requests
    in flight when the fault lands.  At the escalation's exit it reports
    readiness and the requests' HTTP outcomes on one JSON line."""
    import os

    import torch

    from arks_tpu_torch.engine import EngineConfig, InferenceEngine
    from arks_tpu_torch.engine.tokenizer import ByteTokenizer
    from arks_tpu_torch.models import get_config
    from arks_tpu_torch.server import OpenAIServer
    dev = torch.device("cuda", 0) if device == "cuda" else \
        torch.device(device)
    cfg = dataclasses.replace(get_config(MODEL), num_layers=REC_CHILD_LAYERS)
    engine = InferenceEngine(cfg, EngineConfig(
        model=MODEL, num_slots=8, max_cache_len=MAX_PAGES * PAGE,
        prefill_chunk=PAGE, dtype="bfloat16", kv_cache_dtype="bf16",
        seed=SEED), ByteTokenizer(), device=dev)
    server = OpenAIServer(engine, MODEL, host="127.0.0.1", port=0)
    server.start(background=True)
    outcomes, clients, hang_t0 = [], [], []

    class HangStart(logging.Handler):
        """The monotonic time the injected hang begins (the injector logs
        it just before it sleeps)."""

        def emit(self, record):
            if "kind=hang" in record.getMessage() and not hang_t0:
                hang_t0.append(time.monotonic())

    logging.getLogger("arks_tpu_torch.faults").addHandler(HangStart())

    def on_exit(code):
        t_exit = time.monotonic()
        st = _get(server.port, "/readiness")
        if mode == "sticky":
            # Their errors are on the way (a hung step answers nothing).
            for th in clients:
                th.join(30)
        print(json.dumps({"child": mode, "code": code,
                          "readiness": [st[0], st[1]],
                          "state": engine.state,
                          "outcomes": outcomes, "warm_s": warm_s,
                          "hang_to_exit_s": t_exit - hang_t0[0]
                          if hang_t0 else None}), flush=True)
        os._exit(code)

    engine._exit_fn = on_exit
    warm_s = None
    if mode == "hang":
        # A fresh process loads each GEMM's kernels at its first launch,
        # which can hold a step past the 2 s deadline: run one request
        # through the chunk step and the pipe step before the watchdog is
        # armed, with the injector set aside.
        from arks_tpu_torch.engine import Request, SamplingParams, faults
        inj, engine._faults = engine._faults, faults.FaultInjector("")
        t_warm = time.monotonic()
        _rec_drive(engine, [Request("warm", engine.tokenizer.encode(
            "warm up"), SamplingParams(max_tokens=8, temperature=0,
                                       ignore_eos=True))])
        warm_s = time.monotonic() - t_warm
        engine._faults = inj
    if mode == "sticky":
        real = engine._pipe_issue
        calls = []

        def poisoned(*a, **k):
            calls.append(1)
            if len(calls) == 4:
                # An out-of-bounds gather: the kernel's device-side
                # assert poisons the context; the error surfaces at the
                # next read of a result.
                x = torch.zeros(4, device=dev)
                x[torch.full((1,), 1 << 20, device=dev)] += 1
            return real(*a, **k)

        engine._pipe_issue = poisoned
    engine.start()
    for i in range(2):
        def post(i=i):
            st, body, _ = _post_h(server.port, {
                "prompt": f"in flight {i}", "max_tokens": 200,
                "temperature": 0, "ignore_eos": True}, {})
            outcomes.append([st, body.get("error", {}).get("code")
                             if isinstance(body, dict) else None])
        th = threading.Thread(target=post)
        th.start()
        clients.append(th)
    time.sleep(REC_CHILD_TIMEOUT)
    return 1


def _holders(ref, limit=400) -> str:
    """What keeps the object behind ``ref`` alive: the frames (innermost
    last), tracebacks and functions among its referrers, followed
    transitively up to ``limit`` objects, and a count of the other
    referrers by type."""
    import gc
    import types
    skip = set()
    target = ref()
    seen, frontier, found = {id(target)}, [target], []
    kinds = collections.Counter()
    skip.update((id(seen), id(frontier), id(found), id(kinds),
                 id(sys._getframe())))
    while frontier and len(seen) < limit:
        nxt = []
        skip.add(id(nxt))
        for obj in frontier:
            refs = gc.get_referrers(obj)
            skip.add(id(refs))
            for r in refs:
                if id(r) in seen or id(r) in skip:
                    continue
                seen.add(id(r))
                nxt.append(r)
                if isinstance(r, types.FrameType):
                    c = r.f_code
                    found.append(f"frame {c.co_name} "
                                 f"{c.co_filename.rsplit('/', 2)[-2:]}:"
                                 f"{r.f_lineno}")
                elif isinstance(r, (types.TracebackType, types.FunctionType)):
                    found.append(f"{type(r).__name__} "
                                 f"{getattr(r, '__qualname__', '')}")
                else:
                    kinds[type(r).__name__] += 1
            del refs
        frontier = nxt
    del target, frontier
    return f"{found[:40]}; other referrers {dict(kinds)}"


def _freed_by_del(ref, tag, wait_s=5.0) -> bool:
    """Check that the engine behind ``ref`` was freed when its last name
    was deleted, with no GC pass: an engine kept by a reference cycle
    holds its pool, and the weights, until a pass runs, and the phases
    after it measure memory.  A server's request threads may still be
    ending (their frames hold it), so it waits up to ``wait_s`` with the
    collector off.  If not freed, log what holds it, collect, and fail
    the phase."""
    import gc
    was_on = gc.isenabled()
    gc.disable()
    try:
        deadline = time.monotonic() + wait_s
        while ref() is not None and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        if was_on:
            gc.enable()
    if ref() is None:
        log(f"[{tag}] the engine was freed by del, with no GC pass")
        return True
    log(f"[{tag}] the engine outlived del; held by {_holders(ref)}")
    gc.collect()
    raise AssertionError(f"[{tag}] the engine outlived del (freed by a GC "
                         f"pass: {ref() is None})")


def phase_recovery(torch, dev, params):
    """Fault isolation, token replay and the watchdog on Qwen2.5-7B bf16
    at full width, cut to CUT_LAYERS layers (``params``' first layers), 8
    streams of 64 tokens (greedy and seeded
    sampling), every dispatch issue (and the mixed engines' admissions)
    under set_sync_debug_mode("error"):
    - the mixed bf16 paged engine at depths 0 and 2 and the legacy bf16
      slot engine at depth 0: ``decode:5:runtime`` gives every stream of
      the fault-free run (or reports a replay_diverged error), and
      ``decode:5:runtime,replay:1:runtime`` quarantines exactly one;
      recovery seconds and the peak device memory across a recovery
      against a fault-free run's (no second pool);
    - the legacy engine: ``admit_resolve:1:oom`` re-queues its batch;
    - the mixed engine at depth 2: a ``restore`` fault on a host-tier hit
      is blamed on the restoring request alone (no quarantine), its
      stream equals the fault-free round's and the replayed bystander's
      is whole (its tokens after the checked prefix may differ: ROADMAP
      queue 3);
    - the tracer: events per steady step and ns per evt (launches per
      step traced and not: phase_operability);
    - a profiler window of ~12 steps holds the port's kernels and the
      arks_step annotations;
    - subprocesses: a hang past a 2 s ARKS_DISPATCH_DEADLINE_S exits 70
      within [deadline - 0.5, deadline + 1] s of the hang's start, and a
      device-side assert inside a step fails the requests in flight
      with an engine_fault error (HTTP 500), readiness 503 "wedged",
      exit 70."""
    import tempfile
    t_phase = time.perf_counter()
    res = dict(diverged=0, recovery_s=[], peak=[], syncs=0, freed_by_del=[])
    cut_cfg, params = _cut_model(params)
    for sched, depth in (("mixed", "0"), ("mixed", "2"), ("legacy", "0")):
        tag = f"{sched} depth {depth}"
        engine = _rec_engine(torch, dev, params, sched, depth, cut_cfg)
        names = REC_ISSUES + (("_admit",) if sched == "mixed" else ())
        with _SyncGuard(torch, engine, names) as guard:
            _rec_engine_checks(torch, engine, tag, res)
            if sched == "legacy":
                _rec_admit_oom(torch, engine, res)
            if sched == "mixed" and depth == "2":
                _rec_restore(torch, engine, res)
                _rec_tracer_cost(torch, engine, res)
                _rec_step_forms(torch, engine, res)
        log(f"[recovery {tag}] {guard.issues} issues passed "
            f"set_sync_debug_mode('error') ({dict(guard.calls)})")
        if guard.violations:
            raise AssertionError(f"[recovery {tag}] host syncs: "
                                 f"{guard.violations[:3]}")
        res["syncs"] += guard.issues
        if sched == "mixed" and depth == "2":
            with tempfile.TemporaryDirectory() as d:
                _rec_profiler(torch, engine, d, res)
        ref = weakref.ref(engine)
        del engine, guard
        res["freed_by_del"].append((tag, _freed_by_del(
            ref, f"recovery {tag}")))
        torch.cuda.empty_cache()
    for mode in ("hang", "sticky"):
        code, rep, secs = _rec_child_run(mode)
        log(f"[recovery child {mode}] exit {code} after {secs:.1f} s: {rep}")
        if code != 70 or rep is None or rep["state"] != "wedged" or \
                rep["readiness"] != [503, {"error": {
                    "message": "wedged", "code": 503}}]:
            raise AssertionError(f"[recovery child {mode}] {code} {rep}")
        if mode == "sticky" and sorted(map(tuple, rep["outcomes"])) != \
                [(500, "engine_fault")] * 2:
            raise AssertionError(f"[recovery child sticky] {rep}")
        if mode == "hang" and not (
                REC_DEADLINE_S - 0.5 <= (rep["hang_to_exit_s"] or 0)
                <= REC_DEADLINE_S + 1.0):
            # The watchdog polls every min(deadline / 4, 1) s from the
            # step's heartbeat, which precedes the hang by the step's
            # host work.
            raise AssertionError(f"[recovery child hang] exit "
                                 f"{rep['hang_to_exit_s']} s after the hang "
                                 f"began (deadline {REC_DEADLINE_S} s)")
        res[f"child_{mode}_s"] = secs
    log(f"[recovery] replay_diverged {res['diverged']}; recovery seconds "
        f"{res['recovery_s']}; phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return res


PRE_STREAMS, PRE_PROMPT, PRE_TOKENS = 8, 512, 96   # the batch-tier streams
PRE_ARRIVALS, PRE_ARR_PROMPT, PRE_ARR_TOKENS = 2, 64, 32   # latency tier
PRE_AFTER = 16                 # decode dispatches before the arrivals
PRE_TIERS = "latency:ttft_ms=300,batch:"
PRE_ISSUES = ("_pipe_issue", "_issue_mixed", "_issue_decode",
              "_maybe_preempt", "_service_swapped")


def _pre_engine(torch, dev, params, preempt, depth="2", kv="bf16",
                layout="paged", cfg=None):
    """A Qwen2.5-7B engine on ``params`` (8 slots x 4096, chunk 256) with
    the SLO ladder, ``ARKS_PREFIX_HOST_MB=1024`` and two preemptions in
    flight at most: the mixed scheduler on a ``kv`` pool, or the legacy
    one on the bf16 slot cache."""
    import os

    from arks_tpu_torch.engine import EngineConfig, InferenceEngine
    from arks_tpu_torch.engine.tokenizer import ByteTokenizer
    from arks_tpu_torch.models import get_config
    env = dict(ARKS_PIPELINE_DEPTH=depth, ARKS_PREEMPT=str(int(preempt)),
               ARKS_PREFIX_HOST_MB="1024", ARKS_SLO_TIERS=PRE_TIERS,
               ARKS_PREEMPT_MAX_INFLIGHT="2")
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return InferenceEngine(cfg or get_config(MODEL), EngineConfig(
            model=MODEL, num_slots=8, max_cache_len=MAX_PAGES * PAGE,
            prefill_chunk=PAGE, dtype="bfloat16", kv_cache_dtype=kv,
            kv_layout=layout, seed=SEED), ByteTokenizer(), params=params,
            device=dev)
    finally:
        _restore_env(os, old)


def _pre_requests(tag):
    """PRE_STREAMS batch-tier streams (priority 1) of PRE_PROMPT tokens:
    greedy and seeded sampling by turns, the seventh with presence and
    frequency penalties, the last guided; and the PRE_ARRIVALS latency
    arrivals (priority 0), greedy."""
    from arks_tpu_torch.engine import Request, SamplingParams
    rng = np.random.default_rng(SEED + 21)
    reqs = []
    for i in range(PRE_STREAMS):
        kw = dict(max_tokens=PRE_TOKENS, ignore_eos=True, priority=1)
        if i == PRE_STREAMS - 2:
            kw.update(temperature=0.0, presence_penalty=0.5,
                      frequency_penalty=0.3)
        elif i == PRE_STREAMS - 1:
            kw.update(temperature=0.8, top_k=50, seed=300 + i,
                      guide=("regex", "[a-f]+"))
        elif i % 2:
            kw.update(temperature=0.8, top_k=50, seed=300 + i)
        else:
            kw.update(temperature=0.0)
        reqs.append(Request(f"{tag}-b{i}", [int(x) for x in rng.integers(
            32, 120, PRE_PROMPT)], SamplingParams(**kw)))
    late = [Request(f"{tag}-l{i}", [int(x) for x in rng.integers(
        32, 120, PRE_ARR_PROMPT)], SamplingParams(
            max_tokens=PRE_ARR_TOKENS, temperature=0.0, ignore_eos=True,
            priority=0)) for i in range(PRE_ARRIVALS)]
    return reqs, late


def _pre_round(torch, engine, tag, inject="", hook=None):
    """One round: the batch streams, then the arrivals once every stream
    has decoded PRE_AFTER dispatches, driven from this thread (step and
    recover, as the run loop) with every issue under
    set_sync_debug_mode("error").  Returns (streams by name: (tokens,
    finish reason, error, ttft_s), metric deltas, peak device memory, the
    SwapStore bytes of each entry it held, the preempt_swap_seconds legs,
    host syncs caught).  Each stream's entry ends with the shape of its
    first prefill (``_ReplayShape``: where its prompt was cut into
    chunks).  The round's guides are compiled before its requests come
    in: a guided request admitted before its compile published parks and
    joins the chunk steps later, which moves every other prompt's chunk
    cuts (the even quota) and so their bits on the card, by how long the
    compile thread took."""
    import queue

    from arks_tpu_torch.engine import faults
    engine._faults = faults.FaultInjector(inject)
    reqs, late = _pre_requests(tag)
    for guide in {r.params.guide for r in reqs + late
                  if r.params.guide is not None}:
        engine.guides.compile(*guide)
    m = engine.metrics
    hist = m.preempt_swap_seconds
    legs, leg, entry_bytes, culprits = [], ["out"], {}, []
    shapes = {}
    real_obs, real_fin = hist.observe, engine._finish_resume
    real_rec = engine._do_recovery
    real_reg = engine._register_slot

    def observe(v, **kw):
        legs.append((leg[0], v))
        real_obs(v, **kw)

    def finish(res):
        leg[0] = "resume"
        try:
            return real_fin(res)
        finally:
            leg[0] = "out"

    def recover(exc):
        culprits.append(sorted(getattr(exc, "culprits", ())))
        return real_rec(exc)

    def register(req, slot, first, num_prompt, first_lp=None, shape=None):
        shapes.setdefault(req.request_id.split("-", 1)[1], shape)
        return real_reg(req, slot, first, num_prompt, first_lp, shape)

    hist.observe, engine._finish_resume = observe, finish
    engine._do_recovery, engine._register_slot = recover, register
    names = PRE_ISSUES + (("_admit",) if engine._mixed else ())
    before = (m.requests_preempted_total.total(),
              m.engine_faults_total.total(),
              m.requests_quarantined_total.total())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {r.request_id.split("-", 1)[1]: [[], None, None, None]
           for r in reqs + late}
    all_reqs = reqs + late
    d_start = None
    try:
        with _SyncGuard(torch, engine, names) as guard:
            for r in reqs:
                engine.add_request(r)
            for _ in range(100_000):
                try:
                    engine.step(block_s=0.001)
                    engine._consec_faults = 0
                except Exception as e:  # routed as the run loop routes it
                    engine._recover_from_fault(e)
                for r in all_reqs:
                    rec = out[r.request_id.split("-", 1)[1]]
                    while True:
                        try:
                            o = r.outputs.get_nowait()
                        except queue.Empty:
                            break
                        rec[0] += o.token_ids
                        if rec[3] is None and o.ttft_s is not None:
                            rec[3] = o.ttft_s
                        if o.finished:
                            rec[1], rec[2] = o.finish_reason, o.error
                if engine._swap is not None:
                    for rid, (_, need) in engine._swap._entries.items():
                        entry_bytes[rid] = need
                n_disp = engine.dispatches + engine.decode_dispatches
                if late and d_start is None and len(engine._slots) == \
                        PRE_STREAMS:
                    d_start = n_disp
                if late and d_start is not None and \
                        n_disp - d_start >= PRE_AFTER:
                    for r in late:
                        r.arrival_time = time.monotonic()
                        engine.add_request(r)
                    late = []
                if hook is not None and hook(engine, reqs):
                    hook = None
                if (not late and all(v[1] for v in out.values())
                        and engine.idle and engine.state == "serving"):
                    break
            else:
                raise AssertionError(f"[preempt {tag}] never drained: "
                                     f"{ {k: v[1] for k, v in out.items()} }")
    finally:
        del hist.observe, engine._finish_resume, engine._do_recovery
        del engine._register_slot
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    after = (m.requests_preempted_total.total(),
             m.engine_faults_total.total(),
             m.requests_quarantined_total.total())
    delta = [a - b for a, b in zip(after, before)]
    return ({k: tuple(v) + (shapes.get(k),) for k, v in out.items()}, delta,
            peak, entry_bytes, legs, (guard.issues, guard.violations),
            culprits)


def _pre_same(tag, got, base, allow=()):
    """Every batch stream of ``got`` was prefilled as ``base``'s was (the
    same chunk cuts: before anything is preempted or faults, the round ran
    the baseline's schedule), and every stream equals ``base``'s (ids and
    finish reason); those in ``allow`` may end early with a prefix of
    theirs."""
    cut = {k: (got[k][4], base[k][4]) for k in got
           if k.startswith("b") and got[k][4] != base[k][4]}
    if cut:
        raise AssertionError(f"[preempt {tag}] streams {sorted(cut)} were "
                             f"prefilled otherwise than in the baseline "
                             f"(shapes, this round's then the baseline's: "
                             f"{cut})")
    bad = []
    for k, (ids, fin, err, *_) in got.items():
        bids, bfin = base[k][:2]
        if k in allow:
            if ids != bids[:len(ids)]:
                bad.append(k)
        elif (ids, fin, err) != (bids, bfin, None):
            bad.append(k)
    diverged = sum(v[2] == "engine_fault: replay_diverged"
                   for v in got.values())
    if bad or diverged:
        first = {k: next((i for i, (a, b) in enumerate(zip(
            got[k][0], base[k][0])) if a != b), None) for k in bad}
        raise AssertionError(f"[preempt {tag}] streams {bad} differ from "
                             f"the baseline (first differing token index "
                             f"{first}); replay_diverged {diverged}")


def _median_ttft(got):
    return float(np.median([got[f"l{i}"][3] for i in range(PRE_ARRIVALS)]))


def phase_preempt(torch, dev, params, ops):
    """Preemptive KV swap for SLO tiers on Qwen2.5-7B bf16 at full width,
    its rounds cut to CUT_LAYERS layers (``params``' first layers; the
    steady window at full depth): 8 batch-tier streams of 512-token prompts and 96 tokens
    (greedy, seeded sampling, one with presence and frequency penalties,
    one guided), then 2 latency-tier requests (64-token prompts, 32
    tokens) once every stream has decoded 16 dispatches; 8 slots, so
    each arrival seizes a running slot.  Rounds: ``ARKS_PREEMPT=0`` (the
    baseline), ``ARKS_PREEMPT=1`` at depths 0 and 2 (swap mode), an int8
    pool at depth 2 (against its own baseline), the legacy scheduler on
    the bf16 slot cache (replay mode, against its own baseline),
    ``preempt:1:runtime``, and an abort of a swapped-out victim.  Every
    stream equals its baseline's with no replay_diverged, 2 preemptions a
    round, the fault blamed on the victim alone, the SwapStore's bytes
    back to zero after the abort, and no host sync on any issue.  Logs
    preempt_swap_seconds by leg, bytes per victim, the arrivals' median
    TTFT with preemption on and off, and the peak device memory.  With
    ``ARKS_PREEMPT=1`` and nothing to preempt, a steady step launches what
    ``phase_operability``'s default engine launches (``ops``: its 128-step
    window with ``ARKS_PREEMPT`` unset), within half a launch and with no
    kernel name of its own."""
    t_phase = time.perf_counter()
    res = dict(syncs=0, rounds={})
    bases = {}
    # The rounds on the model cut in depth; the steady window (held to
    # phase_operability's) at full depth.
    cut_cfg, cut_params = _cut_model(params)

    def run(tag, preempt, depth="2", kv="bf16", layout="paged", inject="",
            hook=None, base=None, allow=()):
        engine = _pre_engine(torch, dev, cut_params, preempt, depth, kv,
                             layout, cut_cfg)
        want = ("swap" if layout == "paged" else "replay") if preempt \
            else "off"
        if engine.resolved_config["preempt"] != want:
            raise AssertionError(f"[preempt {tag}] mode "
                                 f"{engine.resolved_config['preempt']}")
        got, delta, peak, entry, legs, (issues, syncs), culprits = \
            _pre_round(torch, engine, tag, inject, hook)
        res["syncs"] += issues
        if syncs:
            raise AssertionError(f"[preempt {tag}] host syncs: {syncs[:3]}")
        row = dict(preempted=delta[0], faults=delta[1],
                   quarantined=delta[2], peak=peak, ttft=_median_ttft(got),
                   bytes=sorted(entry.values()),
                   swap_out_s=[v for k, v in legs if k == "out"],
                   resume_s=[v for k, v in legs if k == "resume"],
                   culprits=culprits, issues=issues,
                   swap_left=(engine._swap.bytes_used
                              if engine._swap is not None else 0),
                   reserved=(engine._host.reserved
                             if engine._host is not None else 0))
        log(f"[preempt {tag}] {json.dumps(row)}")
        if base is None:
            if delta[0] or any(v[1] != "length" for v in got.values()):
                raise AssertionError(f"[preempt {tag}] baseline {row}")
        else:
            _pre_same(tag, got, bases[base], allow)
        if row["swap_left"] or row["reserved"]:
            raise AssertionError(f"[preempt {tag}] host bytes left {row}")
        res["rounds"][tag] = row
        ref = weakref.ref(engine)
        del engine
        _freed_by_del(ref, f"preempt {tag}")
        torch.cuda.empty_cache()
        return got, row

    bases["bf16"], _ = run("base", False)
    for depth in ("0", "2"):
        _, row = run(f"swap depth {depth}", True, depth, base="bf16")
        if row["preempted"] != PRE_ARRIVALS or row["faults"] or \
                len(row["swap_out_s"]) != PRE_ARRIVALS or \
                len(row["resume_s"]) != PRE_ARRIVALS:
            raise AssertionError(f"[preempt swap depth {depth}] {row}")
    bases["int8"], _ = run("base int8", False, kv="int8")
    _, row = run("swap int8", True, kv="int8", base="int8")
    if row["preempted"] != PRE_ARRIVALS:
        raise AssertionError(f"[preempt swap int8] {row}")
    bases["slot"], _ = run("base legacy slot", False, layout="slot")
    _, row = run("replay legacy slot", True, layout="slot", base="slot")
    if row["preempted"] != PRE_ARRIVALS or row["swap_out_s"]:
        raise AssertionError(f"[preempt replay legacy slot] {row}")
    _, row = run("fault", True, inject="preempt:1:runtime", base="bf16")
    victims = [c for c in row["culprits"]]
    if row["faults"] != 1 or row["quarantined"] or len(victims) != 1 or \
            len(victims[0]) != 1 or "-b" not in victims[0][0]:
        raise AssertionError(f"[preempt fault] blamed {victims}: {row}")
    aborted, allow = [], set()

    def abort_hook(engine, reqs):
        if engine._swapped:
            rid = next(iter(engine._swapped))
            aborted.append((rid, engine._swap.bytes_used))
            allow.add(rid.split("-", 1)[1])
            engine.abort(rid)
            return True
        return False

    got, row = run("abort", True, hook=abort_hook, base="bf16", allow=allow)
    if len(aborted) != 1 or got[aborted[0][0].split("-", 1)[1]][1] != \
            "abort" or sum(v[1] == "abort" for v in got.values()) != 1:
        raise AssertionError(f"[preempt abort] {aborted} {row}")
    engine = _pre_engine(torch, dev, params, True)
    host_ms, per_step, names = _steady_launches(torch, engine)
    ref = weakref.ref(engine)
    del engine
    _freed_by_del(ref, "preempt steady")
    torch.cuda.empty_cache()
    off_names = ops["steady_names"]
    steady = {False: (ops["host_ms_per_step"][0],
                      ops["launches_per_step"][0], off_names),
              True: (host_ms, per_step, names)}
    diff = {k: names[k] - off_names[k] for k in set(names) | set(off_names)
            if names[k] != off_names[k]}
    only_on = sorted(set(names) - set(off_names))
    r = res["rounds"]
    res.update(
        ttft_off=r["base"]["ttft"], ttft_on=r["swap depth 2"]["ttft"],
        swap_out_s=r["swap depth 2"]["swap_out_s"],
        resume_s=r["swap depth 2"]["resume_s"],
        bytes=r["swap depth 2"]["bytes"],
        peak=(r["base"]["peak"], r["swap depth 2"]["peak"]),
        steady=(steady[False][1], steady[True][1]),
        steady_host_ms=(steady[False][0], steady[True][0]),
        abort_bytes=aborted[0][1])
    log(f"[preempt table] arrivals' median TTFT off {res['ttft_off']:.4f} s"
        f", on {res['ttft_on']:.4f} s; preempt_swap_seconds swap-out "
        f"{res['swap_out_s']}, resume {res['resume_s']}; bytes per victim "
        f"{res['bytes']}; peak device memory baseline {res['peak'][0]} B, "
        f"preempt round {res['peak'][1]} B "
        f"({(res['peak'][1] - res['peak'][0]) / 2**20:+.2f} MiB); launches "
        f"per steady step ARKS_PREEMPT unset (phase_operability's window) "
        f"{res['steady'][0]:.2f}, =1 {res['steady'][1]:.2f}, over the "
        f"window by kernel name differing "
        f"{ {k[:80]: v for k, v in diff.items()} }; host ms "
        f"{res['steady_host_ms']}; issues sync-checked {res['syncs']}; "
        f"phase took {time.perf_counter() - t_phase:.1f} s")
    if abs(res["steady"][1] - res["steady"][0]) >= 0.5 or only_on:
        raise AssertionError(f"[preempt] ARKS_PREEMPT=1 changes the kernel "
                             f"launches per steady step (only with it: "
                             f"{only_on})")
    return res



SPEC_STREAMS, SPEC_PROMPT, SPEC_TOKENS = 8, 128, 64   # the batch streams
SPEC_ARRIVALS, SPEC_ARR_TOKENS = 2, 16                # latency arrivals
SPEC_AFTER = 6                 # speculative dispatches before the arrivals
SPEC_DK = 4                    # --draft-len
SPEC_FAULT = "spec:5:runtime"
# A greedy spec stream may leave the target-only stream only where the
# target-only run's top-2 logprob gap is below this many nats: four bf16
# ulps of these logits (|logit| in [4, 8)), about twice the largest gap
# at which a sound run has left it, half the typical gap.
SPEC_GAP_BOUND = 0.125
SPEC_F32_TOKENS = 32
SPEC_B_TARGET, SPEC_B_DRAFT = "qwen2.5-1.5b", "qwen2.5-0.5b"
SPEC_ISSUES = ("_pipe_issue", "_issue_spec_mixed", "_issue_mixed",
               "_maybe_preempt", "_admit")


def _spec_engine(torch, dev, params, cfg, depth="2", draft=True, kv="bf16",
                 preempt=False, dtype="bfloat16"):
    """An engine on ``params`` (8 slots x 4096, chunk 256, the SLO ladder,
    ``ARKS_PREEMPT`` as asked): with ``draft`` a self-draft on the same
    params (speculative, ``SPEC_DK``), else the target alone."""
    import os

    from arks_tpu_torch.engine import EngineConfig, InferenceEngine
    from arks_tpu_torch.engine.tokenizer import ByteTokenizer
    env = dict(ARKS_PIPELINE_DEPTH=depth, ARKS_PREEMPT=str(int(preempt)),
               ARKS_SLO_TIERS=PRE_TIERS, ARKS_PREEMPT_MAX_INFLIGHT="2")
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return InferenceEngine(cfg, EngineConfig(
            model=MODEL, num_slots=SPEC_STREAMS,
            max_cache_len=MAX_PAGES * PAGE, prefill_chunk=PAGE, dtype=dtype,
            kv_cache_dtype=kv, kv_layout="paged", seed=SEED,
            draft_model=MODEL if draft else None, draft_len=SPEC_DK),
            ByteTokenizer(), params=params, device=dev,
            draft_params=params if draft else None,
            draft_cfg=cfg if draft else None)
    finally:
        _restore_env(os, old)


def _spec_requests(tag, lp=False, seeded=True, tokens=SPEC_TOKENS):
    """SPEC_STREAMS batch-tier streams (priority 1) of SPEC_PROMPT tokens,
    greedy and (``seeded``) seeded sampling by turns, and SPEC_ARRIVALS
    greedy latency-tier arrivals (priority 0); ``lp``: the greedy ones ask
    for top-2 logprobs (a target-only run, for ``_spec_near_ties``)."""
    from arks_tpu_torch.engine import Request, SamplingParams
    rng = np.random.default_rng(SEED + 31)
    reqs = []
    for i in range(SPEC_STREAMS):
        kw = dict(max_tokens=tokens, ignore_eos=True, priority=1)
        if seeded and i % 2:
            kw.update(temperature=0.8, top_k=50, seed=400 + i)
        else:
            kw.update(temperature=0.0, logprobs=2 if lp else None)
        reqs.append(Request(f"{tag}-b{i}", [int(x) for x in rng.integers(
            32, 120, SPEC_PROMPT)], SamplingParams(**kw)))
    late = [Request(f"{tag}-l{i}", [int(x) for x in rng.integers(
        32, 120, 64)], SamplingParams(
            max_tokens=SPEC_ARR_TOKENS, temperature=0.0, ignore_eos=True,
            priority=0, logprobs=2 if lp else None))
        for i in range(SPEC_ARRIVALS)]
    return reqs, late


def _spec_round(torch, engine, tag, lp, seeded, tokens, inject=""):
    """One round: the batch streams, then the arrivals once every stream
    has decoded SPEC_AFTER dispatches, driven from this thread (step and
    recover, as the run loop) with every issue under
    set_sync_debug_mode("error"); the kernel counts set to 0 before it.
    The requests (``_spec_requests``) die with the round: a replayer's
    gate holds the engine.  Returns (streams by name: (tokens, finish,
    error, logprobs), a dict of the round's figures)."""
    import queue

    from arks_tpu_torch.engine import faults
    reqs, late = _spec_requests(tag, lp, seeded, tokens)
    engine._faults = faults.FaultInjector(inject)
    m = engine.metrics
    before = (m.engine_faults_total.total(),
              m.requests_quarantined_total.total(),
              m.requests_preempted_total.total(), engine._spec_proposed,
              engine._spec_accepted, engine.dispatches)
    s0, n0 = m.spec_decode_accepted_length._data.get((), (0, 0.0, 0))[1:]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    out = {r.request_id.split("-", 1)[1]: [[], None, None, []]
           for r in reqs + late}
    all_reqs, late = reqs + late, list(late)
    d_start = t_first = t_done = None
    with _SyncGuard(torch, engine, SPEC_ISSUES) as guard:
        for r in reqs:
            engine.add_request(r)
        for _ in range(100_000):
            try:
                engine.step(block_s=0.001)
                engine._consec_faults = 0
            except Exception as e:  # routed as the run loop routes it
                engine._recover_from_fault(e)
            for r in all_reqs:
                rec = out[r.request_id.split("-", 1)[1]]
                while True:
                    try:
                        o = r.outputs.get_nowait()
                    except queue.Empty:
                        break
                    rec[0] += o.token_ids
                    rec[3] += o.logprobs or []
                    if o.finished:
                        rec[1], rec[2] = o.finish_reason, o.error
            batch = [out[f"b{i}"] for i in range(SPEC_STREAMS)]
            if t_first is None and all(v[0] for v in batch):
                t_first = time.perf_counter()
            if t_done is None and all(v[1] for v in batch):
                t_done = time.perf_counter()
            if late and d_start is None and \
                    len(engine._slots) == SPEC_STREAMS:
                d_start = engine.dispatches
            if late and d_start is not None and \
                    engine.dispatches - d_start >= SPEC_AFTER:
                for r in late:
                    r.arrival_time = time.monotonic()
                    engine.add_request(r)
                late = []
            if (not late and all(v[1] for v in out.values())
                    and engine.idle and engine.state == "serving"):
                break
        else:
            raise AssertionError(f"[spec {tag}] never drained")
    torch.cuda.synchronize()
    after = (m.engine_faults_total.total(),
             m.requests_quarantined_total.total(),
             m.requests_preempted_total.total(), engine._spec_proposed,
             engine._spec_accepted, engine.dispatches)
    d = [a - b for a, b in zip(after, before)]
    s1, n1 = m.spec_decode_accepted_length._data.get((), (0, 0.0, 0))[1:]
    toks = sum(len(out[f"b{i}"][0]) for i in range(SPEC_STREAMS))
    row = dict(faults=d[0], quarantined=d[1], preempted=d[2],
               proposed=d[3], accepted=d[4], dispatches=d[5],
               acceptance=d[4] / max(d[3], 1),
               accepted_len=(s1 - s0) / max(n1 - n0, 1),
               tok_s=toks / max(t_done - t_first, 1e-9),
               peak=torch.cuda.max_memory_allocated(),
               issues=guard.issues, syncs=guard.violations[:3],
               launches=_read_counts())
    return {k: tuple(v) for k, v in out.items()}, row


def _spec_whole(tag, got, want):
    """Every stream of ``got`` equals ``want``'s (ids, finish, no error)."""
    bad = [k for k, v in got.items() if v[:3] != want[k][:2] + (None,)]
    if bad:
        first = {k: next((i for i, (a, b) in enumerate(zip(
            got[k][0], want[k][0])) if a != b), None) for k in bad}
        raise AssertionError(f"[spec {tag}] streams {bad} differ (first "
                             f"differing token {first}; errors "
                             f"{ {k: got[k][2] for k in bad} })")


def _spec_near_ties(got, base):
    """Each greedy stream of the spec run ``got`` against the
    target-only run ``base`` (top-2 logprobs on its greedy streams): equal,
    or first differing where base's top-2 gap is below SPEC_GAP_BOUND.
    Returns [(stream, first differing index, gap)] of those that differ."""
    diff = []
    for k, (ids, fin, err, _) in got.items():
        bids, _, _, blps = base[k]
        if not blps:
            continue          # a seeded stream: no target-only counterpart
        i = next((j for j, (a, b) in enumerate(zip(ids, bids)) if a != b),
                 None)
        if i is None:
            if ids != bids:
                raise AssertionError(f"[spec ties] {k}: {len(ids)} tokens "
                                     f"against {len(bids)}")
            continue
        top = blps[i][1]
        gap = top[0][1] - top[1][1]
        diff.append((k, i, gap))
        if gap >= SPEC_GAP_BOUND:
            raise AssertionError(f"[spec ties] {k} leaves the target-only "
                                 f"stream at token {i}, top-2 gap {gap:.4f} "
                                 f">= {SPEC_GAP_BOUND}")
    return diff


def _spec_gaps(base):
    """The top-2 logprob gaps of every token of the target-only run's
    greedy streams: (median, mean, share below SPEC_GAP_BOUND) in nats,
    what SPEC_GAP_BOUND is read against."""
    gaps = sorted(top[0][1] - top[1][1] for _, _, _, lps in base.values()
                  for _, top in lps)
    if not gaps:
        raise AssertionError("[spec ties] no top-2 logprobs on the "
                             "target-only run")
    return (gaps[len(gaps) // 2], sum(gaps) / len(gaps),
            sum(g < SPEC_GAP_BOUND for g in gaps) / len(gaps))


def _spec_launch_check(tag, cfg, row, dk=SPEC_DK, kv="bf16", draft=True):
    """The round's kernels count num_layers x its dispatches (the verify
    block's row write and attention) and, for the draft, num_layers x
    draft_len x its dispatches (the slot writes and decode attention)."""
    n = row["dispatches"]
    quant = kv != "bf16"
    upd = "paged_kv_update_quant" if quant else "paged_kv_update"
    slot = "kv_cache_update_quant" if quant else "kv_cache_update"
    want = {k: 0 for k in row["launches"]}
    want[upd] = want["paged_mixed_attention"] = cfg.num_layers * n
    if draft:
        want[slot] = want["ragged_decode_attention"] = \
            cfg.num_layers * dk * n
    if row["launches"] != want or not n:
        raise AssertionError(f"[spec {tag}] launches {row['launches']}, "
                             f"expected {want}")


def _spec_kernels(torch, dev):
    """The path's kernels against their plain versions at the shapes
    speculative decoding adds: the slot writes and decode attention (#7,
    #8, #6) at the Qwen2.5-0.5B draft's head_dim 64 and group of 7
    (``slot_batch``: bf16 and int8 caches, a parked slot); the paged row
    write (#2, through the step's destinations) and the ragged mixed
    attention (#1) over verify blocks: 8 lanes of SPEC_DK rows at
    positions on and across page boundaries, at Qwen2.5-1.5B's group of 6
    and at Qwen2.5-7B's of 7.
    Writes bit-identical, attention within phase 3's limits.  Returns
    {kernel: max abs err}."""
    from arks_tpu_torch.ops import paged_attention as pa
    from arks_tpu_torch.ops import pallas_attention as pl
    errs = {}
    b = slot_batch(torch, dev, hkv=2, g=7, d=64)
    layer, rows = b["layer"], (b["k_new"], b["v_new"], b["write_idx"],
                               b["layer"])
    q, qf, args = b["q"], b["q"].float(), (b["lengths"], b["layer"])
    caches = {"bf16": [b["k_cache"], b["v_cache"]],
              "int8": list(_int8(pa, (b["k_cache"], b["v_cache"])))}
    for kv, base in caches.items():
        fn = pl.kv_cache_update if kv == "bf16" else pl.kv_cache_update_quant
        kern = [x.clone() for x in base]
        plain = [x.clone() for x in base]
        fn(*kern, *rows)
        fn(*plain, *rows, impl="plain")
        torch.cuda.synchronize()
        if not _same_bytes(torch, kern, plain):
            raise AssertionError(f"{fn.__name__} at head_dim 64 differs "
                                 "from its plain version")
        sc = {} if kv == "bf16" else dict(k_scale=kern[2], v_scale=kern[3])
        kf, vf = (kern[0].float(), kern[1].float()) if kv == "bf16" else \
            (kern[0], kern[1])
        got = pl.ragged_decode_attention(q, kern[0], kern[1], *args, **sc)
        want = pl.ragged_decode_attention(q, kern[0], kern[1], *args,
                                          impl="plain", **sc)
        got_f = pl.ragged_decode_attention(qf, kf, vf, *args, **sc)
        want_f = pl.ragged_decode_attention(qf, kf, vf, *args,
                                            impl="plain", **sc)
        torch.cuda.synchronize()
        errs[f"ragged_decode_attention {kv}"] = _attn_check(
            torch, f"ragged_decode_attention at head_dim 64, G 7 ({kv} "
            "slot cache)", got, want, want_f, got_f, 4, cross=kv == "bf16")
        errs[fn.__name__] = 0.0
        del kern, plain, kf, vf
    del b, caches
    starts = [254, 256, 509, 700, 1021, 1500, 2046, 3000]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    i32 = dict(dtype=torch.int32, device=dev)
    for hkv, g in ((2, 6), (4, 7)):
        lanes, d = len(starts), 128
        t = lanes * SPEC_DK
        n_pages = lanes * MAX_PAGES
        rng = np.random.default_rng(SEED + 2)
        tables = torch.as_tensor(rng.permutation(n_pages).reshape(
            lanes, MAX_PAGES).astype(np.int32), device=dev)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(
                torch.bfloat16)

        q = randn(t, hkv * g, d)
        k_new, v_new = randn(t, hkv, d), randn(t, hkv, d)
        pools = [randn(2, n_pages, hkv, PAGE, d) for _ in range(2)]
        lane = torch.arange(lanes, **i32)
        pos0 = torch.tensor(starts, **i32)
        pos = (pos0[:, None] + torch.arange(SPEC_DK, **i32)).reshape(-1)
        tab_tok = tables.repeat_interleave(SPEC_DK, dim=0)
        dst = pa.paged_write_rows(pos, tab_tok, PAGE, n_pages)
        kern = [x.clone() for x in pools]
        plain = [x.clone() for x in pools]
        pa.paged_kv_update(*kern, k_new, v_new, None, None, 1, dst=dst)
        pa.paged_kv_update(*plain, k_new, v_new, pos, tab_tok, 1,
                           impl="plain")
        torch.cuda.synchronize()
        if not _same_bytes(torch, kern, plain):
            raise AssertionError("paged_kv_update over verify blocks "
                                 "differs from the plain scatter")
        span = (tables, lane * SPEC_DK,
                torch.full((lanes,), SPEC_DK, **i32), pos0, 1)
        got = pa.paged_mixed_attention(q, *kern, *span, qmax=SPEC_DK)
        want = pa.paged_mixed_attention(q, *kern, *span, impl="plain")
        qf, kf, vf = q.float(), kern[0].float(), kern[1].float()
        want_f = pa.paged_mixed_attention(qf, kf, vf, *span, impl="plain")
        got_f = pa.paged_mixed_attention(qf, kf, vf, *span, qmax=SPEC_DK)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        err_x = (got.float() - want_f).abs().max().item()
        err_f = (got_f - want_f).abs().max().item()
        log(f"[spec kernels] verify blocks ({lanes} lanes x {SPEC_DK} rows) "
            f"at Hkv {hkv}, G {g}: paged_kv_update bit-identical; "
            f"paged_mixed_attention bf16 vs plain bf16 {err:.3e}, vs plain "
            f"f32 {err_x:.3e}, f32 kernel vs plain f32 {err_f:.3e}")
        if not (err <= ATTN_TOL_BF16 and err_x <= ATTN_TOL_F32
                and err_f <= ATTN_TOL_F32_KERNEL):
            raise AssertionError("paged_mixed_attention over verify blocks "
                                 "disagrees with its plain version")
        errs[f"paged_mixed_attention G {g}"] = err
        del kern, plain, pools, kf, vf
    torch.cuda.empty_cache()
    return errs


def _spec_step_profile(torch, dev, params, cfg):
    """One speculative pipe step (``spec_pipe``: the self-draft's
    SPEC_DK decode steps over 8 slots of its slot cache, then the 32-row
    verify block) beside a target-only pipe step (``mixed_pipe``, 8 rows)
    on the same 8 lanes at context 512, greedy: (host ms, device ms,
    launches) per step of each, from ``_profile_step``."""
    from arks_tpu_torch.engine import engine as engine_mod
    from arks_tpu_torch.engine import sampler
    from arks_tpu_torch.models import transformer as tf
    lanes, ctx = SPEC_STREAMS, 512
    maxp = ctx // PAGE + 1
    cache = tf.init_paged_cache(cfg, lanes * maxp, PAGE, torch.bfloat16, dev)
    dcache = tf.init_cache(cfg, lanes, 2 * ctx, torch.bfloat16, dev)
    i32 = dict(dtype=torch.int32, device=dev)
    tables = torch.arange(lanes * maxp, **i32).reshape(lanes, maxp)
    tokens = torch.full((lanes,), 5, **i32)
    lengths = torch.full((lanes,), ctx, **i32)
    alive = torch.ones(lanes, dtype=torch.bool, device=dev)
    stop = torch.full((lanes, sampler.STOP_IDS_MAX), -1, **i32)
    dead = torch.full((lanes,), 4096, **i32)
    state = sampler.init_sampling_state(lanes, SEED, cfg.vocab_size, dev)

    def spec():
        out = engine_mod.spec_pipe(
            params, cfg, params, cfg, cache, dcache, tokens, lengths, alive,
            stop, dead, alive, state, tables, None, sampler.OFF, False, 4096,
            SPEC_DK)
        return out[0].cpu()

    def pipe():
        out = engine_mod.mixed_pipe(
            params, cfg, cache, tokens, lengths, alive, stop, dead, state,
            tables, None, sampler.OFF, False, 4096)
        return out[0].cpu()

    res = {}
    for name, fn in (("spec", spec), ("pipe", pipe)):
        wall, dev_us, kern, _ = _profile_step(torch, fn, 1)
        res[name] = (wall, dev_us / 1e3, kern)
    del cache, dcache
    torch.cuda.empty_cache()
    return res


def _spec_config_b(torch, dev):
    """Config B through the server's own entry (``build_engine`` of
    ``--model qwen2.5-1.5b --draft-model qwen2.5-0.5b --draft-len 4``,
    random weights from SEED and SEED + 1) behind the OpenAI server at
    depth 2: two greedy and two seeded requests at once, each whole.
    Returns (per-request (status, finish, tokens), launches, acceptance,
    draft cache bytes, peak device memory above what was allocated before
    its engine: the config A weights the phase holds)."""
    from arks_tpu_torch.server import OpenAIServer
    from arks_tpu_torch.server import __main__ as server_main
    args = server_main.parse_args([
        "--model", SPEC_B_TARGET, "--draft-model", SPEC_B_DRAFT,
        "--draft-len", str(SPEC_DK), "--dtype", "bfloat16",
        "--kv-cache-dtype", "bf16", "--num-slots", str(SPEC_STREAMS),
        "--max-model-len", str(MAX_PAGES * PAGE), "--seed", str(SEED),
        "--device", dev.type])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _, engine = server_main.build_engine(args)
    dbytes = sum(t.nbytes for t in engine._draft_cache if t is not None)
    server = OpenAIServer(engine, SPEC_B_TARGET, host="127.0.0.1", port=0)
    server.start(background=True)
    engine.start()
    results = [None] * 4
    try:
        _reset_counts()

        def one(i):
            body = {"prompt": f"config B request {i}: speculate " * 4,
                    "max_tokens": 32, "ignore_eos": True,
                    "temperature": 0.0 if i % 2 == 0 else 0.8}
            if i % 2:
                body["seed"] = 500 + i
            st, data, _, _ = _request(server.port, "/v1/completions", body)
            results[i] = (st, data["choices"][0]["finish_reason"]
                          if st == 200 else data,
                          data["usage"]["completion_tokens"]
                          if st == 200 else 0)

        threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        launches = _read_counts()
    finally:
        server.stop()
        engine.stop()
    acc = engine._spec_accepted / max(engine._spec_proposed, 1)
    peak = torch.cuda.max_memory_allocated() - held
    ref = weakref.ref(engine)
    del engine, server
    _freed_by_del(ref, "spec config B")
    torch.cuda.empty_cache()
    return results, launches, acc, dbytes, peak


def phase_spec(torch, dev, params):
    """Speculative decoding on Qwen2.5-7B bf16 at full width, cut to
    CUT_LAYERS layers (``params``' first layers), with a self-draft on the same params (draft_len 4): 8
    batch-tier streams of 128-token prompts and 64 tokens (greedy and
    seeded by turns) and 2 greedy latency-tier arrivals after 6
    dispatches, every issue under set_sync_debug_mode("error").
    Rounds: the target alone (top-2 logprobs on its greedy streams), the
    spec engine at depth 2 (the baseline), at depth 0, with
    ``spec:5:runtime`` and with ``ARKS_PREEMPT=1`` (replay mode: the
    arrivals preempt), each equal to the baseline whole, and an int8
    pool at depth 2, whole.  Each greedy spec stream equals the target's
    or leaves it first where the target's top-2 gap is below
    SPEC_GAP_BOUND.  Each round's kernels count num_layers x its
    dispatches (#1, #2 or #3) and num_layers x draft_len x its dispatches
    (#6, #7 or #8).  Then an f32 self-draft at Qwen2.5-7B width cut to
    F32_LAYERS layers over a bf16 cache: its 8 greedy streams equal the
    target-only engine's whole, acceptance >= 0.95.  Then config B
    (Qwen2.5-1.5B with a Qwen2.5-0.5B draft, through the server).  First
    the kernels at the shapes speculative decoding adds
    (``_spec_kernels``).
    Logs acceptance, accepted length, a spec step beside a target-only
    pipe step (launches, device ms), 8-stream tok/s with spec on and off,
    the draft cache bytes and the peak device memory."""
    from arks_tpu_torch.models import get_config
    from arks_tpu_torch.models import transformer as tf
    t_phase = time.perf_counter()
    cfg, params = _cut_model(params)
    res = dict(rounds={}, syncs=0, launches=collections.Counter())
    rows = res["rounds"]
    res["kernel_errs"] = _spec_kernels(torch, dev)

    def run(tag, draft=True, depth="2", kv="bf16", preempt=False, inject="",
            lp=False, p=params, c=cfg, dtype="bfloat16", seeded=True,
            tokens=SPEC_TOKENS):
        engine = _spec_engine(torch, dev, p, c, depth, draft, kv, preempt,
                              dtype)
        want_mode = "off" if not preempt else "replay"
        if engine.resolved_config["preempt"] != want_mode or \
                engine.resolved_config["spec_mixed"] != str(draft).lower():
            raise AssertionError(f"[spec {tag}] {engine.resolved_config}")
        got, row = _spec_round(torch, engine, tag, lp, seeded, tokens,
                               inject)
        if draft:
            row["draft_bytes"] = sum(t.nbytes for t in engine._draft_cache
                                     if t is not None)
        res["syncs"] += row["issues"]
        res["launches"].update(row["launches"])
        log(f"[spec {tag}] {json.dumps({k: v for k, v in row.items()})}")
        if row["syncs"]:
            raise AssertionError(f"[spec {tag}] host syncs {row['syncs']}")
        _spec_launch_check(tag, c, row, kv=kv, draft=draft)
        bad = {k: v[1:3] for k, v in got.items() if v[1] != "length"}
        if bad:
            raise AssertionError(f"[spec {tag}] streams not whole: {bad}")
        rows[tag] = row
        ref = weakref.ref(engine)
        del engine
        _freed_by_del(ref, f"spec {tag}")
        torch.cuda.empty_cache()
        return got

    target = run("target", draft=False, lp=True)
    base = run("depth 2")
    _spec_whole("depth 0", run("depth 0", depth="0"), base)
    _spec_whole("fault", run("fault", inject=SPEC_FAULT), base)
    _spec_whole("preempt", run("preempt", preempt=True), base)
    run("int8", kv="int8")
    r = rows
    if r["fault"]["faults"] != 1 or r["fault"]["quarantined"]:
        raise AssertionError(f"[spec fault] {r['fault']}")
    if r["preempt"]["preempted"] != SPEC_ARRIVALS:
        raise AssertionError(f"[spec preempt] {r['preempt']}")
    ties = _spec_near_ties(base, target)
    gaps = _spec_gaps(target)
    # f32 at Qwen2.5-7B width cut to F32_LAYERS, bf16 cache: greedy.
    f32cfg = dataclasses.replace(cfg, num_layers=F32_LAYERS)
    f32p = tf.init_params(f32cfg, SEED, torch.float32, dev)
    kw = dict(kv="bf16", p=f32p, c=f32cfg, dtype="float32", seeded=False,
              tokens=SPEC_F32_TOKENS)
    f32_base = run("f32 target", draft=False, **kw)
    _spec_whole("f32", run("f32", **kw), f32_base)
    if r["f32"]["acceptance"] < 0.95:
        raise AssertionError(f"[spec f32] acceptance {r['f32']}")
    del f32p
    torch.cuda.empty_cache()
    step = _spec_step_profile(torch, dev, params, cfg)
    b_res, b_launch, b_acc, b_bytes, b_peak = _spec_config_b(torch, dev)
    res["launches"].update(b_launch)
    if any(x[:2] != (200, "length") or x[2] != 32 for x in b_res) or \
            not all(b_launch[k] for k in (
                "paged_kv_update", "paged_mixed_attention",
                "kv_cache_update", "ragged_decode_attention")):
        raise AssertionError(f"[spec config B] {b_res} {b_launch}")
    res.update(
        acceptance=r["depth 2"]["acceptance"],
        accepted_len=r["depth 2"]["accepted_len"],
        acceptance_int8=r["int8"]["acceptance"],
        acceptance_f32=r["f32"]["acceptance"], acceptance_b=b_acc,
        tok_s=(r["target"]["tok_s"], r["depth 2"]["tok_s"]),
        step=step, draft_bytes=r["depth 2"]["draft_bytes"],
        draft_bytes_b=b_bytes, peak=(r["target"]["peak"],
                                     r["depth 2"]["peak"], b_peak),
        ties=ties, gaps=gaps)
    log(f"[spec table] Qwen2.5-7B self-draft bf16, draft_len {SPEC_DK}: "
        f"acceptance {res['acceptance']:.4f} (int8 pool "
        f"{res['acceptance_int8']:.4f}, f32 {res['acceptance_f32']:.4f}, "
        f"config B {res['acceptance_b']:.4f}), accepted length "
        f"{res['accepted_len']:.3f}; greedy streams differing from the "
        f"target-only run {len(ties)} {ties} (bound {SPEC_GAP_BOUND}; "
        f"the target-only run's top-2 gaps: median {gaps[0]}, mean "
        f"{gaps[1]}, share below the bound {gaps[2]}); "
        f"8-stream tok/s target-only {res['tok_s'][0]:.1f}, spec "
        f"{res['tok_s'][1]:.1f}; spec step host {step['spec'][0]:.2f} ms, "
        f"device {step['spec'][1]:.3f} ms, {step['spec'][2]:.0f} launches; "
        f"target-only pipe step host {step['pipe'][0]:.2f} ms, device "
        f"{step['pipe'][1]:.3f} ms, {step['pipe'][2]:.0f} launches; draft "
        f"cache bytes {res['draft_bytes']} (config B {b_bytes}); peak "
        f"device memory target-only {res['peak'][0]} B, spec "
        f"{res['peak'][1]} B, config B {res['peak'][2]} B above the config "
        f"A weights; config B "
        f"{b_res}; issues sync-checked {res['syncs']}; phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return res


# ---------------------------------------------------------------------------
# Multi-model pool, scale-to-zero, windowed residency
# ---------------------------------------------------------------------------

POOL_MODELS = (MODEL, "qwen2.5-1.5b", "qwen2.5-0.5b")   # primary, the pool's
POOL_ORDER = (0, 1, 2, 1, 0)     # the rounds' models, by index
POOL_PROMPT, POOL_TOKENS = 200, 32   # 4 greedy + 4 seeded streams a round
POOL_AFTER = 4                   # dispatches of a round before the next's
POOL_ISSUES = ("_pipe_issue", "_issue_mixed")
ZERO_IDLE_S = "1"                # ARKS_ELASTIC_IDLE_ZERO_S of phase_zero
ZERO_TOKENS = 32
RES_WINDOW, RES_PROMPT, RES_TOKENS = 6, 1200, 512
RES_LAYERS = 3                   # Qwen2.5-7B's first layers (full width)
RES_PROF_STEPS = 16              # tokens a timed / traced window
RES_ISSUES = ("_pipe_issue", "_issue_mixed", "_issue_residency")
RES_ROUNDS = (("greedy d2 bf16", "2", "bf16", False),    # tag, depth, pool,
              ("seeded d0 bf16", "0", "bf16", True),     # seeded
              ("greedy d2 int8", "2", "int8", False))
MIB = 1 << 20


def _pool_ecfg(model, **kw):
    from arks_tpu_torch.engine import EngineConfig
    return EngineConfig(**dict(dict(
        model=model, num_slots=8, max_cache_len=MAX_PAGES * PAGE,
        prefill_chunk=PAGE, dtype="bfloat16", kv_cache_dtype="bf16",
        seed=SEED), **kw))


def _pool_requests(rnd, model):
    """Round ``rnd``'s 8 streams for ``model`` (None: the primary): its own
    prompts (no prefix is shared across rounds), greedy and seeded by
    turns."""
    from arks_tpu_torch.engine import Request, SamplingParams
    rng = np.random.default_rng(SEED + 40 + rnd)
    reqs = []
    for i in range(8):
        kw = dict(max_tokens=POOL_TOKENS, ignore_eos=True,
                  temperature=0.0 if i % 2 == 0 else 0.8, top_k=50,
                  seed=700 + 10 * rnd + i)
        reqs.append(Request(f"r{rnd}-{i}", [int(x) for x in rng.integers(
            32, 120, POOL_PROMPT)], SamplingParams(**kw), model=model))
    return reqs


def _drive_rounds(torch, engine, rounds, after=None, on_step=None):
    """Drive ``rounds`` (lists of requests) from this thread through the
    engine's step/recover contract: round k+1 is added once round k's
    streams all decode and ``after`` more dispatches ran (None: once round
    k has ended).  ``on_step(engine)`` runs after every step.  Returns
    ({rid: [tokens, finish, error, first-prefill shape]}, host syncs
    caught on the issue paths)."""
    import queue
    out, shapes = {}, {}
    real_reg = engine._register_slot

    def register(req, slot, first, num_prompt, first_lp=None, shape=None):
        shapes.setdefault(req.request_id, shape)
        return real_reg(req, slot, first, num_prompt, first_lp, shape)

    engine._register_slot = register
    added, live, mark = 0, [], None
    try:
        with _SyncGuard(torch, engine, POOL_ISSUES) as guard:
            for _ in range(200_000):
                cur = rounds[added - 1] if added else []
                if added < len(rounds) and (
                        not added or (after is not None and mark is not None
                                      and engine.dispatches - mark >= after)
                        or all(out[r.request_id][1] for r in cur)):
                    for r in rounds[added]:
                        out[r.request_id] = [[], None, None]
                        engine.add_request(r)
                    live += rounds[added]
                    added, mark = added + 1, None
                try:
                    engine.step(block_s=0.001)
                    engine._consec_faults = 0
                except Exception as e:  # routed as the run loop routes it
                    engine._recover_from_fault(e)
                for r in live:
                    rec = out[r.request_id]
                    while True:
                        try:
                            o = r.outputs.get_nowait()
                        except queue.Empty:
                            break
                        rec[0] += o.token_ids
                        if o.finished:
                            rec[1], rec[2] = o.finish_reason, o.error
                cur = rounds[added - 1]
                if mark is None and all(out[r.request_id][0] for r in cur):
                    mark = engine.dispatches
                if on_step is not None:
                    on_step(engine)
                if added == len(rounds) and all(v[1] for v in out.values()) \
                        and engine.idle and not engine._model_loads:
                    break
            else:
                raise AssertionError("[pool] the rounds never drained")
    finally:
        del engine._register_slot
    return ({k: tuple(v) + (shapes.get(k),) for k, v in out.items()},
            (guard.issues, guard.violations))


def _pool_same(tag, got, base):
    """Every stream of ``got`` was prefilled as in ``base`` (the same chunk
    cuts) and equals it: token ids, finish reason, no error."""
    cut = {k: (got[k][3], base[k][3]) for k in base if got[k][3] != base[k][3]}
    if cut:
        raise AssertionError(f"[pool {tag}] streams prefilled otherwise than "
                             f"on their single-model engine: {cut}")
    bad = {k: next((i for i, (a, b) in enumerate(zip(got[k][0], base[k][0]))
                    if a != b), None)
           for k in base if got[k][:3] != base[k][:3]}
    if bad:
        raise AssertionError(f"[pool {tag}] streams differ from their "
                             f"single-model engine's (first differing token "
                             f"{bad}): {[got[k][1:3] for k in bad]}")


def _pool_server(torch, dev):
    """The server's entry: ``build_engine`` of Qwen2.5-1.5B with a
    Qwen2.5-0.5B draft, ``--extra-model`` Qwen2.5-7B and a
    ``--model-pool-hbm-mb`` that holds all three, behind the OpenAI
    server: ``/v1/models`` lists the three with their ``arks`` blocks, the
    draft a pinned pool entry; a request naming Qwen2.5-7B is served by it
    (its load, then a switch), one naming an unknown model gets 404."""
    from arks_tpu_torch.engine.model_pool import tree_bytes
    from arks_tpu_torch.server import OpenAIServer
    from arks_tpu_torch.server import __main__ as server_main
    primary, draft = POOL_MODELS[1], POOL_MODELS[2]
    args = server_main.parse_args([
        "--model", primary, "--draft-model", draft, "--draft-len", "4",
        "--extra-model", POOL_MODELS[0], "--model-pool-hbm-mb", "65536",
        "--dtype", "bfloat16", "--kv-cache-dtype", "bf16",
        "--num-slots", "8", "--max-model-len", str(MAX_PAGES * PAGE),
        "--seed", str(SEED), "--device", dev.type])
    _, engine = server_main.build_engine(args)
    server = OpenAIServer(engine, primary, host="127.0.0.1", port=0)
    server.start(background=True)
    engine.start()
    try:
        st, models, _ = _get(server.port, "/v1/models")
        rows = {m["id"]: m.get("arks") for m in models["data"]}
        entry = engine.pool.entry(draft)
        if st != 200 or set(rows) != set(POOL_MODELS) or \
                not all(rows.values()) or not rows[draft]["pinned"] or \
                not entry.pinned or entry.params is not engine._draft_params:
            raise AssertionError(f"[pool server] /v1/models {models}")
        body = {"prompt": "pool server request", "max_tokens": 16,
                "ignore_eos": True, "temperature": 0.0}
        st, data, _, _ = _request(server.port, "/v1/completions",
                                  dict(body, model=POOL_MODELS[0]))
        if st != 200 or data["choices"][0]["finish_reason"] != "length" or \
                data["model"] != POOL_MODELS[0]:
            raise AssertionError(f"[pool server] extra model: {st} {data}")
        st, data, _, _ = _request(server.port, "/v1/completions",
                                  dict(body, model="no-such-model"))
        if st != 404:
            raise AssertionError(f"[pool server] unknown model: {st} {data}")
        st, models, _ = _get(server.port, "/v1/models")
        res = dict(models={m["id"]: m.get("arks") for m in models["data"]},
                   switch=engine.last_switch_stats,
                   draft_bytes=tree_bytes(engine.pool.params_of(draft)))
    finally:
        server.stop()
        engine.stop()
    ref = weakref.ref(engine)
    del engine, server, entry
    _freed_by_del(ref, "pool server")
    torch.cuda.empty_cache()
    return res


def phase_pool(torch, dev, params):
    """The weight pool on Qwen2.5-7B bf16 at full width (``params``, the
    pinned primary), 8 slots x 4096, depth 2: Qwen2.5-1.5B and
    Qwen2.5-0.5B registered with ``register_model`` (the seed's init, as a
    single-model engine of each boots), ``ARKS_MODEL_POOL_HBM_MB`` set from
    the three trees' ``tree_bytes`` so that 7B + 1.5B fit and the three do
    not.  Rounds of 4 greedy and 4 seeded streams go to 7B, 1.5B, 0.5B,
    1.5B, 7B; each round's requests arrive while the one before it is
    still decoding (its load streams beside it).  The 0.5B does not fit
    beside the active 1.5B: the engine steps back to the 7B, the 1.5B is
    evicted (its saved context and KV pool dropped), and it comes back as
    a cold start.  Every stream equals the same request on a single-model
    engine of its model, bit for bit, prefilled with the same chunk cuts;
    every issue sync-checked.  Logs each switch's seconds and the
    dispatches issued during its load (and their deepest pipeline), the
    pool's resident bytes beside memory_allocated after each switch and
    eviction, and the peak device memory.  Then the server's entry
    (``_pool_server``)."""
    import os

    from arks_tpu_torch.engine import InferenceEngine
    from arks_tpu_torch.engine.model_pool import ModelPool, tree_bytes
    from arks_tpu_torch.engine.tokenizer import ByteTokenizer
    from arks_tpu_torch.models import get_config
    from arks_tpu_torch.models import transformer as tf
    t_phase = time.perf_counter()
    cfgs = [get_config(n) for n in POOL_MODELS]
    sizes = [tree_bytes(params)]
    for c in cfgs[1:]:
        p = tf.init_params(c, SEED, torch.bfloat16, dev)
        sizes.append(tree_bytes(p))
        del p
    torch.cuda.empty_cache()
    budget_mb = -(-(sizes[0] + sizes[1] + sizes[2] // 2) // MIB)
    if sizes[0] + sizes[1] > budget_mb * MIB or \
            sum(sizes) <= budget_mb * MIB:
        raise AssertionError(f"[pool] budget {budget_mb} MiB for {sizes}")
    names = [None if i == 0 else cfgs[i].name for i in POOL_ORDER]
    rounds = [_pool_requests(k, m) for k, m in enumerate(names)]
    # The single-model baselines: one engine a model, its rounds in order.
    base, launches = {}, collections.Counter()
    for i, c in enumerate(cfgs):
        env = dict(ARKS_PIPELINE_DEPTH="2")
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            engine = InferenceEngine(c, _pool_ecfg(c.name), ByteTokenizer(),
                                     params=params if i == 0 else None,
                                     device=dev)
        finally:
            _restore_env(os, old)
        mine = [[dataclasses.replace(r, model=None, outputs=type(
            r.outputs)()) for r in rnd]
            for k, rnd in enumerate(rounds) if POOL_ORDER[k] == i]
        _reset_counts()
        got, (issues, viol) = _drive_rounds(torch, engine, mine)
        launches.update(_read_counts())
        if viol:
            raise AssertionError(f"[pool base {c.name}] host syncs {viol}")
        base.update(got)
        ref = weakref.ref(engine)
        del engine
        _freed_by_del(ref, f"pool base {c.name}")
        torch.cuda.empty_cache()
    # The pooled engine.
    env = dict(ARKS_PIPELINE_DEPTH="2", ARKS_MODEL_POOL_HBM_MB=str(budget_mb))
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        engine = InferenceEngine(cfgs[0], _pool_ecfg(MODEL), ByteTokenizer(),
                                 params=params, device=dev, pool=ModelPool())
    finally:
        _restore_env(os, old)
    for c in cfgs[1:]:
        engine.register_model(c.name)
    pool = engine.pool
    evictions, switches, seen = [], [], [engine.cfg.name, None]
    real_evict = pool.on_evict

    def on_evict(name):
        real_evict(name)
        evictions.append(name)

    pool.on_evict = on_evict

    def on_step(eng):
        if eng.last_switch_stats is not seen[1]:
            seen[1] = eng.last_switch_stats
            torch.cuda.synchronize()
            switches.append(dict(eng.last_switch_stats, evicted=list(
                evictions), resident=pool.resident_bytes(),
                allocated=torch.cuda.memory_allocated() - held))
            evictions.clear()

    _reset_counts()
    got, (issues, viol) = _drive_rounds(torch, engine, rounds,
                                        after=POOL_AFTER, on_step=on_step)
    counts = _read_counts()
    launches.update(counts)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    if viol:
        raise AssertionError(f"[pool] host syncs on the issue paths {viol}")
    _pool_same("pooled", {k: got[k] for k in base}, base)
    cold = {c.name: int(engine.metrics.model_cold_starts_total.get(
        model=c.name)) for c in cfgs[1:]}
    evicted = [name for s in switches for name in s["evicted"]]
    m = engine.metrics
    res = dict(switches=switches, cold=cold, peak=peak, issues=issues,
               switch_s=m.model_switch_seconds._data,
               faults=m.engine_faults_total.total(), sizes=sizes,
               budget_mb=budget_mb, pooled_launches=counts)
    log(f"[pool] {json.dumps({k: v for k, v in res.items() if k != 'switch_s'}, default=str)}")
    if cold != {cfgs[1].name: 2, cfgs[2].name: 1} or \
            cfgs[1].name not in evicted or res["faults"] or \
            [s["model"] for s in switches if s["model"] != MODEL] != \
            [cfgs[i].name for i in POOL_ORDER if i]:
        raise AssertionError(f"[pool] evictions and cold starts: {res}")
    if not (counts["paged_kv_update"] and counts["paged_mixed_attention"]):
        raise AssertionError(f"[pool] kernels {counts}")
    del pool.on_evict
    ref = weakref.ref(engine)
    del engine, pool, real_evict, on_evict, on_step
    _freed_by_del(ref, "pool")
    torch.cuda.empty_cache()
    _reset_counts()
    res["server"] = _pool_server(torch, dev)
    launches.update(_read_counts())
    res["launches"] = launches
    log(f"[pool table] budget {budget_mb} MiB for trees {sizes} B; "
        f"switches (model, seconds, dispatches during the load, deepest "
        f"pipeline, evicted, pool resident B, allocated above the phase "
        f"start B) {[(s['model'], round(s['seconds'], 3), s['overlap_dispatches'], s['overlap_max_depth'], s['evicted'], s['resident'], s['allocated']) for s in switches]}; "
        f"cold starts {cold}; peak device memory above the primary's "
        f"weights {peak} B; server pass {res['server']}; issues "
        f"sync-checked {issues}; phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return res


def phase_zero(torch, dev, ops):
    """Scale-to-zero on the Qwen2.5-7B bf16 engine shape (8 slots x 4096,
    depth 2) with ARKS_ELASTIC_IDLE_ZERO_S=1, behind the OpenAI server.  The
    engine draws its own weights from SEED (they must free with it).  A
    greedy and a seeded request, then the idle engine disarms:
    memory_allocated and memory_reserved fall by at least its weight bytes
    plus its K+V pool bytes, /readiness answers 503 "scaled to zero
    (disarmed)" and /v1/elastic/status armed false.  The same requests
    re-arm it and give the streams they gave before.  Logs
    scale_from_zero_seconds, then the steady step's launches (a window as
    phase_operability's) against phase_operability's: under half a launch
    a step apart, no kernel name new."""
    import os

    from arks_tpu_torch.engine import InferenceEngine
    from arks_tpu_torch.engine.model_pool import tree_bytes
    from arks_tpu_torch.engine.tokenizer import ByteTokenizer
    from arks_tpu_torch.models import get_config
    from arks_tpu_torch.server import OpenAIServer
    t_phase = time.perf_counter()
    env = dict(ARKS_PIPELINE_DEPTH="2", ARKS_ELASTIC_IDLE_ZERO_S=ZERO_IDLE_S)
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        engine = InferenceEngine(get_config(MODEL), _pool_ecfg(MODEL),
                                 ByteTokenizer(), device=dev)
    finally:
        _restore_env(os, old)
    wbytes = tree_bytes(engine.params)
    kvbytes = sum(t.nbytes for t in engine.cache if t is not None)
    server = OpenAIServer(engine, MODEL, host="127.0.0.1", port=0)
    server.start(background=True)
    engine.start()
    bodies = [{"prompt": f"scale to zero request {i}: " * 8,
               "max_tokens": ZERO_TOKENS, "ignore_eos": True,
               "temperature": 0.0 if i == 0 else 0.8, "seed": 900 + i}
              for i in range(2)]

    def serve():
        out = []
        for body in bodies:
            st, data, _, _ = _request(server.port, "/v1/completions", body)
            if st != 200:
                raise AssertionError(f"[zero] {st} {data}")
            out.append(data["choices"][0]["text"])
        return out

    try:
        _reset_counts()
        first = serve()
        torch.cuda.synchronize()
        before = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
        deadline = time.monotonic() + 60
        while engine.armed and time.monotonic() < deadline:
            time.sleep(0.05)
        if engine.armed:
            raise AssertionError("[zero] the idle engine never disarmed")
        torch.cuda.synchronize()
        after = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
        st_r, rdy, _ = _get(server.port, "/readiness")
        st_s, status, _ = _get(server.port, "/v1/elastic/status")
        drop = (before[0] - after[0], before[1] - after[1])
        if min(drop) < wbytes + kvbytes or st_r != 503 or \
                "disarmed" not in json.dumps(rdy) or st_s != 200 or \
                status["armed"] is not False:
            raise AssertionError(f"[zero] disarm: memory before {before}, "
                                 f"after {after}, weights {wbytes} + K+V "
                                 f"{kvbytes}; readiness {st_r} {rdy}; "
                                 f"status {st_s} {status}")
        second = serve()
        launches = _read_counts()
        if second != first:
            raise AssertionError(f"[zero] streams after the re-arm differ: "
                                 f"{first} vs {second}")
        rearm = dict(engine.last_rearm_stats)
        st_r, rdy, _ = _get(server.port, "/readiness")
        if st_r != 200 or rdy["elastic"]["armed"] is not True:
            raise AssertionError(f"[zero] readiness after the re-arm {rdy}")
    finally:
        server.stop()
        engine.stop()
    host_ms, per_step, names = _steady_launches(torch, engine)
    m = engine.metrics
    res = dict(before=before, after=after, drop=drop, weight_bytes=wbytes,
               kv_bytes=kvbytes, rearm=rearm,
               zero_events=m.engine_resizes_total.get(mode="scale_to_zero",
                                                      outcome="ok"),
               scale_from_zero_seconds=m.scale_from_zero_seconds._data,
               steady=(ops["launches_per_step"][0], per_step),
               steady_host_ms=(ops["host_ms_per_step"][0], host_ms),
               launches=launches)
    ref = weakref.ref(engine)
    del engine, server
    _freed_by_del(ref, "zero")
    torch.cuda.empty_cache()
    off_names = ops["steady_names"]
    only_new = sorted(set(names) - set(off_names))
    moved = {k[:80]: names[k] - off_names[k] for k in names | off_names
             if names[k] != off_names[k]}
    log(f"[zero table] memory allocated / reserved before the disarm "
        f"{before}, after {after}, fell {drop} B (weights {wbytes} + K+V "
        f"pool {kvbytes} B); re-arm {rearm}; scale_from_zero_seconds "
        f"{res['scale_from_zero_seconds']}; launches per steady step "
        f"phase_operability {res['steady'][0]:.2f}, after the re-arm "
        f"{res['steady'][1]:.2f}; by kernel name, after the re-arm less "
        f"phase_operability, over the window: {moved}; host ms "
        f"{res['steady_host_ms']}; phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    if res["zero_events"] < 1 or \
            abs(res["steady"][1] - res["steady"][0]) >= 0.5 or only_new:
        raise AssertionError(f"[zero] steady step after the re-arm: "
                             f"{res['steady']} (new kernels {only_new}, "
                             f"by name {moved})")
    return res


def _res_engine(torch, dev, cfg, params, window, depth, kv):
    import os

    from arks_tpu_torch.engine import InferenceEngine
    from arks_tpu_torch.engine.tokenizer import ByteTokenizer
    env = dict(ARKS_PIPELINE_DEPTH=depth,
               ARKS_RESIDENCY_WINDOW_PAGES=str(window))
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return InferenceEngine(cfg, _pool_ecfg(
            MODEL, num_slots=1, kv_cache_dtype=kv, prefix_cache_mb=0),
            ByteTokenizer(), params=params, device=dev)
    finally:
        _restore_env(os, old)


def _res_window(torch, engine, steps):
    """Host ms per token over ``steps`` synchronised steps (one token a
    step), then over as many under torch.profiler: device µs and launches
    per token, and the device timeline's host-to-device copies against its
    kernels (copy µs, and the copy µs that ran while a kernel ran)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step(block_s=0.001)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.step(block_s=0.001)
        torch.cuda.synchronize()
    kern, us, _ = _trace_counts(torch, prof)
    copies, kernels = [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        span = (ev.start_ns(), ev.end_ns())
        (copies if "Memcpy HtoD" in ev.name() else kernels).append(span)
    copy_us = sum(b - a for a, b in copies) / 1e3
    # The kernels' busy intervals merged, then each copy's time inside them.
    busy = []
    for a, b in sorted(kernels):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    starts = [a for a, _ in busy]
    overlap_us = 0.0
    for a, b in copies:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(busy) and busy[i][0] < b:
            overlap_us += max(0, min(b, busy[i][1]) - max(a, busy[i][0])) / 1e3
            i += 1
    return dict(host_ms=host_ms, device_us=us / steps,
                launches=sum(kern.values()) / steps,
                htod_us=copy_us / steps, htod_overlap_us=overlap_us / steps)


def _res_run(torch, dev, cfg, params, tag, window, depth, kv, seeded):
    """One request of RES_PROMPT tokens and RES_TOKENS (greedy with top-2
    logprobs, or seeded) on a one-slot engine, driven from this thread
    with every issue sync-checked; a timed and a traced window of
    RES_PROF_STEPS tokens once the slot decodes past 1,536 positions
    (engaged, on a windowed engine).  Returns ((tokens, logprobs, finish),
    row)."""
    import queue

    from arks_tpu_torch.engine import Request, SamplingParams
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    engine = _res_engine(torch, dev, cfg, params, window, depth, kv)
    rng = np.random.default_rng(SEED + 60)
    kw = dict(temperature=0.8, top_k=50, seed=61) if seeded else \
        dict(temperature=0.0, logprobs=2)
    req = Request(f"res-{tag}", [int(x) for x in rng.integers(
        32, 120, RES_PROMPT)], SamplingParams(
            max_tokens=RES_TOKENS, ignore_eos=True, **kw))
    toks, lps, fin, win, store = [], [], None, None, 0
    per_token = None
    # Wall seconds of the steps by the slot's state after them (prefill,
    # decoding resident, engaged), their counts and the slowest one.
    walls = collections.defaultdict(lambda: [0.0, 0, 0.0])
    engine.add_request(req)
    with _SyncGuard(torch, engine, RES_ISSUES) as guard:
        for _ in range(100_000):
            t_step = time.perf_counter()
            engine.step(block_s=0.001)
            dt = time.perf_counter() - t_step
            r = engine._residency
            state = ("engaged" if r is not None and r.slots else
                     "decode" if toks else "prefill")
            w = walls[state]
            w[0], w[1], w[2] = w[0] + dt, w[1] + 1, max(w[2], dt)
            while True:
                try:
                    o = req.outputs.get_nowait()
                except queue.Empty:
                    break
                toks += o.token_ids
                lps += o.logprobs or []
                if o.finished:
                    fin = o.finish_reason
            if r is not None and r.slots:
                store = max(store, r.store_bytes())
            if win is None and len(toks) >= RES_WINDOW * PAGE - RES_PROMPT \
                    + 8 and RES_TOKENS - len(toks) > 3 * RES_PROF_STEPS:
                _reset_counts()
                win = _res_window(torch, engine, RES_PROF_STEPS)
                # One token a step, timed and traced windows alike.
                per_token = {k: v / (2 * RES_PROF_STEPS)
                             for k, v in _read_counts().items() if v}
            if fin is not None and engine.idle:
                break
    torch.cuda.synchronize()
    m = engine.metrics
    row = dict(window=window, depth=depth, kv=kv, seeded=seeded,
               spans=m.residency_spans_total.total(),
               prefetch_pages=m.residency_prefetch_pages_total.total(),
               store_bytes=store, pool_pages=engine._alloc.num_pages,
               peak=torch.cuda.max_memory_allocated() - held,
               issues=guard.issues, syncs=len(guard.violations),
               prof=win, launches_per_token=per_token,
               context=RES_PROMPT + len(toks),
               walls={k: (round(v[0], 3), v[1], round(v[2], 4))
                      for k, v in walls.items()})
    violations = guard.violations
    ref = weakref.ref(engine)
    del engine, guard
    _freed_by_del(ref, f"residency {tag}")
    torch.cuda.empty_cache()
    if violations:
        raise AssertionError(f"[residency {tag}] host syncs {violations}")
    return (toks, lps, fin), row


def phase_residency(torch, dev, params):
    """Windowed residency on Qwen2.5-7B bf16 at full width, cut to
    RES_LAYERS layers (``params``, their first layers): one slot, pages of 256, ARKS_RESIDENCY_WINDOW_PAGES=6 (a 1,536-token
    device pool), a 1,200-token prompt and 512 generated tokens (a
    1,712-token final context, past the pool: ~170 tokens decode through
    the span chain).  Rounds: greedy with logprobs at depth 2 over a bf16
    pool, seeded at depth 0 over bf16, greedy with logprobs at depth 2
    over an int8 pool; each against a control engine with the window off
    at the same depth and pool: token ids, finish reason and logprob
    floats equal bit for bit, residency_spans_total > 0, every issue
    (the windowed token's ``_issue_residency`` included) sync-checked.
    Logs the spans and prefetched pages, host and device ms and launches
    per windowed token beside a control token, the host-to-device copy
    time of a windowed token and how much of it ran beside a kernel, the
    host-store bytes and each engine's peak device memory."""
    t_phase = time.perf_counter()
    cfg, params = _cut_model(params, RES_LAYERS)
    rows, launches = {}, collections.Counter()
    for tag, depth, kv, seeded in RES_ROUNDS:
        _reset_counts()
        base, brow = _res_run(torch, dev, cfg, params, tag + " control", 0,
                              depth, kv, seeded)
        got, row = _res_run(torch, dev, cfg, params, tag, RES_WINDOW, depth,
                            kv, seeded)
        launches.update(_read_counts())
        rows[tag] = (row, brow)
        log(f"[residency {tag}] {json.dumps(dict(windowed=row, control=brow), default=str)}")
        if got != base or base[2] != "length" or len(got[0]) != RES_TOKENS:
            first = next((i for i, (a, b) in enumerate(zip(got[0], base[0]))
                          if a != b), None)
            raise AssertionError(
                f"[residency {tag}] the windowed stream differs from the "
                f"control's (first differing token {first}; logprobs equal "
                f"{got[1] == base[1]}; finish {got[2]} / {base[2]})")
        if row["spans"] <= 0 or row["prefetch_pages"] <= 0 or \
                row["context"] <= row["pool_pages"] * PAGE:
            raise AssertionError(f"[residency {tag}] the span path did not "
                                 f"run: {row}")
    res = dict(rows=rows, launches=launches)
    w, c = rows["greedy d2 bf16"]
    log(f"[residency table] {torch.cuda.get_device_name(0)}: per windowed "
        f"token (greedy, depth 2, bf16) {w['prof']} vs a control token "
        f"{c['prof']}; launches per windowed token {w['launches_per_token']}"
        f"; spans {w['spans']}, prefetched pages {w['prefetch_pages']}; "
        f"host store {w['store_bytes']} B; peak device memory windowed "
        f"{w['peak']} B, control {c['peak']} B; phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return res


# ---------------------------------------------------------------------------
# Phase: disaggregated prefill/decode (prefill server in a child process)
# ---------------------------------------------------------------------------

DIS_LENS = (100, 256, 400, 560, 700, 850, 1000, 1024)   # prompt tokens
DIS_KINDS = ("greedy", "seeded", "logprobs", "guided", "greedy", "seeded",
             "greedy", "greedy")
DIS_TOKENS = 32
DIS_GUIDE = "[a-f]+"
DIS_CHILD_TIMEOUT = 240
DIS_ISSUES = ("_pipe_issue", "_issue_mixed", "_admit_prefilled")
# The parent's own one-shot prefill against the child's K/V: the same
# weights (both drawn from SEED on the card) give the same bits, or a bf16
# ulp if a GEMM picked another algorithm; other weights differ by O(1).
DIS_SAME_WEIGHTS_TOL = 0.0625


class _Tee:
    """A request's output queue that also keeps what it carried (token
    ids, logprob entries, the finish): the server reads the same queue."""

    def __init__(self):
        import queue
        self.q = queue.Queue()
        self.ids, self.lps = [], []
        self.finish = self.error = None
        self.done = threading.Event()

    def put(self, item, *a, **kw):
        self.ids += item.token_ids
        self.lps += item.logprobs or []
        if item.finished:
            self.finish, self.error = item.finish_reason, item.error
            self.done.set()
        self.q.put(item, *a, **kw)

    def get(self, *a, **kw):
        return self.q.get(*a, **kw)

    def get_nowait(self):
        return self.q.get_nowait()

    def empty(self):
        return self.q.empty()


@contextlib.contextmanager
def _teed(engine, tees):
    """Give every request added to ``engine`` a ``_Tee``, keyed in
    ``tees`` by its prompt length (the prefilled state's for a transferred
    request).  The instance attribute goes on exit (a bound method kept
    there would be a cycle holding the engine)."""
    outer = vars(engine).get("add_request")
    orig = engine.add_request

    def add(req):
        if not isinstance(req.outputs, _Tee):
            req.outputs = _Tee()
        n = req.prefilled.num_prompt if req.prefilled is not None \
            else len(req.prompt_ids)
        tees[n] = req.outputs
        orig(req)

    engine.add_request = add
    try:
        yield tees
    finally:
        if outer is None:
            del engine.add_request
        else:
            engine.add_request = outer


def _post_stream(port, path, body, headers=None):
    """POST a streaming completion: (status, error payload or None, seconds
    to the first SSE frame, total seconds)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
    t0 = time.perf_counter()
    conn.request("POST", path, json.dumps(dict(body, stream=True)),
                 dict({"Content-Type": "application/json"}, **(headers or {})))
    resp = conn.getresponse()
    if resp.status != 200:
        data = resp.read()
        conn.close()
        return resp.status, data[:300], None, time.perf_counter() - t0
    t_first = None
    for raw in resp:
        line = raw.decode().strip()
        if line.startswith("data: ") and t_first is None:
            t_first = time.perf_counter() - t0
        if line == "data: [DONE]":
            break
    conn.close()
    return 200, None, t_first, time.perf_counter() - t0


def _concurrently(fn, items):
    out = [None] * len(items)

    def run(i, x):
        out[i] = fn(x)

    threads = [threading.Thread(target=run, args=(i, x))
               for i, x in enumerate(items)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def _dis_bodies():
    """The eight requests: token-id prompts of DIS_LENS tokens, greedy and
    seeded, one with logprobs, one guided (greedy)."""
    rng = np.random.default_rng(SEED + 71)
    bodies = []
    for i, (n, kind) in enumerate(zip(DIS_LENS, DIS_KINDS)):
        body = {"prompt": [int(x) for x in rng.integers(32, 120, n)],
                "max_tokens": DIS_TOKENS, "temperature": 0.0}
        if kind == "seeded":
            body.update(temperature=0.8, top_k=50, seed=500 + i,
                        ignore_eos=True)
        elif kind == "guided":
            body["guided_regex"] = DIS_GUIDE
        else:
            body["ignore_eos"] = True
        if kind == "logprobs":
            body["logprobs"] = 2
        bodies.append(body)
    return bodies


def _dis_child(dev):
    """Start ``python -m arks_tpu_torch.server --disaggregation-mode
    prefill`` (Qwen2.5-7B at full width, random weights from SEED, one
    slot, no prefix retention); returns (process, port, log path) once its
    readiness answers 200."""
    import os
    import socket
    import tempfile
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    fd, path = tempfile.mkstemp(prefix="arks-prefill-", suffix=".log")
    env = dict(os.environ, ARKS_PREFIX_HOST_MB="0")
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-m", "arks_tpu_torch.server", "--model", MODEL,
         "--disaggregation-mode", "prefill", "--host", "127.0.0.1",
         "--port", str(port), "--device", dev.type, "--dtype", "bfloat16",
         "--kv-cache-dtype", "bf16", "--num-slots", "1",
         "--max-model-len", str(MAX_PAGES * PAGE), "--prefix-cache-mb", "0",
         "--seed", str(SEED)], cwd=root, env=env, stdout=fd,
        stderr=subprocess.STDOUT)
    os.close(fd)
    deadline = time.monotonic() + DIS_CHILD_TIMEOUT
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            break
        try:
            if _get(port, "/readiness")[0] == 200:
                return proc, port, path
        except OSError:
            pass
        time.sleep(0.25)
    _dis_stop_child(proc)
    with open(path, errors="replace") as f:
        tail = f.read()[-3000:]
    raise AssertionError(f"[disagg] the prefill server did not come up "
                         f"(exit {proc.returncode}): {tail}")


def _dis_stop_child(proc):
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)


def _dis_engine(torch, dev, params, kv):
    """A Qwen2.5-7B decode (or unified) engine on ``params``: 8 slots x
    4096, chunk = page = 256, a ``kv`` pool, depth 2, with DIS_GUIDE
    compiled before any request comes (a compile racing admission moves
    chunk cuts)."""
    import os

    from arks_tpu_torch.engine import EngineConfig, InferenceEngine
    from arks_tpu_torch.engine.tokenizer import ByteTokenizer
    from arks_tpu_torch.models import get_config
    old = {"ARKS_PIPELINE_DEPTH": os.environ.get("ARKS_PIPELINE_DEPTH")}
    os.environ["ARKS_PIPELINE_DEPTH"] = "2"
    try:
        engine = InferenceEngine(get_config(MODEL), EngineConfig(
            model=MODEL, num_slots=8, max_cache_len=MAX_PAGES * PAGE,
            prefill_chunk=PAGE, dtype="bfloat16", kv_cache_dtype=kv,
            seed=SEED), ByteTokenizer(), params=params, device=dev)
    finally:
        _restore_env(os, old)
    engine.guides.compile("regex", DIS_GUIDE)
    return engine


def _dis_unified(torch, dev, params, kv, bodies):
    """The unified baseline: the eight requests through ``/v1/completions``
    of a fresh engine, concurrently (the greedy ones with top-2 logprobs,
    for the near-tie rule).  Returns ({prompt length: (ids, finish, error,
    logprob entries)}, TTFTs)."""
    from arks_tpu_torch.server import OpenAIServer
    engine = _dis_engine(torch, dev, params, kv)
    server = OpenAIServer(engine, MODEL, host="127.0.0.1", port=0)
    server.start(background=True)
    engine.start()
    tees = {}
    try:
        with _teed(engine, tees):
            res = _concurrently(lambda b: _post_stream(
                server.port, "/v1/completions",
                dict(b, logprobs=b.get("logprobs", 2))
                if b["temperature"] == 0.0 else b), bodies)
    finally:
        server.stop()
        engine.stop()
    bad = [r for r in res if r[0] != 200]
    if bad:
        raise AssertionError(f"[disagg unified {kv}] {bad}")
    out = {n: (t.ids, t.finish, t.error, t.lps) for n, t in tees.items()}
    ref = weakref.ref(engine)
    del engine, server, tees
    _freed_by_del(ref, f"disagg unified {kv}")
    torch.cuda.empty_cache()
    return out, [r[2] for r in res]


def _near_tie(what, toks, btoks, gap):
    """The near-tie rule: a disaggregated greedy stream ``toks`` against
    the unified one ``btoks`` is equal, or parts first where the unified
    stream's top-2 logprob gap (``gap(i)``) is at most SPEC_GAP_BOUND
    (one-shot and chunked prefills round apart in bf16).  Returns None
    when equal, else (first differing token, its gap); raises otherwise.
    ``what`` names the stream in the error."""
    i = next((j for j, (a, b) in enumerate(zip(toks, btoks)) if a != b),
             None)
    if i is None:
        if len(toks) != len(btoks):
            raise AssertionError(f"{what}: {len(toks)} tokens against "
                                 f"{len(btoks)}")
        return None
    g = gap(i)
    if g > SPEC_GAP_BOUND:
        raise AssertionError(f"{what} leaves the unified stream at token "
                             f"{i}, top-2 gap {g:.4f} > {SPEC_GAP_BOUND}")
    return i, g


def _dis_near_ties(tag, got, base):
    """Greedy disaggregated streams against the unified ones under the
    near-tie rule (``_near_tie``).  Returns [(prompt length, first
    differing token, gap)]."""
    diff = []
    for n, (ids, fin, err, _) in got.items():
        bids, _, _, blps = base[n]
        if err is not None:
            raise AssertionError(f"[disagg {tag}] prompt {n}: {fin} {err}")
        if DIS_KINDS[DIS_LENS.index(n)] == "seeded":
            continue
        tie = _near_tie(f"[disagg {tag}] prompt {n}", ids, bids,
                        lambda i: blps[i][1][0][1] - blps[i][1][1][1])
        if tie is not None:
            diff.append((n, *tie))
    return diff


def _dis_pages(torch, engine, pulled, kv):
    """Every transferred prompt's full pages, found through the device
    index, against ``tf.insert_pages`` of the K/V the server received,
    byte for byte (k, v and, on an int8 pool, the scales).  Returns the
    pages compared."""
    from arks_tpu_torch.engine.paged import chain_digests
    from arks_tpu_torch.models import transformer as tf
    from arks_tpu_torch.models.config import get_config
    cfg = get_config(MODEL)
    compared = 0
    for n, (meta, k, v) in pulled.items():
        full = n // PAGE
        if not full:
            continue
        digs = chain_digests(meta["prompt_ids"], PAGE, full)
        pages = [engine._alloc._index.get(d) for d in digs]
        if None in pages:
            raise AssertionError(f"[disagg {kv}] prompt {n}: a full page "
                                 "is not in the device index")
        npg = -(-n // PAGE)
        scratch = tf.init_paged_cache(
            cfg, npg, PAGE, torch.bfloat16, engine.device,
            quantized=kv == "int8", kv_bits=8)
        tf.insert_pages(scratch, k.to(engine.device), v.to(engine.device),
                        torch.arange(npg, device=engine.device), npg)
        for j, pg in enumerate(pages):
            for name, pool, want in zip(("k", "v", "k_scale", "v_scale"),
                                        engine.cache, scratch):
                if pool is None:
                    continue
                if not torch.equal(pool[:, pg], want[:, j]):
                    raise AssertionError(f"[disagg {kv}] prompt {n} page "
                                         f"{j}: {name} bytes differ from "
                                         "insert_pages of the received K/V")
            compared += 1
        del scratch
    return compared


def _dis_round(torch, dev, params, kv, bodies, child_port, base):
    """One decode pool dtype: the eight requests through the DecodeServer's
    ``/v1/disagg/completions`` (it pulls from the child), every issue and
    every prefilled admission under the sync guard; the same pulled states
    handed to the engine in process; then the checks.  Returns the row."""
    from arks_tpu_torch.engine import Request
    from arks_tpu_torch.engine import kv_transfer
    from arks_tpu_torch.server.disagg import DecodeServer, prefilled_state
    from arks_tpu_torch.server.openai_server import sampling_from_body
    engine = _dis_engine(torch, dev, params, kv)
    server = DecodeServer(engine, MODEL, host="127.0.0.1", port=0)
    server.start(background=True)
    addr = f"127.0.0.1:{child_port}"
    pulled, pulls = {}, {}
    orig_pull = server.pull_kv

    def pull(a, body, chat):
        t0 = time.perf_counter()
        meta, (k, v) = orig_pull(a, body, chat)
        pulls[meta["num_prompt"]] = (time.perf_counter() - t0,
                                     k.nbytes + v.nbytes)
        pulled[meta["num_prompt"]] = (meta, k, v)
        return meta, (k, v)

    server.pull_kv = pull
    engine.start()
    tees, own = {}, {}
    c0 = _read_counts()
    d0 = engine.dispatches
    try:
        with _NoSync(torch, engine, DIS_ISSUES) as guard, \
                _teed(engine, tees):
            res = _concurrently(lambda b: _post_stream(
                server.port, "/v1/disagg/completions", b,
                {"X-Arks-Prefill-Addr": addr}), bodies)
            bad = [r for r in res if r[0] != 200]
            if bad:
                raise AssertionError(f"[disagg {kv}] {bad}")
            launches = {k: v - c0[k] for k, v in _read_counts().items()}
            # The wire round trip: the same bodies pulled here and handed
            # to the engine in process.
            states = []
            for b in bodies:
                t0 = time.perf_counter()
                meta, (k, v) = orig_pull(addr, b, False)
                states.append((b, prefilled_state(meta, k, v),
                               time.perf_counter() - t0,
                               len(kv_transfer.pack(meta, [k, v]))))
            tees_own = {}
            with _teed(engine, tees_own):
                for b, pf, _, _ in states:
                    params_b, _ = sampling_from_body(b, engine.tokenizer,
                                                     engine)
                    engine.add_request(Request(
                        f"own-{pf.num_prompt}", [], params_b, prefilled=pf))
                for t in tees_own.values():
                    if not t.done.wait(600):
                        raise AssertionError(f"[disagg {kv}] an in-process "
                                             "request did not finish")
            own = tees_own
            syncs = dict(guard.calls)
        del guard
    finally:
        server.stop()
        engine.stop()
    del server.pull_kv
    got = {n: (t.ids, t.finish, t.error, t.lps) for n, t in tees.items()}
    mine = {n: (t.ids, t.finish, t.error, t.lps) for n, t in own.items()}
    for n in got:
        if got[n][:3] != mine[n][:3] or len(got[n][3]) != len(mine[n][3]) \
                or any(a[0] != b[0] for a, b in zip(got[n][3], mine[n][3])):
            raise AssertionError(f"[disagg {kv}] prompt {n}: the served "
                                 f"stream {got[n][:3]} is not the in-process "
                                 f"one {mine[n][:3]}")
    lp_n = DIS_LENS[DIS_KINDS.index("logprobs")]
    if len(got[lp_n][3]) != DIS_TOKENS:
        raise AssertionError(f"[disagg {kv}] the logprob stream carries "
                             f"{len(got[lp_n][3])} entries")
    g_n = DIS_LENS[DIS_KINDS.index("guided")]
    if not _walks(engine.guides, ("regex", DIS_GUIDE), got[g_n][0]):
        raise AssertionError(f"[disagg {kv}] the guided stream leaves its "
                             f"guide: {got[g_n][0]}")
    ties = _dis_near_ties(kv, got, base)
    pages = _dis_pages(torch, engine, pulled, kv)
    n_steps = engine.dispatches - d0
    upd = "paged_kv_update_quant" if kv == "int8" else "paged_kv_update"
    if not launches["paged_mixed_attention"] or not launches[upd] or \
            syncs.get("_admit_prefilled", 0) < len(bodies):
        raise AssertionError(f"[disagg {kv}] launches {launches}, "
                             f"guarded calls {syncs}")
    row = dict(ttft_disagg=[r[2] for r in res], pulls=pulls,
               own_pull_s=[s for _, _, s, _ in states],
               wire_bytes=[nb for _, _, _, nb in states],
               ties=ties, pages=pages, launches=launches, syncs=syncs,
               dispatches=n_steps)
    ref = weakref.ref(engine)
    del engine, server, tees, own, pulled
    _freed_by_del(ref, f"disagg {kv}")
    torch.cuda.empty_cache()
    return row


def phase_disagg(torch, dev, params):
    """Prefill/decode disaggregation on Qwen2.5-7B at full width and depth:
    the prefill server a child process (``python -m arks_tpu_torch.server
    --disaggregation-mode prefill``, its own weights from SEED), the decode
    server (DecodeServer, the mixed scheduler at depth 2) in this process
    on ``params`` with a bf16 pool and then an int8 one.  Eight requests of
    100-1,024 tokens (the one-shot limit), greedy and seeded, one with
    logprobs, one guided, concurrently:
    - each served stream equals, bit for bit, the stream of the same
      pulled state handed to the engine in process (the wire round trip);
    - each prompt's full pool pages equal ``tf.insert_pages`` of the
      received K/V, byte for byte;
    - greedy streams against the unified engine's keep the near-tie rule
      (a one-shot and a chunked prefill round apart in bf16);
    - the child's K/V equal this process's own one-shot prefill within
      DIS_SAME_WEIGHTS_TOL (the same weights on both sides).
    Logs the bytes per transfer, the pull seconds and the TTFTs."""
    from arks_tpu_torch.models import transformer as tf
    from arks_tpu_torch.models.config import get_config
    from arks_tpu_torch.server.disagg import DecodeServer
    t_phase = time.perf_counter()
    bodies = _dis_bodies()
    proc, port, path = _dis_child(dev)
    t_up = time.perf_counter() - t_phase
    rows = {}
    _reset_counts()
    try:
        meta, (k, _) = DecodeServer.pull_kv(f"127.0.0.1:{port}", bodies[0],
                                            False)
        ids = meta["prompt_ids"]
        bucket = k.shape[2]
        toks = torch.zeros((1, bucket), dtype=torch.int32, device=dev)
        toks[0, :len(ids)] = torch.tensor(ids, device=dev)
        _, ks, _ = tf.prefill(params, get_config(MODEL), toks,
                              torch.tensor([len(ids)], dtype=torch.int32,
                                           device=dev))
        same_w = (ks.cpu().float() - k.float()).abs().max().item()
        del ks
        if same_w > DIS_SAME_WEIGHTS_TOL:
            raise AssertionError(f"[disagg] the child's K differ from this "
                                 f"process's prefill by {same_w}: other "
                                 "weights")
        for kv in ("bf16", "int8"):
            base, ttft_u = _dis_unified(torch, dev, params, kv, bodies)
            row = _dis_round(torch, dev, params, kv, bodies, port, base)
            row["ttft_unified"] = ttft_u
            rows[kv] = row
            log(f"[disagg {kv}] " + json.dumps(dict(
                bytes_per_transfer=dict(zip(DIS_LENS, row["wire_bytes"])),
                pull_s_served={n: round(s, 4) for n, (s, _) in
                               sorted(row["pulls"].items())},
                pull_s_own=dict(zip(DIS_LENS, [round(s, 4) for s in
                                               row["own_pull_s"]])),
                ttft_disagg_s=dict(zip(DIS_LENS, [round(s, 4) for s in
                                                  row["ttft_disagg"]])),
                ttft_unified_s=dict(zip(DIS_LENS, [round(s, 4) for s in
                                                   ttft_u])),
                near_ties=row["ties"], pages_compared=row["pages"],
                guarded_calls=row["syncs"], launches=row["launches"])))
    finally:
        _dis_stop_child(proc)
    launches = _read_counts()
    log(f"[disagg table] prefill child up in {t_up:.1f} s; its K within "
        f"{same_w} of this process's prefill; 1,024-token transfer "
        f"{rows['bf16']['wire_bytes'][-1]} B; launches {launches}; phase "
        f"took {time.perf_counter() - t_phase:.1f} s")
    return dict(rows=rows, launches=launches, same_weights=same_w)


# ---------------------------------------------------------------------------
# Phase: the fleet's prefix tiers (peer fetch, the disk tier, the sketch)
# ---------------------------------------------------------------------------

FLEET_PREFIX, FLEET_TAIL, FLEET_TOKENS = 1024, 100, 32
FLEET_HOST_PAGES = 2          # the disk engine's host budget, in pages
FLEET_ISSUES = ("_pipe_issue", "_issue_mixed", "_issue_restore",
                "_spill_flush")


def _hist_sum(h):
    """(observations, their sum in seconds) of an unlabelled histogram."""
    n = total = 0
    for _, t, c in h._data.values():
        n, total = n + c, total + t
    return n, total


def _fleet_engine(torch, dev, params, **env):
    """A Qwen2.5-7B engine on ``params`` (8 slots x 4096, chunk = page =
    256, bf16 pool, depth 2) under the ``env`` knobs."""
    import os
    env = dict({"ARKS_PIPELINE_DEPTH": "2"}, **env)
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return _dis_engine(torch, dev, params, "bf16")
    finally:
        _restore_env(os, old)


def _fleet_serve(engine, port, body, headers=None):
    """One streamed completion through ``port`` (the engine's thread
    running): (ids, TTFT seconds)."""
    tees = {}
    with _teed(engine, tees):
        st, err, t_first, _ = _post_stream(port, "/v1/completions", body,
                                           headers)
    if st != 200:
        raise AssertionError(f"[fleet] {st} {err}")
    (tee,) = tees.values()
    if tee.error is not None or len(tee.ids) != FLEET_TOKENS:
        raise AssertionError(f"[fleet] {tee.finish} {tee.error}")
    return tee.ids, t_first


def phase_fleet(torch, dev, params):
    """The fleet's prefix tiers on Qwen2.5-7B at full width (``params``
    shared by every replica), bf16 pools, depth 2:
    - peer fetch: replica A serves a 1,024-token shared prefix plus a
      tail, its pages evicted into its host tier; A's warm stream restores
      them.  Replica B (``ARKS_PEER_FETCH=1``) gets the request with
      ``x-arks-peer-hint`` A: its 4 pages come from A over ``GET
      /v1/cache/blocks/``, only the tail is prefilled, its restored pages
      equal A's host blocks byte for byte and its stream A's warm stream
      bit for bit;
    - the sketch: A's ``GET /v1/cache/sketch`` lists the warm digests at
      tier 0;
    - disk: engine C (``ARKS_PREFIX_DISK_MB``, a host tier of
      FLEET_HOST_PAGES pages) serves the prompt, its pages evicted through
      the host tier to disk; stopped and rebuilt on the same directory, it
      serves the prompt with ``prefix_cache_hit_tokens_total{tier="disk"}``
      1,024 and A's warm stream;
    - scale-to-zero: the rebuilt engine serves a second prompt, disarms
      when idle (``ARKS_ELASTIC_IDLE_ZERO_S``), and the second prompt's
      warm pages are on disk.
    Every issue of A, B and C runs under the sync guard.  Logs the peer
    and disk restore seconds and the TTFTs."""
    import shutil
    import tempfile

    from arks_tpu_torch.engine.paged import chain_digests
    from arks_tpu_torch.server import OpenAIServer
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 91)
    prefix = [int(x) for x in rng.integers(32, 120, FLEET_PREFIX)]
    body = {"prompt": prefix + [int(x) for x in rng.integers(
        32, 120, FLEET_TAIL)], "max_tokens": FLEET_TOKENS,
        "temperature": 0.0, "ignore_eos": True}
    digs = chain_digests(body["prompt"], PAGE, FLEET_PREFIX // PAGE)
    launches = collections.Counter()
    ddir = tempfile.mkdtemp(prefix="arks-fleet-disk-")
    res = {}
    try:
        # ---- replica A: cold, evicted to its host tier, warm ------------
        a = _fleet_engine(torch, dev, params)
        srv_a = OpenAIServer(a, MODEL, host="127.0.0.1", port=0)
        srv_a.start(background=True)
        a.start()
        _reset_counts()
        with _NoSync(torch, a, FLEET_ISSUES):
            cold, ttft_cold = _fleet_serve(a, srv_a.port, body)
            a.stop()
            _evict_prefix(a, digs)
            _settle_spills(a)
            host = _spilled(a, digs, "[fleet A]")
            a.start()
            warm, ttft_warm = _fleet_serve(a, srv_a.port, body)
        st, sketch, _ = _get(srv_a.port, "/v1/cache/sketch")
        tops = set(sketch["tiers"]["device"]["top"]) if st == 200 else set()
        if any(d[:8].hex() not in tops for d in digs):
            raise AssertionError(f"[fleet sketch] the warm digests are not "
                                 f"at tier 0: {st} {sketch}")
        res["sketch"] = dict(epoch=sketch["epoch"],
                             device=sketch["tiers"]["device"]["count"],
                             host=sketch["tiers"]["host"]["count"])
        # ---- replica B: the same prompt, its prefix from A --------------
        b = _fleet_engine(torch, dev, params, ARKS_PEER_FETCH="1")
        srv_b = OpenAIServer(b, MODEL, host="127.0.0.1", port=0)
        srv_b.start(background=True)
        b.start()
        p0 = b.prefill_tokens_total
        try:
            with _NoSync(torch, b, FLEET_ISSUES):
                got_b, ttft_b = _fleet_serve(
                    b, srv_b.port, body,
                    {"x-arks-peer-hint": f"127.0.0.1:{srv_a.port}"})
        finally:
            srv_b.stop()
            b.stop()
            srv_a.stop()
            a.stop()
        m = b.metrics
        fetched = m.prefix_peer_fetch_blocks_total.get(source="peer")
        prefilled = b.prefill_tokens_total - p0
        if fetched != len(digs) or \
                m.prefix_cache_hit_tokens_total.get(tier="peer") != \
                FLEET_PREFIX or prefilled != FLEET_TAIL:
            raise AssertionError(f"[fleet peer] fetched {fetched} blocks, "
                                 f"prefilled {prefilled} tokens")
        same = _same_pages(torch, b, digs, host, "[fleet peer]")
        if got_b != warm:
            raise AssertionError(f"[fleet peer] B's stream {got_b} is not "
                                 f"A's warm stream {warm}")
        res["peer"] = dict(
            ttft_cold=ttft_cold, ttft_warm=ttft_warm, ttft_peer=ttft_b,
            fetch_s=_hist_sum(m.prefix_peer_fetch_seconds),
            restore_s=list(b.prefix_restore_seconds), pages_equal=same,
            cold_equals_warm=cold == warm)
        launches.update(_read_counts())
        refs = [weakref.ref(x) for x in (a, b)]
        del a, b, srv_a, srv_b, m
        for r, tag in zip(refs, ("fleet A", "fleet B")):
            _freed_by_del(r, tag)
        torch.cuda.empty_cache()
        # ---- the disk tier across a restart (driven from this thread) ---
        disk_env = dict(ARKS_PREFIX_DISK_MB="4096", ARKS_PREFIX_DISK_DIR=ddir)
        c = _fleet_engine(torch, dev, params, **disk_env)
        c._host.capacity = FLEET_HOST_PAGES * c._page_bytes
        _reset_counts()
        with _NoSync(torch, c, FLEET_ISSUES):
            _prefix_run(torch, c, body["prompt"], FLEET_TOKENS)
            _evict_prefix(c, digs)
            _settle_spills(c)
            for _ in range(1000):             # the writer takes the rest
                c.step(block_s=0.001)
                if not c._disk_spill_pending and \
                        c._disk_write_queue.empty():
                    break
        spilled = c._disk.num_blocks
        c.stop()                       # flushes the host tier's blocks too
        if not spilled or not all(c._disk.has(x) for x in digs):
            raise AssertionError(f"[fleet disk] blocks on disk {spilled} "
                                 f"before the stop, digests there "
                                 f"{[c._disk.has(x) for x in digs]}")
        ref = weakref.ref(c)
        del c
        _freed_by_del(ref, "fleet C")
        torch.cuda.empty_cache()
        d = _fleet_engine(torch, dev, params, ARKS_ELASTIC_IDLE_ZERO_S="1",
                          **disk_env)
        second = [int(x) for x in rng.integers(32, 120, FLEET_PREFIX
                                               + FLEET_TAIL)]
        digs2 = chain_digests(second, PAGE, FLEET_PREFIX // PAGE)
        try:
            with _NoSync(torch, d, FLEET_ISSUES):
                got_d, ttft_d, pre_d = _prefix_run(torch, d, body["prompt"],
                                                   FLEET_TOKENS)
                _prefix_run(torch, d, second, FLEET_TOKENS)
            deadline = time.monotonic() + 60
            while d.armed and time.monotonic() < deadline:
                d.step(block_s=0.05)
            zero_ok = not d.armed and all(d._disk.has(x) for x in digs2)
        finally:
            d.stop()
        md = d.metrics
        if got_d != warm or pre_d != FLEET_TAIL or \
                md.prefix_cache_hit_tokens_total.get(tier="disk") != \
                FLEET_PREFIX or not zero_ok:
            raise AssertionError(
                f"[fleet disk] stream equal {got_d == warm}, prefilled "
                f"{pre_d}, disk hit tokens "
                f"{md.prefix_cache_hit_tokens_total.get(tier='disk')}, "
                f"scale-to-zero left the warm blocks on disk {zero_ok}")
        res["disk"] = dict(ttft=ttft_d,
                           fetch_s=_hist_sum(md.prefix_peer_fetch_seconds),
                           restore_s=list(d.prefix_restore_seconds),
                           spilled_before_stop=spilled,
                           blocks=d._disk.num_blocks,
                           bytes=d._disk.bytes_used,
                           host_pages=FLEET_HOST_PAGES)
        launches.update(_read_counts())
        ref = weakref.ref(d)
        del d, md
        _freed_by_del(ref, "fleet D")
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ddir, ignore_errors=True)
    if not launches["paged_mixed_attention"] or \
            not launches["paged_kv_update"]:
        raise AssertionError(f"[fleet] launches {dict(launches)}")
    log(f"[fleet table] " + json.dumps(dict(
        res, launches=dict(launches),
        seconds=round(time.perf_counter() - t_phase, 1)), default=str))
    return dict(res, launches=launches)


# ---------------------------------------------------------------------------
# Phase 17: training (arks_tpu_torch/train/)
# ---------------------------------------------------------------------------

TRAIN_MODEL = "qwen2.5-1.5b"          # (a): full widths and depth
TRAIN_PARAMS = 1_543_714_304          # its leaves (embedding tied)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 8
TRAIN_LR = 1e-4
TRAIN_MOE_MODEL = "qwen2-57b-a14b"     # (b): full widths, 1 of 28 layers
TRAIN_MOE_PARAMS = 3_100_494_336
TRAIN_MOE_LAYERS, TRAIN_MOE_BATCH, TRAIN_MOE_STEPS = 1, 4, 3
# (b)'s leaves whose first-step gradient is read: every expert of the
# w_ stacks that received rows nonzero (and the others zero), the rest
# nonzero.
TRAIN_MOE_GRADS = ("layers/router", "layers/shared_gate",
                   "layers/shared_gate_proj", "layers/shared_up",
                   "layers/shared_down", "layers/w_gate", "layers/w_up",
                   "layers/w_down")
TRAIN_CLI_MODEL = "qwen2.5-0.5b"       # (c): the entry point
TRAIN_CLI_TIMEOUT = 300
# The restore's peak device memory may pass the state it allocates by its
# largest leaf (one staged copy) and this much more (allocator rounding).
TRAIN_RESTORE_SLACK = 64 << 20
# The training forward's last-position logits vs prefill's: the layer
# body is shared, only the unembed's row count M differs (B * T vs B), so
# cuBLAS may pick another f32 GEMM.  Relative to max |logit|.
TRAIN_LOGIT_RTOL = 1e-5
# A state in bytes: params, gradients and two AdamW moments, all f32.
STATE_BYTES_PER_PARAM = 16


def _train_corpus(n=160, seed=SEED):
    """Seeded records of random lowercase words, every fourth a
    prompt/completion pair (its prompt masked out of the loss)."""
    import random
    import string
    rng = random.Random(seed)

    def words(lo, hi):
        return " ".join("".join(rng.choice(string.ascii_lowercase)
                                for _ in range(rng.randint(2, 9)))
                        for _ in range(rng.randint(lo, hi)))

    return [{"prompt": words(5, 40), "completion": " " + words(20, 160)}
            if i % 4 == 3 else {"text": words(20, 200)} for i in range(n)]


def _train_batches(torch, dev, records, batch, seq, steps):
    from arks_tpu_torch.engine.tokenizer import ByteTokenizer
    from arks_tpu_torch.train.data import PackedDataset
    ds = PackedDataset(records, ByteTokenizer(), seq_len=seq,
                       batch_size=batch, seed=SEED)
    out = []
    for b in ds.epoch(0):
        out.append(tuple(torch.from_numpy(b[k]).to(dev) for k in
                         ("tokens", "targets", "loss_mask")))
        if len(out) == steps:
            return out
    raise AssertionError(f"[train] the corpus packs {len(out)} batches of "
                         f"{batch} x {seq}, not {steps}")


def _train_run(torch, state, step, batches, tag):
    """Steps ``state`` through ``batches``: (state, losses, ms per step
    from CUDA events)."""
    losses, ms = [], []
    for batch in batches:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        state, loss = step(state, *batch)
        e1.record()
        e1.synchronize()
        ms.append(e0.elapsed_time(e1))
        losses.append(loss.item())
    log(f"[train {tag}] losses {losses}; ms per step {ms}")
    return state, losses, ms


def _state_bytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors.values()
               if t.is_cuda)


def _same_bits(torch, a, b) -> bool:
    """Equal dtype, shape and bits (a view as integers: -0.0 and 0.0
    differ, NaNs with equal bits agree)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    kind = ints[a.element_size()]
    return torch.equal(a.contiguous().view(kind), b.contiguous().view(kind))


def _device_ms_by_kind(torch, prof) -> dict:
    """A profiled window's device ms by kernel kind: the GEMMs (cuBLAS /
    CUTLASS names), reductions, the other elementwise kernels, copies and
    memsets."""
    cuda = torch.autograd.DeviceType.CUDA
    out = collections.Counter()
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != cuda:
            continue
        name = ev.name().lower()
        kind = ("gemm" if any(k in name for k in ("gemm", "cutlass", "sm90",
                                                  "cublas")) else
                "reduce" if "reduce" in name else
                "copy/memset" if any(k in name for k in ("memcpy", "memset",
                                                         "copy")) else
                "elementwise")
        out[kind] += (ev.end_ns() - ev.start_ns()) / 1e6
    return {k: round(v, 1) for k, v in out.most_common()}


def _free_state(torch):
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _train_dense(torch, dev, records):
    """(a) Qwen2.5-1.5B at full width and depth, f32: TRAIN_STEPS steps,
    one profiled; the training forward's logits against prefill's; a
    second run's first four losses, a save at step 2 and a restore into a
    fresh state whose two next steps equal the uninterrupted run's
    losses and every leaf of its state bit for bit; the restore's peak
    memory."""
    import os
    import shutil
    import tempfile
    from torch.profiler import ProfilerActivity, profile

    from arks_tpu_torch.models import get_config
    from arks_tpu_torch.models import transformer as tf
    from arks_tpu_torch.train import checkpoint as ckpt
    from arks_tpu_torch.train import sft
    cfg = get_config(TRAIN_MODEL)
    opt = sft.adamw(TRAIN_LR)
    step = sft.make_train_step(cfg, opt)
    batches = _train_batches(torch, dev, records, TRAIN_BATCH, TRAIN_SEQ,
                             TRAIN_STEPS)
    res = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state = sft.train_init(cfg, SEED, opt, dev)
    n = sum(p.numel() for _, p in sft.named_leaves(state.params))
    if n != TRAIN_PARAMS:
        raise AssertionError(f"[train a] {n} parameters, not {TRAIN_PARAMS}")
    state_gb = n * STATE_BYTES_PER_PARAM / 1e9
    state, losses, ms = _train_run(torch, state, step, batches, "a")
    peak = torch.cuda.max_memory_allocated() - base
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"[train a] losses {losses} do not fall")
    steady = sorted(ms[1:])[len(ms[1:]) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    res.update(losses=losses, ms=ms, ms_median=steady,
               tok_s=tokens / steady * 1e3, peak_bytes=peak,
               state_gb=state_gb, batch=TRAIN_BATCH)
    log(f"[train a] {TRAIN_MODEL} f32, {TRAIN_BATCH} x {TRAIN_SEQ}: "
        f"{steady:.1f} ms per step (median of steps 2-{TRAIN_STEPS}; the "
        f"first {ms[0]:.1f}), {res['tok_s']:.0f} tok/s, peak device memory "
        f"{peak / 1e9:.2f} GB beside the {state_gb:.2f} GB state")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        state, _ = step(state, *batches[0])
        torch.cuda.synchronize()
    kern, dev_us, aten = _trace_counts(torch, prof)
    by_kind = _device_ms_by_kind(torch, prof)
    res.update(step_launches=sum(kern.values()), step_device_ms=dev_us / 1e3,
               step_aten_ops=sum(aten.values()), step_ms_by_kind=by_kind)
    log(f"[train a] one profiled step: {res['step_launches']} device "
        f"kernel launches, {res['step_device_ms']:.1f} ms device "
        f"(by kind, ms: {by_kind}), {res['step_aten_ops']} aten ops; most "
        f"launched {[(n, name[:60]) for name, n in kern.most_common(4)]}")
    with torch.no_grad():
        toks = batches[0][0]
        got = sft.forward_train(state.params, cfg, toks)[:, -1]
        want, _, _ = tf.prefill(state.params, cfg, toks, torch.full(
            (toks.shape[0],), TRAIN_SEQ, dtype=torch.int32, device=dev))
    err = (got - want).abs().max().item()
    tol = TRAIN_LOGIT_RTOL * want.abs().max().item()
    res["logit_err"] = err
    log(f"[train a] training forward vs prefill, last-position logits: "
        f"max |diff| {err:.3e} (limit {tol:.3e})")
    if not err <= tol:
        raise AssertionError(f"[train a] logits differ by {err} > {tol}")
    del state, got, want
    _free_state(torch)

    d = tempfile.mkdtemp(prefix="arks-train-")
    try:
        state = sft.train_init(cfg, SEED, opt, dev)
        state, first, _ = _train_run(torch, state, step, batches[:2],
                                     "a second run")
        t0 = time.perf_counter()
        ckpt.save_train_state(ckpt.make_manager(d), state, wait=True)
        res["save_s"] = time.perf_counter() - t0
        saved_bytes = os.path.getsize(os.path.join(d, "2", ckpt.STATE_FILE))
        state, more, _ = _train_run(torch, state, step, batches[2:4],
                                    "a second run")
        if first + more != losses[:4]:
            raise AssertionError(f"[train a] a second run's losses "
                                 f"{first + more} != {losses[:4]}")
        t0 = time.perf_counter()
        want = {k: ckpt.host_copy(t) for k, t in
                ckpt.state_tensors(state).items()}
        res["copy_s"] = time.perf_counter() - t0
        del state
        _free_state(torch)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        resumed = ckpt.restore_train_state(ckpt.make_manager(d), cfg, opt,
                                           dev)
        torch.cuda.synchronize()
        res["restore_s"] = time.perf_counter() - t0
        restore_peak = torch.cuda.max_memory_allocated() - base
        tensors = ckpt.state_tensors(resumed)
        restored = _state_bytes(tensors)
        largest = max(t.numel() * t.element_size() for t in tensors.values())
        bound = restored + largest + TRAIN_RESTORE_SLACK
        res.update(restore_peak=restore_peak, restored_bytes=restored,
                   saved_bytes=saved_bytes)
        log(f"[train a] checkpoint at step 2: {saved_bytes} B written in "
            f"{res['save_s']:.1f} s, restored in {res['restore_s']:.1f} s; "
            f"restore peak device memory {restore_peak} B against the "
            f"bound {bound} B (the restored state {restored} B + its "
            f"largest leaf {largest} B + {TRAIN_RESTORE_SLACK} B)")
        if resumed.step != 2 or restore_peak > bound:
            raise AssertionError(f"[train a] restore: step {resumed.step}, "
                                 f"peak {restore_peak} > {bound}")
        del tensors
        resumed, after, _ = _train_run(torch, resumed, step, batches[2:4],
                                       "a resumed")
        if after != losses[2:4]:
            raise AssertionError(f"[train a] resumed losses {after} != "
                                 f"{losses[2:4]}")
        t0 = time.perf_counter()
        got = ckpt.state_tensors(resumed)
        bad = [k for k in want if k not in got or not _same_bits(
            torch, got[k], want[k].to(got[k].device))]
        res["compare_s"] = time.perf_counter() - t0
        if bad or got.keys() != want.keys():
            raise AssertionError(f"[train a] the resumed state differs from "
                                 f"the uninterrupted one in {bad[:8]}")
        res["resume_leaves"] = len(want)
        log(f"[train a] resume bit-identical: losses after the restore "
            f"{after} equal the uninterrupted run's, and all {len(want)} "
            f"leaves (params, moments, the update count, step) equal bit "
            f"for bit "
            f"(host copy {res['copy_s']:.1f} s, compare "
            f"{res['compare_s']:.1f} s)")
        del resumed, got, want
    finally:
        shutil.rmtree(d, ignore_errors=True)
    _free_state(torch)
    return res


def _train_moe(torch, dev, records):
    """(b) Qwen2-57B-A14B at full widths, TRAIN_MOE_LAYERS layer, f32:
    TRAIN_MOE_STEPS steps twice from one seed; the first step's gradients
    reach the router, the shared expert and its gate, and exactly the
    experts that received rows."""
    from arks_tpu_torch.models import get_config
    from arks_tpu_torch.models import moe
    from arks_tpu_torch.train import sft
    cfg = dataclasses.replace(get_config(TRAIN_MOE_MODEL),
                              num_layers=TRAIN_MOE_LAYERS)
    opt = sft.adamw(TRAIN_LR)
    step = sft.make_train_step(cfg, opt)
    batches = _train_batches(torch, dev, records, TRAIN_MOE_BATCH,
                             TRAIN_SEQ, TRAIN_MOE_STEPS)
    sizes, grads = [], {}
    real_ragged = moe.ragged_dot

    def spy(xs, w, group_sizes):
        sizes.append(group_sizes.tolist())
        return real_ragged(xs, w, group_sizes)

    runs, res = [], {}
    moe.ragged_dot = spy
    try:
        for run in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            state = sft.train_init(cfg, SEED, opt, dev)
            leaves = dict(sft.named_leaves(state.params))
            n = sum(p.numel() for p in leaves.values())
            if n != TRAIN_MOE_PARAMS:
                raise AssertionError(f"[train b] {n} parameters")
            hooks = []
            if run == 0:
                def keep(name):
                    def hook(p):
                        if name not in grads:
                            g = p.grad[0]
                            grads[name] = (g.reshape(g.shape[0], -1).abs()
                                           .amax(dim=1).tolist()
                                           if name.startswith("layers/w_")
                                           else g.abs().max().item())
                    return hook
                hooks = [leaves[name].register_post_accumulate_grad_hook(
                    keep(name)) for name in TRAIN_MOE_GRADS]
            state, losses, ms = _train_run(torch, state, step, batches,
                                           f"b run {run + 1}")
            for h in hooks:
                h.remove()
            peak = torch.cuda.max_memory_allocated() - base
            runs.append(losses)
            if run == 0:
                steady = sorted(ms[1:])[len(ms[1:]) // 2]
                res.update(losses=losses, ms=ms, ms_median=steady,
                           tok_s=TRAIN_MOE_BATCH * TRAIN_SEQ / steady * 1e3,
                           peak_bytes=peak,
                           state_gb=n * STATE_BYTES_PER_PARAM / 1e9)
            elif losses != runs[0]:
                raise AssertionError(f"[train b] a second identical run's "
                                     f"losses {losses} != {runs[0]}")
            del state, leaves
            _free_state(torch)
    finally:
        moe.ragged_dot = real_ragged
    losses = runs[0]
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"[train b] losses {losses} do not fall")
    routed = sizes[0]                    # the first step's gate products
    if len(routed) != cfg.num_experts or sum(routed) != \
            TRAIN_MOE_BATCH * TRAIN_SEQ * cfg.num_experts_per_tok:
        raise AssertionError(f"[train b] group sizes {routed}")
    zero = [name for name in TRAIN_MOE_GRADS
            if not name.startswith("layers/w_") and not grads[name] > 0]
    for name in ("layers/w_gate", "layers/w_up", "layers/w_down"):
        zero += [f"{name}[{e}]" for e, (rows, g) in
                 enumerate(zip(routed, grads[name])) if (rows > 0) != (g > 0)]
    if zero:
        raise AssertionError(f"[train b] gradients zero (or nonzero on an "
                             f"expert with no rows): {zero}")
    res.update(experts_with_rows=sum(r > 0 for r in routed),
               router_grad=grads["layers/router"],
               shared_gate_grad=grads["layers/shared_gate"])
    log(f"[train b] {TRAIN_MOE_MODEL} f32 at full widths, "
        f"{TRAIN_MOE_LAYERS} layer, {TRAIN_MOE_BATCH} x {TRAIN_SEQ}: "
        f"losses {losses} (a second run's bit-identical); "
        f"{res['ms_median']:.1f} ms per step, {res['tok_s']:.0f} tok/s, "
        f"peak device memory {res['peak_bytes'] / 1e9:.2f} GB beside the "
        f"{res['state_gb']:.2f} GB state; rows per expert {routed}; max "
        f"|grad| router {res['router_grad']:.3e}, shared_gate "
        f"{res['shared_gate_grad']:.3e}, every expert with rows nonzero, "
        f"the {cfg.num_experts - res['experts_with_rows']} without zero")
    return res


def _stamped(line: str, start: float) -> str:
    """A trainer log line as "<seconds since ``start``>s <message>"."""
    import datetime
    at = datetime.datetime.strptime(line[:23], "%Y-%m-%d %H:%M:%S,%f")
    return (f"{at.timestamp() - start:.1f}s "
            f"{line.split(' arks_tpu_torch.train INFO ')[-1]}")


def _train_cli(torch, records):
    """(c) ``python -m arks_tpu_torch.train`` twice without --device: 6
    steps with checkpoints every 3, then 12 resumed from step 6."""
    import os
    import shutil
    import tempfile
    d = tempfile.mkdtemp(prefix="arks-train-cli-")
    try:
        data = os.path.join(d, "corpus.jsonl")
        with open(data, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in records)
        secs, err, logged = [], [], []
        for steps in (6, 12):
            t0, start = time.perf_counter(), time.time()
            r = subprocess.run(
                [sys.executable, "-m", "arks_tpu_torch.train", "--model",
                 TRAIN_CLI_MODEL, "--data", data, "--seq-len", "256",
                 "--batch-size", "4", "--steps", str(steps), "--ckpt-every",
                 "3", "--ckpt-dir", os.path.join(d, "run")],
                capture_output=True, text=True, timeout=TRAIN_CLI_TIMEOUT)
            secs.append(time.perf_counter() - t0)
            err.append(r.stderr)
            logged += [_stamped(ln, start) for ln in r.stderr.splitlines()
                       if " arks_tpu_torch.train INFO " in ln]
            if r.returncode != 0:
                raise AssertionError(f"[train c] --steps {steps} exited "
                                     f"{r.returncode}: {r.stderr[-3000:]}")
        need = [(0, "final checkpoint at step 6"), (1, "resumed from step 6"),
                (1, "final checkpoint at step 12")]
        missing = [line for i, line in need if line not in err[i]]
        if missing:
            raise AssertionError(f"[train c] missing log lines {missing}: "
                                 f"{err[1][-3000:]}")
        steps = sorted(os.listdir(os.path.join(d, "run")))
        log(f"[train c] python -m arks_tpu_torch.train --model "
            f"{TRAIN_CLI_MODEL} (no --device): {secs[0]:.1f} s for 6 steps, "
            f"{secs[1]:.1f} s resumed to 12; its log lines, at seconds "
            f"since the process started: {logged}; kept {steps}")
        return dict(seconds=secs)
    finally:
        shutil.rmtree(d, ignore_errors=True)


def phase_train(torch, dev):
    """Phase 17: the trainer on the card (``arks_tpu_torch/train/``), with
    the grouped MoE route's plain products (ARKS_MOE_KERNEL=auto: the
    grouped matmul kernel has no backward).  Launches none of the nine
    kernels: their counts stay 0 through the phase."""
    import os
    os.environ["ARKS_MOE_KERNEL"] = "auto"
    t_phase = time.perf_counter()
    _reset_counts()
    records = _train_corpus()
    res = {"a": _train_dense(torch, dev, records),
           "b": _train_moe(torch, dev, records),
           "c": _train_cli(torch, records)}
    counts = _read_counts()
    if any(counts.values()):
        raise AssertionError(f"[train] kernel launches {counts}")
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[train] the training phases launched none of the nine kernels "
        f"({counts}); one training step of {TRAIN_MODEL} is "
        f"{res['a']['step_launches']} device kernel launches (aten level) "
        f"and {res['a']['step_aten_ops']} aten ops; phase took "
        f"{res['seconds']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# Phase 18: the operator and the gateway in front of the port
# ---------------------------------------------------------------------------

OP_MANIFEST = "examples/quickstart/quickstart_torch.yaml"
OP_APP, OP_SERVED, OP_NS = "qwen2.5-app", "qwen2.5", "default"
OP_TOKEN, OP_USER, OP_QUOTA = "sk-quickstart", "quickstart-user", \
    "quickstart-quota"
OP_LOAD_TOKEN = "sk-operator-load"     # the roll's client and the TTFT runs
OP_TOKENS = 16                         # greedy tokens of a checked request
OP_TTFT_TOKENS = 32                    # tokens of a timed stream
OP_TTFT_RUNS = 5                       # timed streams a median, each way
OP_BOOT_TIMEOUT = 240
OP_ROLL_TIMEOUT = 300
OP_MEM_SLACK = 1 << 30                 # device bytes a teardown may keep


def _op_get(addr, path):
    host, _, port = addr.partition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _op_served(addr) -> float:
    """The replica's finished requests: request_success_total's samples."""
    status, raw = _op_get(addr, "/metrics")
    if status != 200:
        raise AssertionError(f"[operator] {addr}/metrics: {status}")
    return sum(float(line.rsplit(" ", 1)[1])
               for line in raw.decode().splitlines()
               if line.startswith("request_success_total"))


def _op_device(addr) -> dict:
    status, raw = _op_get(addr, "/v1/device")
    if status != 200:
        raise AssertionError(f"[operator] {addr}/v1/device: {status}")
    return json.loads(raw)


def _op_call(addr, path, body, token=None):
    """POST ``body``: (status, the response as JSON, or its SSE data frames
    as JSON with "[DONE]" last, or the error text), seconds to the first
    SSE frame or None, total seconds)."""
    host, _, port = addr.partition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=600)
    headers = {"Content-Type": "application/json"}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    t0 = time.perf_counter()
    try:
        conn.request("POST", path, json.dumps(body), headers)
        resp = conn.getresponse()
        if resp.status != 200 or not body.get("stream"):
            raw = resp.read()
            try:
                data = json.loads(raw)
            except ValueError:
                data = raw.decode(errors="replace")
            return resp.status, data, None, time.perf_counter() - t0
        frames, t_first = [], None
        for line in resp:
            line = line.decode().strip()
            if not line.startswith("data: "):
                continue
            if t_first is None:
                t_first = time.perf_counter() - t0
            frames.append("[DONE]" if line == "data: [DONE]"
                          else json.loads(line[6:]))
        return 200, frames, t_first, time.perf_counter() - t0
    finally:
        conn.close()


def _op_strip(data):
    """A response without what each response mints anew (id, created)."""
    if isinstance(data, list):
        return [_op_strip(f) for f in data]
    if isinstance(data, dict):
        return {k: v for k, v in data.items() if k not in ("id", "created")}
    return data


def _op_usage(data) -> dict:
    if isinstance(data, list):
        (usage,) = [f["usage"] for f in data
                    if isinstance(f, dict) and f.get("usage")]
        return usage
    return data["usage"]


def _op_text(data) -> str:
    if isinstance(data, list):
        return "".join(c.get("text") or c.get("delta", {}).get("content")
                       or "" for f in data if isinstance(f, dict)
                       for c in f["choices"])
    c = data["choices"][0]
    return c.get("text") or c["message"]["content"]


def _op_bodies():
    """Phase 18's eight requests: four completions and four chats, two of
    each streamed, greedy, OP_TOKENS tokens each."""
    out = []
    for j in range(8):
        chat, stream = j % 2 == 1, j in (2, 3, 6, 7)
        body = {"model": OP_SERVED, "max_tokens": OP_TOKENS,
                "temperature": 0, "ignore_eos": True}
        if chat:
            body["messages"] = [{"role": "user",
                                 "content": f"operator check {j}: hello"}]
        else:
            body["prompt"] = f"operator check {j}: the gateway in front"
        if stream:
            body.update(stream=True, stream_options={"include_usage": True})
        out.append(("/v1/chat/completions" if chat else "/v1/completions",
                    body))
    return out


def _op_groups(driver):
    """{group index: (pid, port, the process)} of the deployed gang."""
    with driver._lock:
        groups = dict(driver._groups.get((OP_NS, OP_APP), {}))
    return {i: (g.proc.pid, g.port, g.proc) for i, g in groups.items()}


def _op_wait(what, pred, timeout, driver, logs):
    import os
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(0.1)
    tails = []
    for name in sorted(os.listdir(logs)):
        with open(os.path.join(logs, name), errors="replace") as f:
            tails.append(f"--- {name}\n{f.read()[-2000:]}")
    raise AssertionError(f"[operator] {what} not within {timeout} s; "
                         f"groups {_op_groups(driver)}\n" + "\n".join(tails))


def _op_roll_client(gw_port, stop, results):
    """Requests through the gateway until ``stop``: completions of 16
    tokens, every other one streamed; each (status, finish reasons, text,
    whole: a stream ended with its usage frame and [DONE])."""
    j = 0
    while not stop.is_set():
        body = {"model": OP_SERVED, "prompt": f"rolling {j}",
                "max_tokens": 16, "temperature": 0, "ignore_eos": True}
        if j % 2:
            body.update(stream=True, stream_options={"include_usage": True})
        try:
            status, data, _, _ = _op_call(f"127.0.0.1:{gw_port}",
                                          "/v1/completions", body,
                                          OP_LOAD_TOKEN)
        except OSError as e:
            results.append((0, repr(e), "", False))
            j += 1
            continue
        if status != 200:
            results.append((status, str(data)[:200], "", False))
        else:
            frames = data if isinstance(data, list) else [data]
            finish = [c["finish_reason"] for f in frames
                      if isinstance(f, dict) for c in f["choices"]
                      if c.get("finish_reason")]
            whole = not isinstance(data, list) or (
                data[-1] == "[DONE]" and any(
                    isinstance(f, dict) and f.get("usage") for f in data))
            results.append((status, finish, _op_text(data), whole))
        j += 1


def phase_operator(torch, dev, smi):
    """Phase 18: ``python -m arks_tpu_torch.control``'s parts in this process
    (``build_manager`` over a ``LocalProcessDriver``, the ``Gateway`` on an
    ephemeral port) deploy the port's quickstart manifest: two replicas of
    ``python -m arks_tpu_torch.server`` serving Qwen2.5-7B at full width
    and depth (random weights from the seed) on this card.  Checks, each
    fatal: both replicas Running with the Endpoint listing both, each on
    the CUDA device holding at least its weight bytes there; eight greedy
    requests through the gateway (four streamed) equal, but for ids and
    timestamps, the same requests sent straight to the replica that served
    each, whose kernels ran; the Quota's usage is the sum of the
    responses'; a request over the token's RPM limit gets 429 and reaches
    no replica; a rolling update (--num-slots 8 -> 6) restarts the two one
    at a time while a client sending through the gateway sees every
    request finish, and the old replicas exit 0 after their drain;
    deleting the Application stops both and the card's memory comes back.
    Returns the replicas' kernel launches over the eight requests and the
    phase's numbers."""
    import os
    import shutil
    import tempfile

    from arks_tpu_torch.control import resources as res
    from arks_tpu_torch.control.__main__ import apply_manifests
    from arks_tpu_torch.control.manager import build_manager
    from arks_tpu_torch.control.workloads import (LocalProcessDriver,
                                                  spec_hash)
    from arks_tpu_torch.gateway.ratelimiter import window_key
    from arks_tpu_torch.gateway.server import Gateway
    from arks_tpu_torch.models import get_config
    from arks_tpu_torch.models.weights import param_shapes

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    cfg = get_config(MODEL)
    weight_bytes = 2 * sum(math.prod(s) for s in param_shapes(cfg).values())
    torch.cuda.empty_cache()
    free0, _ = torch.cuda.mem_get_info()
    log(f"[operator] this process holds {torch.cuda.memory_reserved()} B "
        f"reserved; the card has {free0} B free; a replica's weights are "
        f"{weight_bytes} B")
    # The replicas take the defaults: no earlier phase's ARKS_* setting
    # reaches them.  They import the checkout's package.
    saved = {k: v for k, v in os.environ.items() if k.startswith("ARKS_")}
    saved["PYTHONPATH"] = os.environ.get("PYTHONPATH")
    for k in saved:
        os.environ.pop(k, None)
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, saved["PYTHONPATH"]) if p)
    tmp = tempfile.mkdtemp(prefix="arks-operator-")
    logs = os.path.join(tmp, "logs")
    driver = LocalProcessDriver(log_dir=logs)
    mgr = build_manager(models_root=os.path.join(tmp, "models"),
                        driver=driver)
    gw = Gateway(mgr.store, host="127.0.0.1", port=0, quota_sync_s=0.5)
    out = {}
    try:
        mgr.start()
        gw.start(background=True)
        gwa = f"127.0.0.1:{gw.port}"
        store = mgr.store
        t0 = time.perf_counter()
        apply_manifests(store, os.path.join(root, OP_MANIFEST))
        store.create(res.Token(name="operator-load", spec={
            "token": OP_LOAD_TOKEN, "qos": [{
                "endpoint": {"name": OP_SERVED},
                "rateLimits": [{"type": "rpm", "value": 100000},
                               {"type": "tpm", "value": 100000000}]}]}))
        app = store.get(res.Application, OP_APP)
        args = app.spec["runtimeCommonArgs"]
        if (app.spec["replicas"], app.spec["modelConfig"],
                args[args.index("--seed") + 1]) != (2, MODEL, str(SEED)):
            raise AssertionError(f"[operator] the manifest deploys "
                                 f"{app.spec}")
        # 1. Both replicas Running; the Endpoint lists both.
        running = {}

        def up():
            gs = store.try_get(res.GangSet, OP_APP)
            for g in (driver.status(gs)["groups"] if gs else []):
                if g["phase"] == "Running" and g["index"] not in running:
                    running[g["index"]] = time.perf_counter() - t0
            routes = store.get(res.Endpoint, OP_SERVED).status.get("routes")
            return (len(running) == 2 and routes
                    and len(routes[0]["backend"]["addresses"]) == 2
                    and store.get(res.Application, OP_APP).phase
                    == res.PHASE_RUNNING and routes)

        routes = _op_wait("both replicas Running", up, OP_BOOT_TIMEOUT,
                          driver, logs)
        addrs = sorted(routes[0]["backend"]["addresses"])
        groups = _op_groups(driver)
        by_port = {port: (i, pid) for i, (pid, port, _) in groups.items()}
        devs = {}
        for a in addrs:
            d = devs[a] = _op_device(a)
            i, pid = by_port[int(a.rpartition(":")[2])]
            if not (d["device"].startswith("cuda") and d["pid"] == pid
                    and d["memory_allocated"] >= weight_bytes):
                raise AssertionError(f"[operator] replica {i} at {a}: {d}")
            log(f"[operator] replica {i} (pid {pid}, {a}) Running after "
                f"{running[i]:.2f} s on {d['device']} ({d['name']}), "
                f"{d['memory_allocated']} B allocated there")
        free_up, _ = torch.cuda.mem_get_info()
        if free0 - free_up < 2 * weight_bytes:
            raise AssertionError(f"[operator] the card lost only "
                                 f"{free0 - free_up} B to two replicas")
        apps_smi = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().replace("\n", "; ")
        log(f"[operator] the card's free memory {free0} -> {free_up} B with "
            f"both replicas up; nvidia-smi compute apps: {apps_smi}")
        # 2. Eight requests through the gateway, each equal to the same
        # request sent straight to the replica that served it.
        wait = time.monotonic() + 10
        while not (gw.qos.token_known(OP_TOKEN)
                   and gw.qos.token_known(OP_LOAD_TOKEN)):
            if time.monotonic() > wait:
                raise AssertionError("[operator] tokens not indexed")
            time.sleep(0.02)
        k0 = {a: devs[a]["kernel_launches"] for a in addrs}
        via, usage_sum = [], 0
        for path, body in _op_bodies():
            before = {a: _op_served(a) for a in addrs}
            status, data, _, _ = _op_call(gwa, path, body, OP_TOKEN)
            after = {a: _op_served(a) for a in addrs}
            served = [a for a in addrs if after[a] != before[a]]
            if status != 200 or len(served) != 1 \
                    or after[served[0]] != before[served[0]] + 1:
                raise AssertionError(f"[operator] {path} via the gateway: "
                                     f"{status} {str(data)[:300]}, served "
                                     f"{before} -> {after}")
            usage = _op_usage(data)
            if usage["completion_tokens"] != OP_TOKENS or not _op_text(data):
                raise AssertionError(f"[operator] {path}: usage {usage}")
            usage_sum += usage["total_tokens"]
            via.append((path, body, served[0], data))
        launches = collections.Counter()
        for a in addrs:
            k1 = _op_device(a)["kernel_launches"]
            launches.update({k: k1[k] - k0[a][k] for k in k1})
        for name in ("paged_kv_update", "paged_mixed_attention"):
            if launches[name] <= 0:
                raise AssertionError(f"[operator] the replicas launched "
                                     f"{dict(launches)}")
        for path, body, a, data in via:
            status, direct, _, _ = _op_call(a, path, body)
            if status != 200 or _op_strip(direct) != _op_strip(data):
                raise AssertionError(
                    f"[operator] {path} {body.get('stream', False)}: the "
                    f"gateway's answer differs from {a}'s own:\n"
                    f"{_op_strip(data)}\n{_op_strip(direct)}")
        log(f"[operator] 8 requests through the gateway (4 streamed) equal "
            f"their replicas' direct answers but for ids and timestamps; "
            f"served by {collections.Counter(v[2] for v in via)}; the "
            f"replicas' kernel launches over them {dict(launches)}")
        # TTFT and total time, through the gateway and direct, alternating.
        body = {"model": OP_SERVED, "prompt": "time to first token",
                "max_tokens": OP_TTFT_TOKENS, "temperature": 0,
                "ignore_eos": True, "stream": True,
                "stream_options": {"include_usage": True}}
        runs = {"gateway": [], "direct": []}
        for _ in range(OP_TTFT_RUNS):
            for way, addr, tok in (("gateway", gwa, OP_LOAD_TOKEN),
                                   ("direct", addrs[0], None)):
                status, data, t_first, total = _op_call(
                    addr, "/v1/completions", body, tok)
                if status != 200 or data[-1] != "[DONE]":
                    raise AssertionError(f"[operator] {way}: {status}")
                runs[way].append((t_first, total))
        med = {way: (float(np.median([r[0] for r in v])),
                     float(np.median([r[1] for r in v])))
               for way, v in runs.items()}
        log(f"[operator] {OP_TTFT_TOKENS}-token stream, medians of "
            f"{OP_TTFT_RUNS} (host clock, {smi}): through the gateway TTFT "
            f"{med['gateway'][0] * 1e3:.2f} ms, total "
            f"{med['gateway'][1] * 1e3:.2f} ms; direct TTFT "
            f"{med['direct'][0] * 1e3:.2f} ms, total "
            f"{med['direct'][1] * 1e3:.2f} ms")
        # 4. Over the RPM limit: 429, and no replica sees the request.
        tok = store.get(res.Token, OP_USER)
        limit = {r["type"]: r["value"] for r in
                 tok.spec["qos"][0]["rateLimits"]}["rpm"]
        if time.time() % 60 > 50:
            time.sleep(60.5 - time.time() % 60)
        window = time.time() // 60
        key = window_key(OP_NS, OP_USER, OP_SERVED, "rpm")
        fill = {"model": OP_SERVED, "prompt": "fill", "max_tokens": 1,
                "temperature": 0}
        for _ in range(limit - gw.limiter.backend.get(key)):
            status, data, _, _ = _op_call(gwa, "/v1/completions", fill,
                                          OP_TOKEN)
            if status != 200:
                raise AssertionError(f"[operator] under the limit: {status}"
                                     f" {data}")
            usage_sum += data["usage"]["total_tokens"]
        before = {a: _op_served(a) for a in addrs}
        status, data, _, _ = _op_call(gwa, "/v1/completions", fill, OP_TOKEN)
        after = {a: _op_served(a) for a in addrs}
        if time.time() // 60 != window:
            raise AssertionError("[operator] the rate window turned")
        if status != 429 or "rate limit exceeded: rpm" not in str(data) \
                or after != before:
            raise AssertionError(f"[operator] over the limit: {status} "
                                 f"{data}; served {before} -> {after}")
        log(f"[operator] request {limit + 1} of the minute: 429 "
            f"{data['error']['message']!r}; the replicas' finished requests "
            f"stayed {after}")
        # 3. The Quota's usage: the sum of the responses'.
        used = gw.quota.get_usage(OP_NS, OP_QUOTA)
        _op_wait("the Quota's status", lambda: [
            s["used"] for s in store.get(res.Quota, OP_QUOTA).status.get(
                "quotaStatus", []) if s["type"] == "total"] == [usage_sum],
            10, driver, logs)
        if used["total"] != usage_sum:
            raise AssertionError(f"[operator] quota {used} against the "
                                 f"responses' {usage_sum}")
        log(f"[operator] quota {used} equals the responses' total "
            f"{usage_sum}, also in the Quota's status")
        # 5. A rolling update under load.
        old = _op_groups(driver)
        stop, results = threading.Event(), []
        client = threading.Thread(target=_op_roll_client,
                                  args=(gw.port, stop, results), daemon=True)
        client.start()
        time.sleep(1.0)
        t_roll = time.perf_counter()
        app = store.get(res.Application, OP_APP)
        args = list(app.spec["runtimeCommonArgs"])
        args[args.index("--num-slots") + 1] = "6"
        app.spec["runtimeCommonArgs"] = args
        store.update(app)
        events = []                   # (seconds, group, "restart"|"ready")

        def rolled():
            now = time.perf_counter() - t_roll
            cur = _op_groups(driver)
            for i, (pid, port, _) in cur.items():
                if pid != old[i][0] and (i, "restart") not in \
                        {(e[1], e[2]) for e in events}:
                    events.append((now, i, "restart"))
            gs = store.try_get(res.GangSet, OP_APP)
            st = driver.status(gs)["groups"] if gs else []
            for g in st:
                i = g["index"]
                if g["phase"] == "Running" and cur.get(i, old[i])[0] \
                        != old[i][0] and (i, "ready") not in \
                        {(e[1], e[2]) for e in events}:
                    events.append((now, i, "ready"))
            want = spec_hash(gs) if gs else None
            with driver._lock:
                hashes = [g.spec_hash for g in
                          driver._groups.get((OP_NS, OP_APP), {}).values()]
            routes = store.get(res.Endpoint, OP_SERVED).status.get("routes")
            news = {f"127.0.0.1:{p}" for _, p, _ in cur.values()}
            return (len(events) == 4 and hashes == [want, want]
                    and routes and set(routes[0]["backend"]["addresses"])
                    == news)

        _op_wait("the rolling update", rolled, OP_ROLL_TIMEOUT, driver, logs)
        roll_s = time.perf_counter() - t_roll
        time.sleep(1.0)
        stop.set()
        client.join(timeout=120)
        if client.is_alive():
            raise AssertionError("[operator] the roll's client hung")
        order = sorted(events)
        first, second = order[0][1], [e for e in order if e[1] != order[0][1]]
        ready_first = [t for t, i, e in events if i == first and e == "ready"]
        restart_second = [t for t, i, e in second if e == "restart"]
        rcs = [p.wait(timeout=60) for _, _, p in old.values()]
        bad = [r for r in results if r[0] != 200 or r[1] != ["length"]
               or not r[2] or not r[3]]
        if bad or not results or rcs != [0, 0] or \
                restart_second[0] < ready_first[0]:
            raise AssertionError(f"[operator] roll: {len(results)} requests,"
                                 f" failed {bad[:5]}; old replicas' exit "
                                 f"codes {rcs}; events {order}")
        for i, (pid, port, p) in _op_groups(driver).items():
            if p.args[p.args.index("--num-slots") + 1] != "6":
                raise AssertionError(f"[operator] group {i}: {p.args}")
        log(f"[operator] rolling update --num-slots 8 -> 6 in {roll_s:.2f} s"
            f" ({smi}): restarts and readiness at "
            + ", ".join(f"{t:.2f} s group {i} {e}" for t, i, e in order)
            + f"; the client's {len(results)} requests through the gateway "
            f"all finished whole; the old replicas exited {rcs} after their "
            f"drain")
        # 6. Teardown gives the card's memory back.
        procs = [p for _, _, p in _op_groups(driver).values()]
        t_down = time.perf_counter()
        store.delete(res.Application, OP_APP)
        _op_wait("teardown", lambda: store.try_get(res.GangSet, OP_APP) is None
                 and all(p.poll() is not None for p in procs), 60, driver,
                 logs)
        _op_wait("the card's memory back", lambda: torch.cuda.mem_get_info()[
            0] >= free0 - OP_MEM_SLACK, 30, driver, logs)
        log(f"[operator] teardown in {time.perf_counter() - t_down:.2f} s: "
            f"both replicas exited, the card has "
            f"{torch.cuda.mem_get_info()[0]} B free (before the phase "
            f"{free0})")
        out = {"launches": launches, "running_s": running, "roll_s": roll_s,
               "ttft": med, "requests_during_roll": len(results)}
    finally:
        gw.stop()
        mgr.stop()
        driver.teardown_all()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[operator] phase took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 19: a DisaggregatedApplication behind the port's router
# ---------------------------------------------------------------------------

RT_MANIFEST = "examples/quickstart/disaggregated_torch.yaml"
RT_APP, RT_SERVED, RT_NS = "qwen2.5-pd-app", "qwen2.5-pd", "default"
RT_TOKEN, RT_USER = "sk-pd-quickstart", "pd-quickstart-user"
RT_LOAD_TOKEN = "sk-router-load"       # the cache-aware and TTFT requests
RT_PREFIX_PAGES = 3                    # full pages of the shared prefix
RT_TAIL, RT_TAILS = 32, 6              # distinct tails after the prefix
RT_BOOT_TIMEOUT = 300
RT_REPLICA_BYTES = 18_600_000_000      # one replica on the card (nvidia-smi)


def _rt_groups(driver, app):
    """{(component, group index): (pid, port, the process)} of the app's
    three gangs."""
    out = {}
    with driver._lock:
        for comp in ("router", "prefill", "decode"):
            for i, g in driver._groups.get((RT_NS, f"{app}-{comp}"),
                                           {}).items():
                out[(comp, i)] = (g.proc.pid, g.port, g.proc)
    return out


def _rt_logprobs(data):
    """A response's (or its SSE frames') tokens as [(text, top-2 gap,
    whether its runner-up decodes to the same text)].  Completions carry
    {text: logprob} for the top two (one key when both decode alike, its
    value the runner-up's) beside the chosen token's logprob; chat carries
    both entries."""
    frames = data if isinstance(data, list) else [data]
    out = []
    for f in frames:
        if not isinstance(f, dict):
            continue
        for c in f.get("choices", []):
            lp = c.get("logprobs")
            if not lp:
                continue
            for e in lp.get("content") or []:
                (a, b) = e["top_logprobs"][:2]
                out.append((e["token"], a["logprob"] - b["logprob"],
                            a["token"] == b["token"]))
            for tok, clp, top in zip(lp.get("tokens") or [],
                                     lp.get("token_logprobs") or [],
                                     lp.get("top_logprobs") or []):
                vals = sorted(top.values(), reverse=True)
                out.append((tok, vals[0] - vals[1] if len(vals) > 1
                            else clp - vals[0], len(vals) == 1))
    return out


def _rt_same(what, got, direct):
    """A routed answer against the decode replica's own, under the near-
    tie rule (``_near_tie``) on the token texts.  The answers carry no
    token ids and the byte tokenizer decodes many ids to one text, so the
    streams may have parted at an earlier token whose top-2 decode alike:
    such a token with a gap within the bound also satisfies the rule.
    Returns None when the texts agree (and then the answers are equal but
    for ids, timestamps and logprob values), else (token, gap)."""
    toks, btoks = _rt_logprobs(got), _rt_logprobs(direct)
    if not toks or len(toks) != len(btoks):
        raise AssertionError(f"{what}: {len(toks)} tokens against "
                             f"{len(btoks)}")

    def drop_lp(d):
        d = _op_strip(d)
        if isinstance(d, list):
            return [drop_lp(x) for x in d]
        if isinstance(d, dict):
            return {k: (drop_lp(v) if k == "choices" else v)
                    for k, v in d.items() if k != "logprobs"}
        return d

    try:
        tie = _near_tie(what, [t for t, _, _ in toks],
                        [t for t, _, _ in btoks], lambda i: btoks[i][1])
    except AssertionError:
        i = next(j for j, (a, b) in enumerate(zip(toks, btoks))
                 if a[0] != b[0])
        hidden = [(j, g) for j, (_, g, alike) in enumerate(btoks[:i])
                  if alike and g <= SPEC_GAP_BOUND]
        if not hidden:
            raise
        tie = hidden[0]
    if tie is None:
        if drop_lp(got) != drop_lp(direct):
            raise AssertionError(f"{what}: the answers differ:\n"
                                 f"{drop_lp(got)}\n{drop_lp(direct)}")
    elif _op_usage(got) != _op_usage(direct):
        raise AssertionError(f"{what}: usage {_op_usage(got)} against "
                             f"{_op_usage(direct)}")
    return tie


def _rt_bodies():
    """Phase 19's eight requests: four completions and four chats, two of
    each streamed, greedy, OP_TOKENS tokens each, with top-2 logprobs (for
    the near-tie rule)."""
    out = []
    for path, body in _op_bodies():
        body = dict(body, model=RT_SERVED)
        if "messages" in body:
            body.update(logprobs=True, top_logprobs=2)
        else:
            body["logprobs"] = 2
        out.append((path, body))
    return out


def _rt_metric(addr, key) -> float:
    """One sample of ``addr``'s /metrics; with a bare family name, the sum
    of its samples."""
    status, raw = _op_get(addr, "/metrics")
    if status != 200:
        raise AssertionError(f"[router] {addr}/metrics: {status}")
    if "{" in key:
        return _metric_value(raw.decode(), key)
    return sum(float(line.rsplit(" ", 1)[1])
               for line in raw.decode().splitlines()
               if line.startswith(key + "{") or line.startswith(key + " "))


def phase_router(torch, dev, smi):
    """Phase 19: ``python -m arks_tpu_torch.control``'s parts in this process
    (``build_manager`` over a ``LocalProcessDriver``, the ``Gateway`` on the
    native counter store and SSE scanner) deploy the port's disaggregated
    quickstart: one prefill and two decode replicas of ``python -m
    arks_tpu_torch.server`` serving Qwen2.5-7B at full width and depth
    (random weights from the seed) and the port's router (``python -m
    arks_tpu_torch.router --policy cache_aware``), all on this card.
    Checks, each fatal: the three components Running and the app Running;
    the discovery file lists the prefill and both decode addresses, written
    before the router started; the Endpoint routes to ``<app>-router-svc``
    and the router's readiness is 200; eight greedy requests through
    gateway -> router -> decode (four streamed), the K/V pulled from the
    prefill replica, each equal to the same request sent straight to the
    decode replica that served it under the near-tie rule; the decode
    replicas' kernel counters moved (#1 and #2); a prefix of
    RT_PREFIX_PAGES pages with RT_TAILS distinct tails, in token ids, one
    request after another: after the first, each lands on the decode
    replica that holds the prefix, counted by the router as sketch hits of
    RT_PREFIX_PAGES device blocks; the request past the token's RPM limit
    gets 429 from the native store and reaches neither the router nor a
    replica; deleting the app stops the four processes and the card's
    memory comes back.  Logs the seconds to Running per component, TTFT
    and total time through gateway -> router beside direct (medians of
    OP_TTFT_RUNS), the bytes and seconds of a pull, and the phase's
    seconds.  Returns the replicas' kernel launches over the eight
    requests and the phase's numbers."""
    import os
    import shutil
    import tempfile

    from arks_tpu_torch import knobs
    from arks_tpu_torch import prefix_sketch as ps
    from arks_tpu_torch.control import resources as res
    from arks_tpu_torch.control.__main__ import apply_manifests
    from arks_tpu_torch.control.manager import build_manager
    from arks_tpu_torch.control.workloads import LocalProcessDriver
    from arks_tpu_torch.engine import kv_transfer
    from arks_tpu_torch.gateway import native
    from arks_tpu_torch.gateway.ratelimiter import (RateLimiter,
                                                    make_counter_backend,
                                                    window_key)
    from arks_tpu_torch.gateway.server import Gateway, make_usage_scanner
    from arks_tpu_torch.models import get_config
    from arks_tpu_torch.models.weights import param_shapes

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    cfg = get_config(MODEL)
    weight_bytes = 2 * sum(math.prod(s) for s in param_shapes(cfg).values())
    torch.cuda.empty_cache()
    free0, _ = torch.cuda.mem_get_info()
    log(f"[router] this process holds {torch.cuda.memory_reserved()} B "
        f"reserved; the card has {free0} B free; three replicas take about "
        f"{3 * RT_REPLICA_BYTES} B")
    if free0 < 3 * RT_REPLICA_BYTES:
        raise AssertionError(f"[router] {free0} B free: not enough for "
                             f"three replicas")
    saved = {k: v for k, v in os.environ.items() if k.startswith("ARKS_")}
    saved["PYTHONPATH"] = os.environ.get("PYTHONPATH")
    for k in saved:
        os.environ.pop(k, None)
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, saved["PYTHONPATH"]) if p)
    tmp = tempfile.mkdtemp(prefix="arks-router-")
    logs = os.path.join(tmp, "logs")
    driver = LocalProcessDriver(log_dir=logs)
    mgr = build_manager(models_root=os.path.join(tmp, "models"),
                        driver=driver)
    gw = Gateway(mgr.store, host="127.0.0.1", port=0, quota_sync_s=0.5,
                 rate_limiter=RateLimiter(make_counter_backend("native")))
    out = {}
    try:
        if type(gw.limiter.backend).__name__ != "NativeCounterBackend" or \
                type(make_usage_scanner()).__name__ != "SseUsageScanner":
            raise AssertionError("[router] the native library did not load")
        log(f"[router] the gateway's native library: {native.lib_path()}")
        mgr.start()
        gw.start(background=True)
        gwa = f"127.0.0.1:{gw.port}"
        store = mgr.store
        t0 = time.perf_counter()
        apply_manifests(store, os.path.join(root, RT_MANIFEST))
        store.create(res.Token(name="router-load", spec={
            "token": RT_LOAD_TOKEN, "qos": [{
                "endpoint": {"name": RT_SERVED},
                "rateLimits": [{"type": "rpm", "value": 100000},
                               {"type": "tpm", "value": 100000000}]}]}))
        app = store.get(res.DisaggregatedApplication, RT_APP)
        args = app.spec["runtimeCommonArgs"]
        if (app.spec["modelConfig"], args[args.index("--seed") + 1],
                app.spec["prefill"]["replicas"],
                app.spec["decode"]["replicas"]) != (MODEL, str(SEED), 1, 2):
            raise AssertionError(f"[router] the manifest deploys {app.spec}")
        # 1. Every component Running, the app Running, the route.
        running = {}

        def up():
            for comp in ("router", "prefill", "decode"):
                gs = store.try_get(res.GangSet, f"{RT_APP}-{comp}")
                for g in (driver.status(gs)["groups"] if gs else []):
                    key = (comp, g["index"])
                    if g["phase"] == "Running" and key not in running:
                        running[key] = time.perf_counter() - t0
            svc = store.try_get(res.Service, f"{RT_APP}-router-svc")
            routes = store.get(res.Endpoint, RT_SERVED).status.get("routes")
            return (len(running) == 4 and store.get(
                res.DisaggregatedApplication, RT_APP).phase
                == res.PHASE_RUNNING and svc is not None and routes
                and routes[0]["backend"].get("service")
                == f"{RT_APP}-router-svc"
                and routes[0]["backend"]["addresses"]
                == svc.status.get("addresses") and routes)

        routes = _op_wait("the three components Running", up,
                          RT_BOOT_TIMEOUT, driver, logs)
        (router,) = routes[0]["backend"]["addresses"]
        groups = _rt_groups(driver, RT_APP)
        cmd = store.get(res.GangSet, f"{RT_APP}-router").spec["leader"][
            "command"]
        with open(cmd[cmd.index("--discovery-file") + 1]) as f:
            disc = json.load(f)
        addr = {k: f"127.0.0.1:{port}" for k, (_, port, _) in groups.items()}
        prefill = addr[("prefill", 0)]
        decodes = sorted(addr[("decode", i)] for i in range(2))
        if (disc["prefill"], sorted(disc["decode"])) != ([prefill], decodes) \
                or addr[("router", 0)] != router:
            raise AssertionError(f"[router] discovery {disc}, groups {addr}, "
                                 f"route {router}")
        if _op_get(router, "/readiness")[0] != 200:
            raise AssertionError("[router] the router is not ready")
        devs = {}
        for key, a in sorted(addr.items()):
            if key[0] == "router":
                continue
            d = devs[a] = _op_device(a)
            pid = groups[key][0]
            if not (d["device"].startswith("cuda") and d["pid"] == pid
                    and d["memory_allocated"] >= weight_bytes):
                raise AssertionError(f"[router] {key} at {a}: {d}")
        log(f"[router] Running after " + ", ".join(
            f"{c}-{i} {t:.2f} s" for (c, i), t in sorted(running.items()))
            + f"; router {router}, prefill {prefill}, decode {decodes}; "
            f"replicas on {sorted({d['device'] for d in devs.values()})}, "
            f"allocated {[devs[a]['memory_allocated'] for a in sorted(devs)]}"
            f" B; the card's free memory {free0} -> "
            f"{torch.cuda.mem_get_info()[0]} B")
        # 2. Eight requests through gateway -> router -> decode.
        wait = time.monotonic() + 10
        while not (gw.qos.token_known(RT_TOKEN)
                   and gw.qos.token_known(RT_LOAD_TOKEN)):
            if time.monotonic() > wait:
                raise AssertionError("[router] tokens not indexed")
            time.sleep(0.02)
        k0 = {a: devs[a]["kernel_launches"] for a in devs}
        via, usage_sum = [], 0
        for path, body in _rt_bodies():
            before = {a: _op_served(a) for a in decodes}
            status, data, _, _ = _op_call(gwa, path, body, RT_TOKEN)
            after = {a: _op_served(a) for a in decodes}
            served = [a for a in decodes if after[a] != before[a]]
            if status != 200 or len(served) != 1 \
                    or after[served[0]] != before[served[0]] + 1:
                raise AssertionError(f"[router] {path} via the gateway: "
                                     f"{status} {str(data)[:300]}, served "
                                     f"{before} -> {after}")
            usage = _op_usage(data)
            if usage["completion_tokens"] != OP_TOKENS:
                raise AssertionError(f"[router] {path}: usage {usage}")
            usage_sum += usage["total_tokens"]
            via.append((path, body, served[0], data))
        launches, per = collections.Counter(), {}
        for a in devs:
            k1 = _op_device(a)["kernel_launches"]
            per[a] = {k: k1[k] - k0[a][k] for k in k1 if k1[k] != k0[a][k]}
            launches.update(per[a])
        for a in decodes:
            if not (per[a].get("paged_kv_update", 0) > 0
                    and per[a].get("paged_mixed_attention", 0) > 0):
                raise AssertionError(f"[router] decode {a} launched "
                                     f"{per[a]}")
        ties = []
        for path, body, a, data in via:
            status, direct, _, _ = _op_call(a, path, body)
            if status != 200:
                raise AssertionError(f"[router] direct {a}: {status}")
            tie = _rt_same(f"[router] {path} stream="
                           f"{body.get('stream', False)} on {a}", data,
                           direct)
            if tie is not None:
                ties.append((path, bool(body.get("stream")), *tie))
        log(f"[router] 8 requests gateway -> router -> decode (4 streamed) "
            f"equal their decode replicas' direct answers under the "
            f"near-tie rule (parted at near-ties: {ties}); served by "
            f"{dict(collections.Counter(v[2] for v in via))}; kernel "
            f"launches over them {per}")
        # 3. Cache-aware routing of a shared prefix, in token ids.
        rng = np.random.default_rng(SEED + 91)
        prefix = [int(x) for x in rng.integers(32, 120,
                                               RT_PREFIX_PAGES * PAGE)]
        chain = ps.chain_digests(prefix, PAGE, RT_PREFIX_PAGES)
        poll_s = knobs.get_float("ARKS_ROUTER_SKETCH_POLL_S")
        m0 = {"hit": _rt_metric(
            router, 'router_route_decisions_total{reason="sketch_hit"}')}
        landed, holder = [], None
        for j in range(RT_TAILS):
            body = {"model": RT_SERVED, "max_tokens": 4, "temperature": 0,
                    "ignore_eos": True, "prompt": prefix + [
                        int(x) for x in rng.integers(32, 120, RT_TAIL)]}
            before = {a: _op_served(a) for a in decodes}
            status, data, _, _ = _op_call(gwa, "/v1/completions", body,
                                          RT_LOAD_TOKEN)
            after = {a: _op_served(a) for a in decodes}
            served = [a for a in decodes if after[a] != before[a]]
            if status != 200 or len(served) != 1:
                raise AssertionError(f"[router] prefix request {j}: "
                                     f"{status} {str(data)[:300]}")
            landed.append(served[0])
            if j == 0:
                holder = served[0]
                m0["blocks"] = _rt_metric(
                    router, 'router_expected_hit_blocks_total{backend="'
                    f'{holder}",tier="device"}}')
                # The holder's own sketch lists the prefix at tier 0; a
                # poll of the router that starts after this has ended
                # within two intervals (each fetch takes milliseconds).
                status, raw = _op_get(holder, "/v1/cache/sketch")
                got = ps.BackendSketch.from_payload(json.loads(raw))
                if got.score_chain(chain, "token") != (RT_PREFIX_PAGES, 0,
                                                       0):
                    raise AssertionError(f"[router] {holder}'s sketch "
                                         f"scores {got.score_chain(chain)}")
                time.sleep(2 * poll_s)
        hits = _rt_metric(
            router, 'router_route_decisions_total{reason="sketch_hit"}'
        ) - m0["hit"]
        blocks = _rt_metric(
            router, f'router_expected_hit_blocks_total{{backend="{holder}",'
            'tier="device"}') - m0["blocks"]
        if landed[1:] != [holder] * (RT_TAILS - 1) or \
                hits != RT_TAILS - 1 or \
                blocks != RT_PREFIX_PAGES * (RT_TAILS - 1):
            raise AssertionError(f"[router] prefix requests landed {landed}"
                                 f" (holder {holder}); sketch hits {hits}, "
                                 f"expected device blocks {blocks}")
        log(f"[router] a {RT_PREFIX_PAGES * PAGE}-token prefix with "
            f"{RT_TAILS} distinct {RT_TAIL}-token tails: the first landed on "
            f"{holder}, every later one there too; the router counted "
            f"{hits:.0f} sketch hits and {blocks:.0f} expected device "
            f"blocks (poll interval {poll_s} s)")
        # 4. TTFT and total time: through gateway -> router, and direct.
        body = {"model": RT_SERVED, "prompt": "time to first token",
                "max_tokens": OP_TTFT_TOKENS, "temperature": 0,
                "ignore_eos": True, "stream": True,
                "stream_options": {"include_usage": True}}
        runs = {"gateway -> router": [], "direct": []}
        for _ in range(OP_TTFT_RUNS):
            for way, a, tok in (("gateway -> router", gwa, RT_LOAD_TOKEN),
                                ("direct", decodes[0], None)):
                status, data, t_first, total = _op_call(
                    a, "/v1/completions", body, tok)
                if status != 200 or data[-1] != "[DONE]":
                    raise AssertionError(f"[router] {way}: {status}")
                runs[way].append((t_first, total))
        med = {way: (float(np.median([r[0] for r in v])),
                     float(np.median([r[1] for r in v])))
               for way, v in runs.items()}
        # A pull: the prefill replica's /v1/prefill answer, bytes and time.
        pulls = []
        for _ in range(3):
            host, _, port = prefill.partition(":")
            conn = http.client.HTTPConnection(host, int(port), timeout=120)
            t1 = time.perf_counter()
            conn.request("POST", "/v1/prefill", json.dumps(dict(
                body, stream=False, _chat=False)),
                {"Content-Type": "application/json"})
            resp = conn.getresponse()
            raw = resp.read()
            dt = time.perf_counter() - t1
            conn.close()
            if resp.status != 200:
                raise AssertionError(f"[router] pull: {resp.status}")
            meta, _ = kv_transfer.unpack(raw)
            pulls.append((len(raw), dt))
        log(f"[router] {OP_TTFT_TOKENS}-token stream, medians of "
            f"{OP_TTFT_RUNS} (host clock, {smi}): " + "; ".join(
                f"{way} TTFT {v[0] * 1e3:.2f} ms, total {v[1] * 1e3:.2f} ms"
                for way, v in med.items())
            + f"; a pull of its {meta['num_prompt']}-token prompt: "
            f"{pulls[0][0]} B in " + ", ".join(f"{s * 1e3:.2f}" for _, s in
                                               pulls) + " ms")
        # 5. Over the RPM limit: 429 from the native store; nothing moves.
        tok = store.get(res.Token, RT_USER)
        limit = {r["type"]: r["value"] for r in
                 tok.spec["qos"][0]["rateLimits"]}["rpm"]
        if time.time() % 60 > 50:
            time.sleep(60.5 - time.time() % 60)
        window = time.time() // 60
        key = window_key(RT_NS, RT_USER, RT_SERVED, "rpm")
        fill = {"model": RT_SERVED, "prompt": "fill", "max_tokens": 1,
                "temperature": 0}
        for _ in range(limit - gw.limiter.backend.get(key)):
            status, data, _, _ = _op_call(gwa, "/v1/completions", fill,
                                          RT_TOKEN)
            if status != 200:
                raise AssertionError(f"[router] under the limit: {status} "
                                     f"{data}")
        before = {a: _op_served(a) for a in decodes + [prefill]}
        r_before = _rt_metric(router, "router_requests_total")
        status, data, _, _ = _op_call(gwa, "/v1/completions", fill, RT_TOKEN)
        after = {a: _op_served(a) for a in decodes + [prefill]}
        r_after = _rt_metric(router, "router_requests_total")
        if time.time() // 60 != window:
            raise AssertionError("[router] the rate window turned")
        if status != 429 or "rate limit exceeded: rpm" not in str(data) \
                or after != before or r_after != r_before:
            raise AssertionError(f"[router] over the limit: {status} {data};"
                                 f" served {before} -> {after}, router "
                                 f"{r_before} -> {r_after}")
        log(f"[router] request {limit + 1} of the minute: 429 "
            f"{data['error']['message']!r} from the "
            f"{type(gw.limiter.backend).__name__}; the replicas' and the "
            f"router's counters stayed")
        # 6. Deleting the app stops the four processes.
        procs = [p for _, _, p in _rt_groups(driver, RT_APP).values()]
        t_down = time.perf_counter()
        store.delete(res.DisaggregatedApplication, RT_APP)
        _op_wait("teardown", lambda: all(
            store.try_get(res.GangSet, f"{RT_APP}-{c}") is None
            for c in ("router", "prefill", "decode"))
            and all(p.poll() is not None for p in procs), 60, driver, logs)
        _op_wait("the card's memory back", lambda: torch.cuda.mem_get_info()[
            0] >= free0 - OP_MEM_SLACK, 30, driver, logs)
        log(f"[router] teardown in {time.perf_counter() - t_down:.2f} s: the "
            f"{len(procs)} processes exited, the card has "
            f"{torch.cuda.mem_get_info()[0]} B free (before the phase "
            f"{free0})")
        out = {"launches": launches, "running_s": running, "ttft": med,
               "pull": pulls, "ties": ties}
    finally:
        gw.stop()
        mgr.stop()
        driver.teardown_all()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[router] phase took {out['seconds']:.1f} s")
    return out


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
    smi = phase_device(torch)
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
    _reset_counts()
    recov = phase_recovery(torch, dev, params)
    recov["launches"] = _read_counts()
    _reset_counts()
    pre = phase_preempt(torch, dev, params, ops)
    pre["launches"] = _read_counts()
    spec = phase_spec(torch, dev, params)
    pool = phase_pool(torch, dev, params)
    zero = phase_zero(torch, dev, ops)
    resid = phase_residency(torch, dev, params)
    disagg = phase_disagg(torch, dev, params)
    fleet = phase_fleet(torch, dev, params)
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
    train = phase_train(torch, dev)
    operator = phase_operator(torch, dev, smi)
    router = phase_router(torch, dev, smi)
    gm_row = gm[("528-row", "gate", "int8")]
    slot16, slot8 = legacy[("slot", "bf16")], legacy[("slot", "int8")]
    paged8, paged4 = legacy[("paged", "int8")], legacy[("paged", "int4")]
    pipe_n = collections.Counter(pipeline["launches"])
    pipe_n.update(prefix["launches"])     # served at the defaults, as are
    pipe_n.update(ops["counts"])          # the operability engine and the
    pipe_n.update(ckpt_n)                 # checkpoint-loaded ones, and
    pipe_n.update(recov["launches"])      # the recovery phase's engines,
    pipe_n.update(pre["launches"])        # the preemption phase's and
    pipe_n.update(spec["launches"])       # the speculative phase's, the
    pipe_n.update(pool["launches"])       # pool's (its baselines and the
    pipe_n.update(zero["launches"])       # server pass), scale-to-zero's
    pipe_n.update(resid["launches"])      # residency's (span chains),
    pipe_n.update(disagg["launches"])     # the disaggregated decode
    pipe_n.update(fleet["launches"])      # engines' and the fleet's,
    pipe_n.update(operator["launches"])   # the operator's replicas' and
    pipe_n.update(router["launches"])     # the routed replicas'
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
    log(f"[recovery table] tracing on / off: launches per steady step "
        f"{ops['trace_launches_per_step'][0]:.2f} / "
        f"{ops['trace_launches_per_step'][1]:.2f}, host ms "
        f"{ops['trace_host_ms_per_step'][0]:.3f} / "
        f"{ops['trace_host_ms_per_step'][1]:.3f}")
    log(f"[recovery table] replay_diverged {recov['diverged']}; recovery "
        f"seconds {recov['recovery_s']}; device memory (engine, before, "
        f"fault-free peak, peak across the recovery) {recov['peak']}; tracer "
        f"{recov['tracer']}; profiler window (arks_step annotations, the "
        f"port's kernel events) {recov['profiler']}; restore bystander equal "
        f"{recov['restore_bystander_equal']}; step forms "
        f"{recov['step_forms']}; issues sync-checked "
        f"{recov['syncs']}; subprocesses hang {recov['child_hang_s']:.1f} s, "
        f"sticky {recov['child_sticky_s']:.1f} s; launches {recov['launches']}")
    log(f"[preempt table] TTFT of the latency arrivals (median) off "
        f"{pre['ttft_off']:.4f} s, on {pre['ttft_on']:.4f} s; "
        f"preempt_swap_seconds swap-out {pre['swap_out_s']}, resume "
        f"{pre['resume_s']}; bytes per victim {pre['bytes']}; peak device "
        f"memory {pre['peak']}; launches per steady step {pre['steady']}; "
        f"issues sync-checked {pre['syncs']}; launches {pre['launches']}")
    log(f"[spec table] acceptance {spec['acceptance']:.4f}, accepted "
        f"length {spec['accepted_len']:.3f}; tok/s target-only / spec "
        f"{spec['tok_s']}; spec step (host ms, device ms, launches) "
        f"{spec['step']['spec']} beside the pipe step "
        f"{spec['step']['pipe']}; draft cache bytes {spec['draft_bytes']} "
        f"(config B {spec['draft_bytes_b']}); peak device memory "
        f"{spec['peak']}; differing greedy streams {spec['ties']} (top-2 "
        f"gaps median, mean, share below {SPEC_GAP_BOUND}: {spec['gaps']}); "
        f"issues "
        f"sync-checked {spec['syncs']}; launches {dict(spec['launches'])}")
    ta, tb = train["a"], train["b"]
    log(f"[train table] {TRAIN_MODEL} f32 {ta['batch']} x {TRAIN_SEQ}: "
        f"{ta['ms_median']:.1f} ms per step, {ta['tok_s']:.0f} tok/s, peak "
        f"{ta['peak_bytes']} B beside the {ta['state_gb']:.2f} GB state, "
        f"{ta['step_launches']} launches per step; resume bit-identical "
        f"over {ta['resume_leaves']} leaves (save {ta['save_s']:.1f} s, "
        f"restore {ta['restore_s']:.1f} s, restore peak "
        f"{ta['restore_peak']} B); {TRAIN_MOE_MODEL} x{TRAIN_MOE_LAYERS} "
        f"layer {TRAIN_MOE_BATCH} x {TRAIN_SEQ}: {tb['ms_median']:.1f} ms "
        f"per step, {tb['tok_s']:.0f} tok/s, peak {tb['peak_bytes']} B "
        f"beside the {tb['state_gb']:.2f} GB state; the entry point "
        f"{train['c']['seconds']}; phase {train['seconds']:.1f} s")
    log(f"[operator table] {smi}: replicas Running after "
        + ", ".join(f"{t:.2f} s" for _, t in sorted(
            operator["running_s"].items()))
        + f"; roll {operator['roll_s']:.2f} s under "
        f"{operator['requests_during_roll']} requests; TTFT / total ms "
        f"gateway {operator['ttft']['gateway'][0] * 1e3:.2f} / "
        f"{operator['ttft']['gateway'][1] * 1e3:.2f}, direct "
        f"{operator['ttft']['direct'][0] * 1e3:.2f} / "
        f"{operator['ttft']['direct'][1] * 1e3:.2f}; phase "
        f"{operator['seconds']:.1f} s")
    log(f"[router table] {smi}: Running after " + ", ".join(
        f"{c}-{i} {t:.2f} s" for (c, i), t in sorted(
            router["running_s"].items()))
        + "; TTFT / total ms " + ", ".join(
            f"{way} {v[0] * 1e3:.2f} / {v[1] * 1e3:.2f}"
            for way, v in router["ttft"].items())
        + f"; pull {router['pull'][0][0]} B in "
        f"{min(s for _, s in router['pull']) * 1e3:.2f} ms (least of "
        f"{len(router['pull'])}); near-ties {router['ties']}; phase "
        f"{router['seconds']:.1f} s")
    log(f"[done] all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys}
                                  for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--recovery-child"]:
        sys.exit(recovery_child(sys.argv[2]))
    sys.exit(main())

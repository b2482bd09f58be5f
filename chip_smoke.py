#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``arks_tpu_torch``): drives its main
path on one NVIDIA GPU and holds every kernel of that path against its
plain PyTorch version.  Run from the repository root: ``python3 chip_smoke.py``.

Phases (any failure raises and exits non-zero):
  1. device   the card's name and power limit (nvidia-smi); no CUDA -> exit 2
  2. build    nvcc builds every kernel from arks_tpu_torch/csrc (timed)
  3. kernels  each kernel vs its plain version on the card at Qwen2.5-7B
              shapes (Hkv=4, G=7, D=128, page 256, bf16) on a mixed batch:
              8 decode lanes across page boundaries, prefill chunks of 256
              and 37 tokens (one starting mid-page), padding tokens and
              inactive lanes.  The update must leave the pool bit-identical
              to the plain scatter; the bf16 attention within 5e-3 of the
              plain version in bf16 and 1e-2 of it in f32 on the same bf16
              inputs; the f32 attention within 1e-5 of the plain version in
              f32; rows no lane owns exactly zero.
  4. serve    the port's engine at Qwen2.5-7B full width (random bf16
              weights from a seed, 8 slots, max_cache_len 4096) behind its
              OpenAI server: completions (plain, SSE across two prefill
              chunks, repeated greedy), chat, and concurrent requests that
              share dispatches; both kernels' launch counters must equal
              num_layers x the mixed dispatches of this phase.
  5. parity   two mixed_steps through the kernels vs the same steps through
              impl="plain": logits within 10% of the largest |logit| in
              bf16 and within 5e-4 in f32, and the same argmax wherever the
              top-2 margin exceeds that tolerance.  Then a traced decode
              step: host time per step and the device's busy share.
  6. times    CUDA-event kernel times (L2 flushed before each launch) beside
              their bounds, the plain versions and one PyTorch library call
              computing the same function; end-to-end decode tok/s and TTFT.
The line before the last is the kernels JSON; the last line is the device
JSON.
"""

from __future__ import annotations

import http.client
import json
import math
import subprocess
import sys
import threading
import time

import numpy as np

MODEL = "qwen2.5-7b"
SEED = 0
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
PAGE, MAX_PAGES = 256, 16        # engine page (= chunk) and table width
UPDATE_SRC = "arks_tpu_torch/csrc/paged_kv_update.cu"
ATTN_SRC = "arks_tpu_torch/csrc/paged_mixed_attention.cu"
# Attention, phase 3: the bf16 kernel vs the bf16 plain version (one bf16
# ulp at |x| < 1 is at most 3.9e-3) and vs the f32 plain version on the
# same bf16 inputs; the f32 kernel vs the f32 plain version.
ATTN_TOL_BF16, ATTN_TOL_F32, ATTN_TOL_F32_KERNEL = 5e-3, 1e-2, 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


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
    log(f"[build] {len(logs)} kernels built with nvcc in {secs:.1f} s")
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


def phase_kernels(torch, dev):
    from arks_tpu_torch.ops import paged_attention as pa
    b = kernel_batch(torch, dev)
    upd_args = (b["k_new"], b["v_new"], b["write_idx"], b["tables_tok"],
                b["layer"])
    k_kern, v_kern = b["k_pool"].clone(), b["v_pool"].clone()
    k_plain, v_plain = b["k_pool"].clone(), b["v_pool"].clone()
    pa.paged_kv_update(k_kern, v_kern, *upd_args)
    pa.paged_kv_update(k_plain, v_plain, *upd_args, impl="plain")
    torch.cuda.synchronize()
    same = (torch.equal(k_kern.view(torch.int16), k_plain.view(torch.int16))
            and torch.equal(v_kern.view(torch.int16),
                            v_plain.view(torch.int16)))
    upd_err = max((k_kern.float() - k_plain.float()).abs().max().item(),
                  (v_kern.float() - v_plain.float()).abs().max().item())
    log(f"[kernels] paged_kv_update: pool bytes bit-identical to the plain "
        f"scatter: {same} (max abs err {upd_err})")
    if not same:
        raise AssertionError("paged_kv_update differs from the plain scatter")

    lane = (b["tables"], b["seq_q_start"], b["seq_q_len"], b["seq_pos_start"],
            b["layer"])
    out_k = pa.paged_mixed_attention(b["q"], k_kern, v_kern, *lane)
    out_p = pa.paged_mixed_attention(b["q"], k_kern, v_kern, *lane,
                                     impl="plain")
    qf, kf, vf = b["q"].float(), k_kern.float(), v_kern.float()
    out_f = pa.paged_mixed_attention(qf, kf, vf, *lane, impl="plain")
    out_fk = pa.paged_mixed_attention(qf, kf, vf, *lane)
    torch.cuda.synchronize()
    del kf, vf
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
    b["k_pool"], b["v_pool"] = k_kern, v_kern
    return b, upd_err, err_bf16


# ---------------------------------------------------------------------------
# Phase 4: the served path
# ---------------------------------------------------------------------------


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


def phase_serve(torch, dev):
    from arks_tpu_torch.engine import EngineConfig, InferenceEngine
    from arks_tpu_torch.engine.tokenizer import ByteTokenizer
    from arks_tpu_torch.models import get_config
    from arks_tpu_torch.ops import paged_attention as pa
    from arks_tpu_torch.server import OpenAIServer

    cfg = get_config(MODEL)
    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, EngineConfig(
        model=MODEL, num_slots=8, max_cache_len=MAX_PAGES * PAGE,
        prefill_chunk=PAGE, dtype="bfloat16", seed=SEED), ByteTokenizer(),
        device=dev)
    torch.cuda.synchronize()
    log(f"[serve] {MODEL} engine up in {time.perf_counter() - t0:.1f} s: "
        f"{sum(x.numel() for x in _leaves(engine.params)) / 1e9:.2f}B "
        f"params bf16, pool {tuple(engine.cache.k.shape)}, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    server = OpenAIServer(engine, MODEL, host="127.0.0.1", port=0)
    server.start(background=True)
    engine.start()
    port = server.port
    tok = engine.tokenizer
    res = {}
    try:
        # Warm-up request (first cuBLAS/kernel calls), outside the counts.
        st, data, _, _ = _request(port, "/v1/completions", {
            "prompt": "warm up", "max_tokens": 4, "temperature": 0})
        if st != 200:
            raise AssertionError(f"warm-up failed: {st} {data}")

        pa.paged_kv_update.launches = 0
        pa.paged_mixed_attention.launches = 0
        d0, shared0 = engine.dispatches, engine.shared_dispatches

        prompt = "The port serves OpenAI completions on the card."
        body = {"prompt": prompt, "max_tokens": 24, "temperature": 0}
        st, data, _, secs = _request(port, "/v1/completions", body)
        if st != 200:
            raise AssertionError(f"completion: HTTP {st} {data}")
        text1 = data["choices"][0]["text"]
        _check_usage("completion", data["usage"], len(tok.encode(prompt)),
                     24, data["choices"][0]["finish_reason"])
        st, data2, _, _ = _request(port, "/v1/completions", body)
        if st != 200 or data2["choices"][0]["text"] != text1:
            raise AssertionError("a repeated greedy completion differs")
        log(f"[serve] repeated greedy completion identical ({len(text1)} "
            "chars)")

        long_ids = [int(x) for x in
                    np.random.default_rng(SEED).integers(2, 258, 300)]
        st, frames, ttft, secs = _request(port, "/v1/completions", {
            "prompt": long_ids, "max_tokens": 32, "temperature": 0,
            "ignore_eos": True, "stream": True,
            "stream_options": {"include_usage": True}}, stream=True)
        text, finish, usage = _stream_summary(frames)
        if st != 200 or len(finish) != 1 or len(usage) != 1:
            raise AssertionError(f"SSE completion: HTTP {st}, {finish}")
        _check_usage("SSE completion (300-token prompt, 2 chunks)", usage[0],
                     300, 32, finish[0])
        res["ttft_300_s"] = ttft

        msgs = [{"role": "user", "content": "Say something about pages."}]
        st, data, _, _ = _request(port, "/v1/chat/completions", {
            "messages": msgs, "max_tokens": 16, "temperature": 0})
        if st != 200 or data["choices"][0]["message"]["role"] != "assistant":
            raise AssertionError(f"chat: HTTP {st} {data}")
        _check_usage("chat completion", data["usage"],
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
            _check_usage(f"concurrent {key}", data["usage"], n_prompt, n_max,
                         data["choices"][0]["finish_reason"])
        shared = engine.shared_dispatches - shared0
        log(f"[serve] dispatches carrying decode and prefill tokens: {shared}")
        if shared < 1:
            raise AssertionError("decode and prefill never shared a dispatch")

        dispatches = engine.dispatches - d0
        launches = {"paged_kv_update": pa.paged_kv_update.launches,
                    "paged_mixed_attention":
                        pa.paged_mixed_attention.launches}
        want = cfg.num_layers * dispatches
        log(f"[serve] mixed dispatches {dispatches}, launches {launches}, "
            f"expected {want} each ({cfg.num_layers} layers)")
        if any(v != want for v in launches.values()) or dispatches == 0:
            raise AssertionError("kernel launch counts != layers x dispatches")
        res["launches"] = launches
        res["launches_per_step"] = cfg.num_layers

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
        log(f"[serve] decode {res['decode_tok_s_b1']:.1f} tok/s at batch 1, "
            f"{res['decode_tok_s_b8']:.1f} tok/s aggregate at batch 8 "
            f"({total} tokens in {wall:.2f} s incl. prefill); TTFT of the "
            f"300-token prompt {res['ttft_300_s'] * 1e3:.1f} ms (first SSE "
            "frame)")
    finally:
        server.stop()
        engine.stop()
    return engine, res


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
    f32 on an f32 copy of them.  Both: the same argmax wherever the top-2
    margin exceeds the tolerance.

    f32 is the tight check: within 5e-4 absolute (6.6e-5 measured on an H100).  bf16
    is a loose one: within 10% of the largest |logit|.  The kernel rounds p
    to bf16 before normalising, as the reference kernel does; the oracle
    rounds the normalised probabilities; 28 random layers amplify the
    difference.  At 5% one H100 run passed with 0.297 against a limit of
    0.308, so the limit is 10%; at that width no lane's top-2 margin exceeds
    it, and the argmax clause holds only in f32."""
    from arks_tpu_torch.models import transformer as tf
    worst = {}
    for dtype, rel, abs_tol in ((torch.bfloat16, 0.10, 0.0),
                                (torch.float32, 0.0, 5e-4)):
        params = engine.params if dtype == torch.bfloat16 else {
            k: ({n: w.float() for n, w in v.items()} if isinstance(v, dict)
                else v.float()) for k, v in engine.params.items()}
        worst[str(dtype)] = _parity_steps(torch, dev, tf, engine.cfg, params,
                                          dtype, rel, abs_tol)
        del params
        torch.cuda.empty_cache()
    return worst


def _parity_steps(torch, dev, tf, cfg, params, dtype, rel, abs_tol):
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
    caches = {impl: tf.init_paged_cache(cfg, n_pages, PAGE, dtype, dev)
              for impl in ("kernel", "plain")}
    worst = 0.0
    for i, args in enumerate(steps):
        logits = {impl: tf.mixed_step(params, cfg, caches[impl], tables,
                                      *args, impl=impl)
                  for impl in ("kernel", "plain")}
        k, p = logits["kernel"], logits["plain"]
        tol = rel * p.abs().max().item() + abs_tol
        err = (k - p).abs().max().item()
        top2 = p.topk(2, dim=-1).values
        wide = (top2[:, 0] - top2[:, 1]) > tol
        agree = bool((k.argmax(-1) == p.argmax(-1))[wide].all().item())
        finite = bool(torch.isfinite(k).all().item())
        log(f"[parity] {dtype} step {i}: max |logit diff| {err:.3e} (tol "
            f"{tol:.3e}; max |logit| {p.abs().max().item():.3f}), argmax "
            f"agrees on the {int(wide.sum())} of 3 lanes with margin > tol: "
            f"{agree}; finite {finite}")
        if not (err <= tol and agree and finite):
            raise AssertionError("mixed_step through the kernels disagrees "
                                 "with the plain path")
        worst = max(worst, err)
    return worst


def phase_step_profile(torch, dev, engine):
    """Where a decode step's time goes: one mixed_step + greedy sample over
    8 decode lanes at context 512 on the engine's weights, timed on the host
    clock (synchronised) and traced with torch.profiler for the device's
    kernel time.  Device busy share = summed device kernel time / wall."""
    from torch.profiler import ProfilerActivity, profile

    from arks_tpu_torch.engine import sampler
    from arks_tpu_torch.models import transformer as tf
    cfg, lanes, ctx = engine.cfg, 8, 512
    maxp = ctx // PAGE + 1
    cache = tf.init_paged_cache(cfg, lanes * maxp, PAGE, torch.bfloat16, dev)
    i32 = dict(dtype=torch.int32, device=dev)
    ar = torch.arange(lanes, **i32)
    args = (torch.arange(lanes * maxp, **i32).reshape(lanes, maxp),
            torch.full((lanes,), 5, **i32), ar, torch.full((lanes,), ctx, **i32),
            ar, ar, torch.ones(lanes, **i32), torch.full((lanes,), ctx, **i32))

    def step():
        logits = tf.mixed_step(engine.params, cfg, cache, *args, qmax=1)
        return sampler.sample(logits, None, None, None).cpu()

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
    weight_bytes = sum(x.numel() * x.element_size()
                       for x in _leaves(engine.params))
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(f"[profile] decode step, {lanes} lanes at context {ctx}: "
        f"{wall_ms:.2f} ms host clock ({lanes / wall_ms * 1e3:.1f} tok/s), "
        f"device kernel time "
        + (f"{dev_us / 1e3:.2f} ms/step, busy share "
           f"{dev_us / 1e3 / wall_ms:.3f}" if dev_us else "not measured")
        + f"; weight-read bound {bound_ms:.2f} ms ({weight_bytes} B)")
    for e in top:
        log(f"[profile]   {e.key[:60]:60s} {e.self_device_time_total / 3:9.1f}"
            f" us/step x{e.count // 3}")
    return wall_ms, dev_us / 1e3 if dev_us else None


# ---------------------------------------------------------------------------
# Phase 6: kernel times
# ---------------------------------------------------------------------------


def _time_ms(torch, fn, iters=20, warmup=3):
    """Mean CUDA-event time of fn() over ``iters`` launches, with a 256 MiB
    write before each so L2 (50 MB) holds none of its inputs — the served
    path streams 15 GB of weights between two calls of a kernel."""
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


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
    upd_times = dict(
        ms=_time_ms(torch, lambda: pa.paged_kv_update(k_pool, v_pool, *upd)),
        plain_ms=_time_ms(torch, lambda: pa.paged_kv_update(
            k_pool, v_pool, *upd, impl="plain")),
        library_ms=_time_ms(torch, lib_upd))
    upd_times["bound_ms"] = upd_bytes / HBM_BYTES_PER_S * 1e3

    # paged_mixed_attention: the lane view (3 int32 per lane), each active
    # lane's table entries for its pages, its K/V prefix
    # [0, pos_start + q_len) once per KV head, q read and out written once;
    # flops 4*D per (query head, query, key) pair over the causal span.
    ql = b["seq_q_len"].cpu().numpy().astype(np.int64)
    ps = b["seq_pos_start"].cpu().numpy().astype(np.int64)

    def attn_bytes_of(q_len):
        ends = np.where(q_len > 0, ps + q_len, 0)
        return (3 * len(q_len) * 4 + int((-(-ends // PAGE)).sum()) * 4
                + int(ends.sum()) * hkv * d * el * 2
                + 2 * int(q_len.sum()) * h * d * el)
    ends = np.where(ql > 0, ps + ql, 0)
    attn_bytes = attn_bytes_of(ql)
    pairs = sum(int(np.sum(np.arange(p, p + n) + 1)) for p, n in zip(ps, ql))
    attn_flops = 4 * h * d * pairs
    lane = (b["tables"], b["seq_q_start"], b["seq_q_len"], b["seq_pos_start"],
            layer)
    # Library yardstick: SDPA over the gathered KV of the active lanes.
    act = np.nonzero(ql)[0]
    qmax = int(ql.max())
    kv_len = int(math.ceil(ends.max() / PAGE) * PAGE)
    tab = b["tables"][torch.as_tensor(act, device=k_pool.device)]
    tab = tab[:, : kv_len // PAGE]
    from arks_tpu_torch.ops.paged_attention import paged_gather_kv
    g = h // hkv                                        # GQA, expanded here
    kg = paged_gather_kv(k_pool, tab, layer).repeat_interleave(g, dim=1)
    vg = paged_gather_kv(v_pool, tab, layer).repeat_interleave(g, dim=1)
    span = b["seq_q_start"][act].long()[:, None] + torch.arange(
        qmax, device=k_pool.device)
    qg = b["q"][span.clamp(max=t - 1)].permute(0, 2, 1, 3).contiguous()
    qpos = b["seq_pos_start"][act].long()[:, None] + torch.arange(
        qmax, device=k_pool.device)
    mask = (torch.arange(kv_len, device=k_pool.device)[None, None, :]
            <= qpos[:, :, None])[:, None]
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
        library_ms=_time_ms(torch, lambda: sdpa(qg, kg, vg, attn_mask=mask)))
    byte_ms = attn_bytes / HBM_BYTES_PER_S * 1e3
    flop_ms = attn_flops / BF16_FLOPS * 1e3
    attn_times["bound_ms"] = max(byte_ms, flop_ms)
    attn_times["bound_by"] = "bytes" if byte_ms >= flop_ms else "operations"

    # A decode-only batch (the 8 decode lanes alone) for the record.
    dec = b["seq_q_len"].clone()
    dec[8:] = 0
    dec_work = pa.mixed_work(b["tables"], b["seq_q_start"], dec,
                             b["seq_pos_start"], page=PAGE, hkv=hkv, qmax=1)
    dec_ms = _time_ms(torch, lambda: pa.paged_mixed_attention(
        b["q"], k_pool, v_pool, b["tables"], b["seq_q_start"], dec,
        b["seq_pos_start"], layer, work=dec_work))
    dec_bytes = attn_bytes_of(np.where(np.arange(len(ql)) < 8, ql, 0))
    log(f"[times] paged_kv_update {upd_times['ms'] * 1e3:.1f} us (bound "
        f"{upd_times['bound_ms'] * 1e3:.2f} us, {upd_bytes} B), plain "
        f"{upd_times['plain_ms'] * 1e3:.1f} us, index_put_ x2 "
        f"{upd_times['library_ms'] * 1e3:.1f} us; T={t} tokens")
    log(f"[times] paged_mixed_attention {attn_times['ms'] * 1e3:.1f} us "
        f"(bound {attn_times['bound_ms'] * 1e3:.2f} us by "
        f"{attn_times['bound_by']}: {attn_bytes} B, {attn_flops:.3e} flop), "
        f"plain {attn_times['plain_ms'] * 1e3:.1f} us, SDPA on gathered KV "
        f"{attn_times['library_ms'] * 1e3:.1f} us; wrapper building its "
        f"work list per call {wrapper_ms * 1e3:.1f} us")
    log(f"[times] paged_mixed_attention decode-only (8 lanes, contexts "
        f"{list(ps[:8] + 1)}): {dec_ms * 1e3:.1f} us (bound "
        f"{dec_bytes / HBM_BYTES_PER_S * 1e6:.2f} us by bytes)")
    upd_times["bound_by"] = "bytes"
    return upd_times, attn_times


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
    engine, serve = phase_serve(torch, dev)
    worst = phase_parity(torch, dev, engine)
    log(f"[parity] worst |logit diff| per dtype {worst}")
    phase_step_profile(torch, dev, engine)
    del engine
    torch.cuda.empty_cache()
    upd_t, attn_t = phase_times(torch, b)
    kernels = [
        dict(name="paged_kv_update", route="cuda", source=UPDATE_SRC,
             replaces="arks_tpu/ops/paged_attention.py:1127",
             launches=serve["launches"]["paged_kv_update"],
             max_abs_err=upd_err, **upd_t),
        dict(name="paged_mixed_attention", route="cuda", source=ATTN_SRC,
             replaces="arks_tpu/ops/paged_attention.py:761",
             launches=serve["launches"]["paged_mixed_attention"],
             max_abs_err=attn_err, **attn_t),
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"[done] all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys}
                                  for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

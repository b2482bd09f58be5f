"""The port's legacy scheduler against the JAX engine on the same weights:
``kv_layout="slot"``, and ``kv_layout="paged"`` under ``ARKS_MIXED_STEP=0``,
with f32 and int8 caches on ``tiny`` and ``tiny-gqa`` (and an int4 paged
pool).  Greedy and seeded
token streams must be identical, with more requests than slots and
prompts on both admission paths: buckets (8, 16, 32), so prompts of 3, 10
and 20 tokens are admitted one-shot and prompts of 33 and 48 chunk by
chunk (16).  All pages come back to the allocator afterwards.  Then the
configurations the legacy path refuses, and the server's ``--kv-layout
slot`` on the CPU."""

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arks_tpu.engine import EngineConfig as JaxEngineConfig
from arks_tpu.engine import InferenceEngine as JaxEngine
from arks_tpu.engine import Request as JaxRequest
from arks_tpu.engine import SamplingParams as JaxSamplingParams
from arks_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from arks_tpu.models import get_config as jax_get_config
from arks_tpu.models import transformer as jtf
from arks_tpu_torch.engine import EngineConfig, InferenceEngine, Request, \
    SamplingParams
from arks_tpu_torch.engine import engine as engine_mod
from arks_tpu_torch.engine.tokenizer import ByteTokenizer
from arks_tpu_torch.models import get_config
from arks_tpu_torch.models import transformer as ttf
from arks_tpu_torch.models.weights import params_from_numpy

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
ENGINE_KW = dict(num_slots=2, max_cache_len=64, steps_per_dispatch=4,
                 prefill_chunk=16, dtype="float32",
                 prefill_buckets=(8, 16, 32))


def _prompts(vocab):
    rng = np.random.default_rng(11)
    lens = [3, 20, 48, 10, 33]     # 48 and 33 chunk; the rest are one-shot
    return [[int(x) for x in rng.integers(2, vocab, n)] for n in lens]


def _collect(outputs, timeout=120):
    ids = []
    while True:
        out = outputs.get(timeout=timeout)
        ids.extend(out.token_ids)
        if out.finished:
            return ids, out


def _drive(engine, busy, n_steps=1000):
    for _ in range(n_steps):
        engine.step(block_s=0.01)
        if not busy(engine):
            return
    raise AssertionError("engine did not drain")


def _sampling(i, max_tokens, seed):
    if seed is None:
        return dict(max_tokens=max_tokens, temperature=0.0, ignore_eos=True)
    return dict(max_tokens=max_tokens, temperature=0.8, top_k=20, top_p=0.9,
                seed=seed + i, ignore_eos=True)


def _jax_streams(name, params, prompts, max_tokens, layout, kv, seed):
    ecfg = JaxEngineConfig(model=name, kv_layout=layout, kv_cache_dtype=kv,
                           prefix_cache_mb=0, **ENGINE_KW)
    eng = JaxEngine(jax_get_config(name), ecfg, JaxByteTokenizer(),
                    params=params)
    assert not eng._mixed and eng._paged == (layout == "paged")
    reqs = [JaxRequest(f"r{i}", p, JaxSamplingParams(
        **_sampling(i, max_tokens, seed))) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    _drive(eng, lambda e: e.num_running or not e._queue.empty()
           or e._prefilling)
    return [_collect(r.outputs) for r in reqs]


def _torch_streams(name, params, prompts, max_tokens, layout, kv, seed):
    eng = InferenceEngine(get_config(name), EngineConfig(
        model=name, kv_layout=layout, kv_cache_dtype=kv, **ENGINE_KW),
        ByteTokenizer(), params=params, device="cpu")
    assert not eng._mixed and eng._paged == (layout == "paged")
    reqs = [Request(f"r{i}", p, SamplingParams(
        **_sampling(i, max_tokens, seed))) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    _drive(eng, lambda e: not e.idle)
    return [_collect(r.outputs) for r in reqs], eng


def _params(name, key):
    jparams = jtf.init_params(jax_get_config(name), jax.random.PRNGKey(key),
                              jnp.float32)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      get_config(name), "cpu")


def _same_streams(want, got):
    for (w_ids, w_fin), (g_ids, g_fin) in zip(want, got, strict=True):
        assert g_ids == w_ids
        assert (g_fin.finish_reason, g_fin.num_prompt_tokens,
                g_fin.num_generated_tokens) == (
            w_fin.finish_reason, w_fin.num_prompt_tokens,
            w_fin.num_generated_tokens)


def _check_engine(eng, kv, layout):
    assert eng.dispatches == 0 and eng.decode_steps == \
        4 * eng.decode_dispatches > 0
    assert isinstance(eng.cache, ttf.PagedKVCache if layout == "paged"
                      else ttf.KVCache)
    assert eng.cache.quantized == (kv in ("int8", "int4"))
    if layout == "paged":
        assert eng._alloc.free_pages == \
            eng._alloc.num_pages - eng._alloc.retained_pages


@pytest.mark.parametrize("kv", ["auto", "int8"])
@pytest.mark.parametrize("layout", ["slot", "paged"])
@pytest.mark.parametrize("name", ["tiny", "tiny-gqa"])
def test_legacy_greedy_streams_match_jax_engine(name, layout, kv,
                                                monkeypatch):
    monkeypatch.setenv("ARKS_MIXED_STEP", "0")
    jparams, tparams = _params(name, 3)
    prompts = _prompts(jax_get_config(name).vocab_size)
    want = _jax_streams(name, jparams, prompts, 9, layout, kv, None)
    got, eng = _torch_streams(name, tparams, prompts, 9, layout, kv, None)
    _same_streams(want, got)
    _check_engine(eng, kv, layout)


@pytest.mark.parametrize("layout", ["slot", "paged"])
@pytest.mark.parametrize("name", ["tiny", "tiny-gqa"])
def test_legacy_f32_engine_bf16_cache_greedy_streams_match_jax_engine(
        name, layout, monkeypatch):
    """An f32 engine over a bf16 cache on the legacy scheduler (slot cache,
    and paged under ARKS_MIXED_STEP=0): the greedy streams are the JAX
    engine's, and the known stream of ``tiny``'s PRNGKey(3) weights for
    the prompt [5..10] comes out on both."""
    monkeypatch.setenv("ARKS_MIXED_STEP", "0")
    jparams, tparams = _params(name, 3)
    prompts = _prompts(jax_get_config(name).vocab_size)
    if name == "tiny":
        prompts = [list(range(5, 11))] + prompts
    want = _jax_streams(name, jparams, prompts, 9, layout, "bf16", None)
    got, eng = _torch_streams(name, tparams, prompts, 9, layout, "bf16",
                              None)
    assert eng.cache.k.dtype == torch.bfloat16
    _same_streams(want, got)
    _check_engine(eng, "bf16", layout)
    if name == "tiny":
        assert got[0][0][:5] == [422, 505, 428, 390, 413]


@pytest.mark.parametrize("seed", [5, 2**33 + 7])
@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_legacy_seeded_streams_match_jax_engine(layout, seed, monkeypatch):
    """Seeded draws at temperature 0.8 with top-k and top-p: the first
    token with the request's key, the rest with fold_in(key, 1) split at
    every decode step of an active slot."""
    monkeypatch.setenv("ARKS_MIXED_STEP", "0")
    name = "tiny-gqa"
    jparams, tparams = _params(name, 5)
    prompts = _prompts(jax_get_config(name).vocab_size)
    want = _jax_streams(name, jparams, prompts, 11, layout, "auto", seed)
    got, eng = _torch_streams(name, tparams, prompts, 11, layout, "auto",
                              seed)
    _same_streams(want, got)
    assert len({tuple(ids) for ids, _ in got}) == len(prompts)
    _check_engine(eng, "auto", layout)


def test_legacy_mixes_greedy_and_seeded_slots(monkeypatch):
    """Greedy and seeded requests share decode dispatches on the slot
    cache: every stream matches the JAX engine's."""
    name = "tiny-gqa"
    jparams, tparams = _params(name, 6)
    prompts = _prompts(jax_get_config(name).vocab_size)

    def run(lib):
        kw = dict(max_tokens=10, ignore_eos=True)
        if lib == "jax":
            eng = JaxEngine(jax_get_config(name), JaxEngineConfig(
                model=name, kv_layout="slot", prefix_cache_mb=0,
                **ENGINE_KW), JaxByteTokenizer(), params=jparams)
            mk = lambda i, p, sp: JaxRequest(  # noqa
                f"r{i}", p, JaxSamplingParams(**sp))
            busy = lambda e: (e.num_running or not e._queue.empty()  # noqa
                              or e._prefilling)
        else:
            eng = InferenceEngine(get_config(name), EngineConfig(
                model=name, kv_layout="slot", **ENGINE_KW), ByteTokenizer(),
                params=tparams, device="cpu")
            mk = lambda i, p, sp: Request(f"r{i}", p, SamplingParams(**sp))  # noqa
            busy = lambda e: not e.idle  # noqa
        reqs = [mk(i, p, dict(kw, temperature=0.7, seed=40 + i) if i % 2
                   else dict(kw, temperature=0.0))
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.add_request(r)
        _drive(eng, busy)
        return [_collect(r.outputs) for r in reqs]

    _same_streams(run("jax"), run("torch"))


def test_admission_groups_one_shot_prompts_by_bucket(monkeypatch):
    """Prompts of one bucket are admitted in one batch (sizes from
    ARKS_ADMIT_BATCH_SIZES); a long prompt takes the chunked path."""
    monkeypatch.setenv("ARKS_ADMIT_BATCH_SIZES", "2")
    calls = []
    admit = InferenceEngine._issue_admit_batch

    def spy(self, items):
        calls.append(sorted(len(ids) for _, ids, _ in items))
        return admit(self, items)

    monkeypatch.setattr(InferenceEngine, "_issue_admit_batch", spy)
    eng = InferenceEngine(get_config("tiny"), EngineConfig(
        model="tiny", kv_layout="slot", **dict(ENGINE_KW, num_slots=4)),
        ByteTokenizer(), device="cpu")
    assert eng._admit_sizes == (2, 1)
    lens = [5, 7, 12, 40]
    reqs = [Request(f"r{i}", list(range(2, 2 + n)), SamplingParams(
        max_tokens=3, temperature=0.0)) for i, n in enumerate(lens)]
    for r in reqs:
        eng.add_request(r)
    _drive(eng, lambda e: not e.idle)
    assert sorted(calls) == [[5, 7], [12]]
    assert all(_collect(r.outputs)[1].finish_reason == "length"
               for r in reqs)


def test_slot_cache_rejects_int4():
    with pytest.raises(ValueError, match="int4"):
        InferenceEngine(get_config("tiny"), EngineConfig(
            model="tiny", kv_layout="slot", kv_cache_dtype="int4",
            **ENGINE_KW), ByteTokenizer(), device="cpu")


def test_legacy_paged_int4_raises(monkeypatch):
    """Once a refusal, now the int4 repair: a paged int4 pool under
    ARKS_MIXED_STEP=0 serves (its decode attention rides the mixed kernel,
    one query per slot) and its greedy streams equal the JAX engine's,
    which sends int4 decode to its XLA oracle, on f32 ``tiny`` and
    ``tiny-gqa``."""
    monkeypatch.setenv("ARKS_MIXED_STEP", "0")
    for name in ("tiny", "tiny-gqa"):
        jparams, tparams = _params(name, 3)
        prompts = _prompts(jax_get_config(name).vocab_size)
        want = _jax_streams(name, jparams, prompts, 9, "paged", "int4", None)
        got, eng = _torch_streams(name, tparams, prompts, 9, "paged", "int4",
                                  None)
        _same_streams(want, got)
        _check_engine(eng, "int4", "paged")
        assert eng.cache.kv_bits == 4


@pytest.mark.parametrize("knob,layout,mixed", [
    (None, "auto", True), ("1", "paged", True), ("0", "auto", False),
    ("0", "paged", False), (None, "slot", False), ("1", "slot", False)])
def test_mixed_step_knob_resolution(knob, layout, mixed, monkeypatch):
    if knob is None:
        monkeypatch.delenv("ARKS_MIXED_STEP", raising=False)
    else:
        monkeypatch.setenv("ARKS_MIXED_STEP", knob)
    eng = InferenceEngine(get_config("tiny"), EngineConfig(
        model="tiny", kv_layout=layout, **ENGINE_KW), ByteTokenizer(),
        device="cpu")
    assert eng._mixed == mixed and eng._paged == (layout != "slot")
    assert eng._park_sentinel() == 64
    monkeypatch.setenv("ARKS_MIXED_STEP", "yes")
    with pytest.raises(ValueError, match="ARKS_MIXED_STEP"):
        engine_mod.mixed_step_knob()


def test_resolve_buckets_matches_jax():
    for buckets, max_len, chunk in (((32, 64, 128), 64, 16),
                                    ((128, 256), 64, 16), ((8, 16), 64, None),
                                    ((32, 64, 128, 256, 512, 1024), 4096, 256)):
        kw = dict(prefill_buckets=buckets, max_cache_len=max_len,
                  prefill_chunk=chunk)
        assert EngineConfig(**kw).resolve_buckets() == \
            JaxEngineConfig(**kw).resolve_buckets()


# ---------------------------------------------------------------------------
# The server with --kv-layout slot
# ---------------------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port, body, stream=False):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/completions", json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    if not stream:
        data = json.loads(resp.read())
        conn.close()
        return resp.status, data
    frames = []
    for raw in resp:
        line = raw.decode().strip()
        if line == "data: [DONE]":
            break
        if line.startswith("data: "):
            frames.append(json.loads(line[6:]))
    conn.close()
    return resp.status, frames


def test_server_kv_layout_slot_on_cpu():
    """``python -m arks_tpu_torch.server --kv-layout slot --device cpu``:
    a completion and an SSE stream give the greedy text of an in-process
    slot-layout engine on the same seed."""
    port = _free_port()
    cmd = [sys.executable, "-m", "arks_tpu_torch.server", "--model", "tiny",
           "--device", "cpu", "--port", str(port), "--host", "127.0.0.1",
           "--num-slots", "2", "--max-model-len", "64", "--dtype", "float32",
           "--kv-layout", "slot", "--seed", "3"]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.Popen(cmd, env=env, cwd=str(REPO),
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        prompt = "slot layout"
        eng = InferenceEngine(get_config("tiny"), EngineConfig(
            model="tiny", num_slots=2, max_cache_len=64, dtype="float32",
            kv_layout="slot", seed=3), ByteTokenizer(), device="cpu")
        req = Request("r", ByteTokenizer().encode(prompt), SamplingParams(
            max_tokens=10, temperature=0.0, ignore_eos=True))
        eng.add_request(req)
        _drive(eng, lambda e: not e.idle)
        want = ByteTokenizer().decode(_collect(req.outputs)[0])
        body = {"prompt": prompt, "max_tokens": 10, "temperature": 0,
                "ignore_eos": True}
        deadline = time.monotonic() + 120
        while True:
            try:
                st, data = _post(port, body)
                break
            except OSError:
                if time.monotonic() > deadline or proc.poll() is not None:
                    raise
                time.sleep(0.5)
        assert st == 200 and data["choices"][0]["text"] == want
        assert data["choices"][0]["finish_reason"] == "length"
        st, frames = _post(port, dict(body, stream=True), stream=True)
        assert st == 200
        assert "".join(f["choices"][0]["text"] for f in frames
                       if f["choices"]) == want
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)

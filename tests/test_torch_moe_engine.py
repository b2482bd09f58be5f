"""MoE models end to end on the CPU, the port against the reference on the
same weights: ``mixed_step`` on ``tiny-moe`` and ``tiny-mixtral`` in f32
with unquantized, int8 and int4 weights, over a flat batch of at least 64
tokens (the grouped dispatch, both ``ARKS_MOE_KERNEL`` routes) and one
below it (dense), logits within atol 1e-4 with the same argmax; the
legacy scheduler's prefill and ``decode_step`` on MoE weights; the
engines' greedy streams identical with unquantized and int8 weights on
both routes; and ``--weight-dtype`` through the server."""

import os
import signal
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
from arks_tpu.models import quant as jquant
from arks_tpu.models import transformer as jtf
from arks_tpu_torch.engine import EngineConfig, InferenceEngine, Request, \
    SamplingParams
from arks_tpu_torch.engine.tokenizer import ByteTokenizer
from arks_tpu_torch.models import get_config
from arks_tpu_torch.models import moe as tmoe
from arks_tpu_torch.models import transformer as ttf
from arks_tpu_torch.models.weights import params_from_numpy

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
PAGE, MAX_PAGES = 16, 6
_KEYS = ("tokens", "token_slot", "token_pos", "sample_src", "seq_q_start",
         "seq_q_len", "seq_pos_start")


def _params(name, bits, key=1):
    jparams = jtf.init_params(jax_get_config(name), jax.random.PRNGKey(key),
                              jnp.float32)
    if bits:
        jparams = jquant.quantize_params(jparams, bits=bits)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      get_config(name), "cpu")


def _batches(vocab, n_chunk):
    """Two mixed batches over 3 lanes: lane 0 prefills an ``n_chunk``-token
    prompt (completes, crosses pages), lane 1 the first 5 of 12; then
    lane 0 decodes, lane 1 completes, lane 2 starts 9 tokens; 2 padding
    tokens.  Flat sizes n_chunk + 5 and 25."""
    rng = np.random.default_rng(3)
    p0 = rng.integers(2, vocab, n_chunk)
    p1 = rng.integers(2, vocab, 12)
    p2 = rng.integers(2, vocab, 9)
    out = []
    for lanes, pad in (([(0, p0, 0, True), (1, p1[:5], 0, False)], 0),
                       ([(0, np.array([7]), n_chunk, True),
                         (1, p1[5:], 5, True), (2, p2, 0, False)], 2)):
        a = {k: [] for k in ("tokens", "token_slot", "token_pos")}
        lane_v = {k: np.zeros(3, np.int32) for k in
                  ("sample_src", "seq_q_start", "seq_q_len", "seq_pos_start")}
        for lane, ids, start, samples in lanes:
            lane_v["seq_q_start"][lane] = len(a["tokens"])
            lane_v["seq_q_len"][lane] = len(ids)
            lane_v["seq_pos_start"][lane] = start
            a["tokens"] += [int(x) for x in ids]
            a["token_slot"] += [lane] * len(ids)
            a["token_pos"] += range(start, start + len(ids))
            if samples:
                lane_v["sample_src"][lane] = len(a["tokens"]) - 1
        a["tokens"] += [0] * pad
        a["token_slot"] += [-1] * pad
        a["token_pos"] += [MAX_PAGES * PAGE] * pad
        out.append({**{k: np.asarray(v, np.int32) for k, v in a.items()},
                    **lane_v})
    return out


@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("route", ["dense", "xla", "pallas"])
@pytest.mark.parametrize("name", ["tiny-moe", "tiny-mixtral"])
def test_mixed_step_matches_jax(name, route, bits, monkeypatch):
    """dense: flat batches of 25 and 25 tokens; xla / pallas: a first
    batch of 70 tokens (grouped on both sides), then 25 (dense)."""
    n_chunk = 20 if route == "dense" else 65
    if route != "dense":
        monkeypatch.setenv("ARKS_MOE_KERNEL", route)
    jparams, tparams = _params(name, bits)
    jcfg, tcfg = jax_get_config(name), get_config(name)
    n_pages = 3 * MAX_PAGES
    tables = np.random.default_rng(9).permutation(n_pages).reshape(
        3, MAX_PAGES).astype(np.int32)
    jcache = jtf.init_paged_cache(jcfg, n_pages, PAGE, jnp.float32)
    tcache = ttf.init_paged_cache(tcfg, n_pages, PAGE, "float32", "cpu")
    grouped = []
    real = tmoe.moe_ffn_grouped

    def spy(*a, **kw):
        grouped.append(True)
        return real(*a, **kw)
    monkeypatch.setattr(tmoe, "moe_ffn_grouped", spy)
    for i, batch in enumerate(_batches(jcfg.vocab_size, n_chunk)):
        n_grouped = len(grouped)
        want, jcache = jtf.mixed_step(jparams, jcfg, jcache,
                                      jnp.asarray(tables),
                                      *(jnp.asarray(batch[k]) for k in _KEYS))
        got = ttf.mixed_step(tparams, tcfg, tcache, torch.from_numpy(tables),
                             *(torch.from_numpy(batch[k]) for k in _KEYS))
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
        np.testing.assert_array_equal(got.numpy().argmax(-1),
                                      want.argmax(-1))
        t_flat = batch["tokens"].shape[0]
        assert (len(grouped) > n_grouped) == (t_flat >= 64), (i, t_flat)


@pytest.mark.parametrize("bits", [0, 8])
@pytest.mark.parametrize("name", ["tiny-moe", "tiny-mixtral"])
def test_legacy_paths_match_jax(name, bits):
    """The legacy scheduler's model calls inherit MoE: a one-shot prefill
    of [2, 40] (80 tokens: grouped), its K/V inserted into a slot cache,
    then three decode_steps (dense) — logits within atol 1e-4 of the
    reference's, with the same argmax."""
    jparams, tparams = _params(name, bits, key=5)
    jcfg, tcfg = jax_get_config(name), get_config(name)
    rng = np.random.default_rng(4)
    tokens = rng.integers(2, jcfg.vocab_size, (2, 40)).astype(np.int32)
    lengths = np.array([40, 33], np.int32)

    def check(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
        np.testing.assert_array_equal(got.numpy().argmax(-1),
                                      want.argmax(-1))
        return want.argmax(-1).astype(np.int32)

    want, jk, jv = jtf.prefill(jparams, jcfg, jnp.asarray(tokens),
                               jnp.asarray(lengths))
    got, tk, tv = ttf.prefill(tparams, tcfg, torch.from_numpy(tokens),
                              torch.from_numpy(lengths))
    nxt = check(got, want)
    jcache = jtf.insert_batch(jtf.init_cache(jcfg, 2, 64, jnp.float32), jk,
                              jv, jnp.asarray([0, 1], jnp.int32))
    tcache = ttf.insert_batch(ttf.init_cache(tcfg, 2, 64, "float32", "cpu"),
                              tk, tv, [0, 1])
    for _ in range(3):
        want, jcache = jtf.decode_step(jparams, jcfg, jcache,
                                       jnp.asarray(nxt), jnp.asarray(lengths))
        got = ttf.decode_step(tparams, tcfg, tcache, torch.from_numpy(nxt),
                              torch.from_numpy(lengths))
        nxt = check(got, want)
        lengths = lengths + 1


# ---------------------------------------------------------------------------
# Engines: greedy streams
# ---------------------------------------------------------------------------

# num_slots + chunk = 66 >= 64: every mixed step groups on both engines.
ENGINE_KW = dict(num_slots=2, max_cache_len=192, steps_per_dispatch=4,
                 prefill_chunk=64, dtype="float32")


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [[int(x) for x in rng.integers(2, vocab, n)]
            for n in (3, 70, 20, 130)]


def _collect(outputs, timeout=120):
    ids = []
    while True:
        out = outputs.get(timeout=timeout)
        ids.extend(out.token_ids)
        if out.finished:
            return ids, out.finish_reason


def _drive(engine, busy, n_steps=500):
    for _ in range(n_steps):
        engine.step(block_s=0.01)
        if not busy(engine):
            return
    raise AssertionError("engine did not drain")


def _jax_streams(name, params, prompts, max_tokens, monkeypatch, **kw):
    monkeypatch.setenv("ARKS_MIXED_STEP", "1")
    eng = JaxEngine(jax_get_config(name), JaxEngineConfig(
        model=name, prefill_buckets=(16, 32), kv_layout="paged",
        **ENGINE_KW, **kw), JaxByteTokenizer(), params=params)
    assert eng._mixed and eng._paged
    reqs = [JaxRequest(f"r{i}", p, JaxSamplingParams(
        max_tokens=max_tokens, temperature=0.0, ignore_eos=True))
        for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    _drive(eng, lambda e: e.num_running or not e._queue.empty()
           or e._prefilling)
    return [_collect(r.outputs) for r in reqs]


def _torch_streams(name, params, prompts, max_tokens, **kw):
    eng = InferenceEngine(get_config(name), EngineConfig(
        model=name, **ENGINE_KW, **kw), ByteTokenizer(), params=params,
        device="cpu")
    reqs = [Request(f"r{i}", p, SamplingParams(
        max_tokens=max_tokens, temperature=0.0, ignore_eos=True))
        for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    _drive(eng, lambda e: not e.idle)
    return [_collect(r.outputs) for r in reqs], eng


@pytest.mark.parametrize("weight_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("route", ["xla", "pallas"])
@pytest.mark.parametrize("name", ["tiny-moe", "tiny-mixtral"])
def test_greedy_streams_match_jax_engine(name, route, weight_dtype,
                                         monkeypatch):
    """Unquantized f32 weights ("bf16" = no quantization), or int8 weights
    quantized from them by each engine on load."""
    monkeypatch.setenv("ARKS_MOE_KERNEL", route)
    jparams, tparams = _params(name, 0, key=3)
    prompts = _prompts(jax_get_config(name).vocab_size)
    want = _jax_streams(name, jparams, prompts, 6, monkeypatch,
                        weight_dtype=weight_dtype)
    got, eng = _torch_streams(name, tparams, prompts, 6,
                              weight_dtype=weight_dtype)
    assert eng._moe_grouped
    assert (weight_dtype == "int8") == isinstance(
        eng.params["layers"]["w_gate"], dict)
    assert got == want


def test_quantized_random_init_serves(monkeypatch):
    """A random int4 Mixtral-shaped engine (no params given) draws its
    weights quantized and serves a greedy request twice identically."""
    monkeypatch.setenv("ARKS_MOE_KERNEL", "pallas")
    prompt = list(range(2, 80))
    outs = []
    for _ in range(2):
        got, eng = _torch_streams("tiny-mixtral", None, [prompt], 5,
                                  weight_dtype="int4")
        outs.append(got[0])
    assert eng.params["layers"]["w_up"]["q"].shape[-2] * 2 == \
        get_config("tiny-mixtral").hidden_size
    assert "gs" in eng.params["layers"]["wq"] and \
        "s" in eng.params["embed"]
    assert outs[0] == outs[1] and outs[0][1] == "length"


# ---------------------------------------------------------------------------
# The server's --weight-dtype
# ---------------------------------------------------------------------------


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port, body):
    import http.client
    import json
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/completions", json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    return resp.status, data


def test_server_weight_dtype_int8_on_cpu():
    """``python -m arks_tpu_torch.server --model tiny-mixtral
    --weight-dtype int8 --device cpu``: a completion gives the greedy text
    of an in-process engine with int8 weights on the same seed."""
    port = _free_port()
    cmd = [sys.executable, "-m", "arks_tpu_torch.server", "--model",
           "tiny-mixtral", "--device", "cpu", "--port", str(port),
           "--host", "127.0.0.1", "--num-slots", "2", "--max-model-len",
           "64", "--dtype", "float32", "--weight-dtype", "int8", "--seed",
           "3"]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.Popen(cmd, env=env, cwd=str(REPO),
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        prompt = "experts in int8"
        eng = InferenceEngine(get_config("tiny-mixtral"), EngineConfig(
            model="tiny-mixtral", num_slots=2, max_cache_len=64,
            dtype="float32", weight_dtype="int8", seed=3), ByteTokenizer(),
            device="cpu")
        assert "s" in eng.params["layers"]["w_down"]
        req = Request("r", ByteTokenizer().encode(prompt), SamplingParams(
            max_tokens=8, temperature=0.0, ignore_eos=True))
        eng.add_request(req)
        _drive(eng, lambda e: not e.idle)
        want = ByteTokenizer().decode(_collect(req.outputs)[0])
        body = {"prompt": prompt, "max_tokens": 8, "temperature": 0,
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
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)

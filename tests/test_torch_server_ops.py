"""The server an operator runs, on CPU ``tiny`` over HTTP: ``/metrics``
counts what was served, ``/readiness`` answers 200 with its admission block
and 503 while draining, ``drain()`` lets an in-flight stream finish whole
while new completions get 503, the tenant and tier headers reach the fair
queue, a full queue answers 429 (the tenant's bound) and 503 (the global
bound) with ``Retry-After``, and ``python -m arks_tpu_torch.server
--model-path DIR`` serves a checkpoint and drains on SIGTERM."""

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from arks_tpu_torch.engine import EngineConfig, InferenceEngine
from arks_tpu_torch.engine.tokenizer import ByteTokenizer
from arks_tpu_torch.engine.types import Request, SamplingParams
from arks_tpu_torch.models import get_config
from arks_tpu_torch.server import OpenAIServer

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
KW = dict(num_slots=2, max_cache_len=64, steps_per_dispatch=4,
          prefill_chunk=16, dtype="float32")


def _request(port, method, path, body=None, headers=None, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    data = None if body is None else json.dumps(body)
    conn.request(method, path, body=data,
                 headers=dict({"Content-Type": "application/json"},
                              **(headers or {})))
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    text = raw.decode()
    ctype = resp.getheader("Content-Type") or ""
    payload = json.loads(text) if ctype.startswith("application/json") \
        else text
    return resp.status, payload, dict(resp.getheaders())


def _stream(port, body, frames, done, headers=None):
    """POST a streaming completion, appending each SSE frame as it comes."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/completions",
                 body=json.dumps(dict(body, stream=True, stream_options={
                     "include_usage": True})),
                 headers=dict({"Content-Type": "application/json"},
                              **(headers or {})))
    resp = conn.getresponse()
    frames.append(resp.status)
    for line in resp:
        line = line.decode().strip()
        if line.startswith("data: ") and line != "data: [DONE]":
            frames.append(json.loads(line[6:]))
    conn.close()
    done.set()


def _server(monkeypatch, start_engine=True, **env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    eng = InferenceEngine(get_config("tiny"), EngineConfig(model="tiny",
                                                           **KW),
                          ByteTokenizer(), device="cpu")
    srv = OpenAIServer(eng, "tiny", host="127.0.0.1", port=0)
    srv.start(background=True)
    if start_engine:
        eng.start()
    return eng, srv


def _wait_ready(port, timeout=60):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st, body, _ = _request(port, "GET", "/readiness")
        if st == 200:
            return body
        time.sleep(0.05)
    raise AssertionError(f"not ready: {st} {body}")


def _metric(text: str, key: str) -> float:
    for line in text.splitlines():
        if line.startswith(key + " "):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


BODY = {"prompt": "operability", "max_tokens": 6, "temperature": 0,
        "ignore_eos": True}


def _assert_whole(frames, max_tokens):
    """A stream that ended normally: 200, a "length" finish and the usage
    frame's count of every token asked for."""
    assert frames[0] == 200
    assert frames[-2]["choices"][0]["finish_reason"] == "length"
    assert frames[-1]["usage"]["completion_tokens"] == max_tokens


def test_metrics_and_readiness(monkeypatch):
    """After N requests ``/metrics`` counts N successes and the generated
    tokens (the reference's rule: every sampled token after the first, the
    first being the TTFT sample), and ``/readiness`` answers its
    admission and SLO-burn blocks."""
    eng, srv = _server(monkeypatch)
    try:
        ready = _wait_ready(srv.port)
        assert ready["status"] == "ready"
        assert ready["admission"]["fair"] is True
        assert ready["admission"]["queue_depth"] == 0
        assert ready["slo_burn"] == {}
        n, streamed = 3, 0
        for i in range(n):
            st, data, _ = _request(srv.port, "POST", "/v1/completions",
                                   dict(BODY, max_tokens=4 + i))
            assert st == 200
            streamed += data["usage"]["completion_tokens"]
        st, text, hdrs = _request(srv.port, "GET", "/metrics")
        assert st == 200 and hdrs["Content-Type"] == \
            "text/plain; version=0.0.4"
        assert _metric(text, 'request_success_total{reason="length"}') == n
        assert _metric(text, "generation_tokens_total") == streamed - n
        assert _metric(text, "time_to_first_token_seconds_count") == n
        assert _metric(text, 'ttft_seconds_count{tier="default"}') == n
        assert 'engine_config_info{' in text and \
            'decode_impl="plain"' in text
        assert "spec_decode" not in text and "engine_faults" not in text
    finally:
        srv.stop()
        eng.stop()


def test_drain_finishes_streams_and_refuses_new_work(monkeypatch):
    """``drain()`` with a stream in flight (the engine held meanwhile, so
    it stays in flight): readiness turns 503, a new completion gets 503
    "server is draining", and the drain waits; once the engine runs, the
    stream finishes with all its tokens and the server stops."""
    eng, srv = _server(monkeypatch)
    try:
        _wait_ready(srv.port)
        eng.stop()
        frames, done = [], threading.Event()
        body = dict(BODY, max_tokens=40)
        t = threading.Thread(target=_stream, args=(srv.port, body, frames,
                                                   done))
        t.start()
        deadline = time.monotonic() + 60
        while eng._queue.qsize() < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        drainer = threading.Thread(target=srv.drain, args=(60.0,))
        drainer.start()
        while not srv.draining:
            time.sleep(0.001)
        st, body_503, _ = _request(srv.port, "GET", "/readiness")
        assert st == 503 and body_503["error"]["message"] == "draining"
        st, err, _ = _request(srv.port, "POST", "/v1/completions", BODY)
        assert st == 503 and "draining" in err["error"]["message"]
        time.sleep(0.3)
        assert drainer.is_alive() and not done.is_set()
        eng.start()
        assert done.wait(60)
        drainer.join(60)
        assert not drainer.is_alive()
        _assert_whole(frames, 40)
        with pytest.raises(OSError):
            _request(srv.port, "GET", "/health", timeout=5)
    finally:
        srv.stop()
        eng.stop()


def test_queue_bounds_tenant_and_tier_headers(monkeypatch):
    """With the engine held, a two-tenant flood over ``ARKS_QUEUE_MAX=3``
    / ``ARKS_QUEUE_TENANT_MAX=2``: the tenant's third request gets 429
    (``tenant_queue_full``, Retry-After, the tenant echoed), a third
    tenant past the global bound 503 (``queue_full``); an unknown tier is
    a 400.  Once the engine runs, every queued request completes and the
    tier's TTFT lands under its name."""
    eng, srv = _server(monkeypatch, start_engine=False,
                       ARKS_QUEUE_MAX="3", ARKS_QUEUE_TENANT_MAX="2",
                       ARKS_SLO_TIERS="latency:ttft_ms=60000,batch:")
    results: list = []

    def post(headers):
        results.append(_request(srv.port, "POST", "/v1/completions", BODY,
                                headers))

    threads = []

    def queue_one(tenant):
        th = threading.Thread(target=post, args=(
            {"x-arks-tenant": tenant, "x-arks-tier": "latency"},))
        th.start()
        threads.append(th)
        deadline = time.monotonic() + 30
        while eng._queue.qsize() < len(threads) and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng._queue.qsize() == len(threads)

    try:
        queue_one("ns/a")
        queue_one("ns/a")
        st, err, hdrs = _request(srv.port, "POST", "/v1/completions", BODY,
                                 {"x-arks-tenant": "ns/a"})
        assert st == 429 and err["error"]["code"] == "tenant_queue_full"
        assert int(hdrs["Retry-After"]) >= 1
        assert hdrs["x-arks-tenant"] == "ns/a"
        queue_one("ns/b")
        assert eng.saturation()["saturation"] == 1.0
        st, err, hdrs = _request(srv.port, "POST", "/v1/completions", BODY,
                                 {"x-arks-tenant": "ns/c"})
        assert st == 503 and err["error"]["code"] == "queue_full"
        assert int(hdrs["Retry-After"]) >= 1
        assert hdrs["x-arks-saturation"] == "1.00"
        st, err, _ = _request(srv.port, "POST", "/v1/completions", BODY,
                              {"x-arks-tier": "gold"})
        assert st == 400 and "unknown SLO tier" in err["error"]["message"]
        eng.start()
        for th in threads:
            th.join(120)
        assert sorted(r[0] for r in results) == [200, 200, 200]
        st, text, _ = _request(srv.port, "GET", "/metrics")
        assert _metric(text, 'requests_shed_total{reason="tenant_cap",'
                             'tenant="ns/a",tier="latency"}') == 1
        assert _metric(text, 'requests_shed_total{reason="queue_full",'
                             'tenant="ns/c",tier="latency"}') == 1
        assert _metric(text, 'ttft_seconds_count{tier="latency"}') == 3
    finally:
        srv.stop()
        eng.stop()


def test_negative_priority_gets_no_admission(monkeypatch):
    """A body ``priority`` below 0 (the fair queue's urgent lane, past its
    bounds) is a 400, on a full queue as on an empty one, and
    ``add_request`` refuses it too: the full queue's depth is unchanged."""
    eng, srv = _server(monkeypatch, start_engine=False,
                       ARKS_QUEUE_MAX="1")
    try:
        st, err, _ = _request(srv.port, "POST", "/v1/completions",
                              dict(BODY, priority=-1))
        assert st == 400 and "priority" in err["error"]["message"]
        assert eng._queue.qsize() == 0
        eng.add_request(Request("held", [1, 2, 3],
                                SamplingParams(max_tokens=2)))
        assert eng._queue.qsize() == 1
        st, err, _ = _request(srv.port, "POST", "/v1/completions",
                              dict(BODY, priority=-5))
        assert st == 400 and "priority" in err["error"]["message"]
        with pytest.raises(ValueError, match="priority"):
            eng.add_request(Request("urgent", [1, 2, 3],
                                    SamplingParams(max_tokens=2,
                                                   priority=-1)))
        assert eng._queue.qsize() == 1
        st, err, _ = _request(srv.port, "POST", "/v1/completions", BODY)
        assert st == 503 and err["error"]["code"] == "queue_full"
    finally:
        srv.stop()
        eng.stop()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_serves_a_checkpoint_and_drains_on_sigterm(tmp_path):
    """``--model tiny --model-path DIR`` loads the checkpoint (int8 on
    load); SIGTERM with a stream in flight: the stream finishes, readiness
    and new completions get 503, and the process exits 0."""
    cfg = get_config("tiny")
    rng = np.random.default_rng(0)
    shapes = {"model.embed_tokens.weight": (cfg.vocab_size, cfg.hidden_size),
              "model.norm.weight": (cfg.hidden_size,),
              "lm_head.weight": (cfg.vocab_size, cfg.hidden_size)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        shapes.update({
            p + "input_layernorm.weight": (cfg.hidden_size,),
            p + "post_attention_layernorm.weight": (cfg.hidden_size,),
            p + "self_attn.q_proj.weight": (cfg.q_dim, cfg.hidden_size),
            p + "self_attn.k_proj.weight": (cfg.kv_dim, cfg.hidden_size),
            p + "self_attn.v_proj.weight": (cfg.kv_dim, cfg.hidden_size),
            p + "self_attn.o_proj.weight": (cfg.hidden_size, cfg.q_dim),
            p + "self_attn.q_proj.bias": (cfg.q_dim,),
            p + "self_attn.k_proj.bias": (cfg.kv_dim,),
            p + "self_attn.v_proj.bias": (cfg.kv_dim,),
            p + "mlp.gate_proj.weight": (cfg.intermediate_size,
                                         cfg.hidden_size),
            p + "mlp.up_proj.weight": (cfg.intermediate_size,
                                       cfg.hidden_size),
            p + "mlp.down_proj.weight": (cfg.hidden_size,
                                         cfg.intermediate_size)})
    save_file({k: (rng.standard_normal(s) * 0.05).astype(np.float32)
               for k, s in shapes.items()},
              str(tmp_path / "model.safetensors"))
    # A tokenizer directory without assets: the byte-level tokenizer (the
    # checkpoint's own directory has none, which is refused).
    (tmp_path / "tok").mkdir()
    port = _free_port()
    cmd = [sys.executable, "-m", "arks_tpu_torch.server", "--model", "tiny",
           "--model-path", str(tmp_path), "--tokenizer-path",
           str(tmp_path / "tok"),
           "--device", "cpu", "--port", str(port), "--host", "127.0.0.1",
           "--num-slots", "2", "--max-model-len", "256", "--dtype",
           "float32", "--weight-dtype", "int8", "--drain-timeout", "60"]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.Popen(cmd, env=env, cwd=str(REPO),
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                if _request(port, "GET", "/readiness", timeout=5)[0] == 200:
                    break
            except OSError:
                pass
            if time.monotonic() > deadline or proc.poll() is not None:
                raise AssertionError(proc.stderr.read().decode()[-2000:])
            time.sleep(0.2)
        frames, done = [], threading.Event()
        th = threading.Thread(target=_stream, args=(
            port, dict(BODY, max_tokens=160), frames, done))
        th.start()
        while len(frames) < 2 and not done.is_set():
            time.sleep(0.01)
        proc.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + 30
        while _request(port, "GET", "/readiness")[0] != 503:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        st, err, _ = _request(port, "POST", "/v1/completions", BODY)
        assert st == 503 and "draining" in err["error"]["message"]
        assert done.wait(60)
        _assert_whole(frames, 160)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)

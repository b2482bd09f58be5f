"""The port's OpenAI server on ``tiny`` (device="cpu"): an HTTP completion,
an SSE stream and a chat completion return the text of the JAX engine's
greedy stream on the same weights; stop strings cut the text; the sampling
fields the port once refused (logprobs, penalties, logit_bias, n, min_tokens,
guides, echo, batched prompts) are answered as the reference server answers
them on the same weights, and bad bodies get the reference's 400s."""

import http.client
import json

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
from arks_tpu.server import OpenAIServer as JaxOpenAIServer
from arks_tpu_torch.engine import EngineConfig, InferenceEngine
from arks_tpu_torch.engine.tokenizer import ByteTokenizer
from arks_tpu_torch.models import get_config
from arks_tpu_torch.models.weights import params_from_numpy
from arks_tpu_torch.server import OpenAIServer

torch.set_num_threads(2)

NAME = "tiny"
ENGINE_KW = dict(num_slots=2, max_cache_len=64, steps_per_dispatch=4,
                 prefill_chunk=16, dtype="float32")
PROMPT = "The port serves a paged pool, chunk by chunk."   # 46 tokens
MAX_TOKENS = 12


@pytest.fixture(scope="module")
def jparams():
    return jtf.init_params(jax_get_config(NAME), jax.random.PRNGKey(5),
                           jnp.float32)


@pytest.fixture(scope="module")
def reference(jparams):
    """The JAX engine's greedy ids for the completion and the chat prompt."""
    mp = pytest.MonkeyPatch()
    mp.setenv("ARKS_MIXED_STEP", "1")
    try:
        eng = JaxEngine(jax_get_config(NAME), JaxEngineConfig(
            model=NAME, prefill_buckets=(8, 16, 32), kv_layout="paged",
            **ENGINE_KW), JaxByteTokenizer(), params=jparams)
        tok = JaxByteTokenizer()
        prompts = {"completion": tok.encode(PROMPT),
                   "chat": tok.apply_chat_template(
                       [{"role": "user", "content": "hi there"}])}
        reqs = {k: JaxRequest(k, ids, JaxSamplingParams(
            max_tokens=MAX_TOKENS, temperature=0.0))
            for k, ids in prompts.items()}
        for r in reqs.values():
            eng.add_request(r)
        for _ in range(500):
            eng.step(block_s=0.01)
            if not (eng.num_running or not eng._queue.empty()
                    or eng._prefilling):
                break
        out = {}
        for k, r in reqs.items():
            ids = []
            while True:
                o = r.outputs.get(timeout=60)
                ids += o.token_ids
                if o.finished:
                    break
            out[k] = (ids, o.finish_reason, o.num_prompt_tokens)
        return out
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def server(jparams):
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               get_config(NAME), "cpu")
    eng = InferenceEngine(get_config(NAME), EngineConfig(model=NAME,
                                                         **ENGINE_KW),
                          ByteTokenizer(), params=params, device="cpu")
    srv = OpenAIServer(eng, NAME, host="127.0.0.1", port=0)
    srv.start(background=True)
    eng.start()
    yield srv
    srv.stop()
    eng.stop()


def _post(srv, path, body, stream=False):
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=120)
    conn.request("POST", path, json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    if not stream or resp.status != 200:
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


def _get(srv, path):
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    return resp.status, data


def _text(ids):
    return ByteTokenizer().decode(ids)


def test_completion_matches_jax_greedy_stream(server, reference):
    ids, finish, n_prompt = reference["completion"]
    st, data = _post(server, "/v1/completions", {
        "prompt": PROMPT, "max_tokens": MAX_TOKENS, "temperature": 0})
    assert st == 200
    assert data["choices"][0]["text"] == _text(ids)
    assert data["choices"][0]["finish_reason"] == finish
    assert data["usage"] == {"prompt_tokens": n_prompt,
                             "completion_tokens": len(ids),
                             "total_tokens": n_prompt + len(ids)}


def test_sse_stream_matches_jax_greedy_stream(server, reference):
    ids, finish, n_prompt = reference["completion"]
    st, frames = _post(server, "/v1/completions", {
        "prompt": PROMPT, "max_tokens": MAX_TOKENS, "temperature": 0,
        "stream": True, "stream_options": {"include_usage": True}},
        stream=True)
    assert st == 200
    text = "".join(f["choices"][0]["text"] for f in frames if f["choices"])
    assert text == _text(ids)
    assert [f["choices"][0]["finish_reason"] for f in frames
            if f["choices"] and f["choices"][0]["finish_reason"]] == [finish]
    assert frames[-1]["choices"] == []
    assert frames[-1]["usage"]["completion_tokens"] == len(ids)


def test_chat_matches_jax_greedy_stream(server, reference):
    ids, finish, n_prompt = reference["chat"]
    st, data = _post(server, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hi there"}],
        "max_tokens": MAX_TOKENS, "temperature": 0})
    assert st == 200
    msg = data["choices"][0]["message"]
    assert msg == {"role": "assistant", "content": _text(ids)}
    assert data["usage"]["prompt_tokens"] == n_prompt
    st, frames = _post(server, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hi there"}],
        "max_tokens": MAX_TOKENS, "temperature": 0, "stream": True},
        stream=True)
    assert frames[0]["choices"][0]["delta"] == {"role": "assistant"}
    assert "".join(f["choices"][0]["delta"].get("content", "")
                   for f in frames) == _text(ids)


@pytest.mark.parametrize("stream", [False, True])
def test_stop_string_cuts_the_text(server, reference, stream):
    full = _text(reference["completion"][0])
    stop = full[3:5]
    want = full[:full.find(stop)]
    body = {"prompt": PROMPT, "max_tokens": MAX_TOKENS, "temperature": 0,
            "stop": [stop], "stream": stream}
    st, data = _post(server, "/v1/completions", body, stream=stream)
    assert st == 200
    if stream:
        text = "".join(f["choices"][0]["text"] for f in data)
        finish = data[-1]["choices"][0]["finish_reason"]
    else:
        text = data["choices"][0]["text"]
        finish = data["choices"][0]["finish_reason"]
    assert (text, finish) == (want, "stop")


@pytest.fixture(scope="module")
def ref_server(jparams):
    """The reference's server on the JAX engine, same weights and
    scheduler."""
    mp = pytest.MonkeyPatch()
    mp.setenv("ARKS_MIXED_STEP", "1")
    eng = JaxEngine(jax_get_config(NAME), JaxEngineConfig(
        model=NAME, prefill_buckets=(8, 16, 32), kv_layout="paged",
        **ENGINE_KW), JaxByteTokenizer(), params=jparams)
    srv = JaxOpenAIServer(eng, NAME, host="127.0.0.1", port=0)
    srv.start(background=True)
    eng.start()
    yield srv
    srv.stop()
    eng.stop()
    mp.undo()


def _norm(x):
    """A payload less its ids and timestamps."""
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()
                if k not in ("id", "created")}
    if isinstance(x, list):
        return [_norm(v) for v in x]
    return x


def _close(got, want):
    """Equal, with logprob values (the payloads' only floats) within
    1e-5."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for k in want:
            _close(got[k], want[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
    elif isinstance(want, float):
        assert abs(got - want) <= 1e-5, (got, want)
    else:
        assert got == want


@pytest.mark.parametrize("extra", [
    {"logprobs": 2}, {"logprobs": 0}, {"presence_penalty": 0.5},
    {"logit_bias": {"5": 10}}, {"n": 2}, {"min_tokens": 3},
    {"response_format": {"type": "json_object"}}, {"echo": True},
    {"prompt": ["a", "b"]},
])
def test_served_like_the_reference(server, ref_server, extra):
    """Fields the port answered with 400 before it served them: the same
    status and payload as the reference server's (seeded sampling)."""
    body = {"prompt": PROMPT, "max_tokens": 4, "temperature": 0.8,
            "seed": 5, **extra}
    st, data = _post(server, "/v1/completions", body)
    want_st, want = _post(ref_server, "/v1/completions", body)
    assert st == want_st == 200
    _close(_norm(data), _norm(want))


@pytest.mark.parametrize("path,extra", [
    ("/v1/completions", {"prompt": "x" * 80}),
    ("/v1/completions", {"echo": True, "stream": True}),
    ("/v1/chat/completions", {"echo": True}),
    ("/v1/completions", {"logit_bias": {str(i): 1 for i in range(301)}}),
    ("/v1/completions", {"logit_bias": {"512": 1}}),
    ("/v1/completions", {"guided_choice": []}),
    ("/v1/completions", {"response_format": {"type": "yaml"}}),
    ("/v1/chat/completions", {
        "tools": [{"type": "function", "function": {"name": "f"}}],
        "tool_choice": "required",
        "response_format": {"type": "json_object"}}),
    ("/v1/completions", {"n": 17}),
])
def test_unserved_or_bad_fields_are_400(server, ref_server, path, extra):
    """Bad bodies: the reference server's 400 and payload."""
    body = {"max_tokens": 4, **extra}
    if path == "/v1/completions":
        body.setdefault("prompt", PROMPT)
    else:
        body["messages"] = [{"role": "user", "content": "hi"}]
    st, data = _post(server, path, body)
    want_st, want = _post(ref_server, path, body)
    assert st == want_st == 400 and data["error"]["message"]
    assert data == want


def test_models_and_health(server):
    assert _get(server, "/v1/models") == (200, {"object": "list", "data": [{
        "id": NAME, "object": "model", "created": 0, "owned_by": "arks"}]})
    assert _get(server, "/health") == (200, {"status": "ok"})
    assert _get(server, "/nope")[0] == 404

"""The port's OpenAI server against the reference's (``arks_tpu/server/
openai_server.py`` on the JAX engine), on the same f32 ``tiny`` weights:
the same body gets the same status and payload from both — ids,
timestamps and tool-call ids aside, logprob values within 1e-5 — for
completions and chat, streamed and not: logprobs (chosen and top-N),
``n`` 2 with child seeds, batched prompts, echo, penalties, logit_bias,
min_tokens under a stop string, every guide kind, tools rendered into the
prompt and a forced tool call; and the reference's own 400s."""

import http.client
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arks_tpu.engine import EngineConfig as JaxEngineConfig
from arks_tpu.engine import InferenceEngine as JaxEngine
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
ENGINE_KW = dict(num_slots=3, max_cache_len=512, steps_per_dispatch=4,
                 prefill_chunk=64, dtype="float32")
TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "Weather of a city",
    "parameters": {"type": "object", "properties": {
        "city": {"type": "string"}}, "required": ["city"]}}},
         {"type": "function", "function": {"name": "add"}}]
CHAT = [{"role": "user", "content": "What is the weather in Paris?"}]
P = "Tell me about pages and slots."


@pytest.fixture(scope="module")
def servers():
    """(reference server, port server) on the same weights, the JAX engine
    on its mixed scheduler like the port's default."""
    mp = pytest.MonkeyPatch()
    mp.setenv("ARKS_MIXED_STEP", "1")
    jparams = jtf.init_params(jax_get_config(NAME), jax.random.PRNGKey(9),
                              jnp.float32)
    jeng = JaxEngine(jax_get_config(NAME), JaxEngineConfig(
        model=NAME, kv_layout="paged", prefix_cache_mb=0, **ENGINE_KW),
        JaxByteTokenizer(), params=jparams)
    teng = InferenceEngine(get_config(NAME), EngineConfig(
        model=NAME, **ENGINE_KW), ByteTokenizer(),
        params=params_from_numpy(jax.tree.map(np.asarray, jparams),
                                 get_config(NAME), "cpu"), device="cpu")
    pair = []
    for cls, eng in ((JaxOpenAIServer, jeng), (OpenAIServer, teng)):
        srv = cls(eng, NAME, host="127.0.0.1", port=0)
        srv.start(background=True)
        eng.start()
        pair.append((srv, eng))
    yield pair[0][0], pair[1][0]
    for srv, eng in pair:
        srv.stop()
        eng.stop()
    mp.undo()


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", path, json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    if not body.get("stream") or resp.status != 200:
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


def _norm(x):
    """The payload less what differs per server run: ids and
    timestamps."""
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()
                if k not in ("id", "created")}
    if isinstance(x, list):
        return [_norm(v) for v in x]
    return x


def _close(got, want, path="$"):
    """Equal, with floats (only logprob values in these payloads) within
    1e-5."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, (int, float)) and abs(got - want) <= 1e-5, \
            (path, got, want)
    else:
        assert got == want, (path, got, want)


def _same_answer(servers, path, body):
    ref, port = servers
    want = _post(ref.port, path, body)
    got = _post(port.port, path, body)
    assert got[0] == want[0]
    _close(_norm(got[1]), _norm(want[1]))
    return got


COMPLETIONS = {
    "logprobs 2": dict(prompt=P, max_tokens=8, temperature=0, logprobs=2),
    "logprobs 5, stream, stop string": dict(
        prompt=P, max_tokens=12, temperature=0, logprobs=5, stream=True,
        stop=["zz", "q!"], stream_options={"include_usage": True}),
    "n 2 seeded": dict(prompt=P, max_tokens=6, temperature=0.8, seed=11,
                       n=2),
    "batched prompts, echo, logprobs": dict(
        prompt=["Hello", "World of slots"], max_tokens=5, temperature=0,
        echo=True, logprobs=1),
    "echo with logprobs 0": dict(prompt=P, max_tokens=5, temperature=0,
                                 echo=True, logprobs=0),
    "penalties and bias": dict(prompt=P, max_tokens=10, temperature=0,
                               presence_penalty=1.2, frequency_penalty=0.6,
                               logit_bias={"40": 4.5, "41": -100}),
    "min_tokens under a stop string": dict(
        prompt=P, max_tokens=10, temperature=0, min_tokens=6,
        logit_bias={"70": 6.0}, stop=["DD"], stop_token_ids=[70]),
    "json_object": dict(prompt=P, max_tokens=16, temperature=0,
                        response_format={"type": "json_object"}),
    "json_schema, seeded": dict(
        prompt=P, max_tokens=20, temperature=0.7, seed=3,
        response_format={"type": "json_schema", "json_schema": {
            "name": "x", "schema": {"type": "object", "properties": {
                "ok": {"type": "boolean"}}, "required": ["ok"]}}}),
    "guided_choice": dict(prompt=P, max_tokens=8, temperature=0,
                          guided_choice=["alpha", "beta"]),
    "guided_regex, stream": dict(prompt=P, max_tokens=8, temperature=0,
                                 guided_regex="[0-9]{2}-[a-z]+",
                                 stream=True),
    "guided_json": dict(prompt=P, max_tokens=12, temperature=0,
                        guided_json={"type": "array", "items": {
                            "type": "integer"}, "maxItems": 2}),
    "best_of ignored": dict(prompt=P, max_tokens=4, temperature=0,
                            best_of=3),
}
CHATS = {
    "logprobs true, top 3": dict(messages=CHAT, max_tokens=8, temperature=0,
                                 logprobs=True, top_logprobs=3),
    "logprobs, stream": dict(messages=CHAT, max_tokens=8, temperature=0,
                             logprobs=True, top_logprobs=2, stream=True),
    "n 2 seeded": dict(messages=CHAT, max_tokens=5, temperature=0.9,
                       seed=4, n=2),
    "tools, auto": dict(messages=CHAT, max_tokens=8, temperature=0,
                        tools=TOOLS),
    "forced tool call": dict(messages=CHAT, max_tokens=64, temperature=0,
                             tools=TOOLS, tool_choice={
                                 "type": "function",
                                 "function": {"name": "get_weather"}}),
    "forced tool call, stream": dict(
        messages=CHAT, max_tokens=64, temperature=0, tools=TOOLS,
        tool_choice="required", stream=True,
        stream_options={"include_usage": True}),
    "guided_choice, min_tokens": dict(messages=CHAT, max_tokens=8,
                                      temperature=0, min_tokens=2,
                                      guided_choice=["yes", "no"]),
}


def _no_call_ids(x):
    """Tool-call ids are random per response: blank them."""
    if isinstance(x, dict):
        return {k: ("call" if k == "id" and str(v).startswith("call_")
                    else _no_call_ids(v)) for k, v in x.items()}
    if isinstance(x, list):
        return [_no_call_ids(v) for v in x]
    return x


@pytest.mark.parametrize("case", list(COMPLETIONS))
def test_completions_answered_like_the_reference(servers, case):
    st, data = _same_answer(servers, "/v1/completions", COMPLETIONS[case])
    assert st == 200


@pytest.mark.parametrize("case", list(CHATS))
def test_chat_answered_like_the_reference(servers, case):
    ref, port = servers
    body = CHATS[case]
    want = _post(ref.port, "/v1/chat/completions", body)
    got = _post(port.port, "/v1/chat/completions", body)
    assert got[0] == want[0] == 200
    _close(_no_call_ids(_norm(got[1])), _no_call_ids(_norm(want[1])))


def test_forced_tool_call_walks_its_grammar(servers):
    """The forced call's text stays inside the hermes call grammar; where
    it finished, it parses as a call of the named function."""
    from arks_tpu_torch.server import tools

    _, port = servers
    st, data = _post(port.port, "/v1/chat/completions", dict(
        CHATS["forced tool call"], max_tokens=200))
    assert st == 200
    choice = data["choices"][0]
    if choice["finish_reason"] == "tool_calls":
        calls = choice["message"]["tool_calls"]
        assert [c["function"]["name"] for c in calls] == ["get_weather"]
        json.loads(calls[0]["function"]["arguments"])
    else:
        assert choice["message"]["content"].startswith(
            tools.TOOL_OPEN[:len(choice["message"]["content"])])


def test_n_children_take_seed_plus_j(servers):
    """n 2 with a seed answers as two single requests seeded seed and
    seed + 1."""
    _, port = servers
    body = dict(COMPLETIONS["n 2 seeded"])
    st, data = _post(port.port, "/v1/completions", body)
    texts = [c["text"] for c in data["choices"]]
    body.pop("n")
    singles = []
    for j in range(2):
        singles.append(_post(port.port, "/v1/completions",
                             dict(body, seed=11 + j))[1]["choices"][0]["text"])
    assert texts == singles
    assert data["usage"]["completion_tokens"] == 12


BAD = {
    "echo with stream": dict(prompt=P, echo=True, stream=True),
    "301 bias entries": dict(prompt=P, logit_bias={
        str(i): 1 for i in range(301)}),
    "bias id out of range": dict(prompt=P, logit_bias={"100000": 1}),
    "bad guided_choice": dict(prompt=P, guided_choice=["a", 3]),
    "unknown response_format": dict(prompt=P,
                                    response_format={"type": "xml"}),
    "n 17": dict(prompt=P, n=17),
    "n 2 streamed": dict(prompt=P, n=2, stream=True),
    "bad regex": dict(prompt=P, guided_regex="(ab"),
    "min_tokens with 9 stop ids": dict(prompt=P, min_tokens=3,
                                       stop_token_ids=list(range(2, 11))),
}
BAD_CHAT = {
    "echo in chat": dict(messages=CHAT, echo=True),
    "forced call with response_format": dict(
        messages=CHAT, tools=TOOLS, tool_choice="required",
        response_format={"type": "json_object"}),
    "unknown tool": dict(messages=CHAT, tools=TOOLS, tool_choice={
        "type": "function", "function": {"name": "nope"}}),
}


@pytest.mark.parametrize("case", list(BAD))
def test_completions_400_like_the_reference(servers, case):
    st, data = _same_answer(servers, "/v1/completions",
                            dict(BAD[case], max_tokens=4))
    assert st == 400 and data["error"]["message"]


@pytest.mark.parametrize("case", list(BAD_CHAT))
def test_chat_400_like_the_reference(servers, case):
    st, data = _same_answer(servers, "/v1/chat/completions",
                            dict(BAD_CHAT[case], max_tokens=4))
    assert st == 400 and data["error"]["message"]

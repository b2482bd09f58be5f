"""Scale-to-zero and re-arm in the port (``ARKS_ELASTIC_IDLE_ZERO_S``)
against the reference's ``tests/test_elastic.py``.

- ``test_scale_to_zero_and_rearm_on_demand`` (the reference's :86): an
  idle engine disarms (weights, KV pool and sampling rows dropped), a
  queue arrival re-arms it, and the demand's stream equals the one a
  never-disarmed engine gives; the same scenario through the JAX engine
  on the same f32 weights gives the same token ids.
- ``test_disarmed_readiness_and_http_rearm`` (:214): readiness answers
  503 "scaled to zero (disarmed)" while ``/v1/elastic/status`` stays
  reachable; a completion re-arms the engine (the reference re-arms
  through POST /v1/elastic/resize, which the port answers 501: live
  resize is the parallelism slice) and readiness returns 200.
- The ``/v1/elastic/status`` part of ``test_elastic_http_surface`` (:176),
  and the readiness payload's ``elastic`` block.
- A pool engine that disarms and re-arms keeps its extra models
  registered and serves them with the same streams.
The reference's resize cases belong to live resize (not served here).
"""

import contextlib
import dataclasses
import json
import os
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import torch

from arks_tpu.engine import EngineConfig as JaxEngineConfig
from arks_tpu.engine import InferenceEngine as JaxEngine
from arks_tpu.engine import Request as JaxRequest
from arks_tpu.engine import SamplingParams as JaxSamplingParams
from arks_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from arks_tpu.models import get_config as jax_get_config
from arks_tpu.models import transformer as jtf
from arks_tpu_torch.engine import (EngineConfig, InferenceEngine, Request,
                                   SamplingParams)
from arks_tpu_torch.engine.model_pool import ModelPool
from arks_tpu_torch.engine.tokenizer import ByteTokenizer
from arks_tpu_torch.models import get_config
from arks_tpu_torch.models.weights import params_from_numpy
from arks_tpu_torch.server.openai_server import OpenAIServer

torch.set_num_threads(2)

KW = dict(model="tiny", num_slots=2, max_cache_len=64,
          prefill_buckets=(8, 16, 32), steps_per_dispatch=4,
          dtype="float32")
ENV = ("ARKS_ELASTIC_IDLE_ZERO_S", "ARKS_PIPELINE_DEPTH")


@contextlib.contextmanager
def _env(**kv):
    old = {k: os.environ.get(k) for k in ENV}
    try:
        for k in ENV:
            os.environ.pop(k, None)
        os.environ.update({k: str(v) for k, v in kv.items()})
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _engine(idle_zero="0.05", **kw):
    with _env(ARKS_ELASTIC_IDLE_ZERO_S=idle_zero, ARKS_PIPELINE_DEPTH=0):
        return InferenceEngine(get_config("tiny"), EngineConfig(**KW),
                               ByteTokenizer(), device="cpu", **kw)


def _greedy(rid, prompt=(5, 6, 7), cls=Request, sp_cls=SamplingParams,
            **kw):
    return cls(rid, list(prompt), sp_cls(max_tokens=10, temperature=0.0,
                                         ignore_eos=True), **kw)


def _collect(req, timeout=120):
    ids, fin = [], None
    while True:
        out = req.outputs.get(timeout=timeout)
        ids.extend(out.token_ids)
        if out.finished:
            fin = out
            break
    return ids, fin.finish_reason


def _drive(eng, n_steps=400):
    for _ in range(n_steps):
        eng.step(block_s=0.01)
        if eng.armed and eng.idle:
            return


def _disarm(eng, timeout=30):
    deadline = time.monotonic() + timeout
    while eng.armed and time.monotonic() < deadline:
        eng.step(block_s=0.01)
        time.sleep(0.01)
    assert not eng.armed, "idle engine never scaled to zero"


def test_scale_to_zero_and_rearm_on_demand():
    """Disarm on idle, re-arm on demand, the stream unchanged; the same
    through the JAX engine on the same f32 weights."""
    base_eng = _engine(idle_zero="0")
    r0 = _greedy("b0")
    base_eng.add_request(r0)
    _drive(base_eng)
    base = _collect(r0)

    eng = _engine()
    _disarm(eng)
    assert eng.params is None and eng.cache is None
    assert eng.elastic_status()["armed"] is False
    assert eng.metrics.engine_resizes_total.get(
        mode="scale_to_zero", outcome="ok") == 1
    r1 = _greedy("d0")
    eng.add_request(r1)
    _drive(eng)
    assert eng.armed, "demand did not re-arm the engine"
    assert _collect(r1) == base == (base[0], "length")
    assert eng.last_rearm_stats["seconds"] > 0
    assert eng.metrics.engine_resizes_total.get(
        mode="rearm", outcome="ok") == 1
    assert eng.metrics.scale_from_zero_seconds._data

    # The JAX engine (booted and re-armed from its seed) against the port
    # engine booted on the bridged weights and re-armed from them.
    jparams = jtf.init_params(jax_get_config("tiny"), jax.random.PRNGKey(0),
                              jax.numpy.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                get_config("tiny"), "cpu")
    with _env(ARKS_ELASTIC_IDLE_ZERO_S="0.05", ARKS_PIPELINE_DEPTH=0):
        jeng = JaxEngine(jax_get_config("tiny"), JaxEngineConfig(**KW),
                         JaxByteTokenizer())
    _disarm(jeng)
    jreq = _greedy("j0", cls=JaxRequest, sp_cls=JaxSamplingParams)
    jeng.add_request(jreq)
    _drive(jeng)
    want = _collect(jreq)
    peng = _engine(params=tparams)
    peng.set_rearm_loader(lambda cfg: tparams)
    _disarm(peng)
    preq = _greedy("p0")
    peng.add_request(preq)
    _drive(peng)
    assert peng.last_rearm_stats["streamed"] is True
    assert _collect(preq) == want


def _get_json(port, path):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _post_json(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _served(eng):
    eng.start()
    srv = OpenAIServer(eng, served_model_name="t", host="127.0.0.1", port=0)
    srv.start(background=True)
    return srv


def _wait_ready(port, timeout=30):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        code, body = _get_json(port, "/readiness")
        if code == 200:
            return body
        time.sleep(0.05)
    raise AssertionError("readiness never turned 200")


def test_elastic_status_and_readiness_block():
    """GET /v1/elastic/status and readiness's elastic block while armed;
    POST /v1/elastic/resize answers 501 (no live resize)."""
    eng = _engine(idle_zero="0")
    srv = _served(eng)
    try:
        code, st = _get_json(srv.port, "/v1/elastic/status")
        assert code == 200 and st["armed"] and st["shape"] == "tp1xdp1"
        rdy = _wait_ready(srv.port)
        assert rdy["elastic"]["armed"] is True
        assert "slo_burn" in rdy and "admission" in rdy
        code, out = _post_json(srv.port, "/v1/elastic/resize",
                               {"tensor_parallel": 2})
        assert code == 501
        assert "no elastic resize support" in out["error"]["message"]
    finally:
        srv.stop()
        eng.stop()


def test_disarmed_readiness_and_http_rearm():
    """A scaled-to-zero engine 503s readiness "disarmed" while its status
    stays reachable; a completion re-arms it and readiness returns 200."""
    eng = _engine()
    srv = _served(eng)
    try:
        deadline = time.monotonic() + 30
        while eng.armed and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not eng.armed
        code, out = _get_json(srv.port, "/readiness")
        assert code == 503 and "disarmed" in out["error"]["message"]
        code, st = _get_json(srv.port, "/v1/elastic/status")
        assert code == 200 and st["armed"] is False
        code, out = _post_json(srv.port, "/v1/completions", {
            "prompt": [5, 6, 7], "max_tokens": 4, "temperature": 0})
        assert code == 200 and out["choices"][0]["finish_reason"] == "length"
        assert eng.armed
        code, rdy = _get_json(srv.port, "/readiness")
        assert code == 200 and rdy["elastic"]["armed"] is True
        assert rdy["elastic"]["last_rearm"]["seconds"] > 0
    finally:
        srv.stop()
        eng.stop()


def test_pool_engine_keeps_extra_models_across_scale_to_zero():
    """A pool engine serves its extra model, disarms, and re-arms on a
    request for that model: the registration survives, the model's context
    is rebuilt on its resident weights and the stream is unchanged."""
    cfg_b = dataclasses.replace(get_config("tiny"), name="tiny2",
                                num_layers=1)
    eng = _engine(pool=ModelPool())
    eng.register_model(cfg_b)
    first = _greedy("b-1", model="tiny2")
    eng.add_request(first)
    _drive(eng)
    want = _collect(first)
    back = _greedy("a-1")
    eng.add_request(back)
    _drive(eng)
    _collect(back)
    assert eng.cfg.name == "tiny"
    _disarm(eng)
    assert eng.pool.entry("tiny").state == "evicted"
    again = _greedy("b-2", model="tiny2")
    eng.add_request(again)
    for _ in range(800):
        eng.step(block_s=0.01)
        if eng.armed and eng.idle and not eng._model_loads:
            break
    assert eng.served_models() == ["tiny", "tiny2"]
    assert _collect(again) == want
    assert eng.cfg.name == "tiny2"
    assert eng.metrics.engine_resizes_total.get(mode="rearm",
                                                outcome="ok") == 1

"""The port server's flags and knobs that the reference's server has
(``arks_tpu/server/__main__.py``): ``ARKS_DRAIN_TIMEOUT`` as the
``--drain-timeout`` default, ``--steps-per-dispatch``, ``--dispatch-
deadline`` and ``--fault-retries`` reaching the engine, the parallelism
flags accepted at 1 and refused above it, ``--disaggregation-mode``
refused, the weight pool behind ``--extra-model``,
``--model-pool-hbm-mb`` and ``--draft-model`` (``/v1/models`` with its
``arks`` blocks, routing by ``model``, 404 for an unknown one), and the
knobs the engine refuses (the disk tier, peer fetch) against the one it
now serves (the residency window)."""

import json
import urllib.error
import urllib.request

import pytest
import torch

from arks_tpu_torch import knobs
from arks_tpu_torch.engine import engine as engine_mod
from arks_tpu_torch.server import __main__ as server_main
from arks_tpu_torch.server.openai_server import OpenAIServer

torch.set_num_threads(2)

BASE = ["--model", "tiny", "--device", "cpu", "--num-slots", "2",
        "--max-model-len", "64"]


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in ("ARKS_DRAIN_TIMEOUT", "ARKS_DISPATCH_DEADLINE_S",
                 "ARKS_FAULT_RETRIES", "ARKS_MODEL_POOL_HBM_MB",
                 "ARKS_RESIDENCY_WINDOW_PAGES", "ARKS_PREFIX_DISK_MB",
                 "ARKS_PEER_FETCH", "ARKS_PEER_ADDRS"):
        monkeypatch.delenv(name, raising=False)


def _build(*extra):
    return server_main.build_engine(server_main.parse_args(BASE + list(extra)))


def test_drain_timeout_defaults_to_the_knob(monkeypatch):
    assert server_main.parse_args(BASE).drain_timeout == 20.0
    monkeypatch.setenv("ARKS_DRAIN_TIMEOUT", "8")
    assert server_main.parse_args(BASE).drain_timeout == 8.0
    assert server_main.parse_args(
        BASE + ["--drain-timeout", "3"]).drain_timeout == 3.0


def test_dispatch_flags_reach_the_engine():
    _, eng = _build("--steps-per-dispatch", "3", "--fault-retries", "2",
                    "--dispatch-deadline", "5")
    assert eng.ecfg.steps_per_dispatch == 3
    assert eng.max_prompt_len == 64 - 3 - 1
    assert eng._fault_retries == 2
    assert knobs.get_float("ARKS_DISPATCH_DEADLINE_S") == 5.0


@pytest.mark.parametrize("flag", ["--tensor-parallel-size", "--tp",
                                  "--data-parallel-size", "--dp",
                                  "--context-parallel-size", "--cp",
                                  "--pipeline-parallel-size", "--pp",
                                  "--num-slices"])
def test_parallelism_flags_accepted_at_one_refused_above(flag):
    _, eng = _build(flag, "1")
    assert eng.resolved_config["tensor_parallel"] == "1"
    with pytest.raises(NotImplementedError, match="parallelism"):
        _build(flag, "2")


def test_disaggregation_mode_is_refused():
    with pytest.raises(NotImplementedError, match="disaggregat"):
        _build("--disaggregation-mode", "prefill")


def test_unserved_knobs_refuse_the_disk_tier_and_peer_fetch(monkeypatch):
    monkeypatch.setenv("ARKS_RESIDENCY_WINDOW_PAGES", "4")
    engine_mod.check_unserved_knobs()
    for name, value, what in (("ARKS_PREFIX_DISK_MB", "64", "disk"),
                              ("ARKS_PEER_FETCH", "1", "peer"),
                              ("ARKS_PEER_ADDRS", "h:1", "peer")):
        monkeypatch.setenv(name, value)
        with pytest.raises(NotImplementedError, match=what):
            engine_mod.check_unserved_knobs()
        monkeypatch.delenv(name)


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def test_extra_model_pool_over_http():
    """--extra-model and --model-pool-hbm-mb build the pool: /v1/models
    lists both models with their arks blocks, a request naming the extra
    model is served by it, an unknown model is a 404; --draft-model puts
    the draft in the pool, pinned."""
    cfg, eng = _build("--extra-model", "tiny-gqa", "--model-pool-hbm-mb",
                      "64")
    assert eng.pool.budget_bytes == 64 << 20
    assert eng.served_models() == ["tiny", "tiny-gqa"]
    eng.start()
    srv = OpenAIServer(eng, cfg.name, host="127.0.0.1", port=0)
    srv.start(background=True)
    try:
        code, models = _get(srv.port, "/v1/models")
        assert code == 200
        rows = {m["id"]: m["arks"] for m in models["data"]}
        assert rows["tiny"]["pinned"] and rows["tiny"]["state"] == "resident"
        assert rows["tiny-gqa"] == {"state": "evicted", "pinned": False,
                                    "resident_bytes": 0, "cold_starts": 0}
        body = {"prompt": [5, 6, 7], "max_tokens": 4, "temperature": 0}
        code, out = _post(srv.port, dict(body, model="tiny-gqa"))
        assert code == 200 and out["model"] == "tiny-gqa"
        assert out["choices"][0]["finish_reason"] == "length"
        code, models = _get(srv.port, "/v1/models")
        rows = {m["id"]: m["arks"] for m in models["data"]}
        assert rows["tiny-gqa"]["state"] == "resident"
        assert rows["tiny-gqa"]["cold_starts"] == 1
        code, out = _post(srv.port, dict(body, model="no-such-model"))
        assert code == 404
    finally:
        srv.stop()
        eng.stop()
    _, deng = _build("--draft-model", "tiny-gqa", "--draft-len", "3")
    assert deng.pool is not None
    assert deng.pool.entry("tiny-gqa").pinned
    assert deng.pool.params_of("tiny-gqa") is deng._draft_params
    assert deng.pool.params_of("tiny") is deng.params

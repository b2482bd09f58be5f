"""Multi-model serving in the port: the weight pool
(``arks_tpu_torch/engine/model_pool.py``) against the reference's unit
cases (``tests/test_model_pool.py``), and the engine's pooled serving
against ``tests/test_multi_model.py``'s scenarios.

- Pool units: the reference's ten cases on torch tensors (the budget, the
  LRU, refcounts and pins, tickets, load failures), plus ``tree_bytes`` of
  quantized leaves (int8 values and their f32 scales count as stored).
- Pooled streams: one port engine serving ``tiny`` and a one-layer
  ``tiny2`` through the pool emits, per request, exactly the stream of a
  single-model port engine of that config (token ids and finish reasons
  equal), greedy and seeded, at pipeline depths 0 and 2; and the same
  requests through the JAX engine's pool on the same f32 weights give the
  same token ids (depth 0), also when the first switch faults.
- A fault in the ``model_switch`` phase replays the parked requests and
  converges to the fault-free streams; with a zero retry budget exactly
  the parked culprits fail.  An unknown model fails fast; an abort reaches
  a request parked on a load.
- A budget that cannot hold two secondaries beside the primary: the
  engine steps back to the primary, the LRU secondary is evicted (its
  saved context, and with it its KV pool, dropped) and comes back as a
  cold start, every stream still equal to its single-model engine's.

The reference's compile-budget case (``test_second_model_adds_no_new_
program_shapes``) has no counterpart: the port runs eager PyTorch and
compiles no programs, so a second model cannot add program shapes.
"""

import contextlib
import dataclasses
import gc
import os
import threading
import time
import weakref

import jax
import numpy as np
import pytest
import torch

from arks_tpu.engine import EngineConfig as JaxEngineConfig
from arks_tpu.engine import InferenceEngine as JaxEngine
from arks_tpu.engine import Request as JaxRequest
from arks_tpu.engine import SamplingParams as JaxSamplingParams
from arks_tpu.engine.model_pool import ModelPool as JaxModelPool
from arks_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from arks_tpu.models import get_config as jax_get_config
from arks_tpu.models import transformer as jtf
from arks_tpu_torch.engine import (EngineConfig, InferenceEngine, Request,
                                   SamplingParams)
from arks_tpu_torch.engine.model_pool import (LoadTicket, ModelPool,
                                              PoolFullError, tree_bytes)
from arks_tpu_torch.engine.tokenizer import ByteTokenizer
from arks_tpu_torch.models import get_config
from arks_tpu_torch.models.weights import params_from_numpy

torch.set_num_threads(2)

MB = 1 << 20


def _params(mb):
    """A param tree of exactly ``mb`` MiB of stored bytes."""
    return {"w": torch.zeros((mb, MB // 4), dtype=torch.float32)}


# ---------------------------------------------------------------------------
# Pool units (the reference's tests/test_model_pool.py)
# ---------------------------------------------------------------------------


def test_tree_bytes_counts_stored_leaf_bytes():
    assert tree_bytes(_params(3)) == 3 * MB
    assert tree_bytes({"a": _params(1), "b": _params(2)}) == 3 * MB
    quantized = {"q": torch.zeros((64, 32), dtype=torch.int8),
                 "s": torch.zeros((1, 32), dtype=torch.float32)}
    assert tree_bytes({"layers": {"wq": quantized}}) == 64 * 32 + 32 * 4


def test_register_is_idempotent_and_adopt_makes_resident():
    pool = ModelPool(hbm_budget_mb=0)
    e1 = pool.register("m", cfg="cfg-a", model_path="/p")
    e2 = pool.register("m", cfg="ignored", pinned=True)
    assert e1 is e2 and e1.pinned and e1.model_path == "/p"
    pool.adopt("m", "cfg-a", _params(2))
    snap = {s["name"]: s for s in pool.snapshot()}
    assert snap["m"]["state"] == "resident"
    assert snap["m"]["resident_bytes"] == 2 * MB
    assert snap["m"]["pinned"] is True
    assert pool.params_of("m")["w"].shape[0] == 2


def test_ensure_returns_ticket_then_resident_entry():
    pool = ModelPool(hbm_budget_mb=0)
    gate = threading.Event()

    def loader():
        gate.wait(10)
        return _params(1)

    pool.register("m", "cfg", loader=loader)
    t = pool.ensure("m")
    assert isinstance(t, LoadTicket) and not t.event.is_set()
    # Re-ensuring while the load is in flight returns the SAME ticket.
    assert pool.ensure("m") is t
    gate.set()
    assert t.event.wait(10) and t.error is None
    e = pool.ensure("m")
    assert not isinstance(e, LoadTicket)
    assert e.state == "resident" and e.cold_starts == 1
    assert pool.load("m", timeout=10)["w"].shape[0] == 1


def test_ensure_unknown_model_raises_keyerror():
    pool = ModelPool(hbm_budget_mb=0)
    with pytest.raises(KeyError):
        pool.ensure("nope")
    pool.register("m", "cfg")  # registered, but no loader and no params
    with pytest.raises(KeyError):
        pool.ensure("m")


def test_loader_failure_surfaces_on_the_ticket():
    pool = ModelPool(hbm_budget_mb=0)

    def boom():
        raise OSError("disk gone")

    pool.register("m", "cfg", loader=boom)
    t = pool.ensure("m")
    assert t.event.wait(10)
    assert "disk gone" in t.error
    assert pool.entry("m").state == "evicted"
    with pytest.raises(RuntimeError, match="disk gone"):
        pool.load("m", timeout=10)


def test_budget_evicts_lru_idle_unpinned():
    pool = ModelPool(hbm_budget_mb=3)
    evicted = []
    pool.on_evict = evicted.append
    pool.adopt("old", "cfg", _params(1))
    time.sleep(0.01)
    pool.adopt("new", "cfg", _params(1))
    pool.register("big", "cfg", loader=lambda: _params(2))
    assert pool.load("big", timeout=10)["w"].shape[0] == 2
    # Only the LRU entry goes; "new" still fits next to "big".
    assert evicted == ["old"]
    snap = {s["name"]: s["state"] for s in pool.snapshot()}
    assert snap == {"old": "evicted", "new": "resident", "big": "resident"}
    # The evicted entry remembers its size: a reload makes room first.
    assert pool.entry("old").nbytes == 1 * MB


def test_pinned_and_in_use_models_never_evicted():
    pool = ModelPool(hbm_budget_mb=3)
    pool.adopt("flag", "cfg", _params(1), pinned=True)
    pool.adopt("busy", "cfg", _params(1))
    pool.acquire("busy")  # the engine decodes with it
    pool.register("big", "cfg", loader=lambda: _params(2))
    with pytest.raises(PoolFullError):
        pool.load("big", timeout=10)
    snap = {s["name"]: s["state"] for s in pool.snapshot()}
    assert snap["flag"] == "resident" and snap["busy"] == "resident"
    pool.release("busy")
    assert pool.load("big", timeout=10)["w"].shape[0] == 2
    assert pool.entry("busy").state == "evicted"


def test_pool_full_error_rides_the_ticket_as_exhausted():
    pool = ModelPool(hbm_budget_mb=1)
    pool.adopt("flag", "cfg", _params(1), pinned=True)
    pool.register("big", "cfg", loader=lambda: _params(2))
    t = pool.ensure("big")
    assert t.event.wait(10)
    assert "model_pool_exhausted" in t.error
    # The size is remembered: the next claim fails before streaming.
    with pytest.raises(PoolFullError):
        pool.ensure("big")


def test_acquire_requires_resident_and_refcounts_nest():
    pool = ModelPool(hbm_budget_mb=0)
    pool.register("m", "cfg", loader=lambda: _params(1))
    with pytest.raises(RuntimeError, match="not resident"):
        pool.acquire("m")
    pool.load("m", timeout=10)
    pool.acquire("m")
    pool.acquire("m")
    assert pool.entry("m").refcount == 2
    pool.release("m")
    pool.release("m")
    pool.release("m")  # over-release is a no-op, never negative
    assert pool.entry("m").refcount == 0


def test_budget_env_validation(monkeypatch):
    monkeypatch.setenv("ARKS_MODEL_POOL_HBM_MB", "not-a-number")
    with pytest.raises(ValueError, match="ARKS_MODEL_POOL_HBM_MB"):
        ModelPool()
    monkeypatch.setenv("ARKS_MODEL_POOL_HBM_MB", "64")
    assert ModelPool().budget_bytes == 64 * MB
    with pytest.raises(ValueError):
        ModelPool(hbm_budget_mb=-1)


# ---------------------------------------------------------------------------
# Pooled serving (the reference's tests/test_multi_model.py)
# ---------------------------------------------------------------------------

DEFAULTS = dict(num_slots=2, max_cache_len=64, prefill_buckets=(8, 16, 32),
                steps_per_dispatch=4, prefill_chunk=16, kv_layout="paged",
                dtype="float32")
ENV = ("ARKS_PIPELINE_DEPTH", "ARKS_MIXED_STEP", "ARKS_FAULT_INJECT",
       "ARKS_FAULT_RETRIES", "ARKS_MODEL_POOL_HBM_MB")
# (model slot, prompt, greedy?): interleaved across the two models,
# greedy and seeded per model.  Seeds are explicit: the fallback seed
# counter is engine-wide.
WORKLOAD = [
    ("a", [5, 6, 7], True),
    ("b", [9] * 5, True),
    ("a", [11] * 4, False),
    ("b", [3, 1, 4], False),
]


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


def _cfg_b(name="tiny2"):
    return dataclasses.replace(get_config("tiny"), name=name, num_layers=1)


def _drive(eng, n_steps=4000):
    """The engine thread's step/recover contract, synchronously, until
    every parked request has been switched to and served."""
    for _ in range(n_steps):
        try:
            eng.step(block_s=0.01)
        except Exception as e:  # noqa: BLE001 — as the loop routes it
            eng._recover_from_fault(e)
        if eng.idle and eng.state == "serving" and not eng._model_loads:
            return
    raise AssertionError("engine did not drain")


def _collect(req, timeout=120):
    ids, fin = [], None
    while True:
        out = req.outputs.get(timeout=timeout)
        ids.extend(out.token_ids)
        if out.finished:
            fin = out
            break
    return ids, fin.finish_reason, fin.error


def _requests(model_b, only=None, cls=Request, sp_cls=SamplingParams):
    reqs = []
    for i, (slot, prompt, greedy) in enumerate(WORKLOAD):
        if only is not None and slot != only:
            continue
        sp = sp_cls(max_tokens=12, temperature=0.0 if greedy else 0.9,
                    top_p=0.9, top_k=40, seed=31 + i, ignore_eos=True)
        reqs.append(cls(f"m{i}", list(prompt), sp,
                        model=model_b if slot == "b" and only is None
                        else None))
    return reqs


def _single(depth, cfg):
    with _env(ARKS_PIPELINE_DEPTH=depth):
        return InferenceEngine(cfg, EngineConfig(model=cfg.name, **DEFAULTS),
                               ByteTokenizer(), device="cpu")


def _pooled(depth, models=(), budget_mb=None, **env):
    with _env(ARKS_PIPELINE_DEPTH=depth, **env):
        eng = InferenceEngine(get_config("tiny"),
                              EngineConfig(model="tiny", **DEFAULTS),
                              ByteTokenizer(), device="cpu",
                              pool=ModelPool(hbm_budget_mb=budget_mb))
    for cfg in models:
        eng.register_model(cfg)
    return eng


def _baseline(depth, cfg_b):
    """Per-request streams from two single-model engines."""
    base = {}
    for slot, cfg in (("a", get_config("tiny")), ("b", cfg_b)):
        eng = _single(depth, cfg)
        reqs = _requests(cfg_b.name, only=slot)
        for r in reqs:
            eng.add_request(r)
        _drive(eng)
        base.update({r.request_id: _collect(r) for r in reqs})
    return base


def _pooled_run(depth, cfg_b, **env):
    eng = _pooled(depth, (cfg_b,), **env)
    reqs = _requests(cfg_b.name)
    for r in reqs:
        eng.add_request(r)
    _drive(eng)
    return {r.request_id: _collect(r) for r in reqs}, eng


@pytest.mark.parametrize("depth", [0, 2])
def test_pooled_streams_equal_single_model_engines(depth):
    """Token ids and finish reasons equal, per request, to the single-model
    engine of that request's config."""
    cfg_b = _cfg_b()
    base = _baseline(depth, cfg_b)
    got, eng = _pooled_run(depth, cfg_b)
    assert {rid: g[1] for rid, g in got.items()} == \
        {rid: "length" for rid in base}
    assert got == base, "pooled streams diverged from single-model engines"
    assert eng.metrics.model_switch_seconds._data
    assert eng.last_switch_stats["model"] == "tiny2"
    assert sum(eng.metrics.engine_faults_total._values.values()) == 0
    assert eng.served_models() == ["tiny", "tiny2"]
    assert int(eng.metrics.model_cold_starts_total.get(model="tiny2")) == 1
    assert eng.metrics.model_pool_resident_bytes.get(model="tiny2") == \
        tree_bytes(eng.pool.params_of("tiny2"))


@pytest.mark.parametrize("inject", [None, "model_switch:1:runtime"],
                         ids=["clean", "switch-fault"])
def test_pooled_streams_equal_the_jax_pooled_engine(inject):
    """The same requests through the JAX engine's pool (f32 ``tiny`` and
    ``tiny2`` weights bridged into the port): equal token ids and finish
    reasons, at depth 0; with a fault at the first model switch, both
    engines recover to the same streams."""
    env = {} if inject is None else dict(ARKS_FAULT_INJECT=inject)
    jcfg = jax_get_config("tiny")
    jcfg_b = dataclasses.replace(jcfg, name="tiny2", num_layers=1)
    ja = jtf.init_params(jcfg, jax.random.PRNGKey(0), jax.numpy.float32)
    # The reference's register_model loader: the engine seed's init.
    jb = jtf.init_params(jcfg_b, jax.random.PRNGKey(0), jax.numpy.float32)
    with _env(ARKS_PIPELINE_DEPTH=0, ARKS_MIXED_STEP="auto", **env):
        jeng = JaxEngine(jcfg, JaxEngineConfig(model="tiny", **DEFAULTS),
                         JaxByteTokenizer(), params=ja, pool=JaxModelPool())
    jeng.register_model(jcfg_b)
    jreqs = _requests("tiny2", cls=JaxRequest, sp_cls=JaxSamplingParams)
    for r in jreqs:
        jeng.add_request(r)
    _drive(jeng)
    want = {r.request_id: _collect(r) for r in jreqs}

    def bridge(p, cfg):
        return params_from_numpy(jax.tree.map(np.asarray, p), cfg, "cpu")

    cfg_b = _cfg_b()
    with _env(ARKS_PIPELINE_DEPTH=0, **env):
        eng = InferenceEngine(get_config("tiny"),
                              EngineConfig(model="tiny", **DEFAULTS),
                              ByteTokenizer(),
                              params=bridge(ja, get_config("tiny")),
                              device="cpu", pool=ModelPool())
    eng.pool.register("tiny2", cfg_b, loader=lambda: bridge(jb, cfg_b))
    reqs = _requests("tiny2")
    for r in reqs:
        eng.add_request(r)
    _drive(eng)
    got = {r.request_id: _collect(r) for r in reqs}
    assert got == want
    faults = int(inject is not None)
    assert eng.metrics.engine_faults_total.total() == faults
    assert sum(jeng.metrics.engine_faults_total._values.values()) == faults


@pytest.mark.parametrize("depth", [0, 2])
def test_model_switch_fault_recovers_byte_identical(depth):
    """A fault in the model_switch phase replays the parked requests
    through a retried switch and converges to the fault-free streams."""
    cfg_b = _cfg_b()
    base, _ = _pooled_run(depth, cfg_b)
    got, eng = _pooled_run(depth, cfg_b,
                           ARKS_FAULT_INJECT="model_switch:1:runtime")
    assert got == base, "streams diverged after a model_switch fault"
    faults = dict(eng.metrics.engine_faults_total._values)
    assert sum(faults.values()) == 1
    assert any("model_switch" in str(k) for k in faults)
    # Both tiny2-routed requests re-queued (nothing emitted yet), nobody
    # quarantined.
    assert eng.metrics.requests_recovered_total.total() == 2
    assert eng.metrics.requests_quarantined_total.total() == 0
    assert eng.state == "serving"


def test_model_switch_fault_quarantines_parked_culprits_only():
    """With a zero retry budget the switch's culprits (the requests parked
    for the target) fail alone; the active model's streams are
    untouched."""
    cfg_b = _cfg_b()
    base, _ = _pooled_run(0, cfg_b)
    got, eng = _pooled_run(0, cfg_b, ARKS_FAULT_INJECT="model_switch:1:runtime",
                           ARKS_FAULT_RETRIES=0)
    for rid, (ids, reason, error) in got.items():
        if rid in ("m1", "m3"):  # the two tiny2-routed requests
            assert reason == "error" and "model_switch" in error
        else:
            assert (ids, reason, error) == base[rid]
    assert eng.metrics.requests_quarantined_total.total() == 2
    assert eng.state == "serving"


def test_unknown_model_fails_fast():
    eng = _pooled(0, (_cfg_b(),))
    req = Request("nope", [1, 2, 3], SamplingParams(max_tokens=4,
                                                    temperature=0.0),
                  model="no-such-model")
    eng.add_request(req)
    _drive(eng, n_steps=50)
    assert _collect(req)[1:] == ("error", "model_not_found")
    assert not eng._awaiting_model


def test_abort_while_parked_for_model():
    """An abort reaches a request parked on a model load, and the waiting
    gauge comes back down."""
    eng = _pooled(0, (_cfg_b(),))
    entry = eng.pool.entry("tiny2")
    orig, gate = entry.loader, threading.Event()
    entry.loader = lambda: (gate.wait(30), orig())[1]
    req = Request("parked", [7, 8, 9], SamplingParams(
        max_tokens=4, temperature=0.0, ignore_eos=True), model="tiny2")
    eng.add_request(req)
    for _ in range(200):
        eng.step(block_s=0.01)
        if eng._awaiting_model:
            break
    assert eng._awaiting_model, "request never parked for its model"
    assert eng.metrics.requests_parked.get(reason="model") == 1
    eng.abort("parked")
    for _ in range(200):
        eng.step(block_s=0.01)
        if not eng._awaiting_model:
            break
    gate.set()
    assert _collect(req)[1] == "abort"
    assert not eng._awaiting_model
    assert eng.metrics.num_requests_waiting.get() == 0
    _drive(eng, n_steps=200)  # the unblocked load settles


def test_budget_eviction_steps_back_and_cold_starts():
    """Two one-layer secondaries that cannot both sit beside the primary:
    serving b, then c, then b again steps back to the primary each time
    (the active secondary's own reference holds the room), evicts the LRU
    secondary with its saved context and KV pool, and reloads b as a cold
    start; every stream equals its single-model engine's."""
    cfg_b, cfg_c = _cfg_b("tiny2"), _cfg_b("tiny3")
    one = tree_bytes(_single(0, cfg_b).params)
    primary = tree_bytes(_single(0, get_config("tiny")).params)
    eng = _pooled(0, (cfg_b, cfg_c))
    # The budget in bytes (the tiny trees are below one MiB): the primary
    # and one secondary fit, not two.
    eng.pool.budget_bytes = primary + one + one // 2
    got, order = {}, []
    for rnd, cfg in enumerate((cfg_b, cfg_c, cfg_b)):
        sp = SamplingParams(max_tokens=8, temperature=0.0, ignore_eos=True)
        req = Request(f"r{rnd}", [5 + rnd, 6, 7], sp, model=cfg.name)
        eng.add_request(req)
        _drive(eng)
        got[req.request_id] = _collect(req)
        order.append(eng.cfg.name)
        if rnd == 0:
            # The saved context of b holds its KV pool: eviction drops it.
            ctx_ref = weakref.ref(eng.cache.k)
    gc.collect()
    assert ctx_ref() is None, "the evicted model's KV pool is still alive"
    assert order == ["tiny2", "tiny3", "tiny2"]
    assert int(eng.metrics.model_cold_starts_total.get(model="tiny2")) == 2
    assert int(eng.metrics.model_cold_starts_total.get(model="tiny3")) == 1
    assert eng.pool.entry("tiny3").state == "evicted"
    for rnd, cfg in enumerate((cfg_b, cfg_c, cfg_b)):
        single = _single(0, cfg)
        sp = SamplingParams(max_tokens=8, temperature=0.0, ignore_eos=True)
        req = Request(f"r{rnd}", [5 + rnd, 6, 7], sp)
        single.add_request(req)
        _drive(single)
        assert got[req.request_id] == _collect(req)

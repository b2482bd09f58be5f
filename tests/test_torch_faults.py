"""Fault isolation, token replay and the dispatch watchdog: the port
(``arks_tpu_torch/engine/faults.py`` and the engine's recovery) against the
reference's (``arks_tpu/engine/faults.py``, ``_recover_from_fault``).

The same scripted ``ARKS_FAULT_INJECT`` scenarios (``tests/test_chaos.py``)
run through the JAX engine and the port's, on the slot cache (legacy
scheduler) and the paged mixed scheduler, at pipeline depths 0 and 2, on
f32 ``tiny`` with one set of weights.  Both engines are driven step by step
from one thread through the engine thread's own step/recover contract.  The
port's recovered streams must equal its fault-free run and the JAX
engine's faulted run (ids and finish reasons), with equal fault, recovered
and quarantined counts and the same final state.
"""

import ast
import contextlib
import os
import pathlib
import time

import jax
import numpy as np
import pytest
import torch

from arks_tpu.engine import EngineConfig as JaxEngineConfig
from arks_tpu.engine import InferenceEngine as JaxEngine
from arks_tpu.engine import Request as JaxRequest
from arks_tpu.engine import SamplingParams as JaxSamplingParams
from arks_tpu.engine import faults as ref_faults
from arks_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from arks_tpu.models import get_config as jax_get_config
from arks_tpu.models import transformer as jtf
from arks_tpu_torch.engine import (EngineConfig, InferenceEngine, Request,
                                   SamplingParams)
from arks_tpu_torch.engine import engine as engine_mod
from arks_tpu_torch.engine import faults
from arks_tpu_torch.engine.tokenizer import ByteTokenizer
from arks_tpu_torch.models import get_config
from arks_tpu_torch.models import moe as tmoe
from arks_tpu_torch.models.weights import params_from_numpy

torch.set_num_threads(2)

NAME = "tiny"
KW = dict(num_slots=2, max_cache_len=64, prefill_buckets=(8, 16, 32),
          steps_per_dispatch=4, prefill_chunk=16, dtype="float32")
# (layout, ARKS_MIXED_STEP) per scheduler.
LAYOUTS = {"slot": ("slot", "0"), "paged-mixed": ("paged", "1")}
CASES = [(lay, depth) for lay in LAYOUTS for depth in (0, 2)]
ENV = ("ARKS_PIPELINE_DEPTH", "ARKS_MIXED_STEP", "ARKS_FAULT_INJECT",
       "ARKS_FAULT_RETRIES", "ARKS_OVERLAP_DECODE", "ARKS_TRACE")


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


@pytest.fixture(scope="module")
def weights():
    jparams = jtf.init_params(jax_get_config(NAME), jax.random.PRNGKey(3),
                              jax.numpy.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                get_config(NAME), "cpu")
    return jparams, tparams


def _case_env(layout: str, depth: int, **kv) -> dict:
    return dict(ARKS_PIPELINE_DEPTH=depth,
                ARKS_MIXED_STEP=LAYOUTS[layout][1],
                ARKS_OVERLAP_DECODE="0", **kv)


def port_engine(weights, layout, depth, **kv):
    with _env(**_case_env(layout, depth, **kv)):
        return InferenceEngine(get_config(NAME), EngineConfig(
            model=NAME, kv_layout=LAYOUTS[layout][0], **KW),
            ByteTokenizer(), params=weights[1], device="cpu")


@pytest.fixture(scope="module")
def jax_engines(weights):
    """One JAX engine per case, reused by every scenario (its programs
    compile once); each scenario arms a fresh injector."""
    out = {}
    for layout, depth in CASES:
        with _env(**_case_env(layout, depth)):
            eng = JaxEngine(jax_get_config(NAME), JaxEngineConfig(
                model=NAME, kv_layout=LAYOUTS[layout][0], **KW),
                JaxByteTokenizer(), params=weights[0])
        if depth:
            assert eng._pipe_warm_wait(300) == "ready"
        out[(layout, depth)] = eng
    return out


def _busy(eng) -> bool:
    return bool(eng.num_running or not eng._queue.empty() or eng._prefilling
                or eng._awaiting_restore or eng.state != "serving")


def _drive(eng, n_steps=1500, hook=None):
    """The engine thread's step/recover contract, synchronously; ``hook``
    runs after each step until it returns True."""
    for _ in range(n_steps):
        try:
            eng.step(block_s=0.005)
        except Exception as e:  # noqa: BLE001 — routed like the run loop
            eng._recover_from_fault(e)
        if hook is not None and hook(eng):
            hook = None
        if hook is None and not _busy(eng):
            return
    raise AssertionError("engine did not drain")


def _collect(req):
    ids, fin = [], None
    while True:
        out = req.outputs.get(timeout=60)
        ids.extend(out.token_ids)
        if out.finished:
            return ids, out.finish_reason, out.error


def _requests(rq, sp, scenario):
    """The scenario's workload (``tests/test_chaos.py``'s), as requests of
    one package; request ids carry the scenario (the JAX engines serve
    every scenario of a case)."""
    if scenario == "chunk":
        # Beyond the largest one-shot bucket (32): the legacy scheduler
        # chunk-prefills it beside a decoding stream.
        specs = [([5, 6, 7], dict(max_tokens=14, temperature=0.0)),
                 ([7] * 40, dict(max_tokens=6, temperature=0.0))]
    elif scenario == "abort":
        specs = [([5, 6, 7], dict(max_tokens=40, temperature=0.0)),
                 ([9, 9], dict(max_tokens=6, temperature=0.0))]
    else:
        specs = [(p, dict(max_tokens=14,
                          temperature=0.0 if i % 2 == 0 else 0.9,
                          top_p=0.9, top_k=40, seed=21 + i))
                 for i, p in enumerate([[5, 6, 7], [9] * 5])]
    return [rq(f"{scenario}-{i}", p, sp(ignore_eos=True, **kw))
            for i, (p, kw) in enumerate(specs)]


# name -> (ARKS_FAULT_INJECT, ARKS_FAULT_RETRIES)
SCENARIOS = {
    "decode": ("decode:3:runtime", 1),
    "quarantine": ("decode:3:runtime,replay:1:runtime", 1),
    "zero_retry": ("decode:3:runtime", 0),
    "admit_resolve": ("admit_resolve:1:runtime", 1),
    "chunk": ("chunk:1:runtime", 1),
    "abort": ("", 1),
}


def _abort_hook(eng):
    """Once a stream decodes: abort it and force a step fault before the
    scheduler can consume the abort on the normal path."""
    if not eng._slots:
        return False
    eng.abort("abort-0")
    eng._faults.arm("decode:1:runtime")
    return True


def _counts(eng):
    m = eng.metrics
    return (m.engine_faults_total.total(), m.requests_recovered_total.total(),
            m.requests_quarantined_total.total(),
            sum(n for _, _, n in m.engine_recovery_seconds._data.values()))


def _run(eng, rq, sp, fault_cls, scenario, inject=True):
    spec, retries = SCENARIOS[scenario]
    eng._faults = fault_cls(spec if inject else "")
    eng._fault_retries = retries
    eng._consec_faults = 0
    before = _counts(eng)
    reqs = _requests(rq, sp, scenario)
    for r in reqs:
        eng.add_request(r)
    _drive(eng, hook=_abort_hook if inject and scenario == "abort" else None)
    got = [_collect(r) for r in reqs]
    return got, [a - b for a, b in zip(_counts(eng), before)], eng.state


@pytest.mark.parametrize("layout,depth", CASES,
                         ids=[f"{lay}-{d}" for lay, d in CASES])
def test_recovered_streams_equal_reference_and_fault_free(
        weights, jax_engines, layout, depth):
    """Every scenario on one case: the port's faulted run equals the JAX
    engine's faulted run (streams, finish reasons, error codes, fault /
    recovered / quarantined / recovery counts, final state), and each of
    its surviving streams equals the port's own fault-free run."""
    jeng = jax_engines[(layout, depth)]
    for scenario in SCENARIOS:
        want, jcounts, jstate = _run(jeng, JaxRequest, JaxSamplingParams,
                                     ref_faults.FaultInjector, scenario)
        base, _, _ = _run(port_engine(weights, layout, depth), Request,
                          SamplingParams, faults.FaultInjector, scenario,
                          inject=False)
        eng = port_engine(weights, layout, depth)
        ptrs = [t.data_ptr() for t in eng.cache if t is not None]
        got, counts, state = _run(eng, Request, SamplingParams,
                                  faults.FaultInjector, scenario)
        tag = f"{layout}-{depth} {scenario}"
        # Streams that end early (quarantined, aborted) hold the tokens
        # delivered before their end, which depend on when results land
        # (the JAX engine's dispatches run asynchronously; on the CPU the
        # port's are ready at once): a prefix of the fault-free stream.
        # Every other stream is whole.
        assert [(fin, err and err.split(":")[0]) for _, fin, err in got] == \
            [(fin, err and err.split(":")[0]) for _, fin, err in want], tag
        assert [err for *_, err in got] == [err for *_, err in want], tag
        assert counts == jcounts and state == jstate == "serving", \
            (tag, counts, jcounts)
        for (ids, fin, _), (jids, _, _), (bids, bfin, _) in zip(got, want,
                                                                base):
            if fin in ("error", "abort"):
                assert ids == bids[:len(ids)], tag
                assert jids == bids[:len(jids)], tag
            else:
                assert (ids, fin) == (jids, fin) == (bids, bfin), tag
        if scenario in ("decode", "quarantine"):
            assert counts[0] >= 1, tag
        # No second pool: the recovery zeroed the same tensors in place.
        assert [t.data_ptr() for t in eng.cache if t is not None] == ptrs


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_engine_is_freed_after_a_fault_and_a_replay_without_a_gc_pass(
        weights, layout):
    """A recovery leaves no reference cycle through the engine (a replay
    gate, a survivor, a StepFault's traceback): after a fault, a replay
    and a quarantine, an engine dropped by ``del`` frees its pool at once
    (a cycle would keep it, and the weights, alive until a GC pass)."""
    import gc
    import logging
    import weakref
    gc.collect()
    gc.disable()
    # The test runner's log capture keeps every record, and a record's
    # exc_info keeps the frames of the fault (and the engine in them).
    logging.disable(logging.CRITICAL)
    try:
        eng = port_engine(weights, layout, 2)
        _, counts, state = _run(eng, Request, SamplingParams,
                                faults.FaultInjector, "quarantine")
        assert counts[0] == 2 and counts[2] == 1 and state == "serving"
        ref = weakref.ref(eng)
        del eng
        assert ref() is None
    finally:
        logging.disable(logging.NOTSET)
        gc.enable()


def test_recovery_keeps_the_pool_and_zeroes_it(weights):
    """The recovery reset allocates no second pool: the pool's tensors are
    the same objects, zeroed in place; the allocator and tables start
    empty; the sampling rows are those of a fresh engine."""
    eng = port_engine(weights, "paged-mixed", 0)
    fresh = port_engine(weights, "paged-mixed", 0)
    ptrs = [t.data_ptr() for t in eng.cache if t is not None]
    r = Request("x", [5, 6, 7], SamplingParams(max_tokens=30, temperature=0.9,
                                               seed=4, ignore_eos=True))
    eng.add_request(r)
    for _ in range(5):
        eng.step(block_s=0.005)
    assert eng._slots and eng.cache.k.abs().sum() > 0
    eng._reset_device_state()
    assert [t.data_ptr() for t in eng.cache if t is not None] == ptrs
    assert all(not t.any() for t in eng.cache if t is not None)
    assert eng._alloc.free_pages == eng._alloc.num_pages
    for a, b in zip(eng._sampling, fresh._sampling):
        assert torch.equal(a, b)


def test_replay_repeats_the_original_prefill_shape(weights, monkeypatch):
    """A replayer's prefill repeats its original's shape: on the mixed
    scheduler its prompt is cut into the recorded chunks (the others share
    the rest of the budget), on the legacy one its one-shot batch is padded
    back to the recorded size; the streams are those of a plain run."""
    seen = {}
    real = engine_mod.InferenceEngine._register_slot

    def spy(self, req, slot, first, num_prompt, first_lp=None, shape=None):
        seen[req.request_id] = shape
        return real(self, req, slot, first, num_prompt, first_lp, shape)

    monkeypatch.setattr(engine_mod.InferenceEngine, "_register_slot", spy)
    greedy = dict(max_tokens=6, temperature=0.0, ignore_eos=True)
    streams = {}
    for planned in (False, True):
        eng = port_engine(weights, "paged-mixed", 0)
        if planned:
            eng._replay_shape["a"] = engine_mod._ReplayShape(
                takes=(10, 10, 10, 10))
        reqs = [Request(n, [3 + i] * 40, SamplingParams(**greedy))
                for i, n in enumerate("ab")]
        streams[planned] = _run_requests(eng, reqs)
    assert seen["a"].takes == (10, 10, 10, 10)
    assert seen["b"].takes[0] == 6 and sum(seen["b"].takes) == 40
    assert streams[True] == streams[False]
    shapes = []
    real_prefill = engine_mod.tf.prefill

    def prefill(params, cfg, tokens, lengths):
        shapes.append(tuple(tokens.shape))
        return real_prefill(params, cfg, tokens, lengths)

    monkeypatch.setattr(engine_mod.tf, "prefill", prefill)
    for planned in (False, True):
        eng = port_engine(weights, "slot", 0)
        if planned:
            eng._replay_shape["x"] = engine_mod._ReplayShape(admit_m=4)
        streams[planned] = _run_requests(eng, [Request(
            "x", [5, 6, 7], SamplingParams(**greedy))])
    assert [m for m, _ in shapes] == [1, 4] and seen["x"].admit_m == 4
    assert streams[True] == streams[False]


def _run_requests(eng, reqs):
    for r in reqs:
        eng.add_request(r)
    _drive(eng)
    return [_collect(r) for r in reqs]


def test_tracing_off_gives_the_same_recovered_streams(weights):
    """ARKS_TRACE=0 and 1 give the same recovered streams and counts."""
    runs = []
    for trace in ("0", "1"):
        eng = port_engine(weights, "paged-mixed", 2, ARKS_TRACE=trace)
        assert eng.trace.enabled == (trace == "1")
        runs.append(_run(eng, Request, SamplingParams, faults.FaultInjector,
                         "quarantine")[:2])
    assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# Units: the injector, classify, the sticky-error rule
# ---------------------------------------------------------------------------


def _outcome(fn):
    try:
        fn()
        return None
    except Exception as e:  # noqa: BLE001 — compared across packages
        return type(e).__name__, str(e)


@pytest.mark.parametrize("spec", [
    "decode:2:runtime, replay:1:oom", "decode:x:runtime", "decode:0:runtime",
    "decode:1:nope", "decode:1", "", "chunk:1:value,admit:2:runtime",
    "spec:1:runtime,resize:3:oom", " , decode:1:runtime"])
def test_injector_parses_and_fires_as_the_reference(spec):
    """The same spec through both injectors: the same refusal, or the same
    firing sequence over the same phase calls (each entry fires once)."""
    got, want = (_outcome(lambda: faults.FaultInjector(spec)),
                 _outcome(lambda: ref_faults.FaultInjector(spec)))
    assert got == want
    if got is not None:
        return
    a, b = faults.FaultInjector(spec), ref_faults.FaultInjector(spec)
    assert a.active == b.active
    for phase in ["decode", "replay", "decode", "chunk", "admit", "admit",
                  "decode", "spec", "resize", "resize", "resize", "replay"]:
        assert _outcome(lambda: a.fire(phase)) == \
            _outcome(lambda: b.fire(phase)), (spec, phase)


def test_classify_and_sticky_errors():
    cases = [RuntimeError("x"), ValueError("v"), KeyError("k"),
             IndexError("i"), TypeError("t"), OSError("io"), MemoryError(),
             RuntimeError("RESOURCE_EXHAUSTED: out of memory"),
             faults.InjectedFault("boom")]
    for e in cases:
        ref_e = ref_faults.InjectedFault(str(e)) \
            if isinstance(e, faults.InjectedFault) else e
        assert faults.classify(e) == ref_faults.classify(ref_e), e
    sf = faults.StepFault("decode", "oom", culprits=["a"])
    assert faults.classify(sf) == "oom" and sf.culprits == ("a",)
    assert faults.classify(torch.cuda.OutOfMemoryError("CUDA out of "
                                                       "memory")) == "oom"
    assert faults.STATE_CODES == ref_faults.STATE_CODES
    sticky = RuntimeError("CUDA error: device-side assert triggered")
    wrapped = faults.StepFault("decode", "runtime")
    wrapped.__cause__ = sticky
    assert faults.is_sticky(sticky) and faults.is_sticky(wrapped)
    assert faults.is_sticky(RuntimeError(
        "CUDA error: an illegal memory access was encountered"))
    for benign in (RuntimeError("x"), faults.InjectedFault("decode:1"),
                   torch.cuda.OutOfMemoryError("CUDA out of memory"),
                   ValueError("device-side assert")):
        assert not faults.is_sticky(benign), benign


# ---------------------------------------------------------------------------
# The watchdog and the sticky-error exit
# ---------------------------------------------------------------------------


def _wait(cond, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.01)


def test_watchdog_escalates_on_an_injected_hang(weights, monkeypatch):
    """A ``hang`` in a decode dispatch outlives ARKS_DISPATCH_DEADLINE_S:
    the watchdog flips the state to "wedged" and exits 70 (through the
    injected exit function)."""
    monkeypatch.setenv("ARKS_FAULT_HANG_S", "1.5")
    monkeypatch.setenv("ARKS_DISPATCH_DEADLINE_S", "0.2")
    eng = port_engine(weights, "paged-mixed", 0,
                      ARKS_FAULT_INJECT="decode:2:hang")
    codes = []
    eng._exit_fn = codes.append
    eng.start()
    try:
        eng.add_request(Request("h", [5, 6, 7], SamplingParams(
            max_tokens=6, temperature=0.0, ignore_eos=True)))
        _wait(lambda: codes)
        assert codes == [70] and eng.state == "wedged"
        assert eng.metrics.engine_state.get() == faults.STATE_WEDGED
    finally:
        eng.stop()


def test_watchdog_quiet_while_healthy(weights, monkeypatch):
    monkeypatch.setenv("ARKS_DISPATCH_DEADLINE_S", "1.0")
    eng = port_engine(weights, "slot", 2)
    codes = []
    eng._exit_fn = codes.append
    eng.start()
    try:
        reqs = [Request(f"q{i}", [5, 6, 7 + i], SamplingParams(
            max_tokens=12, temperature=0.0, ignore_eos=True))
            for i in range(3)]
        for r in reqs:
            eng.add_request(r)
        assert [_collect(r)[1] for r in reqs] == ["length"] * 3
        time.sleep(0.3)
        assert not codes and eng.state == "serving"
        assert eng._watchdog is not None
    finally:
        eng.stop()


@pytest.mark.parametrize("layout", ["slot", "paged-mixed"])
def test_sticky_error_fails_in_flight_and_exits_70(weights, layout,
                                                   monkeypatch):
    """A device-side assert inside a step (the text a sticky CUDA error
    carries) cannot be recovered in-process: every request in flight and
    queued ends with an engine_fault error, the state is "wedged", and
    the engine exits 70."""
    eng = port_engine(weights, layout, 0)
    codes = []
    eng._exit_fn = codes.append
    monkeypatch.setattr(engine_mod.time, "sleep", lambda s: None)
    real = engine_mod._HostCopy.result
    calls = []

    def result(self):
        # A sticky error surfaces where the host reads a dispatch's
        # results (an asynchronous kernel failure).
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("CUDA error: device-side assert triggered")
        return real(self)

    monkeypatch.setattr(engine_mod._HostCopy, "result", result)
    reqs = [Request(f"s{i}", [5, 6, 7 + i], SamplingParams(
        max_tokens=20, temperature=0.0, ignore_eos=True)) for i in range(3)]
    for r in reqs:
        eng.add_request(r)
    for _ in range(200):
        try:
            eng.step(block_s=0.005)
        except Exception as e:  # noqa: BLE001 — routed like the run loop
            eng._recover_from_fault(e)
        if codes:
            break
    assert codes == [70] and eng.state == "wedged"
    outs = [_collect(r) for r in reqs]
    assert [(fin, err) for _, fin, err in outs] == \
        [("error", "engine_fault: device/wedged")] * 3
    assert eng.metrics.engine_faults_total.total() == 0


# ---------------------------------------------------------------------------
# Static guard
# ---------------------------------------------------------------------------


# The reference's fault API (``arks_tpu/analysis/rules/exceptions.py``
# FAULT_API): a broad handler that calls one of these routes the fault.
FAULT_API = {"swallowed", "StepFault", "classify", "_recover_from_fault",
             "_exit"}
# The reference's reviewed exceptions (``tools/arkslint-baseline.json``),
# for the port's copies of the same handlers.
REVIEWED = {
    # The fault API's last line of defense: failures are classified and
    # re-dispatched (into the next recovery round) or fatal.
    ("engine.py", "InferenceEngine._recover_from_fault"),
    # The compile worker isolates guide failures: the error is recorded on
    # the job and surfaced to the waiting request.
    ("guides.py", "GuideCompiler._compile_job"),
}


def _handler_ok(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else \
                getattr(f, "id", "")
            if name in FAULT_API:
                return True
    return False


def _broad_handlers(tree):
    """(qualname, handler) of every broad handler of a module."""
    out = []

    def visit(node, scope):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                visit(child, scope + [child.name])
                continue
            if isinstance(child, ast.ExceptHandler):
                t = child.type
                if t is None or (isinstance(t, ast.Name) and t.id in (
                        "Exception", "BaseException")):
                    out.append((".".join(scope), child))
            visit(child, scope)

    visit(tree, [])
    return out


def test_no_silent_swallows_in_the_port_engine_package():
    """Every broad handler (``except Exception``/``BaseException``/bare
    ``except``) under arks_tpu_torch/engine/ re-raises or routes through
    the fault API (``faults.swallowed``, a StepFault, the recovery entry,
    the exit), as tests/test_fault_guard.py requires of the reference's
    engine package; the two reviewed handlers are the reference's own
    reviewed exceptions."""
    root = pathlib.Path(__file__).resolve().parents[1] / "arks_tpu_torch" \
        / "engine"
    bad, reviewed = [], set()
    for path in sorted(root.glob("*.py")):
        for qual, node in _broad_handlers(ast.parse(path.read_text())):
            if _handler_ok(node):
                continue
            if (path.name, qual) in REVIEWED:
                reviewed.add((path.name, qual))
                continue
            bad.append(f"{path.name}:{node.lineno} ({qual})")
    assert not bad, bad
    assert reviewed == REVIEWED, "a reviewed handler moved: shrink the list"


def test_replay_gate_suppresses_and_verifies():
    """The gate drops what the client already received, forwards the rest,
    and fails the request once on the first divergent token."""
    import queue

    from arks_tpu_torch.engine.types import RequestOutput

    class _Eng:
        def __init__(self):
            self.aborted = []

        def abort(self, rid):
            self.aborted.append(rid)

    inner, eng = queue.Queue(), _Eng()
    gate = engine_mod._ReplayGate(inner, eng, "g", [4, 5, 6, 7], 3)
    gate.put(RequestOutput("g", [4]))
    gate.put(RequestOutput("g", [5, 6, 7]))
    gate.put(RequestOutput("g", [8], finished=True, finish_reason="length"))
    assert [o.token_ids for o in list(inner.queue)] == [[7], [8]]
    gate2 = engine_mod._ReplayGate(inner, eng, "h", [4, 5], 2)
    gate2.put(RequestOutput("h", [4, 9]))
    gate2.put(RequestOutput("h", [1], finished=True))
    last = list(inner.queue)[-1]
    assert last.error == "engine_fault: replay_diverged"
    assert eng.aborted == ["h"] and len(inner.queue) == 3


# ---------------------------------------------------------------------------
# A decode row's bits do not depend on the step form
# ---------------------------------------------------------------------------


def _step_logits(monkeypatch, name):
    """Record every logits tensor ``name`` (a transformer entry point the
    engine calls) returns, with the call's ``split``."""
    seen = []
    real = getattr(engine_mod.tf, name)

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append((kw.get("split"), out.clone()))
        return out

    monkeypatch.setattr(engine_mod.tf, name, spy)
    return seen


def _moe_routes(monkeypatch):
    """Record (rows, grouped) of every MoE FFN call."""
    seen = []
    real = tmoe.moe_ffn

    def spy(x, *args, grouped, **kw):
        seen.append((x.numel() // x.shape[-1], grouped))
        return real(x, *args, grouped=grouped, **kw)

    monkeypatch.setattr(tmoe, "moe_ffn", spy)
    return seen


def _decoding_engine(name, dtype, layout, **kw):
    """An engine of ``layout`` at depth 0 with three greedy streams
    decoding (its own seeded weights)."""
    with _env(**_case_env(layout, 0)):
        eng = InferenceEngine(get_config(name), EngineConfig(
            model=name, kv_layout=LAYOUTS[layout][0], **dict(
                KW, num_slots=4, dtype=dtype, **kw)),
            ByteTokenizer(), device="cpu")
    for i in range(3):
        eng.add_request(Request(f"d{i}", [5 + i, 6, 7, 8 + i], SamplingParams(
            max_tokens=40, temperature=0.0, ignore_eos=True)))
    for _ in range(50):
        eng.step(block_s=0.001)
        if len(eng._slots) == 3:
            break
    eng.step(block_s=0.001)
    assert len(eng._slots) == 3
    return eng


@pytest.mark.parametrize("name,dtype,chunk", [
    ("tiny", "float32", 16), ("tiny", "bfloat16", 16),
    ("tiny-moe", "float32", 64)])
def test_decode_lane_bits_equal_in_pipe_and_chunk_steps(monkeypatch, name,
                                                        dtype, chunk):
    """A decode lane's logits from the pipe step (``mixed_pipe``, B rows)
    equal, bit for bit, its logits from the classic mixed step that
    carries a prefill chunk beside it (the decode block of B rows, then
    the chunk block): what lets a replay decode in other step forms than
    its original.  ``tiny-moe`` with a 64-token budget runs its chunk
    block grouped and its decode block dense, as the pipe step does
    (each MoE FFN call's rows and route recorded).  A chunk's rows, too,
    get the same bits beside decode lanes and in an idle engine's step
    (the same split, no decode lane): its completing lane's logits are
    equal."""
    eng = _decoding_engine(name, dtype, "paged-mixed",
                           max_cache_len=chunk * 4, prefill_chunk=chunk)
    eng.add_request(Request("long", [9] * (chunk * 2 + 3), SamplingParams(
        max_tokens=4, temperature=0.0, ignore_eos=True)))
    eng._admit()
    assert eng._prefilling
    pool = [t for t in eng.cache if t is not None]
    before = [t.clone() for t in pool]
    seen = _step_logits(monkeypatch, "mixed_step")
    routes = _moe_routes(monkeypatch)
    eng._issue_mixed()
    classic_routes = list(routes)
    routes.clear()
    for t, b in zip(pool, before):
        t.copy_(b)
    eng._pipe_issue()
    (split, classic), (none, pipe) = seen
    n, layers = eng.ecfg.num_slots, eng.cfg.num_layers
    assert split == n and none is None
    dec = [(n, False)] if name == "tiny-moe" else []
    assert routes == dec * layers
    assert classic_routes == (dec + [(chunk, True)] * len(dec)) * layers
    for slot in eng._slots:
        assert torch.equal(classic[slot], pipe[slot]), slot

    short = [11, 12, 13] * (chunk // 4)
    first = {}
    for idle in (False, True):
        if idle:
            with _env(**_case_env("paged-mixed", 0)):
                eng = InferenceEngine(get_config(name), EngineConfig(
                    model=name, kv_layout="paged", **dict(
                        KW, num_slots=4, dtype=dtype,
                        max_cache_len=chunk * 4, prefill_chunk=chunk)),
                    ByteTokenizer(), device="cpu")
            eng._free = [1, 2, 3, 0]    # the slot the busy engine gives
        else:
            eng = _decoding_engine(name, dtype, "paged-mixed",
                                   max_cache_len=chunk * 4,
                                   prefill_chunk=chunk)
        eng.add_request(Request(f"short-{idle}", short, SamplingParams(
            max_tokens=4, temperature=0.0, ignore_eos=True)))
        eng._admit()
        (slot,) = eng._prefilling
        seen.clear()
        eng._issue_mixed()
        ((split, logits),) = seen
        assert split == n
        first[idle] = (slot, logits[slot])
    assert first[True][0] == first[False][0] == 0
    assert torch.equal(first[True][1], first[False][1])


def test_legacy_decode_lane_bits_equal_in_both_step_forms(monkeypatch):
    """A legacy lane's logits from ``_issue_decode``'s steps
    (``decode_step``) equal those from ``decode_pipe``'s
    (``decode_state_step``), step for step: both run all B lanes."""
    eng = _decoding_engine("tiny", "float32", "slot")
    pool = [t for t in eng.cache if t is not None]
    before = [t.clone() for t in pool]
    seen = _step_logits(monkeypatch, "decode_step")
    eng._issue_decode()
    for t, b in zip(pool, before):
        t.copy_(b)
    seen_pipe = _step_logits(monkeypatch, "decode_state_step")
    eng._pipe_issue()
    k = eng.ecfg.steps_per_dispatch
    assert len(seen_pipe) == k
    for (_, a), (_, b) in zip(seen[:k], seen_pipe):
        for slot in eng._slots:
            assert torch.equal(a[slot], b[slot]), slot


def _drive_late(eng, reqs, late):
    """Add ``reqs``, then ``late`` once a stream decodes; drive until all
    ended.  Returns {rid: (ids, finish reason, error)}."""
    for r in reqs:
        eng.add_request(r)
    for _ in range(3000):
        try:
            eng.step(block_s=0.001)
        except Exception as e:  # noqa: BLE001 — routed like the run loop
            eng._recover_from_fault(e)
        if late and eng._slots:
            for r in late:
                eng.add_request(r)
            late = []
        if not late and not _busy(eng):
            return {r.request_id: _collect(r) for r in reqs}
    raise AssertionError("engine did not drain")


def test_restore_fault_replay_streams_whole_equal(weights):
    """The restore round on the mixed engine at depth 2: a two-page prefix
    is spilled to the host tier, then requested again beside a decoding
    seeded bystander, once fault-free and once with ``restore:1:runtime``.
    The fault replays the bystander, whose replay decodes in pipe steps
    where its original decoded beside the restoring request's chunks; its
    whole stream, past the gate's checked prefix too, equals the
    fault-free round's."""
    eng = port_engine(weights, "paged-mixed", 2)
    page = eng._page
    prefix = [int(x) for x in np.random.default_rng(13).integers(
        32, 120, 2 * page)]
    digests = engine_mod.chain_digests(prefix, page, 2)
    _drive_late(eng, [Request("warm", prefix + [65, 66, 67], SamplingParams(
        max_tokens=8, temperature=0.0, ignore_eos=True))], [])
    rounds = []
    for rnd, inject in enumerate(("", "restore:1:runtime")):
        alloc = eng._alloc
        alloc.decref(alloc.alloc(alloc.free_pages + alloc.retained_pages))
        eng._spill_flush()
        for _ in range(100):
            if not eng._spills:
                break
            eng.step(block_s=0.001)
        assert all(eng._host.peek(d) is not None for d in digests)
        eng._faults = faults.FaultInjector(inject)
        faults0 = eng.metrics.engine_faults_total.total()
        by = Request(f"by-{rnd}", [11, 12, 13, 14, 15], SamplingParams(
            max_tokens=40, temperature=0.8, top_k=50, seed=77,
            ignore_eos=True))
        victim = Request(f"victim-{rnd}", prefix + [70, 71, 72, 73],
                         SamplingParams(max_tokens=8, temperature=0.0,
                                        ignore_eos=True))
        got = _drive_late(eng, [by, victim], [])
        rounds.append((got[by.request_id], got[victim.request_id],
                       eng.metrics.engine_faults_total.total() - faults0))
    (by0, v0, f0), (by1, v1, f1) = rounds
    assert (f0, f1) == (0, 1)
    assert eng.metrics.engine_faults_total.get(phase="restore",
                                               kind="injected") == 1
    assert by0[1:] == by1[1:] == ("length", None) and len(by0[0]) == 40
    assert by1 == by0 and v1 == v0

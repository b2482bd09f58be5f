"""Request tracing, the flight recorder and the profiler windows: the port
(``arks_tpu_torch/obs/``) against the reference's (``arks_tpu/obs/``), and
the port's server surface for them.

- **Unit parity**: the same inputs through both packages' ``TraceCtx``,
  ``Tracer`` and ``TraceStore`` give the same results (times and minted
  ids aside): W3C round trips and refusals, span assembly, tail-based
  retention, store eviction, pending GC, the flight recorder, the Chrome
  export.
- **Byte identity**: the same workload with ``ARKS_TRACE=1`` and ``0``
  gives identical streams on both schedulers at depths 0 and 2.
- **Server**: ``/v1/traces``, ``/v1/traces/{id}`` (404 when unknown),
  ``/v1/traces/export``, ``/v1/profiler/start|stop``, readiness 503
  "recovering" during a recovery, and a faulted request's trace retained
  with its replay event and the flight tail.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from arks_tpu.obs import perfetto as ref_perfetto
from arks_tpu.obs import trace as ref_trace
from arks_tpu_torch.engine import (EngineConfig, InferenceEngine, Request,
                                   SamplingParams)
from arks_tpu_torch.engine.tokenizer import ByteTokenizer
from arks_tpu_torch.models import get_config
from arks_tpu_torch.obs import logctx
from arks_tpu_torch.obs import perfetto as port_perfetto
from arks_tpu_torch.obs import profiler as port_profiler
from arks_tpu_torch.obs import trace as port_trace
from arks_tpu_torch.server.openai_server import OpenAIServer

torch.set_num_threads(2)

MODS = (ref_trace, port_trace)


# ----------------------------------------------------------- W3C context

@pytest.mark.parametrize("bad", [
    None, "", "garbage", "00-abc-def-01",
    "00-" + "g" * 32 + "-" + "1" * 16 + "-01",
    "00-" + "0" * 32 + "-" + "1" * 16 + "-01",
    "00-" + "1" * 32 + "-" + "0" * 16 + "-01",
    "00-" + "1" * 31 + "-" + "1" * 16 + "-01",
    "01-" + "a" * 32 + "-" + "b" * 16 + "-00",
    " 00-" + "a" * 32 + "-" + "b" * 16 + "-01 "])
def test_traceparent_parse_as_the_reference(bad):
    """The same header parses (or is refused) the same way, the parent
    link and flags kept, and the next hop's context keeps the trace."""
    got, want = port_trace.TraceCtx.parse(bad), ref_trace.TraceCtx.parse(bad)
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.trace_id, got.parent_id, got.flags) == \
            (want.trace_id, want.parent_id, want.flags)
        child = got.child()
        assert child.trace_id == got.trace_id and \
            child.parent_id == got.span_id
        assert child.traceparent().split("-")[1] == got.trace_id


def test_from_headers_and_spans_header_as_the_reference():
    root = ref_trace.TraceCtx()
    spans = [{"component": "gateway", "name": "gateway.admit",
              "start": 1.0, "end": 2.0}, "junk", {"component": "router"}]
    for headers in (
            {"traceparent": root.traceparent(),
             "x-arks-trace-spans": json.dumps(spans)},
            {"x-arks-trace-spans": "not json"},
            {"x-arks-trace-spans": json.dumps({"a": 1})}, {}):
        got = port_trace.TraceCtx.from_headers(headers)
        want = ref_trace.TraceCtx.from_headers(headers)
        assert got.upstream == want.upstream
        assert (got.trace_id == root.trace_id) == \
            (want.trace_id == root.trace_id)
        assert got.parent_id == want.parent_id
    assert port_trace.spans_header(spans[:1]) == \
        ref_trace.spans_header(spans[:1])
    assert (port_trace.TRACEPARENT_HEADER, port_trace.SPANS_HEADER) == \
        (ref_trace.TRACEPARENT_HEADER, ref_trace.SPANS_HEADER)


# ------------------------------------------------------------ the tracer

def _tracers(monkeypatch, **env):
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))
    return [m.Tracer() for m in MODS]   # collectors not started


def _shape(trace):
    """A trace without its times and minted ids."""
    if trace is None:
        return None
    return {"request_id": trace["request_id"], "tier": trace["tier"],
            "flags": trace["flags"], "parent_id": trace["parent_id"],
            "tail": trace["flight_tail"] and [
                (e["rid"], e["name"], e["ph"], e["arg"])
                for e in trace["flight_tail"]],
            "spans": sorted((s["name"], s["component"], str(s.get("arg")),
                             s["end"] is None) for s in trace["spans"])}


def _script(tr, ctx_cls):
    """Lifecycle events of five requests: a clean one with a tier and a
    caller context, a faulted one with a pinned flight tail, a quarantined
    one, an SLO violator, one parked at an open span; engine-scope pipe
    and recover spans overlapping them, and phase markers."""
    ctx = ctx_cls(trace_id="a" * 32, parent_id="b" * 16, upstream=[
        {"component": "gateway", "name": "gateway.admit", "start": 0.5,
         "end": 0.6}])
    tr.register("clean", ctx=ctx, tier="gold")
    tr.register("faulty")
    tr.evt("clean", "queue", "B")
    tr.evt("", "phase.mixed", "B")
    tr.evt("clean", "queue", "E")
    tr.evt("clean", "prefill", "B", 7)
    tr.evt("", "pipe", "B", 1)
    tr.evt("clean", "prefill", "E")
    tr.evt("clean", "first_token", "I", 0.01)
    tr.evt("", "pipe", "E", 2)
    tr.evt("", "phase.mixed", "E")
    tr.evt("faulty", "queue", "B")
    tr.evt("", "recover", "B", "decode/injected")
    tr.evt("faulty", "fault", "I", "decode/injected")
    tr.attach_tail("faulty", [{"t": 1.0, "rid": "x", "name": "n", "ph": "I",
                               "arg": None, "thread": "t"}])
    tr.evt("faulty", "replay", "I", 3)
    tr.evt("", "recover", "E")
    tr.evt("quar", "queue", "B")
    tr.evt("quar", "quarantined", "I", "engine_fault: decode/injected")
    tr.evt("slow", "slo_violation", "I", (120.0, 100.0))
    tr.evt("slow", "finish", "I", "stop")
    tr.evt("parked", "park.guide", "B")
    tr.evt("clean", "finish", "I", "length")
    tr.evt("faulty", "finish", "I", "length")


@pytest.mark.parametrize("sample", ["1.0", "0.0"])
def test_tracer_assembly_and_retention_as_the_reference(monkeypatch,
                                                        sample):
    """The same events through both tracers: the same assembled traces
    (spans, flags, tiers, parent links, pinned tails), the same tail-based
    retention at sample rates 1 and 0, the same phase spans and flight
    recorder tail."""
    trs = _tracers(monkeypatch, ARKS_TRACE="1", ARKS_TRACE_SAMPLE=sample)
    for tr, m in zip(trs, MODS):
        _script(tr, m.TraceCtx)
        tr.flush()
    got, want = trs[1], trs[0]
    for rid in ("clean", "faulty", "quar", "slow", "parked", "nobody"):
        assert _shape(got.store.get(rid)) == _shape(want.store.get(rid)), rid
    if sample == "1.0":
        assert got.store.get("a" * 32)["request_id"] == "clean"
    assert len(got.store) == len(want.store)
    assert [(s["name"], s["arg"]) for s in got.phase_spans()] == \
        [(s["name"], s["arg"]) for s in want.phase_spans()]
    assert [(e["rid"], e["name"], e["ph"], e["arg"]) for e in got.tail(8)] \
        == [(e["rid"], e["name"], e["ph"], e["arg"]) for e in want.tail(8)]
    assert sorted(got._pending) == sorted(want._pending) == ["parked"]


def test_store_eviction_and_pending_gc_as_the_reference(monkeypatch):
    def t(rid, flags):
        return {"trace_id": rid + "-tid", "request_id": rid,
                "flags": flags, "spans": [], "start": 0, "end": 1}
    stores = [m.TraceStore(cap=3) for m in MODS]
    for store in stores:
        for rid, flags in (("a", ["faulted"]), ("b", []), ("c", []),
                           ("d", ["quarantined"]), ("e", []), ("f", [])):
            store.add(t(rid, flags))
    assert [x["request_id"] for x in stores[1].all()] == \
        [x["request_id"] for x in stores[0].all()]
    assert stores[1].get("a-tid") and stores[1].get("b") is None
    trs = _tracers(monkeypatch, ARKS_TRACE="1")
    for tr in trs:
        tr._PENDING_CAP = 4
        for i in range(8):    # aborted requests: no terminal event, ever
            tr.evt(f"zombie-{i}", "queue", "B")
        tr.flush()
    assert sorted(trs[1]._pending) == sorted(trs[0]._pending)
    assert len(trs[1]._pending) == 4


def test_disabled_tracer_and_chrome_export(monkeypatch):
    tr = _tracers(monkeypatch, ARKS_TRACE="0")[1]
    tr.evt("r", "queue", "B")
    tr.register("r")
    tr.flush()
    assert tr.tail() == [] and tr.store.get("r") is None
    trs = _tracers(monkeypatch, ARKS_TRACE="1")
    for tr, m in zip(trs, MODS):
        _script(tr, m.TraceCtx)
        tr.flush()
    exports = [p.chrome_trace(tr.store.all(), tr.phase_spans())
               for p, tr in zip((ref_perfetto, port_perfetto), trs)]
    for ex in exports:
        for ev in ex["traceEvents"]:
            ev.pop("ts", None)
            ev.pop("dur", None)
            ev.get("args", {}).pop("trace_id", None)
    assert exports[1] == exports[0]


def test_evt_is_a_ring_store(monkeypatch):
    """The hot path: a tuple stored into the thread's ring, the ring
    overwritten past its capacity, and each thread its own ring."""
    tr = _tracers(monkeypatch, ARKS_TRACE="1", ARKS_TRACE_RING="4")[1]
    for i in range(6):
        tr.evt("r", "chunk", "I", i)
    ring = tr._tl.ring
    assert ring.idx == 6 and [r[4] for r in ring.buf] == [4, 5, 2, 3]
    th = threading.Thread(target=lambda: tr.evt("", "spill", "I", 1))
    th.start()
    th.join()
    assert len(tr._rings) == 2
    assert [e["arg"] for e in tr.tail(3)] == [4, 5, 1]


def test_logctx_stamps_records():
    import logging
    log = logging.getLogger("arks_tpu_torch.test_logctx")
    logctx.install(log)
    logctx.install(log)
    assert sum(isinstance(f, logctx.ContextFilter)
               for f in log.filters) == 1
    seen = []

    class _H(logging.Handler):
        def emit(self, record):
            seen.append((record.getMessage(), record.request_id,
                         record.trace_id))

    h = _H()
    log.addHandler(h)
    log.setLevel(logging.INFO)
    try:
        with logctx.bound("req-1", "t" * 32):
            log.info("hello %d", 3)
        log.info("bare")
    finally:
        log.removeHandler(h)
    assert seen == [(f"hello 3 [rid=req-1 trace={'t' * 32}]", "req-1",
                     "t" * 32), ("bare", "-", "-")]


# ------------------------------------------------- engines and the server

def _engine(monkeypatch, layout="paged", depth=0, trace="1", **env):
    monkeypatch.setenv("ARKS_TRACE", trace)
    monkeypatch.setenv("ARKS_PIPELINE_DEPTH", str(depth))
    monkeypatch.setenv("ARKS_MIXED_STEP", "1" if layout == "paged" else "0")
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))
    return InferenceEngine(get_config("tiny"), EngineConfig(
        model="tiny", num_slots=2, max_cache_len=64,
        prefill_buckets=(8, 16, 32), prefill_chunk=16, kv_layout=layout,
        dtype="float32"), ByteTokenizer(), device="cpu")


def _collect(req):
    ids = []
    while True:
        out = req.outputs.get(timeout=60)
        ids.extend(out.token_ids)
        if out.finished:
            return ids, out.finish_reason


@pytest.mark.parametrize("layout", ["paged", "slot"])
@pytest.mark.parametrize("depth", [0, 2])
def test_streams_identical_with_tracing_on_and_off(monkeypatch, layout,
                                                   depth):
    """The tracer records, it never schedules: the same streams (greedy,
    seeded, a guided one, one long prompt) with ARKS_TRACE=1 and 0."""
    runs = []
    for trace in ("1", "0"):
        eng = _engine(monkeypatch, layout, depth, trace)
        reqs = [Request("g", [5, 6, 7], SamplingParams(
                    max_tokens=12, temperature=0.0, ignore_eos=True)),
                Request("s", [9] * 5, SamplingParams(
                    max_tokens=12, temperature=0.9, top_k=40, seed=3,
                    ignore_eos=True)),
                Request("l", [7] * 40, SamplingParams(
                    max_tokens=6, temperature=0.0, ignore_eos=True)),
                Request("j", [4, 4], SamplingParams(
                    max_tokens=10, temperature=0.0, guide=("regex", "[a-c]+"),
                    ignore_eos=True))]
        for r in reqs:
            eng.add_request(r)
        for _ in range(2000):
            eng.step(block_s=0.005)
            if eng.idle:
                break
        runs.append([_collect(r) for r in reqs])
        if trace == "1":
            eng.trace.flush()
            assert {t["request_id"] for t in eng.trace.store.all()} == \
                {"g", "s", "l", "j"}
            names = {s["name"] for s in eng.trace.store.get("l")["spans"]}
            assert {"queue", "prefill", "first_token", "finish"} <= names
            assert any(s["name"].startswith("phase.")
                       for s in eng.trace.phase_spans())
        else:
            assert eng.trace.tail() == []
    assert runs[0] == runs[1]


def _http(port, method, path, body=None, headers=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


@pytest.fixture
def served(monkeypatch, tmp_path):
    servers = []

    def make(**env):
        monkeypatch.setenv("ARKS_PROF_DIR", str(tmp_path / "prof"))
        eng = _engine(monkeypatch, **env)
        srv = OpenAIServer(eng, "tiny", port=0)
        eng.start()
        srv.start(background=True)
        servers.append((srv, eng))
        deadline = time.monotonic() + 30
        while srv.readiness()[0] != 200:
            if time.monotonic() > deadline:
                raise AssertionError("server never ready")
            # The loop turns warm after its first finished step.
            time.sleep(0.01)
        return srv, eng

    yield make
    for srv, eng in servers:
        srv.stop()
        eng.stop()


def test_traces_endpoints(served):
    """A caller's traceparent is continued: its trace is served by trace
    id and by request id with the queue/prefill/first_token/finish spans
    and the caller's span as parent; the index lists it; an unknown id is
    a 404; the export is Chrome trace events for the three components."""
    srv, eng = served(ARKS_TRACE_SAMPLE="1.0")
    tid, parent = "c" * 32, "d" * 16
    st, out = _http(srv.port, "POST", "/v1/completions",
                    {"prompt": "trace me", "max_tokens": 4,
                     "temperature": 0, "ignore_eos": True},
                    {"traceparent": f"00-{tid}-{parent}-01"})
    assert st == 200 and out["choices"][0]["finish_reason"] == "length"
    st, tr = _http(srv.port, "GET", f"/v1/traces/{tid}")
    assert st == 200 and tr["trace_id"] == tid and tr["parent_id"] == parent
    names = {s["name"] for s in tr["spans"]}
    assert {"queue", "prefill", "first_token", "finish"} <= names
    st, by_rid = _http(srv.port, "GET", f"/v1/traces/{tr['request_id']}")
    assert st == 200 and by_rid["trace_id"] == tid
    st, index = _http(srv.port, "GET", "/v1/traces")
    assert st == 200 and [t["trace_id"] for t in index["traces"]] == [tid]
    assert index["traces"][0]["spans"] == len(tr["spans"])
    st, err = _http(srv.port, "GET", "/v1/traces/" + "e" * 32)
    assert st == 404 and "not found" in err["error"]["message"]
    st, ex = _http(srv.port, "GET", "/v1/traces/export")
    assert st == 200 and ex["displayTimeUnit"] == "ms"
    procs = {e["args"]["name"] for e in ex["traceEvents"]
             if e["name"] == "process_name"}
    assert procs == {"gateway", "router", "engine"}
    assert any(e.get("ph") == "X" and e["args"].get("trace_id") == tid
               for e in ex["traceEvents"])


def test_profiler_window(served, tmp_path):
    """POST /v1/profiler/start opens a torch.profiler window (a second
    start is refused), the steps run inside it carry the arks_step
    annotation, and stop writes the window's Chrome trace."""
    srv, eng = served()
    st, out = _http(srv.port, "POST", "/v1/profiler/start", {})
    assert st == 200 and out["ok"] and out["dir"].startswith(
        str(tmp_path / "prof"))
    st, again = _http(srv.port, "POST", "/v1/profiler/start", {})
    assert again == {"ok": False, "error": "already_active",
                     "dir": out["dir"]}
    st, done = _http(srv.port, "POST", "/v1/completions",
                     {"prompt": "profile me", "max_tokens": 6,
                      "temperature": 0, "ignore_eos": True})
    assert st == 200
    st, stop = _http(srv.port, "POST", "/v1/profiler/stop", {})
    assert stop == {"ok": True, "dir": out["dir"]}
    path = os.path.join(out["dir"], port_profiler.TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(str(e.get("name", "")).startswith("arks_step")
               for e in events)
    st, again = _http(srv.port, "POST", "/v1/profiler/stop", {})
    assert again == {"ok": False, "error": "not_active"}


def test_readiness_recovering_and_the_faulted_trace(served):
    """A decode fault mid-stream: readiness answers 503 "recovering"
    while the recovery runs, the stream still finishes whole, and with
    ARKS_TRACE_SAMPLE=0 only the faulted request's trace is retained,
    flagged, with its replay event, the recover span and the flight
    recorder's tail."""
    srv, eng = served(ARKS_TRACE_SAMPLE="0.0")
    st, clean = _http(srv.port, "POST", "/v1/completions",
                      {"prompt": "clean", "max_tokens": 4, "temperature": 0,
                       "ignore_eos": True})
    assert st == 200
    hold, seen = threading.Event(), []
    real = eng._reset_device_state

    def slow_reset():
        seen.append(srv.readiness())
        hold.wait(30)
        real()

    eng._reset_device_state = slow_reset
    eng._faults.arm("decode:3:runtime")
    box = {}
    th = threading.Thread(target=lambda: box.update(out=_http(
        srv.port, "POST", "/v1/completions",
        {"prompt": "faulted", "max_tokens": 12, "temperature": 0,
         "ignore_eos": True})))
    th.start()
    deadline = time.monotonic() + 30
    while not seen:
        assert time.monotonic() < deadline, "no recovery"
        time.sleep(0.01)
    st, msg = _http(srv.port, "GET", "/readiness")
    hold.set()
    th.join(60)
    del eng._reset_device_state
    assert seen[0] == (503, "recovering") and st == 503
    assert msg["error"]["message"] == "recovering"
    st, out = box["out"]
    assert st == 200 and out["choices"][0]["finish_reason"] == "length"
    assert out["usage"]["completion_tokens"] == 12
    assert eng.state == "serving" and srv.readiness()[0] == 200
    st, index = _http(srv.port, "GET", "/v1/traces")
    assert [t["flags"] for t in index["traces"]] == [["faulted"]]
    st, tr = _http(srv.port, "GET",
                   f"/v1/traces/{index['traces'][0]['request_id']}")
    names = [s["name"] for s in tr["spans"]]
    assert "replay" in names and "recover" in names
    assert tr["flight_tail"] and any(
        e["name"] == "recover" for e in tr["flight_tail"])

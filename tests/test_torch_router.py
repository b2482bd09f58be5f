"""The port's router (``arks_tpu_torch.router``) held against the
reference's (``arks_tpu.router``): each case of the reference's
``tests/test_router_sketch.py`` and ``tests/test_router_failover.py`` runs
through both routers on the same sketches, bodies and stub backends, and
the candidate orders, peer hints, route-decision and retry counters,
failover sequences, relayed headers, status codes and ``Retry-After`` must
be equal (and what the reference's tests assert).  The sketch reader, the
prefix key and the rendezvous hash are held alike on payloads from both
packages' exporters."""

import contextlib
import hashlib
import json
import socket
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

import arks_tpu.prefix_sketch as ref_ps
import arks_tpu.router as ref_router
import arks_tpu_torch.prefix_sketch as port_ps
import arks_tpu_torch.router as port_router
from arks_tpu_torch import tenancy

PAGE = 4
IDS = list(range(32))                      # 8 token blocks at PAGE=4
CHAIN = port_ps.chain_digests(IDS, PAGE, 8)
A, B, C = "10.0.0.1:1", "10.0.0.2:1", "10.0.0.3:1"
PACKAGES = {"ref": (ref_router, ref_ps), "port": (port_router, port_ps)}
# Families whose values are clocks (ages, join seconds), not decisions.
_CLOCKS = ("router_sketch_age_seconds", "router_join_seconds")


def both(fn, monkeypatch, *args):
    """``fn(router module, sketch module, *args)`` for the reference's
    router and the port's, each under its own environment; the two results
    must be equal.  Returns the port's."""
    out = {}
    for tag, (rmod, psmod) in PACKAGES.items():
        with monkeypatch.context() as m:
            out[tag] = fn(m, rmod, psmod, *args)
    assert out["port"] == out["ref"]
    return out["port"]


def _payload(ps, dev=(), host=(), epoch="e.0", page=PAGE, disk=None):
    ex = ps.SketchExporter(page)
    p = ex.build(list(dev), ("k", 1), list(host), 1,
                 disk=list(disk) if disk else None)
    p["epoch"] = epoch
    return p


def _body(ids=IDS):
    return json.dumps({"model": "tiny", "prompt": ids}).encode()


def _inject(router, ps, addr, payload, age_s=0.0):
    bs = ps.BackendSketch.from_payload(payload)
    router.sketches._state[addr] = {"sketch": bs,
                                    "at": time.monotonic() - age_s}


def _mk(m, rmod, decode="", prefill="", policy="cache_aware", **kw):
    m.setenv("ARKS_PREFILL_ADDRS", prefill)
    m.setenv("ARKS_DECODE_ADDRS", decode)
    m.setenv("ARKS_ROUTER_RETRY_BACKOFF_S", "0.01")
    # Keep the background poller inert: cases drive poll_once() directly.
    m.setenv("ARKS_ROUTER_SKETCH_POLL_S", "60")
    return rmod.Router(rmod.Discovery(None), "tiny", host="127.0.0.1",
                       port=0, policy=policy, **kw)


def _metrics(router) -> list[str]:
    """The router's /metrics samples, but for its clock families."""
    return [line for line in router.registry.render().splitlines()
            if not line.startswith("#")
            and not line.startswith(_CLOCKS)]


def _pick(router, body, prefill, decode):
    hint: list = []
    p, cands = router._pick(body, prefill, decode, hint_out=hint)
    return p, list(cands), hint


def _rz_order(key, backends):
    return sorted(backends, reverse=True,
                  key=lambda b: hashlib.sha1(key + b"\x00"
                                             + b.encode()).digest())


def _stop(router):
    """Stop ``router`` without waiting out its serve loop's half-second
    poll (the sockets close within it; every case takes fresh ports)."""
    router.sketches.stop()
    threading.Thread(target=router.stop, daemon=True).start()


# ---------------------------------------------------------------------------
# Scoring order (white-box: _pick with injected sketches)
# ---------------------------------------------------------------------------

def _deepest(m, rmod, ps):
    r = _mk(m, rmod)
    _inject(r, ps, A, _payload(ps, dev=CHAIN[:1]))
    _inject(r, ps, B, _payload(ps, dev=CHAIN[:3]))
    _inject(r, ps, C, _payload(ps))
    return _pick(r, _body(), [], [A, B, C]), _metrics(r)


def test_deepest_hit_wins_and_orders_failover_candidates(monkeypatch):
    (p, cands, hint), metrics = both(_deepest, monkeypatch)
    assert (p, cands, hint) == ("", [B, A, C], [B])
    assert 'router_route_decisions_total{reason="sketch_hit"} 1' in metrics
    assert ('router_expected_hit_blocks_total{backend="10.0.0.2:1",'
            'tier="device"} 3') in metrics


def _tiers(m, rmod, ps):
    """w = 1.0: two device blocks (4.0) beat three host blocks (3.0); a
    disk block weighs 0.5."""
    r = _mk(m, rmod)
    _inject(r, ps, A, _payload(ps, host=CHAIN[:3]))
    _inject(r, ps, B, _payload(ps, dev=CHAIN[:2]))
    _inject(r, ps, C, _payload(ps, dev=CHAIN[:1], disk=CHAIN[1:6]))
    return _pick(r, _body(), [], [A, B, C]), _metrics(r)


def test_device_blocks_outweigh_host_and_disk_blocks(monkeypatch):
    (_, cands, hint), metrics = both(_tiers, monkeypatch)
    # C: 2.0 + 5 x 0.5 = 4.5 beats B's 4.0 and A's 3.0; C covers deepest.
    assert cands == [C, B, A] and hint == [C]
    assert ('router_expected_hit_blocks_total{backend="10.0.0.3:1",'
            'tier="disk"} 5') in metrics


def _tie(m, rmod, ps):
    r = _mk(m, rmod)
    _inject(r, ps, A, _payload(ps, dev=CHAIN[:2]))
    _inject(r, ps, B, _payload(ps, dev=CHAIN[:2]))
    r._inflight = {A: 3, B: 0}
    first = _pick(r, _body(), [], [A, B])
    r._inflight = {A: 1, B: 1}
    rest = [_pick(r, _body(), [], [A, B]) for _ in range(3)]
    return first, rest, _metrics(r)


def test_tie_falls_back_to_least_loaded_then_rendezvous(monkeypatch):
    first, rest, metrics = both(_tie, monkeypatch)
    assert first[1][0] == B, "tied scores: the quieter backend wins"
    key = json.dumps(IDS[:64]).encode()
    assert {r[1][0] for r in rest} == {_rz_order(key, [A, B])[0]}
    assert 'router_route_decisions_total{reason="tie_fallback"} 4' \
        in metrics


def _zero(m, rmod, ps):
    r = _mk(m, rmod)
    _inject(r, ps, A, _payload(ps))
    _inject(r, ps, B, _payload(ps))
    return _pick(r, _body(), [], [A, B]), _metrics(r)


def test_all_zero_scores_are_a_tie_not_a_hit(monkeypatch):
    (_, _, hint), metrics = both(_zero, monkeypatch)
    assert hint == []
    assert metrics == ['router_route_decisions_total{reason="tie_fallback"}'
                       ' 1']


def _stale(m, rmod, ps):
    r = _mk(m, rmod)
    out = [_pick(r, _body(), [], [A, B])]
    # A sketch past the staleness deadline counts as absent (default
    # ARKS_ROUTER_SKETCH_STALE_S=10).
    _inject(r, ps, A, _payload(ps, dev=CHAIN[:3]), age_s=100.0)
    out.append(_pick(r, _body(), [], [A, B]))
    return out, _metrics(r)


def test_stale_or_absent_sketches_fall_back_to_rendezvous(monkeypatch):
    picks, metrics = both(_stale, monkeypatch)
    key = json.dumps(IDS[:64]).encode()
    assert [p[1] for p in picks] == [_rz_order(key, [A, B])] * 2
    assert metrics == ['router_route_decisions_total{reason="stale_sketch"}'
                       ' 2']


def _no_key(m, rmod, ps):
    r = _mk(m, rmod)
    out = [_pick(r, json.dumps({"model": "tiny"}).encode(), ["p1", "p2"],
                 [A, B, C]) for _ in range(4)]
    return out, _metrics(r)


def test_promptless_body_counts_no_key_and_rotates(monkeypatch):
    picks, metrics = both(_no_key, monkeypatch)
    assert [p[:2] for p in picks] == [
        ("p1", [A, B, C]), ("p2", [B, C, A]), ("p1", [C, A, B]),
        ("p2", [A, B, C])]
    assert metrics == ['router_route_decisions_total{reason="no_key"} 4']


def _kill_switch(m, rmod, ps):
    m.setenv("ARKS_ROUTER_SKETCH", "0")
    r = _mk(m, rmod)
    _inject(r, ps, A, _payload(ps, dev=CHAIN[:3]))
    return r.sketch_on, _pick(r, _body(), [], [A, B]), _metrics(r)


def test_sketch_env_kill_switch(monkeypatch):
    on, (_, cands, _), metrics = both(_kill_switch, monkeypatch)
    key = json.dumps(IDS[:64]).encode()
    assert not on and cands == _rz_order(key, [A, B]) and metrics == []


def _multi_turn(m, rmod, ps):
    r = _mk(m, rmod)
    _inject(r, ps, A, _payload(ps, dev=CHAIN[:2]))
    _inject(r, ps, B, _payload(ps))
    history, out = IDS[:8], []
    for turn in range(4):
        out.append(_pick(r, _body(history), [], [B, A]))
        history = history + [100 + turn] * 4    # next turn grows the chain
    return out, _metrics(r)


def test_multi_turn_affinity_follows_the_growing_chain(monkeypatch):
    picks, metrics = both(_multi_turn, monkeypatch)
    assert [p[1][0] for p in picks] == [A] * 4
    assert 'router_route_decisions_total{reason="sketch_hit"} 4' in metrics


def _text(m, rmod, ps):
    r = _mk(m, rmod)
    text = "s" * 600
    ex = ps.SketchExporter(PAGE)
    tds = list(ps.iter_text_digests(text, ex.text_chars))
    toks = ps.chain_digests(list(range(8)), PAGE, 2)
    ex._links[tds[0]] = toks[0]
    ex._links[tds[1]] = toks[1]
    _inject(r, ps, A, _payload(ps))
    _inject(r, ps, B, ex.build(toks, ("k", 1), [], 1))
    body = json.dumps({"model": "tiny", "prompt": text}).encode()
    chat = json.dumps({"model": "tiny", "messages": [
        {"role": "system", "content": text[:300]},
        {"role": "user", "content": [{"type": "text", "text": text[300:]}]},
    ]}).encode()
    return (len(tds), _pick(r, body, ["p"], [A, B]),
            _pick(r, chat, ["p"], [A, B]), _metrics(r))


def test_text_domain_scoring_without_tokenizer(monkeypatch):
    n, pick, chat, metrics = both(_text, monkeypatch)
    assert n == 2 and pick == ("p", [B, A], [B])
    # The chat's canonical text joins its turns with NUL: only its first
    # block is the prompt's.
    assert chat == ("p", [B, A], [B])
    assert ('router_expected_hit_blocks_total{backend="10.0.0.2:1",'
            'tier="device"} 3') in metrics


def test_score_chain_and_keys_agree_across_both_exporters():
    """Each package's ``BackendSketch`` scores each package's exported
    payload alike, token and text domains, every tier; ``_prefix_key`` and
    ``_rendezvous`` give the same keys and choices."""
    text = "prefix " * 200
    for dev, host, disk in ((CHAIN[:3], CHAIN[3:5], CHAIN[5:7]),
                            (CHAIN[:0], CHAIN[:4], None),
                            (CHAIN[:8], [], CHAIN[:2])):
        payloads = []
        for ps in (ref_ps, port_ps):
            ex = ps.SketchExporter(PAGE)
            ex.link(text, list(range(len(text) // 2)))
            payloads.append(ex.build(list(dev), 1, list(host), 2,
                                     disk=list(disk) if disk else None))
        tchain = list(port_ps.iter_text_digests(text, 256))
        got = {(pi, ri, dom): ps.BackendSketch.from_payload(p).score_chain(
                   chain, dom)
               for pi, p in enumerate(payloads)
               for ri, ps in enumerate((ref_ps, port_ps))
               for dom, chain in (("token", CHAIN), ("text", tchain))}
        for dom in ("token", "text"):
            assert len({v for k, v in got.items() if k[2] == dom}) == 1, got
    bodies = [{"prompt": "x" * 700}, {"prompt": IDS},
              {"prompt": [True, 1]}, {"prompt": ""}, {"model": "m"},
              {"messages": [{"role": "user", "content": "hi"},
                            {"role": "user", "content": [
                                {"type": "image_url"}]}]},
              {"messages": [{"role": "user", "content": [
                  {"type": "text", "text": "a"}, {"type": "text",
                                                  "text": "b"}]}]}]
    for obj in bodies:
        raw = json.dumps(obj).encode()
        assert port_router._prefix_key(raw) == ref_router._prefix_key(raw)
        assert port_router._token_prompt(obj) == ref_router._token_prompt(obj)
    assert port_router._prefix_key(b"\xff not json") is None
    backends = [f"10.1.0.{i}:80" for i in range(7)]
    for i in range(50):
        key = f"key {i}".encode()
        assert port_router._rendezvous(key, backends) == \
            ref_router._rendezvous(key, backends)


# ---------------------------------------------------------------------------
# Stub backends: scripted POSTs and a mutable sketch
# ---------------------------------------------------------------------------

class _Backend:
    """A decode backend stub: each element of ``script`` handles one
    request — "ok", "503", ("503", retry_after), or ("429", headers);
    past the script's end the last entry repeats.  It serves GET
    /v1/cache/sketch from ``payload`` and records each POST's path and
    headers.  ``reset`` re-arms it for the next router."""

    def __init__(self, script, payload=None):
        backend = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _send(self, code, data, headers=()):
                self.send_response(code)
                for k, v in headers:
                    self.send_header(k, v)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/v1/cache/sketch" and backend.payload:
                    self._send(200, json.dumps(backend.payload).encode())
                elif self.path == "/readiness":
                    self._send(backend.ready, b"{}")
                else:
                    self._send(404, b"{}")

            def do_POST(self):
                self.rfile.read(int(self.headers.get("Content-Length", 0)))
                backend.seen.append((self.path, {
                    k.lower(): v for k, v in self.headers.items()
                    if k.lower() != "x-arks-trace-spans"},
                    self.headers.get("x-arks-trace-spans")))
                i = min(backend.calls, len(backend.script) - 1)
                backend.calls += 1
                action, extra = backend.script[i], None
                if isinstance(action, tuple):
                    action, extra = action
                if action == "503":
                    self._send(503, b'{"error":{"message":"draining",'
                                    b'"code":503}}',
                               [("Retry-After", str(extra))]
                               if extra is not None else [])
                elif action == "429":
                    self._send(429, b'{"error":{"message":"tenant queue '
                                    b'full","code":"tenant_queue_full"}}',
                               extra)
                elif action == "sse":
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.end_headers()
                    for j in range(3):
                        self.wfile.write(f"data: {{\"n\": {j}}}\n\n".encode())
                        self.wfile.flush()
                    self.wfile.write(b"data: [DONE]\n\n")
                    self.close_connection = True
                else:
                    self._send(200, json.dumps(
                        {"id": "ok", "object": "text_completion",
                         "served_by": backend.name,
                         "choices": []}).encode())

        self.script = script
        self.payload = payload
        self.ready = 200
        self.reset()
        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.addr = f"127.0.0.1:{self._httpd.server_port}"
        self.name = self.addr
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()

    def reset(self):
        self.calls = 0
        self.seen = []

    def stop(self):
        def down():
            self._httpd.shutdown()
            self._httpd.server_close()
        threading.Thread(target=down, daemon=True).start()


@pytest.fixture
def stubs():
    made = []

    def make(script, payload=None):
        b = _Backend(script, payload)
        made.append(b)
        return b

    yield make
    for b in made:
        b.stop()


def _free_port_addr() -> str:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"127.0.0.1:{port}"


def _call(router, body=None, headers=None, path="/v1/completions"):
    """(status, JSON body or raw bytes, selected response headers).  A
    routed request returns once the router has counted it (it counts after
    its answer went out)."""
    routed = path in ("/v1/completions", "/v1/chat/completions")
    before = router.requests_total.total()
    req = urllib.request.Request(
        f"http://127.0.0.1:{router.port}{path}",
        data=body if isinstance(body, bytes) else json.dumps(
            body or {"model": "tiny", "prompt": "x"}).encode(),
        headers=dict({"Content-Type": "application/json"},
                     **(headers or {})))
    try:
        resp = urllib.request.urlopen(req, timeout=30)
    except urllib.error.HTTPError as e:
        resp = e
    with resp:
        raw = resp.read()
        hdrs = {k: resp.headers.get(k) for k in (
            "Retry-After", tenancy.HDR_TENANT, tenancy.HDR_SATURATION,
            "x-arks-tier", "Content-Type", "Transfer-Encoding")
            if resp.headers.get(k) is not None}
        try:
            data = json.loads(raw)
        except ValueError:
            data = raw
    deadline = time.monotonic() + 10
    while routed and router.requests_total.total() == before:
        assert time.monotonic() < deadline, "the router never counted it"
        time.sleep(0.005)
    return resp.status, data, hdrs


def _get(router, path):
    try:
        resp = urllib.request.urlopen(f"http://127.0.0.1:{router.port}{path}",
                                      timeout=10)
    except urllib.error.HTTPError as e:
        resp = e
    with resp:
        return resp.status, json.loads(resp.read())


def _seen(*backends):
    """What reached each stub, trace ids and span timings aside."""
    out = []
    for b in backends:
        rows = []
        for path, hdrs, spans in b.seen:
            hdrs = dict(hdrs)
            hdrs.pop("traceparent", None)
            hdrs.pop("host", None)
            rows.append((path, hdrs, [(s["component"], s["name"], s["arg"])
                                      for s in json.loads(spans)]
                         if spans else None))
        out.append((b.calls, rows))
        b.reset()
    return out


def _live(m, rmod, ps, decode, prefill="", fn=None, **kw):
    """Start ``rmod``'s router over ``decode``, run ``fn(router)``, stop."""
    r = _mk(m, rmod, decode=",".join(decode), prefill=prefill, **kw)
    r.start(background=True)
    try:
        return fn(r)
    finally:
        _stop(r)


# ---------------------------------------------------------------------------
# Failover (the reference's tests/test_router_failover.py)
# ---------------------------------------------------------------------------

def test_failover_on_503_to_next_backend(monkeypatch, stubs):
    bad, good = stubs(["503"]), stubs(["ok"])

    def run(m, rmod, ps):
        return _live(m, rmod, ps, [bad.addr, good.addr], "127.0.0.1:1",
                     lambda r: (_call(r), _metrics(r), _seen(bad, good)),
                     policy="round_robin")

    (st, out, _), metrics, seen = both(run, monkeypatch)
    assert st == 200 and out["served_by"] == good.addr
    assert [s[0] for s in seen] == [1, 1]
    assert seen[1][1][0][0] == "/v1/disagg/completions"
    assert seen[1][1][0][1]["x-arks-prefill-addr"] == "127.0.0.1:1"
    assert 'router_retries_total{reason="backend_503"} 1' in metrics


def test_failover_on_connection_error(monkeypatch, stubs):
    dead, good = _free_port_addr(), stubs(["ok"])

    def run(m, rmod, ps):
        return _live(m, rmod, ps, [dead, good.addr], "127.0.0.1:1",
                     lambda r: (_call(r), _metrics(r), _seen(good)),
                     policy="round_robin")

    (st, out, _), metrics, _ = both(run, monkeypatch)
    assert st == 200 and out["served_by"] == good.addr
    assert 'router_retries_total{reason="connect_error"} 1' in metrics


def test_flapping_backend_recovers_on_backoff_round(monkeypatch, stubs):
    flapper = stubs(["503", "ok"])

    def run(m, rmod, ps):
        return _live(m, rmod, ps, [flapper.addr], "127.0.0.1:1",
                     lambda r: (_call(r), _seen(flapper)),
                     policy="round_robin")

    (st, out, _), seen = both(run, monkeypatch)
    assert st == 200 and out["served_by"] == flapper.addr
    assert seen[0][0] == 2


def test_all_backends_503_passes_retry_after_through(monkeypatch, stubs):
    a, b = stubs([("503", 7)]), stubs([("503", 31)])

    def run(m, rmod, ps):
        return _live(m, rmod, ps, [a.addr, b.addr], "127.0.0.1:1",
                     lambda r: (_call(r), _metrics(r), _seen(a, b)),
                     policy="round_robin")

    (st, out, hdrs), metrics, seen = both(run, monkeypatch)
    assert st == 503 and out["error"]["code"] == 503
    assert hdrs["Retry-After"] in ("7", "31")
    assert [s[0] for s in seen] == [2, 2]
    assert 'router_retries_total{reason="backend_503"} 4' in metrics
    assert 'router_requests_total{status="503"} 1' in metrics


def test_tenant_shed_429_relays_headers_unchanged(monkeypatch, stubs):
    """A backend 429 is not a failover event: the router relays it with
    Retry-After, x-arks-tenant and x-arks-saturation intact, and forwards
    the gateway-minted tenant and the SLO tier toward the backend."""
    shed = stubs([("429", [("Retry-After", "3"),
                           (tenancy.HDR_TENANT, "team-a/alice"),
                           (tenancy.HDR_SATURATION, "0.87"),
                           ("x-arks-tier", "batch")])])
    sent = {tenancy.HDR_TENANT: "team-a/alice", "x-arks-tier": "batch",
            "x-not-relayed": "1"}

    def run(m, rmod, ps):
        return _live(m, rmod, ps, [shed.addr], "127.0.0.1:1",
                     lambda r: (_call(r, headers=sent), _seen(shed)),
                     policy="round_robin")

    (st, out, hdrs), seen = both(run, monkeypatch)
    assert st == 429 and out["error"]["code"] == "tenant_queue_full"
    assert (hdrs["Retry-After"], hdrs[tenancy.HDR_TENANT],
            hdrs[tenancy.HDR_SATURATION], hdrs["x-arks-tier"]) == \
        ("3", "team-a/alice", "0.87", "batch")
    (_, hdrs_in, _), = seen[0][1]
    assert hdrs_in[tenancy.HDR_TENANT] == "team-a/alice"
    assert hdrs_in["x-arks-tier"] == "batch"
    assert "x-not-relayed" not in hdrs_in


def test_no_backends_still_503s(monkeypatch):
    def run(m, rmod, ps):
        return _live(m, rmod, ps, [], "",
                     lambda r: (_call(r), _get(r, "/readiness"),
                                _metrics(r)))

    (st, _, _), ready, metrics = both(run, monkeypatch)
    assert st == 503 and ready[0] == 503
    assert 'router_requests_total{status="503"} 1' in metrics


def test_streams_relay_chunked_and_the_surface_answers(monkeypatch, stubs):
    """An SSE answer without Content-Length is relayed chunked, frame for
    frame; a chat request goes to /v1/disagg/chat/completions; the GET
    surface (/v1/models, /healthz, /readiness, 404s) and an unknown POST
    path answer alike; a caller's traceparent continues with the pick
    span in the spans header."""
    sse = stubs(["sse", "ok"])
    parent = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"

    def run(m, rmod, ps):
        def go(r):
            out = [_call(r, headers={"traceparent": parent}),
                   _call(r, {"model": "tiny", "messages": [
                       {"role": "user", "content": "hi"}]},
                       path="/v1/chat/completions")]
            for path in ("/v1/models", "/healthz", "/readiness", "/nope"):
                with pytest.raises(urllib.error.HTTPError) if path == \
                        "/nope" else contextlib.nullcontext():
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{r.port}{path}",
                            timeout=10) as resp:
                        data = json.load(resp)
                        data.get("data", [{}])[0].pop("created", None)
                        out.append(data)
            out.append(_call(r, path="/v1/embeddings"))
            tp = sse.seen[0][1]["traceparent"]
            out.append(tp.split("-")[1])
            return out, _seen(sse)

        return _live(m, rmod, ps, [sse.addr], "127.0.0.1:9", go)

    out, seen = both(run, monkeypatch)
    st, data, hdrs = out[0]
    assert st == 200 and hdrs["Transfer-Encoding"] == "chunked"
    assert data == b"".join(f"data: {{\"n\": {j}}}\n\n".encode()
                            for j in range(3)) + b"data: [DONE]\n\n"
    assert out[1][1]["served_by"] == sse.addr
    assert out[2]["data"][0]["id"] == "tiny"
    assert out[4] == {"status": "ready"}
    assert out[5][0] == 404 and out[6] == "ab" * 16
    assert [row[0] for row in seen[0][1]] == [
        "/v1/disagg/completions", "/v1/disagg/chat/completions"]
    assert seen[0][1][0][2] == [("router", "router.pick", sse.addr)]


# ---------------------------------------------------------------------------
# Poller + live backends (the reference's tests/test_router_sketch.py)
# ---------------------------------------------------------------------------

def test_poller_drops_restarted_backend_epoch(monkeypatch, stubs):
    be = stubs(["ok"])
    off = stubs(["ok"], {"enabled": False})

    def run(m, rmod, ps):
        be.payload = _payload(ps, dev=CHAIN[:3], epoch="boot1.0")
        r = _mk(m, rmod, decode=f"{be.addr},{off.addr}")
        out = []
        r.sketches.poll_once()
        out.append((r.sketches.get(be.addr).epoch, r.sketches.get(off.addr)))
        # The backend restarts: new epoch, cold cache.  The next poll must
        # REPLACE the copy — the pre-restart membership is gone.
        be.payload = _payload(ps, epoch="boot2.0")
        r.sketches.poll_once()
        bs = r.sketches.get(be.addr)
        out.append((bs.epoch, bs.score_chain(CHAIN, "token")))
        # An unreachable poll keeps the last copy (staleness retires it).
        be.payload = None
        r.sketches.poll_once()
        out.append(r.sketches.get(be.addr).epoch)
        return out, _metrics(r)

    out, metrics = both(run, monkeypatch)
    assert out == [("boot1.0", None), ("boot2.0", (0, 0, 0)), "boot2.0"]
    assert ('router_sketch_epoch_drops_total{backend="%s"} 1' % be.addr
            in metrics)


def test_sketch_winner_still_fails_over_and_unified_forwarding(monkeypatch,
                                                               stubs):
    """The sketch-preferred backend 503s: the request moves on to the next
    candidate exactly like pre-sketch failover, and in unified mode it
    travels the plain completion path with no prefill header."""
    win, other = stubs(["503"]), stubs(["ok"])

    def run(m, rmod, ps):
        win.payload = _payload(ps, dev=CHAIN[:4])
        other.payload = _payload(ps)

        def go(r):
            ready = _get(r, "/readiness")
            r.sketches.poll_once()
            return ready, _call(r, _body()), _metrics(r), _seen(win, other)

        return _live(m, rmod, ps, [win.addr, other.addr], "", go,
                     unified=True)

    ready, (st, out, _), metrics, seen = both(run, monkeypatch)
    assert ready[1]["status"] == "ready"
    assert st == 200 and out["served_by"] == other.addr
    assert seen[0][0] == 1 and seen[0][1][0][0] == "/v1/completions"
    assert "x-arks-prefill-addr" not in seen[0][1][0][1]
    # The unified request's peer hint names the sketch winner where the
    # request landed elsewhere.
    assert seen[1][1][0][1]["x-arks-peer-hint"] == win.addr
    assert 'router_route_decisions_total{reason="sketch_hit"} 1' in metrics
    assert 'router_retries_total{reason="backend_503"} 1' in metrics


def test_connection_error_invalidates_the_dead_backends_sketch(monkeypatch,
                                                               stubs):
    dead, good = _free_port_addr(), stubs(["ok"])

    def run(m, rmod, ps):
        good.payload = _payload(ps)

        def go(r):
            _inject(r, ps, dead, _payload(ps, dev=CHAIN[:4]))
            out = _call(r, _body())
            gone = r.sketches.get(dead) is None
            # The NEXT pick no longer scores the dead backend a hit.
            nxt = _pick(r, _body(), [], [dead, good.addr])
            return out, gone, nxt, _metrics(r), _seen(good)

        return _live(m, rmod, ps, [dead, good.addr], "", go, unified=True)

    (st, out, _), gone, nxt, metrics, _ = both(run, monkeypatch)
    assert st == 200 and out["served_by"] == good.addr and gone
    assert 'router_route_decisions_total{reason="sketch_hit"} 1' in metrics
    assert 'router_retries_total{reason="connect_error"} 1' in metrics


def test_planned_join_and_leave(monkeypatch, stubs):
    """``plan_join`` waits for /readiness, primes the sketch without an
    epoch drop and admits the backend; a join that never goes ready times
    out; ``plan_leave`` masks a discovery-file backend and drops its
    sketch."""
    joiner, listed = stubs(["ok"]), stubs(["ok"])

    def run(m, rmod, ps):
        joiner.payload = _payload(ps, dev=CHAIN[:2], epoch="j.0")
        m.setenv("ARKS_ELASTIC_JOIN_TIMEOUT_S", "0.2")
        r = _mk(m, rmod, decode=listed.addr, prefill="127.0.0.1:1")
        joiner.ready = 503
        with pytest.raises(TimeoutError):
            r.plan_join(joiner.addr)
        joiner.ready = 200
        stats = r.plan_join(joiner.addr)
        out = [sorted(k for k in stats if k != "seconds"),
               stats["sketch_primed"], r.discovery.backends(),
               r.sketches.get(joiner.addr).epoch]
        r.plan_leave(listed.addr)
        out += [r.discovery.backends(), r.sketches.get(listed.addr)]
        with pytest.raises(ValueError):
            r.discovery.add("router", "x:1")
        return out, _metrics(r)

    out, metrics = both(run, monkeypatch)
    assert out[1] is True and out[3] == "j.0" and out[5] is None
    assert out[2] == (["127.0.0.1:1"], [listed.addr, joiner.addr])
    assert out[4] == (["127.0.0.1:1"], [joiner.addr])
    assert ('router_planned_membership_total{op="join",outcome="timeout"} '
            '1') in metrics
    assert not [line for line in metrics if "epoch_drops" in line]


def test_discovery_file_is_reread_on_change(tmp_path, monkeypatch):
    path = tmp_path / "d.json"

    def run(m, rmod, ps):
        m.setenv("ARKS_PREFILL_ADDRS", "env:1")
        m.setenv("ARKS_DECODE_ADDRS", "env:2,env:3")
        d = rmod.Discovery(str(path))
        out = [d.backends()]
        path.write_text(json.dumps({"prefill": ["p:1"], "decode": ["d:1"]}))
        out.append(d.backends())
        d.add("decode", "d:2")
        path.write_text(json.dumps({"prefill": ["p:2"],
                                    "decode": ["d:1", "d:3"]}))
        import os
        os.utime(path, (time.time() + 5, time.time() + 5))
        out.append(d.backends())
        path.write_text("{not json")
        os.utime(path, (time.time() + 10, time.time() + 10))
        out.append(d.backends())
        path.unlink()
        return out

    out = both(run, monkeypatch)
    assert out == [(["env:1"], ["env:2", "env:3"]), (["p:1"], ["d:1"]),
                   (["p:2"], ["d:1", "d:3", "d:2"]),
                   (["p:2"], ["d:1", "d:3", "d:2"])]


def test_entry_point_refuses_service_discovery():
    from arks_tpu_torch.router.__main__ import main
    with pytest.raises(NotImplementedError, match="Kubernetes"):
        main(["--service-discovery", "--application", "a"])
    with pytest.raises(ValueError, match="policy"):
        port_router.Router(port_router.Discovery(None), "m", policy="random")

"""The port's gateway held against the reference's (``arks_tpu.gateway``):
each fronts its own stub OpenAI backend, one scripted request list goes
through both, and the status codes, error bodies, relayed bytes, requests
forwarded to the stubs and metered usage must be equal.  Then the port's
own difference, a backend's 503 fails over to the next backend, and the
entry point on the native and Redis counter stores."""

import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from arks_tpu.control import resources as ref_res
from arks_tpu.control import store as ref_store
from arks_tpu.gateway import ratelimiter as ref_rl
from arks_tpu.gateway import server as ref_server
from arks_tpu_torch.control import resources as res
from arks_tpu_torch.control import store as port_store
from arks_tpu_torch.gateway import ratelimiter as port_rl
from arks_tpu_torch.gateway import server as port_server

USAGE = {"prompt_tokens": 7, "completion_tokens": 5, "total_tokens": 12}
# The frozen wall clock of both gateways' rate windows: 10 s into a minute.
NOW = 1_800_000_010.0


class _Stub:
    """An OpenAI backend with fixed usage (a stream ends with the usage
    frame), recording what reaches it; ``status`` answers every request
    with that code and no body instead."""

    def __init__(self, status=None):
        self.requests = []
        self.status = status
        stub = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_POST(self):
                body = json.loads(self.rfile.read(
                    int(self.headers.get("Content-Length", 0))))
                # The gateway's admit span carries its clock: present,
                # not compared.
                stub.requests.append((self.path, body, {
                    k.lower(): v for k, v in self.headers.items()
                    if k.lower().startswith("x-arks-")
                    and k.lower() != "x-arks-trace-spans"},
                    "x-arks-trace-spans" in {k.lower() for k in
                                             self.headers}))
                if stub.status:
                    self.send_response(stub.status)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                if body.get("stream"):
                    frames = [{"id": "x", "choices": [
                        {"index": 0, "delta": {"content": "hi"}}]},
                        {"id": "x", "choices": [], "usage": USAGE}]
                    data = b"".join(b"data: " + json.dumps(f).encode()
                                    + b"\n\n" for f in frames)
                    data += b"data: [DONE]\n\n"
                    ctype = "text/event-stream"
                else:
                    data = json.dumps({"id": "x", "choices": [
                        {"message": {"content": "hello"}}],
                        "usage": USAGE}).encode()
                    ctype = "application/json"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.addr = f"127.0.0.1:{self.httpd.server_port}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


class _Clock:
    def __init__(self, now):
        self.now = now

    def time(self):
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


def _world(store_mod, res_mod, server_mod, limiter, addrs):
    store = store_mod.Store()
    store.create(res_mod.Endpoint(name="m1", namespace="ns", status={
        "routes": [{"backend": {"addresses": addrs}, "weight": 1}]}))
    store.create(res_mod.Endpoint(name="m2", namespace="ns", spec={}))
    for name, limits, quota in (
            ("alice", [{"type": "rpm", "value": 50}], "alice-q"),
            ("rpm-user", [{"type": "rpm", "value": 3}], None),
            ("tpm-user", [{"type": "rpm", "value": 50},
                          {"type": "tpm", "value": 20}], None),
            ("bob", [{"type": "rpm", "value": 1000}], None)):
        store.create(res_mod.Token(name=name, namespace="ns", spec={
            "token": f"sk-{name}",
            "qos": [{"endpoint": {"name": "m1"}, "rateLimits": limits,
                     **({"quota": {"name": quota}} if quota else {})},
                    {"endpoint": {"name": "ghost"}}]}))
    store.create(res_mod.Quota(name="alice-q", namespace="ns", spec={
        "quotas": [{"type": "total", "value": 40},
                   {"type": "prompt", "value": 1000}]}))
    gw = server_mod.Gateway(store, host="127.0.0.1", port=0,
                            rate_limiter=limiter, quota_sync_s=0.1)
    gw.start(background=True)
    deadline = time.monotonic() + 10
    while not all(gw.qos.token_known(f"sk-{n}") for n in
                  ("alice", "rpm-user", "tpm-user", "bob")):
        assert time.monotonic() < deadline
        time.sleep(0.01)
    return gw, store


def _call(gw, body, token="sk-alice", path="/v1/chat/completions"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{gw.port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json",
                 **({"Authorization": f"Bearer {token}"} if token else {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read(), r.headers.get("Retry-After")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Retry-After")


CHAT = {"model": "m1", "messages": [{"role": "user", "content": "hi"}],
        "max_tokens": 4}
STREAM = dict(CHAT, stream=True, stream_options={"include_usage": True})
SCRIPT = (
    [("no auth", CHAT, None, "/v1/chat/completions"),
     ("bad token", CHAT, "sk-nobody", "/v1/chat/completions"),
     ("chat", CHAT, "sk-alice", "/v1/chat/completions"),
     ("completion", {"model": "m1", "prompt": "hi", "max_tokens": 3},
      "sk-alice", "/v1/completions"),
     ("stream", STREAM, "sk-alice", "/v1/chat/completions"),
     ("stream without usage", dict(CHAT, stream=True), "sk-alice",
      "/v1/chat/completions"),
     ("not in qos", dict(CHAT, model="m2"), "sk-alice",
      "/v1/chat/completions"),
     ("no endpoint", dict(CHAT, model="ghost"), "sk-alice",
      "/v1/chat/completions"),
     ("no model", {"messages": []}, "sk-alice", "/v1/chat/completions"),
     ("bad path", CHAT, "sk-alice", "/v1/embeddings")]
    + [(f"rpm {i}", CHAT, "sk-rpm-user", "/v1/chat/completions")
       for i in range(4)]
    + [(f"tpm {i}", CHAT, "sk-tpm-user", "/v1/chat/completions")
       for i in range(3)]
    + [(f"quota {i}", STREAM if i % 2 else CHAT, "sk-alice",
        "/v1/chat/completions") for i in range(3)])


def _run(store_mod, res_mod, server_mod, rl_mod, monkeypatch):
    clock = _Clock(NOW)
    monkeypatch.setattr(rl_mod, "time", clock)
    monkeypatch.setattr(server_mod, "time", clock)
    stub = _Stub()
    gw, store = _world(store_mod, res_mod, server_mod,
                       rl_mod.RateLimiter(rl_mod.MemoryCounterBackend()),
                       [stub.addr])
    try:
        out = [(tag,) + _call(gw, body, token, path)
               for tag, body, token, path in SCRIPT]
        gw.syncer.sync_once()
        quota = store.get(res_mod.Quota, "alice-q", "ns")
        return (out, stub.requests, gw.quota.get_usage("ns", "alice-q"),
                [(s["type"], s["used"]) for s in
                 quota.status["quotaStatus"]])
    finally:
        gw.stop()
        stub.stop()


def test_gateway_answers_like_the_reference(monkeypatch):
    # The reference's stream scan in Python (its native scanner, built
    # with g++ on first use, is held equal to it by its own tests).
    monkeypatch.setattr(ref_server, "make_usage_scanner",
                        ref_server.PyUsageScanner)
    want = _run(ref_store, ref_res, ref_server, ref_rl, monkeypatch)
    got = _run(port_store, res, port_server, port_rl, monkeypatch)
    assert got == want
    codes = {tag: code for tag, code, _, _ in want[0]}
    assert [codes[t] for t in ("no auth", "bad token", "chat", "completion",
                               "stream", "stream without usage",
                               "not in qos", "no endpoint", "no model",
                               "bad path")] == \
        [401, 401, 200, 200, 200, 400, 403, 404, 400, 404]
    assert [codes[f"rpm {i}"] for i in range(4)] == [200, 200, 200, 429]
    assert [codes[f"tpm {i}"] for i in range(3)] == [200, 200, 429]
    assert [codes[f"quota {i}"] for i in range(3)] == [200, 429, 429]
    by_tag = {tag: (body, ra) for tag, _, body, ra in want[0]}
    assert b"rate limit exceeded: tpm (24/20)" in by_tag["tpm 2"][0]
    assert by_tag["rpm 3"][1] == "50"          # to the window's edge
    assert b"quota exceeded: total" in by_tag["quota 2"][0]
    assert b'"usage"' in by_tag["stream"][0]
    # alice: chat + completion + stream + quota 0 metered, 12 tokens each.
    assert want[2]["total"] == 48 and want[3][2] == ("total", 48)
    assert len(want[1]) == 3 + 3 + 2 + 1
    assert all(h["x-arks-namespace"] == "ns" and spans
               for _, _, h, spans in want[1])


@pytest.fixture()
def failover():
    stubs = [_Stub(status=503), _Stub()]
    gw, _ = _world(port_store, res, port_server,
                   port_rl.RateLimiter(port_rl.MemoryCounterBackend()),
                   [s.addr for s in stubs])
    yield gw, stubs
    gw.stop()
    for s in stubs:
        s.stop()


def test_backend_503_fails_over_and_ejects(failover):
    """A backend that answers 503 (a replica draining in a rolling update)
    passes the request on: every request succeeds on the other backend,
    and after three 503s the draining one is ejected."""
    gw, (draining, live) = failover
    n = 0
    while len(draining.requests) < 3:     # the pick is random
        code, body, _ = _call(gw, CHAT, token="sk-bob")
        assert code == 200 and json.loads(body)["usage"] == USAGE
        n += 1
        assert n < 200
    assert gw.ejector.available([draining.addr, live.addr]) == [live.addr]
    for _ in range(5):
        assert _call(gw, CHAT, token="sk-bob")[0] == 200
    assert len(draining.requests) == 3 and len(live.requests) == n + 5
    assert gw.limiter.backend.get(port_rl.window_key(
        "ns", "bob", "m1", "tpm")) == (n + 5) * 12


def test_last_backend_503_reaches_the_client(failover):
    gw, (draining, live) = failover
    live.status = 503
    code, body, _ = _call(gw, CHAT)
    assert code == 503 and body == b""
    assert len(draining.requests) + len(live.requests) == 2
    assert gw.quota.get_usage("ns", "alice-q")["total"] == 0


@pytest.mark.parametrize("kind", ["native", "redis"])
def test_unported_counter_stores_are_refused(kind, tmp_path):
    """Both shared counter stores serve (the name is from before they were
    ported): ``make_counter_backend`` gives each, and the gateway's entry
    point on each admits a token's RPM limit and answers 429 past it."""
    import os
    import socket
    import subprocess
    import sys

    import yaml

    from arks_tpu_torch.gateway.rediskv import RespServer
    srv = RespServer()
    srv.start()
    addr = f"127.0.0.1:{srv.port}"
    stub = _Stub()
    gw = None
    try:
        backend = port_rl.make_counter_backend(kind, addr)
        assert type(backend).__name__ == {
            "native": "NativeCounterBackend",
            "redis": "RedisCounterBackend"}[kind]
        assert backend.incr("k", 3, 60) == 3 and backend.get("k") == 3
        manifest = tmp_path / "qos.yaml"
        manifest.write_text(yaml.safe_dump_all([
            # The file provider's Endpoint: its routes as an operator's
            # endpoint controller would have written them.
            {"kind": "Endpoint", "metadata": {"name": "m1"}, "spec": {},
             "status": {"routes": [{"backend": {"addresses": [stub.addr]},
                                    "weight": 1}]}},
            {"kind": "Token", "metadata": {"name": "bob"}, "spec": {
                "token": "sk-bob", "qos": [{"endpoint": {"name": "m1"},
                                            "rateLimits": [
                                                {"type": "rpm",
                                                 "value": 2}]}]}}]))
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        gw = subprocess.Popen(
            [sys.executable, "-m", "arks_tpu_torch.gateway", "--backend",
             kind, "--redis-addr", addr, "--port", str(port), "--host",
             "127.0.0.1", "--manifests", str(manifest)],
            cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        body = {"model": "m1", "messages": [{"role": "user",
                                             "content": "x"}]}
        codes, deadline = [], time.monotonic() + 60
        while len(codes) < 3:
            assert time.monotonic() < deadline and gw.poll() is None
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/chat/completions",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json",
                         "Authorization": "Bearer sk-bob"})
            try:
                with urllib.request.urlopen(req, timeout=10) as r:
                    r.read()
                    codes.append(r.status)
            except urllib.error.HTTPError as e:
                if e.code != 401:         # the token is not indexed yet
                    codes.append(e.code)
            except OSError:
                time.sleep(0.1)           # not listening yet
        assert codes == [200, 200, 429]
        assert len(stub.requests) == 2
        if kind == "redis":               # the window lives in the server
            from arks_tpu_torch.gateway.rediskv import RespClient
            key = port_rl.window_key("default", "bob", "m1", "rpm")
            assert RespClient(srv.host, srv.port).command("GET", key) == b"2"
    finally:
        if gw is not None:
            gw.terminate()
            out = gw.communicate(timeout=30)[0].decode(errors="replace")
            assert f"backend={kind}" in out, out
        stub.stop()
        srv.stop()

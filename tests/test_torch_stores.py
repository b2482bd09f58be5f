"""The gateway's shared counter stores in the port
(``arks_tpu_torch.gateway.rediskv`` and ``.native``) held against the
reference's: the port's RESP clients and its counter and quota stores
against the reference's ``RespServer``, and the reference's clients
against the port's server, through the cases of the reference's
``tests/test_rediskv.py`` (roundtrips, pipelines, expiry, cluster slots and
redirects, sentinel resolution); one key script through every counter
store of both packages (memory, native, RESP); the native SSE scanner
against the Python one; and the native library built by two processes at
once."""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from arks_tpu.gateway import native as ref_native
from arks_tpu.gateway import ratelimiter as ref_rl
from arks_tpu.gateway import rediskv as ref_kv
from arks_tpu.gateway.quota import QuotaService as RefQuotaService
from arks_tpu.gateway.server import PyUsageScanner as RefPyScanner
from arks_tpu_torch.control import resources as res
from arks_tpu_torch.control.store import Store
from arks_tpu_torch.gateway import native
from arks_tpu_torch.gateway import ratelimiter as rl
from arks_tpu_torch.gateway import rediskv as kv
from arks_tpu_torch.gateway.quota import QuotaService
from arks_tpu_torch.gateway.server import (
    Gateway, PyUsageScanner, make_usage_scanner,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = {"ref": ref_kv, "port": kv}
# (client package, server package): the port's clients on the reference's
# server, the reference's on the port's, and the port's on its own.
PAIRS = [("port", "ref"), ("ref", "port"), ("port", "port")]


class _Clock:
    """A RESP server's wall clock, advanced by hand (expiry without
    sleeping)."""

    def __init__(self, t):
        self.t = t

    def time(self):
        return self.t


@pytest.fixture
def servers(monkeypatch):
    """make(package) -> a started RespServer of that package; every server
    is stopped after the case."""
    made = []

    def make(pkg):
        s = PKG[pkg].RespServer()
        s.start()
        made.append(s)
        return s

    yield make
    # Stopped without waiting out each serve loop's half-second poll (the
    # sockets close within it; every case takes fresh ports).
    for s in made:
        threading.Thread(target=s.stop, daemon=True).start()


def _client(pkg, srv):
    return PKG[pkg].RespClient(srv.host, srv.port)


# ---------------------------------------------------------------------------
# Protocol roundtrips
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cli,srv", PAIRS)
def test_resp_roundtrip_pipeline_and_expiry(servers, monkeypatch, cli, srv):
    s = servers(srv)
    clock = _Clock(1_800_000_000.0)
    monkeypatch.setattr(PKG[srv], "time", clock)
    c = _client(cli, s)
    assert c.command("PING") == "PONG"
    assert c.command("GET", "missing") is None
    assert c.command("SET", "k", "5") == "OK"
    assert c.command("GET", "k") == b"5"
    assert c.command("INCRBY", "k", 3) == 8
    assert c.command("TTL", "k") == -1
    assert c.command("EXPIRE", "k", 100) == 1
    assert c.command("TTL", "k") == 100
    assert c.command("DEL", "k") == 1
    assert c.command("TTL", "k") == -2
    assert c.pipeline(("INCRBY", "p", 2), ("TTL", "p"),
                      ("INCRBY", "p", 2)) == [2, -1, 4]
    c.command("EXPIRE", "p", 1)
    clock.t += 1.2
    assert c.command("GET", "p") is None
    assert c.command("EXPIRE", "p", 1) == 0
    # An -ERR reply inside a pipelined batch raises, but every reply is
    # consumed first: the next command reads its own reply.
    c.command("SET", "ok", "1")
    with pytest.raises(PKG[cli].RespError):
        c.pipeline(("BOGUSCMD", "x"), ("INCRBY", "ok", 5))
    assert c.command("GET", "ok") == b"6"
    assert c.command("FLUSHALL") == "OK"
    assert c.command("GET", "ok") is None
    c.close()


def test_key_slot_and_crc16_agree():
    keys = ["123456789", "{user1000}.following", "{user1000}.followers",
            "foo{}{bar}", "bar", "", "{", "}{a}", b"\xff\x00raw",
            "arks:quota:namespace=d:quotaname=q:type=total"]
    keys += [rl.window_key("ns", f"u{i}", "m", "rpm", now=1_800_000_000.0)
             for i in range(40)]
    for k in keys:
        assert kv.key_slot(k) == ref_kv.key_slot(k)
    assert kv.key_slot("123456789") == 0x31C3 % 16384
    assert kv.key_slot("foo{}{bar}") == kv._crc16(b"foo{}{bar}") % 16384
    for data in (b"", b"a", b"123456789", bytes(range(256))):
        assert kv._crc16(data) == ref_kv._crc16(data)


# ---------------------------------------------------------------------------
# Counter and quota stores over RESP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cli,srv", PAIRS)
def test_counter_and_quota_stores_share_one_server(servers, cli, srv):
    """The counter store equals the in-memory one; two limiters share one
    window and two quota services one ledger; both packages' stores on one
    server read each other's counters (same key layout)."""
    s = servers(srv)
    pkg = PKG[cli]
    rl_mod = rl if cli == "port" else ref_rl
    redis_b = pkg.RedisCounterBackend(_client(cli, s))
    mem_b = rl_mod.MemoryCounterBackend()
    for key, amt in [("a", 1), ("b", 5), ("a", 2), ("c", 10), ("a", 1)]:
        assert redis_b.incr(key, amt, 60) == mem_b.incr(key, amt, 60)
    for key in ("a", "b", "c", "missing"):
        assert redis_b.get(key) == mem_b.get(key)
    a = rl_mod.RateLimiter(pkg.RedisCounterBackend(_client(cli, s)))
    other = "ref" if cli == "port" else "port"
    b = (rl if other == "port" else ref_rl).RateLimiter(
        PKG[other].RedisCounterBackend(_client(other, s)))
    a.do_limit("ns", "u", "m", {"rpm": 1, "tpm": 30})
    b.do_limit("ns", "u", "m", {"rpm": 1, "tpm": 12})
    assert a.check_limit("ns", "u", "m", {"rpm": 3}, {})[0].current == 2
    assert b.check_limit("ns", "u", "m", {"rpm": 2}, {})[0].over
    assert [r.current for r in a.check_limit(
        "ns", "u", "m", {"tpm": 100}, {"tpm": 10})] == [42]
    rq = pkg.RedisQuotaService(_client(cli, s))
    mq = (QuotaService if cli == "port" else RefQuotaService)()
    for q in (rq, mq):
        q.incr_usage("ns", "qa", {"prompt": 10, "response": 5, "total": 15})
        q.incr_usage("ns", "qa", {"total": 5, "bogus": 3, "prompt": 0})
    assert rq.get_usage("ns", "qa") == mq.get_usage("ns", "qa")
    for total in (20, 21):
        assert rq.check("ns", "qa", {"total": total}) == \
            mq.check("ns", "qa", {"total": total})
    rq.set_usage("ns", "qa", "total", 3)
    assert PKG[other].RedisQuotaService(_client(other, s)).get_usage(
        "ns", "qa")["total"] == 3
    assert kv.quota_key("ns", "qa", "total") == \
        ref_kv.quota_key("ns", "qa", "total")


def _gateway(store, backend, quota):
    gw = Gateway(store, host="127.0.0.1", port=0, quota_sync_s=60,
                 rate_limiter=rl.RateLimiter(backend), quota=quota)
    gw.start(background=True)
    return gw


def test_two_port_gateways_share_a_rate_limit(servers):
    """rpm=2 in all across two of the port's gateways over the reference's
    server: the first two admissions take the shared window (the dead
    backend turns them into 502/503, past admission), the third is 429 on
    either replica."""
    s = servers("ref")
    store = Store()
    store.create(res.Endpoint(name="m1", namespace="t", spec={}, status={
        "routes": [{"backend": {"addresses": ["127.0.0.1:9"]},
                    "weight": 1}]}))
    store.create(res.Token(name="bob", namespace="t", spec={
        "token": "sk-bob",
        "qos": [{"endpoint": {"name": "m1"},
                 "rateLimits": [{"type": "rpm", "value": 2}]}]}))
    gws = []
    for _ in range(2):
        client = kv.RespClient(s.host, s.port)
        gws.append(_gateway(store, kv.RedisCounterBackend(client),
                            kv.RedisQuotaService(client)))
    deadline = time.monotonic() + 10
    while not all(g.qos.token_known("sk-bob") for g in gws):
        assert time.monotonic() < deadline
        time.sleep(0.02)

    def post(gw):
        req = urllib.request.Request(
            f"http://127.0.0.1:{gw.port}/v1/chat/completions",
            data=json.dumps({"model": "m1", "messages": [
                {"role": "user", "content": "x"}]}).encode(),
            headers={"Content-Type": "application/json",
                     "Authorization": "Bearer sk-bob"})
        try:
            urllib.request.urlopen(req, timeout=10)
            return 200
        except urllib.error.HTTPError as e:
            return e.code

    try:
        assert post(gws[0]) in (502, 503)
        assert post(gws[1]) in (502, 503)
        assert post(gws[0]) == 429
        assert post(gws[1]) == 429
    finally:
        for g in gws:
            g.stop()


# ---------------------------------------------------------------------------
# Cluster + sentinel topologies (reference cmd/gateway/main.go:137-170)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cli,srv", PAIRS)
def test_cluster_client_follows_moved_and_bootstraps_slots(servers, cli,
                                                           srv):
    pkg = PKG[cli]
    a, b = servers(srv), servers(srv)
    key = "arks:quota:namespace=d:quotaname=q:type=total"
    slot = kv.key_slot(key)
    # Node A disowns the key's slot and points at B.
    a.moved_slots[slot] = f"127.0.0.1:{b.port}"
    client = pkg.RespClusterClient([("127.0.0.1", a.port)])
    client.command("SET", key, 41)
    assert int(client.command("INCRBY", key, 1)) == 42
    assert _client(cli, b).command("GET", key) == b"42"
    assert key.encode() not in a._srv.kv.data     # A only redirected
    client.close()
    # CLUSTER SLOTS at construction routes the key to B on the first try.
    a.moved_slots.clear()
    topo = [(0, slot - 1, "127.0.0.1", a.port),
            (slot, 16383, "127.0.0.1", b.port)]
    a.cluster_slots.extend(topo)
    b.cluster_slots.extend(topo)
    client = pkg.RespClusterClient([("127.0.0.1", a.port)])
    assert client._slots[slot] == ("127.0.0.1", b.port)
    assert ("127.0.0.1", b.port) in client._nodes
    assert client.pipeline(("SET", key, 7), ("GET", key), ("PING",)) == \
        ["OK", b"7", "PONG"]
    client.close()


@pytest.mark.parametrize("cli,srv", PAIRS)
def test_cluster_client_fails_over_when_default_node_dies(servers, cli,
                                                          srv):
    a, b = servers(srv), servers(srv)
    topo = [(0, 16383, "127.0.0.1", b.port)]
    a.cluster_slots.extend(topo)
    b.cluster_slots.extend(topo)
    client = PKG[cli].RespClusterClient([("127.0.0.1", a.port)])
    a.stop()
    assert client.command("PING") == "PONG"
    assert client.command("SET", "k", "1") == "OK"
    assert client.command("GET", "k") == b"1"
    client.close()
    with pytest.raises(ConnectionError):
        PKG[cli].RespClusterClient([("127.0.0.1", a.port)])


@pytest.mark.parametrize("cli,srv", PAIRS)
def test_cluster_backend_parity_with_single(servers, cli, srv):
    pkg = PKG[cli]
    a, b, single = servers(srv), servers(srv), servers(srv)
    key = "arks:rl:ns=d:user=u:model=m:rpm:12345"
    a.moved_slots[kv.key_slot(key)] = f"127.0.0.1:{b.port}"
    cluster = pkg.RedisCounterBackend(
        pkg.RespClusterClient([("127.0.0.1", a.port)]))
    one = pkg.RedisCounterBackend(_client(cli, single))
    for backend in (cluster, one):
        assert backend.get(key) == 0
        assert backend.incr(key, 3, ttl_s=60) == 3
        assert backend.incr(key, 2, ttl_s=60) == 5
        assert backend.get(key) == 5


@pytest.mark.parametrize("cli,srv", PAIRS)
def test_sentinel_resolves_refollows_and_the_factory_picks(servers, cli,
                                                           srv):
    pkg = PKG[cli]
    master1, master2, sentinel = servers(srv), servers(srv), servers(srv)
    sentinel.sentinel_masters["mymaster"] = ("127.0.0.1", master1.port)
    client = pkg.SentinelRespClient([("127.0.0.1", sentinel.port)],
                                    "mymaster")
    client.command("SET", "k", "v1")
    assert client.command("GET", "k") == b"v1"
    # Failover: the sentinel points at master2; losing master1 forces a
    # reconnect, which re-resolves through the sentinel.
    sentinel.sentinel_masters["mymaster"] = ("127.0.0.1", master2.port)
    master1.stop()
    client.command("SET", "k", "v2")
    assert client.command("GET", "k") == b"v2"
    client.close()
    with pytest.raises(ConnectionError):
        pkg.SentinelRespClient([("127.0.0.1", sentinel.port)], "nobody")
    single = pkg.make_resp_client(f"127.0.0.1:{master2.port}")
    cluster = pkg.make_resp_client(
        f"127.0.0.1:{master2.port}, 127.0.0.1:{sentinel.port}")
    sent = pkg.make_resp_client(f"127.0.0.1:{sentinel.port}",
                                sentinel_master="mymaster")
    assert [type(c).__name__ for c in (single, cluster, sent)] == [
        "RespClient", "RespClusterClient", "SentinelRespClient"]
    assert (sent.host, sent.port) == ("127.0.0.1", master2.port)
    for c in (single, cluster, sent):
        c.close()


# ---------------------------------------------------------------------------
# One key script through every counter store of both packages
# ---------------------------------------------------------------------------

def _script(backend) -> list:
    """The rate limiter's use of a store: window keys of several users and
    rules, increments, reads and an expired window."""
    out = []
    keys = [rl.window_key("ns", u, "m", rule, now=1_800_000_000.0)
            for u in ("alice", "bob") for rule in ("rpm", "tpm", "rpd")]
    for i, key in enumerate(keys * 3):
        out.append(backend.incr(key, 1 + i % 4, 65))
        out.append(backend.get(key))
    out.append(backend.get("never"))
    out.append(backend.incr("gone", 7, 0))     # expires at once
    out.append(backend.get("gone"))
    out.append(backend.incr("gone", 1, 60))    # a new window, not 8
    return out


def test_every_counter_store_counts_alike(servers):
    assert native.available() and ref_native.available()
    s_ref, s_ref2, s_port = servers("ref"), servers("ref"), servers("port")
    stores = {
        "port memory": rl.make_counter_backend("memory"),
        "port native": rl.make_counter_backend("native"),
        "port redis": rl.make_counter_backend(
            "redis", f"127.0.0.1:{s_port.port}"),
        "port redis on the reference's server": rl.make_counter_backend(
            "redis", f"127.0.0.1:{s_ref.port}"),
        "ref memory": ref_rl.MemoryCounterBackend(),
        "ref native": ref_native.NativeCounterBackend(),
        "ref redis": ref_kv.RedisCounterBackend(
            ref_kv.RespClient(s_ref2.host, s_ref2.port)),
    }
    assert type(stores["port native"]).__name__ == "NativeCounterBackend"
    assert type(stores["port redis"]).__name__ == "RedisCounterBackend"
    runs = {name: _script(b) for name, b in stores.items()}
    want = runs.pop("ref memory")
    for name, got in runs.items():
        assert got == want, name
    assert len(stores["port native"]) == 7
    assert type(rl.make_counter_backend("auto")).__name__ == \
        "NativeCounterBackend"
    assert type(rl.RateLimiter().backend).__name__ == "NativeCounterBackend"
    with pytest.raises(ValueError):
        rl.make_counter_backend("etcd")


def test_native_off_falls_back_or_raises(monkeypatch):
    """``ARKS_NATIVE=0``: ``auto`` takes the in-memory store and ``native``
    raises, naming why; a library that does not load raises the same."""
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("ARKS_NATIVE", "0")
    assert isinstance(rl.make_counter_backend("auto"),
                      rl.MemoryCounterBackend)
    with pytest.raises(RuntimeError, match="ARKS_NATIVE=0"):
        rl.make_counter_backend("native")
    assert isinstance(make_usage_scanner(), PyUsageScanner)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setenv("ARKS_NATIVE", "1")
    monkeypatch.setenv("ARKS_NATIVE_LIB", "/nonexistent/libarksgw.so")
    with pytest.raises(RuntimeError, match="nonexistent"):
        native.NativeCounterBackend()
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.delenv("ARKS_NATIVE_LIB")
    assert type(make_usage_scanner()).__name__ == "SseUsageScanner"


# ---------------------------------------------------------------------------
# The SSE usage scanner
# ---------------------------------------------------------------------------

def _frames():
    chunks = [{"id": "c1", "choices": [{"delta": {"content": "hi"}}],
               "usage": None},
              {"id": "c1", "choices": [], "usage": {
                  "prompt_tokens": 11, "completion_tokens": 7,
                  "total_tokens": 18}}]
    return ("".join(f"data: {json.dumps(c)}\n\n" for c in chunks)
            + "data: [DONE]\n\n").encode()


@pytest.mark.parametrize("raw", [
    _frames(),
    b'data: {"usage": {"prompt_tokens": 100, "completion_tokens": 1, '
    b'"total_tokens": 101}}\n\ndata: {"usage": {"prompt_tokens": 100, '
    b'"completion_tokens": 50}}\n\n',
    b'data: {"usage": {"prompt_tokens": 3, "completion_tokens": 2, '
    b'"total_tokens": 5}}\n\ndata: {"usage": {"prompt_tokens": "NaN"}}\n\n',
    b'data: {"usage": {"prompt_tokens": 4}, "total_tokens": 999}\n\n',
    b'data: {"usage": null}\r\n\r\ndata: [DONE]\r\n\r\n',
])
def test_native_scanner_agrees_with_both_python_scanners(raw):
    for n in (1, 3, 16, len(raw)):
        scanners = [native.SseUsageScanner(), PyUsageScanner(),
                    ref_native.SseUsageScanner(), RefPyScanner()]
        for i in range(0, len(raw), n):
            for s in scanners:
                s.feed(raw[i:i + n])
        assert len({json.dumps(s.usage()) for s in scanners}) == 1, n
        assert scanners[0].done == scanners[2].done


# ---------------------------------------------------------------------------
# The library's build
# ---------------------------------------------------------------------------

_BUILD = """
import sys, time
from pathlib import Path
from arks_tpu_torch.gateway import native
native.BUILD_DIR = Path(sys.argv[1])
while time.time() < float(sys.argv[2]):
    time.sleep(0.001)
b = native.NativeCounterBackend()
print(native.lib_path().name, b.incr("k", 2, 60), b.get("k"))
"""


def test_two_processes_build_the_library_at_once(tmp_path):
    """Two processes that build into one empty directory at the same
    moment each load a whole library: the build writes a temporary file of
    its own and renames it into place."""
    start = time.time() + 1.0
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD, str(tmp_path / "build"), str(start)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    name = native.lib_path().name
    assert [o[0].split() for o in outs] == [[name, "2", "2"]] * 2
    assert sorted(os.listdir(tmp_path / "build")) == [name]


# ---------------------------------------------------------------------------
# The gateway's entry point on each store
# ---------------------------------------------------------------------------

def test_gateway_entry_point_refuses_an_unreachable_redis():
    from arks_tpu_torch.gateway.__main__ import main
    with pytest.raises(ConnectionError):
        main(["--backend", "redis", "--redis-addr", "127.0.0.1:1",
              "--port", "0"])

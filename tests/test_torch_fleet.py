"""The port as a fleet member, on CPU ``tiny``: the disk prefix tier, peer
block fetch, the routing sketch and the disaggregated servers (the
counterparts of ``tests/test_disk_tier.py``, ``tests/test_peer_fetch.py``,
``tests/test_prefix_sketch.py`` and the server half of
``tests/test_disagg.py``).

- Disk tier: for the same blocks the port's files equal the reference's
  ``DiskPrefixTier`` files byte for byte, and each reads the other's; a
  restarted engine serves a warm prefix from disk with the warm stream;
  a stale epoch is refused, a corrupt block dropped, the byte budget kept
  and torn writes cleaned at boot; scale-to-zero leaves the warm blocks
  on disk.
- Peer fetch: a replica restores a peer's blocks instead of prefilling
  them, with the peer's stream; a peer that dies mid-fetch costs the
  restore of the rest, never the stream.
- Sketch: for the same membership the port's ``cache_sketch`` payload is
  the reference ``SketchExporter``'s, and the reference's router reader
  scores it alike.
- Servers: a port PrefillServer and DecodeServer over loopback, fronted by
  the reference's router in PD mode; both are freed by ``del`` at once."""

import gc
import hashlib
import http.client
import http.server
import json
import socket
import threading
import weakref

import ml_dtypes
import numpy as np
import pytest
import torch

from arks_tpu import prefix_sketch as jsketch
from arks_tpu.engine import prefix_cache as jprefix
from arks_tpu_torch.engine import EngineConfig, InferenceEngine, Request, \
    SamplingParams
from arks_tpu_torch.engine import kv_transfer
from arks_tpu_torch.engine import prefix_cache as tprefix
from arks_tpu_torch.engine.paged import chain_digests
from arks_tpu_torch.engine.tokenizer import ByteTokenizer
from arks_tpu_torch.models import get_config
from arks_tpu_torch.server.disagg import DecodeServer, PrefillServer
from arks_tpu_torch.server.openai_server import OpenAIServer

torch.set_num_threads(2)

KW = dict(model="tiny", num_slots=2, max_cache_len=64,
          prefill_buckets=(8, 16, 32), steps_per_dispatch=4,
          prefill_chunk=16, kv_layout="paged", prefix_cache_mb=0,
          dtype="float32")
VOCAB = get_config("tiny").vocab_size
WARM = [int(x) % VOCAB for x in range(3, 36)]          # 2 pages + a tail


def _mk(monkeypatch, ddir=None, host_mb="64", disk_mb="8", peer_fetch="0",
        **kw):
    monkeypatch.setenv("ARKS_PIPELINE_DEPTH", "0")
    monkeypatch.setenv("ARKS_PREFIX_HOST_MB", host_mb)
    monkeypatch.setenv("ARKS_PEER_FETCH", peer_fetch)
    monkeypatch.setenv("ARKS_PEER_FETCH_TIMEOUT_S", "5")
    monkeypatch.delenv("ARKS_PEER_ADDRS", raising=False)
    if ddir is None:
        monkeypatch.delenv("ARKS_PREFIX_DISK_MB", raising=False)
    else:
        monkeypatch.setenv("ARKS_PREFIX_DISK_MB", disk_mb)
        monkeypatch.setenv("ARKS_PREFIX_DISK_DIR", str(ddir))
    return InferenceEngine(get_config("tiny"), EngineConfig(**{**KW, **kw}),
                           ByteTokenizer(), device="cpu")


def _run_one(eng, rid, ids, peer_hint=None, max_tokens=4, seed=None):
    """One request driven from this thread to its end: (ids, finish)."""
    p = SamplingParams(max_tokens=max_tokens, ignore_eos=True,
                       temperature=0.0 if seed is None else 0.8, seed=seed)
    req = Request(rid, list(ids), p, peer_hint=peer_hint)
    eng.add_request(req)
    toks = []
    for _ in range(4000):
        eng.step(block_s=0.005)
        while not req.outputs.empty():
            out = req.outputs.get_nowait()
            toks += out.token_ids
            if out.finished:
                return toks, out.finish_reason
    raise AssertionError(f"{rid} did not finish")


def _churn(eng, n=5):
    for i in range(n):
        _run_one(eng, f"churn{i}", [(9 + i) % VOCAB] * 33, max_tokens=3)


# ---------------------------------------------------------------------------
# The disk tier's files
# ---------------------------------------------------------------------------


def _blocks(kind, n=3, seed=0):
    """n page blocks as (reference numpy dicts, port torch dicts)."""
    rng = np.random.default_rng(seed)
    shape = (2, 8, 16, 8)
    out = []
    for _ in range(n):
        r, p = {}, {}
        for name in ("k", "v"):
            if kind == "bf16":
                bits = rng.integers(0, 1 << 16, size=shape, dtype=np.uint16)
                bits &= 0x7F7F
                r[name] = bits.view(ml_dtypes.bfloat16)
                p[name] = torch.from_numpy(bits.view(np.int16).copy()).view(
                    torch.bfloat16)
            else:
                a = rng.integers(-127, 128, size=shape, dtype=np.int8)
                if kind == "int4":
                    a = ((a[..., 0::2] & 15) | (a[..., 1::2] << 4)).astype(
                        np.int8)
                r[name], p[name] = a, torch.from_numpy(a.copy())
        if kind != "bf16":
            for name in ("k_scale", "v_scale"):
                s = np.abs(rng.standard_normal(shape[:3])).astype(np.float32)
                r[name], p[name] = s, torch.from_numpy(s.copy())
        out.append((r, p))
    return out


def _dir_bytes(path):
    return {f.name: f.read_bytes() for f in sorted(path.iterdir())}


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_disk_files_equal_the_references(tmp_path, kind):
    """The same blocks put in the same order under the same epoch: both
    directories hold the same files with the same bytes (manifest
    included), each tier reads the other's directory back to the same
    bytes, and a file of another epoch is refused and counted."""
    blocks = _blocks(kind)
    digs = [hashlib.sha1(bytes([i])).digest() for i in range(len(blocks))]
    jt = jprefix.DiskPrefixTier(16, 1 << 20, str(tmp_path / "ref"), "e1")
    tt = tprefix.DiskPrefixTier(16, 1 << 20, str(tmp_path / "port"), "e1")
    for d, (r, p) in zip(digs, blocks):
        assert jt.put(d, r) and tt.put(d, p)
    assert _dir_bytes(tmp_path / "ref") == _dir_bytes(tmp_path / "port")
    assert tt.snapshot()[0] == jt.snapshot()[0] == digs
    assert tt.bytes_used == jt.bytes_used
    # Each side adopts and reads the other's directory.
    tt2 = tprefix.DiskPrefixTier(16, 1 << 20, str(tmp_path / "ref"), "e1")
    jt2 = jprefix.DiskPrefixTier(16, 1 << 20, str(tmp_path / "port"), "e1")
    for d, (r, p) in zip(digs, blocks):
        got, back = tt2.get(d), jt2.get(d)
        for f in r:
            assert got[f].dtype == p[f].dtype and torch.equal(
                got[f].view(torch.uint8), p[f].view(torch.uint8))
            assert back[f].tobytes() == np.asarray(r[f]).tobytes()
    # A stale epoch: the boot wipes, and a file smuggled in after is
    # refused on read.
    tt3 = tprefix.DiskPrefixTier(16, 1 << 20, str(tmp_path / "port"), "e2")
    assert tt3.num_blocks == 0 and tt3.get(digs[0]) is None
    (tmp_path / "port" / (digs[0].hex() + ".akv")).write_bytes(
        kv_transfer.pack_block(digs[0], "e1", blocks[0][1]))
    tt4 = tprefix.DiskPrefixTier(16, 1 << 20, str(tmp_path / "port"), "e2")
    assert tt4.has(digs[0]) and tt4.get(digs[0]) is None
    assert not tt4.has(digs[0]) and tt4.corrupt_blocks == 1


def test_disk_tier_budget_corruption_and_torn_writes(tmp_path):
    """The byte budget evicts LRU blocks and deletes their files; a
    truncated file is a counted miss and is deleted; a ``.tmp`` orphan of
    a torn write is removed at boot."""
    blocks = [p for _, p in _blocks("int8", n=4, seed=3)]
    t = tprefix.DiskPrefixTier(16, 1 << 20, str(tmp_path), "e")
    digs = [bytes([i + 1]) * 20 for i in range(4)]
    assert t.put(digs[0], blocks[0])
    t.capacity = int(t.bytes_used * 2.5)
    for d, b in zip(digs[1:], blocks[1:]):
        assert t.put(d, b)
    assert t.num_blocks == 2 and t.evicted_blocks == 2
    assert t.bytes_used <= t.capacity
    assert {f.name for f in tmp_path.glob("*.akv")} == {
        d.hex() + ".akv" for d in digs[2:]}
    path = tmp_path / (digs[3].hex() + ".akv")
    path.write_bytes(path.read_bytes()[:40])
    assert t.get(digs[3]) is None and t.corrupt_blocks == 1
    assert not path.exists() and not t.has(digs[3])
    orphan = tmp_path / ("dead" + ".akv.9.tmp")
    orphan.write_bytes(b"torn")
    t2 = tprefix.DiskPrefixTier(16, 1 << 20, str(tmp_path), "e")
    assert not orphan.exists() and t2.num_blocks == 1


# ---------------------------------------------------------------------------
# The disk tier in the engine
# ---------------------------------------------------------------------------


def test_restart_serves_the_warm_prefix_from_disk(monkeypatch, tmp_path):
    """A small host budget pushes the warm prompt's blocks through the
    host tier to disk; an engine rebuilt on the same directory serves the
    prompt with both full pages from disk (``prefix_cache_hit_tokens_total
    {tier="disk"}`` 32, only the tail prefilled) and the warm stream."""
    ddir = tmp_path / "store"
    a = _mk(monkeypatch, ddir, host_mb="1")
    a._host.capacity = 3 * a._page_bytes       # three pages of host RAM
    base = _run_one(a, "w1", WARM)
    seeded = _run_one(a, "s1", WARM, seed=5)
    _churn(a)
    a.stop()
    digs = chain_digests(WARM, 16, 2)
    assert all((ddir / (d.hex() + ".akv")).exists() for d in digs)
    assert a.metrics.prefix_cache_usage_bytes.get(tier="disk") > 0
    b = _mk(monkeypatch, ddir)
    assert all(b._disk.has(d) for d in digs), "the boot scan lost blocks"
    p0 = b.prefill_tokens_total
    try:
        assert _run_one(b, "w2", WARM) == base
        m = b.metrics
        assert m.prefix_cache_hit_tokens_total.get(tier="disk") == 32
        assert m.prefix_peer_fetch_blocks_total.get(source="disk") == 2
        assert b.prefill_tokens_total - p0 == len(WARM) - 32
        assert _run_one(b, "s2", WARM, seed=5) == seeded
    finally:
        b.stop()


def test_scale_to_zero_leaves_the_warm_blocks_on_disk(monkeypatch, tmp_path):
    """An idle engine with a disk tier flushes its device index and host
    tier to disk as it disarms; the sketch's epoch moves and tier 0 is
    empty while disarmed; the re-armed engine serves the prefix warm."""
    ddir = tmp_path / "store"
    monkeypatch.setenv("ARKS_ELASTIC_IDLE_ZERO_S", "0.05")
    eng = _mk(monkeypatch, ddir)
    base = _run_one(eng, "w1", WARM)
    digs = chain_digests(WARM, 16, 2)
    epoch0 = eng.cache_sketch()["epoch"]
    for _ in range(200):
        eng.step(block_s=0.005)
        if not eng.armed:
            break
    assert not eng.armed
    assert all(eng._disk.has(d) for d in digs)
    assert all((ddir / (d.hex() + ".akv")).exists() for d in digs)
    sk = eng.cache_sketch()
    assert sk["epoch"] != epoch0 and sk["tiers"]["device"]["count"] == 0
    assert sk["tiers"]["disk"]["count"] >= 2
    assert _run_one(eng, "w2", WARM) == base
    eng.stop()


# ---------------------------------------------------------------------------
# Peer fetch
# ---------------------------------------------------------------------------


def _warm_peer(monkeypatch):
    """Replica A with the warm prompt's blocks in its host tier (churn
    evicted its device pages), served over HTTP."""
    a = _mk(monkeypatch)
    base = _run_one(a, "w1", WARM)
    _churn(a)
    digs = chain_digests(WARM, 16, 2)
    assert all(a._host.has(d) for d in digs)
    srv = OpenAIServer(a, "tiny", host="127.0.0.1", port=0)
    srv.start()
    return a, srv, base, digs


def test_peer_fetch_restores_instead_of_prefilling(monkeypatch):
    """Replica B (``ARKS_PEER_FETCH=1``) with the hint: both full pages
    come from A over ``GET /v1/cache/blocks/``, only the tail is
    prefilled, the restored pages hold A's bytes and the stream is A's;
    the block endpoint answers 404 for a block A does not hold."""
    a, srv, base, digs = _warm_peer(monkeypatch)
    try:
        b = _mk(monkeypatch, peer_fetch="1")
        p0 = b.prefill_tokens_total
        assert _run_one(b, "w2", WARM,
                        peer_hint=f"127.0.0.1:{srv.port}") == base
        m = b.metrics
        assert m.prefix_peer_fetch_blocks_total.get(source="peer") == 2
        assert m.prefix_cache_hit_tokens_total.get(tier="peer") == 32
        assert b.prefill_tokens_total - p0 == len(WARM) - 32
        for d in digs:
            page = b._alloc._index[d]
            want = a._host.peek(d)
            assert torch.equal(b.cache.k[:, page], want["k"])
            assert torch.equal(b.cache.v[:, page], want["v"])
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
        conn.request("GET", "/v1/cache/blocks/" + "ab" * 20)
        assert conn.getresponse().status == 404
        conn.close()
        b.stop()
    finally:
        srv.stop()
        a.stop()


class _DyingPeer(http.server.ThreadingHTTPServer):
    """Serves one block, then drops every later connection mid-request."""

    daemon_threads = True

    def __init__(self, payloads):
        self.payloads, self.served = dict(payloads), 0
        super().__init__(("127.0.0.1", 0), _DyingHandler)


class _DyingHandler(http.server.BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 (http.server's name)
        buf = self.server.payloads.get(self.path)
        if self.server.served >= 1 or buf is None:
            self.connection.close()
            return
        self.server.served += 1
        self.send_response(200)
        self.send_header("Content-Length", str(len(buf)))
        self.end_headers()
        self.wfile.write(buf)

    def log_message(self, *a):
        pass


def test_a_peer_dying_mid_fetch_falls_back_to_prefill(monkeypatch):
    """The peer serves the first block and dies: that block restores, the
    rest is prefilled, the stream is the warm one, and nothing faults."""
    a, srv, base, digs = _warm_peer(monkeypatch)
    payloads = {f"/v1/cache/blocks/{d.hex()}": srv.block_payload(d.hex())
                for d in digs}
    srv.stop()
    a.stop()
    peer = _DyingPeer(payloads)
    threading.Thread(target=peer.serve_forever, daemon=True).start()
    b = _mk(monkeypatch, peer_fetch="1")
    try:
        assert _run_one(b, "w2", WARM, peer_hint="127.0.0.1:%d"
                        % peer.server_address[1]) == base
        m = b.metrics
        assert m.prefix_peer_fetch_blocks_total.get(source="peer") == 1
        assert m.prefix_cache_hit_tokens_total.get(tier="peer") == 16
        assert m.engine_faults_total.total() == 0 and b.state == "serving"
    finally:
        b.stop()
        peer.shutdown()
        peer.server_close()


# ---------------------------------------------------------------------------
# The routing sketch
# ---------------------------------------------------------------------------


def test_cache_sketch_equals_the_reference_exporters(monkeypatch, tmp_path):
    """An engine with blocks in all three tiers and a text link: its
    payload equals the reference ``SketchExporter``'s built from the same
    membership with the same boot epoch, and the reference router's
    ``BackendSketch`` scores both alike."""
    eng = _mk(monkeypatch, tmp_path / "store", host_mb="1")
    eng._host.capacity = 3 * eng._page_bytes
    text = "".join(chr(97 + i % 26) for i in range(600))
    ids = [min(ord(c), VOCAB - 1) for c in text[:600]][:33]
    eng.note_prompt_text({"prompt": text}, ids)
    _run_one(eng, "w1", WARM)
    _churn(eng, n=7)
    _run_one(eng, "t1", ids)
    while not eng._disk_write_queue.empty():
        threading.Event().wait(0.01)
    eng._sketch._boot = "0badcafe"
    got = eng.cache_sketch()
    ref = jsketch.SketchExporter(16)
    ref._boot = "0badcafe"
    ref.link(text, ids)
    dev, host, disk = (eng._alloc.index_snapshot()[0],
                       eng._host.snapshot()[0], eng._disk.snapshot()[0])
    assert dev and host and disk
    hits = eng.metrics.prefix_cache_hit_tokens_total
    want = ref.build(dev, 1, host, 1, disk=disk, disk_key=1, hit_tokens={
        t: hits.get(tier=t) for t in ("device", "host", "disk")},
        query_tokens=eng.metrics.prefix_cache_query_tokens_total.total(),
        extra={"model": "tiny"})
    for p in (got, want):
        p.pop("built_unix")
    assert got == want
    assert got["tiers"]["device"]["text_count"] >= 1
    chains = [chain_digests(WARM, 16, 2), chain_digests(ids, 16, 2),
              chain_digests([(9 + 6) % VOCAB] * 33, 16, 2)]
    g, w = (jsketch.BackendSketch.from_payload(x) for x in (got, want))
    for ch in chains:
        assert g.score_chain(ch) == w.score_chain(ch)
    assert g.score_chain(list(jsketch.iter_text_digests(text, 256)),
                         "text") == w.score_chain(
        list(jsketch.iter_text_digests(text, 256)), "text")
    eng.stop()


# ---------------------------------------------------------------------------
# The disaggregated servers
# ---------------------------------------------------------------------------


def _post(port, path, body, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", path, body=json.dumps(body), headers=dict(
        {"Content-Type": "application/json"}, **(headers or {})))
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, json.loads(data) if data[:1] == b"{" else data


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    return resp.status, data


def _pair(monkeypatch):
    monkeypatch.setenv("ARKS_PIPELINE_DEPTH", "0")
    engines = [InferenceEngine(get_config("tiny"), EngineConfig(**KW),
                               ByteTokenizer(), device="cpu")
               for _ in range(2)]
    ps = PrefillServer(engines[0], "tiny", host="127.0.0.1", port=0)
    ds = DecodeServer(engines[1], "tiny", host="127.0.0.1", port=0)
    ps.start()
    ds.start()
    engines[1].start()
    return engines, ps, ds


def test_prefill_and_decode_servers_over_loopback(monkeypatch):
    """``/v1/disagg/*`` pulls from the prefill server and answers what the
    unified endpoint answers (completions and chat, streamed too); a
    prompt past the prefill limit is 400 ``context_length_exceeded``; a
    dead prefill server 502; no header 400; ``n`` > 1 and ``echo`` 400;
    the prefill server's completions 501 and its readiness 200 without a
    loop; then the reference's router in PD mode fronts the pair, and the
    port's router does the same."""
    from arks_tpu.router import Discovery, Router
    from arks_tpu_torch import router as port_router
    (pe, de), ps, ds = _pair(monkeypatch)
    hdr = {"X-Arks-Prefill-Addr": f"127.0.0.1:{ps.port}"}
    body = {"model": "tiny", "prompt": "hello fleet of replicas",
            "max_tokens": 6, "temperature": 0, "ignore_eos": True}
    chat = {"model": "tiny", "max_tokens": 5, "temperature": 0.7, "seed": 4,
            "messages": [{"role": "user", "content": "hi there"}]}
    routers = []
    try:
        st, dis = _post(ds.port, "/v1/disagg/completions", body, hdr)
        assert st == 200
        st, uni = _post(ds.port, "/v1/completions", body)
        assert dis["choices"] == uni["choices"]
        assert dis["usage"] == uni["usage"]
        st, dchat = _post(ds.port, "/v1/disagg/chat/completions", chat, hdr)
        _, uchat = _post(ds.port, "/v1/chat/completions", chat)
        assert st == 200 and dchat["choices"] == uchat["choices"]
        st, err = _post(ds.port, "/v1/disagg/completions",
                        dict(body, prompt="x" * 40), hdr)
        assert (st, err["error"]["code"]) == (400, "context_length_exceeded")
        assert _post(ds.port, "/v1/disagg/completions", body,
                     {"X-Arks-Prefill-Addr": "127.0.0.1:1"})[0] == 502
        assert _post(ds.port, "/v1/disagg/completions", body)[0] == 400
        # The prefill server refuses n > 1 first: the pull fails (502 with
        # its reason), as the reference's pair answers.
        st, err = _post(ds.port, "/v1/disagg/completions", dict(body, n=2),
                        hdr)
        assert st == 502 and "n > 1" in err["error"]["message"]
        assert _post(ds.port, "/v1/disagg/completions", dict(body, echo=True),
                     hdr)[0] == 400
        assert _post(ps.port, "/v1/completions", body)[0] == 501
        assert _get(ps.port, "/readiness")[0] == 200
        # Readiness carries the sketch's epoch and version, not the sketch.
        st, ready = _get(ds.port, "/readiness")
        _, sketch = _get(ds.port, "/v1/cache/sketch")
        assert st == 200 and ready["sketch"]["enabled"] is True
        assert (ready["sketch"]["epoch"], ready["sketch"]["version"]) == \
            (sketch["epoch"], sketch["version"])
        assert sketch["tiers"]["device"]["count"] >= 1
        for disc_cls, router_cls in ((Discovery, Router),
                                     (port_router.Discovery,
                                      port_router.Router)):
            disc = disc_cls(None)
            disc.add("prefill", f"127.0.0.1:{ps.port}")
            disc.add("decode", f"127.0.0.1:{ds.port}")
            router = router_cls(disc, "tiny", host="127.0.0.1", port=0)
            routers.append(router)
            router.start(background=True)
            st, routed = _post(router.port, "/v1/completions", body)
            assert st == 200 and routed["choices"] == uni["choices"]
        st, rchat = _post(router.port, "/v1/chat/completions", chat)
        assert st == 200 and rchat["choices"] == uchat["choices"]
    finally:
        for router in routers:
            router.stop()
            # Its sketch poller may be polling still: a poll that outlived
            # the test would reach the next test's server on a reused port.
            if router.sketches._thread is not None:
                router.sketches._thread.join(10)
        ps.stop()
        ds.stop()
        de.stop()


def test_disaggregated_servers_are_freed_without_a_gc_pass(monkeypatch):
    """Both servers, having answered a disaggregated request and stopped,
    free themselves and their engines when dropped by ``del``."""
    gc.collect()
    gc.disable()
    try:
        (pe, de), ps, ds = _pair(monkeypatch)
        st, _ = _post(ds.port, "/v1/disagg/completions",
                      {"prompt": "free me", "max_tokens": 3},
                      {"X-Arks-Prefill-Addr": f"127.0.0.1:{ps.port}"})
        assert st == 200
        ps.stop()
        ds.stop()
        de.stop()
        refs = [weakref.ref(x) for x in (pe, de, ps, ds)]
        del pe, de, ps, ds
        assert [r() for r in refs] == [None] * 4
    finally:
        gc.enable()


def test_a_free_port_is_refused_by_a_dead_peer_probe():
    """``_BlockFetcher.block_get`` of a closed port is a miss, not a
    raise."""
    from arks_tpu_torch.engine.engine import _BlockFetcher
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    f = _BlockFetcher(None, None, [], 2.0, "e", None)
    assert f.block_get(f"127.0.0.1:{port}", b"\0" * 20) is None

"""Disaggregated-serving router (the port's copy of
``arks_tpu/router/__init__.py``).

The reference deploys ``sglang_router.launch_router --pd-disaggregation
--service-discovery --prefill-selector ... --decode-selector ...``
(internal/controller/arksdisaggregatedapplication_controller.go:1630-1670).
This is the native equivalent: an OpenAI-surface HTTP server that, per
request, picks one prefill and one decode backend and forwards the request
to the decode server with the chosen prefill address in the
``X-Arks-Prefill-Addr`` header; the decode server pulls the KV directly
from the prefill server (one KV hop — the router never carries KV bytes).
It is pure I/O: it imports no torch.

Service discovery: a JSON file ``{"prefill": ["host:port"...],
"decode": [...]}`` re-read on mtime change, which the operator's
DisaggregatedApplication controller maintains, with ``ARKS_PREFILL_ADDRS``
/ ``ARKS_DECODE_ADDRS`` as the fallback.  The reference's Kubernetes
label-selector discovery (``KubeDiscovery``) needs the Kubernetes client,
which the port does not have yet (``ROADMAP.md`` queue 1 item 5.3).

Routing policies (the reference router's ``--policy`` flag, default
``cache_aware`` in its generated command line):

- ``round_robin``: rotate over ready backends.
- ``cache_aware``: prefer the backend whose prefix caches ACTUALLY hold
  the request's prefix.  Decode backends export a prefix-digest sketch
  (``GET /v1/cache/sketch`` — a versioned bloom/top-K summary of the
  chain digests resident in tier 0 and tier 1, see
  arks_tpu_torch.prefix_sketch); an async poller keeps a per-backend copy,
  and ``_pick`` scores candidates by *expected hit depth*: walk the
  request's digest chain against each sketch — tokenize-free, in the
  token domain for pre-tokenized prompts and the text domain otherwise —
  and take the deepest hit, tier-0 weighted.  Fallback ladder when
  sketches are stale/absent or scores tie: least-loaded, then
  rendezvous-hashing the prompt *prefix* (which also keeps remapping
  minimal when backends come and go — only the moved backend's keys
  reshuffle).  ``ARKS_ROUTER_SKETCH=0`` turns scoring off entirely
  (rendezvous-only, the pre-sketch behavior).
"""

from __future__ import annotations

import hashlib
import http.client
import itertools
import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from arks_tpu_torch import knobs
from arks_tpu_torch import prefix_sketch as sketch_mod
from arks_tpu_torch import tenancy
from arks_tpu_torch.gateway.metrics import RouterMetrics
from arks_tpu_torch.obs import logctx
from arks_tpu_torch.obs import trace as trace_mod
from arks_tpu_torch.utils.swallow import swallowed

log = logging.getLogger("arks_tpu_torch.router")
logctx.install(log)

# Trace propagation rides the same switch the engine tracer uses; the
# router keeps no span store of its own — its completed spans travel in
# the x-arks-trace-spans header and assemble engine-side.
_TRACE_ON = knobs.get_bool("ARKS_TRACE")

HDR_PREFILL_ADDR = "X-Arks-Prefill-Addr"
HDR_TIER = "x-arks-tier"   # SLO tier (arks_tpu_torch.slo), forwarded verbatim
# Fleet prefix cache: the decode backend the router's sketches say holds
# the request's warm prefix DEEPEST.  Forwarded whenever it differs from
# the backend actually chosen (load/ties/failover can route elsewhere) —
# the engine's peer fetch (ARKS_PEER_FETCH) then pulls the blocks from
# this peer instead of re-prefilling.
HDR_PEER_HINT = "X-Arks-Peer-Hint"


class Discovery:
    """mtime-cached backend lists from a discovery file (+ env fallback).

    A programmatic overlay (``add``/``remove``) sits ON TOP of the file/
    env lists: planned membership changes (Router.plan_join / plan_leave,
    the elastic scale-up handoff) take effect immediately and survive file
    reloads — the controller's discovery file catching up later is a
    no-op, not a flap.  ``remove`` also MASKS a file-listed backend, so a
    planned leave can run ahead of the file update."""

    def __init__(self, path: str | None):
        self.path = path
        self._mtime = 0.0
        self._lock = threading.Lock()
        self._prefill: list[str] = _env_addrs("ARKS_PREFILL_ADDRS")
        self._decode: list[str] = _env_addrs("ARKS_DECODE_ADDRS")
        self._extra: dict[str, list[str]] = {"prefill": [], "decode": []}
        self._masked: dict[str, set[str]] = {"prefill": set(),
                                             "decode": set()}

    def add(self, role: str, addr: str) -> None:
        """Admit ``addr`` to ``role`` ahead of the discovery file."""
        if role not in ("prefill", "decode"):
            raise ValueError(f"unknown backend role {role!r}")
        with self._lock:
            self._masked[role].discard(addr)
            if addr not in self._extra[role]:
                self._extra[role].append(addr)

    def remove(self, role: str, addr: str) -> None:
        """Withdraw ``addr`` from ``role`` (and mask it if file-listed)."""
        if role not in ("prefill", "decode"):
            raise ValueError(f"unknown backend role {role!r}")
        with self._lock:
            if addr in self._extra[role]:
                self._extra[role].remove(addr)
            self._masked[role].add(addr)

    def backends(self) -> tuple[list[str], list[str]]:
        if self.path and os.path.exists(self.path):
            try:
                mtime = os.path.getmtime(self.path)
                with self._lock:
                    if mtime != self._mtime:
                        with open(self.path) as f:
                            data = json.load(f)
                        self._prefill = list(data.get("prefill", []))
                        self._decode = list(data.get("decode", []))
                        self._mtime = mtime
            except (OSError, ValueError, json.JSONDecodeError):
                log.warning("bad discovery file %s", self.path, exc_info=True)
        with self._lock:
            out = []
            for role, base in (("prefill", self._prefill),
                               ("decode", self._decode)):
                merged = [a for a in base if a not in self._masked[role]]
                merged += [a for a in self._extra[role] if a not in merged]
                out.append(merged)
            return out[0], out[1]


def _env_addrs(name: str) -> list[str]:
    return knobs.get_list(name)


# Prompt-prefix window the cache_aware policy keys on.  Long enough to
# separate distinct system prompts, short enough that divergent tails (the
# user turn) don't defeat the affinity.
_PREFIX_KEY_CHARS = 512


def _prefix_key(body: bytes) -> bytes | None:
    """Locality key: the first _PREFIX_KEY_CHARS of the prompt text."""
    try:
        obj = json.loads(body)
    except (ValueError, UnicodeDecodeError):
        return None
    return _prefix_key_obj(obj)


def _prefix_key_obj(obj) -> bytes | None:
    """Locality key from a parsed body.  Text extraction (content-part
    joining, stop-at-unknown-shape so later turns never leak into the
    key) lives in prefix_sketch.canonical_prompt_text — the SAME scan the
    sketch's text-domain digests use, so the rendezvous key and the
    scoring chain always agree on what "the prompt text" is.  Prompts
    with no usable text get no key (round-robin — never pin them all to
    one backend via a shared empty key), EXCEPT pre-tokenized token-id
    prompts, which key on their leading id window."""
    if not isinstance(obj, dict):
        return None
    text = sketch_mod.canonical_prompt_text(obj)
    if text:
        return text[:_PREFIX_KEY_CHARS].encode("utf-8", "surrogatepass")
    ids = _token_prompt(obj)
    if ids:
        return json.dumps(ids[:64]).encode()
    return None


def _token_prompt(obj) -> list | None:
    """The request's pre-tokenized prompt ids, or None.  These score in
    the token domain — the engine's exact chain digests — with no
    tokenizer anywhere near the router."""
    p = obj.get("prompt") if isinstance(obj, dict) else None
    if (isinstance(p, list) and p
            and all(isinstance(t, int) and not isinstance(t, bool)
                    for t in p)):
        return p
    return None


def _rendezvous(key: bytes, backends: list[str]) -> str:
    """Highest-random-weight choice: stable per key, minimal remap on
    backend churn."""
    return max(backends,
               key=lambda b: hashlib.sha1(key + b"\x00" + b.encode()).digest())


class _SketchPoller:
    """Per-backend prefix-digest sketch cache, refreshed by one
    background thread off the request path (requests only ever read the
    last accepted copy — a slow backend degrades to a stale sketch and
    the fallback ladder, never to requests blocking on a poll).

    Epoch discipline: a backend that restarts or fault-resets comes back
    with a new epoch; the poller replaces its copy wholesale on every
    successful fetch (counting epoch changes), and the forward path's
    connection errors invalidate eagerly — a dead backend's pre-restart
    sketch must not keep winning placement until the poll interval
    catches up."""

    def __init__(self, router: "Router", interval_s: float, stale_s: float):
        self.router = router
        self.interval = interval_s
        self.stale = stale_s
        self._lock = threading.Lock()
        self._state: dict[str, dict] = {}   # addr -> {"sketch", "at"}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop,
                                            name="router-sketch", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.poll_once()
            except Exception:
                log.warning("sketch poll failed", exc_info=True)

    def poll_once(self) -> None:
        """One refresh round over the current decode set (also the test/
        bench entry point — deterministic, no thread required)."""
        _, decode = self.router.discovery.backends()
        m = self.router.metrics
        now = time.monotonic()
        for addr in decode:
            payload = self._fetch(addr)
            if payload is None:
                # Unreachable or malformed: keep the last accepted copy
                # until the staleness deadline retires it in get().
                continue
            bs = sketch_mod.BackendSketch.from_payload(payload)
            with self._lock:
                prev = self._state.get(addr)
                if not bs.enabled:
                    self._state[addr] = {"sketch": None, "at": now}
                    continue
                if (prev is not None and prev["sketch"] is not None
                        and prev["sketch"].epoch != bs.epoch):
                    # Backend restarted/reset between polls: the old
                    # sketch described a cache that no longer exists.
                    m.sketch_epoch_drops_total.inc(backend=addr)
                self._state[addr] = {"sketch": bs, "at": now}
            for tier, v in bs.hit_tokens.items():
                m.backend_hit_tokens.set(v, backend=addr, tier=tier)
        with self._lock:
            for addr in list(self._state):
                if addr not in decode:
                    del self._state[addr]
            ages = {a: max(0.0, now - st["at"])
                    for a, st in self._state.items()}
        for addr, age in ages.items():
            m.sketch_age.set(age, backend=addr)

    def _fetch(self, addr: str) -> dict | None:
        host, _, port = addr.partition(":")
        try:
            conn = http.client.HTTPConnection(host, int(port or 80),
                                              timeout=2.0)
            try:
                conn.request("GET", "/v1/cache/sketch")
                resp = conn.getresponse()
                data = resp.read()
                if resp.status != 200:
                    return None
                obj = json.loads(data)
                return obj if isinstance(obj, dict) else None
            finally:
                conn.close()
        except (OSError, http.client.HTTPException, ValueError):
            return None

    def get(self, addr: str) -> "sketch_mod.BackendSketch | None":
        """The backend's sketch if fresh; None when absent, disabled, or
        past the ARKS_ROUTER_SKETCH_STALE_S deadline."""
        with self._lock:
            st = self._state.get(addr)
            if st is None or st["sketch"] is None:
                return None
            if time.monotonic() - st["at"] > self.stale:
                return None
            return st["sketch"]

    def invalidate(self, addr: str) -> None:
        with self._lock:
            self._state.pop(addr, None)

    def prime(self, addr: str) -> bool:
        """Seed a joining backend's sketch BEFORE it enters routing (the
        planned-membership handoff).  A prime is the backend's first
        observation, so it NEVER counts as an epoch drop — the drop
        counter stays reserved for restarts/resizes of an already-known
        backend.  Returns True when a sketch (enabled or not) was
        fetched and stored."""
        payload = self._fetch(addr)
        if payload is None:
            return False
        bs = sketch_mod.BackendSketch.from_payload(payload)
        with self._lock:
            self._state[addr] = {
                "sketch": bs if bs.enabled else None,
                "at": time.monotonic()}
        return True


class Router:
    def __init__(self, discovery: Discovery, served_model_name: str,
                 host: str = "0.0.0.0", port: int = 8080,
                 policy: str = "cache_aware", unified: bool = False):
        if policy not in ("round_robin", "cache_aware"):
            raise ValueError(f"unknown policy {policy!r}")
        self.discovery = discovery
        self.served_model_name = served_model_name
        self.host, self.port = host, port
        self.policy = policy
        # Unified mode: backends are plain OpenAI servers (no prefill/
        # decode split) — only the decode list is consulted, and requests
        # forward to the ordinary path with no prefill header.
        self.unified = unified or knobs.get_bool("ARKS_ROUTER_UNIFIED")
        self._rr = itertools.count()
        self._httpd: ThreadingHTTPServer | None = None
        self.metrics = RouterMetrics()
        self.registry = self.metrics.registry
        self.requests_total = self.metrics.requests_total
        self.backends_gauge = self.metrics.backends
        self.retries_total = self.metrics.retries_total
        # Sketch scoring (cache_aware only; ARKS_ROUTER_SKETCH=0 restores
        # the rendezvous-only behavior).
        self.sketch_on = (policy == "cache_aware"
                          and knobs.get_bool("ARKS_ROUTER_SKETCH"))
        self._t0_weight = knobs.get_float("ARKS_ROUTER_SKETCH_T0_WEIGHT")
        self._disk_weight = knobs.get_float("ARKS_ROUTER_SKETCH_DISK_WEIGHT")
        self._max_blocks = knobs.get_int("ARKS_ROUTER_SKETCH_MAX_BLOCKS")
        poll_s = knobs.get_float("ARKS_ROUTER_SKETCH_POLL_S")
        stale_s = knobs.get_float("ARKS_ROUTER_SKETCH_STALE_S")
        self.sketches = _SketchPoller(self, poll_s, stale_s)
        # In-flight forwards per decode backend (least-loaded fallback).
        self._load_lock = threading.Lock()
        self._inflight: dict[str, int] = {}

    # ------------------------------------------------------------------

    def start(self, background: bool = True) -> None:
        router = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _json(self, code: int, payload: dict) -> None:
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _error(self, code: int, message: str) -> None:
                self._json(code, {"error": {"message": message, "code": code}})

            def do_GET(self):
                if self.path == "/v1/models":
                    self._json(200, {"object": "list", "data": [
                        {"id": router.served_model_name, "object": "model",
                         "created": int(time.time()), "owned_by": "arks-tpu"}]})
                elif self.path == "/metrics":
                    text = router.registry.render().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(text)))
                    self.end_headers()
                    self.wfile.write(text)
                elif self.path in ("/healthz", "/health"):
                    self._json(200, {"status": "ok"})
                elif self.path == "/readiness":
                    pre, dec = router.discovery.backends()
                    if dec and (pre or router.unified):
                        self._json(200, {"status": "ready"})
                    else:
                        self._error(503, "no prefill/decode backends yet")
                else:
                    self._error(404, f"no route {self.path}")

            def do_POST(self):
                if self.path not in ("/v1/chat/completions", "/v1/completions"):
                    return self._error(404, f"no route {self.path}")
                router._route(self)

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_port
        if self.sketch_on:
            self.sketches.start()
        if background:
            threading.Thread(target=self._httpd.serve_forever, name="router",
                             daemon=True).start()
        else:
            self._httpd.serve_forever()

    def stop(self) -> None:
        self.sketches.stop()
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()

    # ---- planned membership (elastic scale-up/down handoff) ----------

    def plan_join(self, addr: str, role: str = "decode",
                  timeout_s: float | None = None) -> dict:
        """Admit a (re-)armed backend through a PLANNED handoff: gate on
        its /readiness (a scaled-to-zero replica 503s until re-armed and
        warm-up has been issued), prime its sketch drop-free, and only
        then add it to routing — the joining replica never sees traffic
        before it can serve, so a mid-workload join produces zero 5xx.
        Returns join stats; raises TimeoutError when the backend never
        went ready within ARKS_ELASTIC_JOIN_TIMEOUT_S."""
        if timeout_s is None:
            timeout_s = knobs.get_float("ARKS_ELASTIC_JOIN_TIMEOUT_S")
        add = getattr(self.discovery, "add", None)
        if add is None:
            raise TypeError(
                f"discovery {type(self.discovery).__name__} does not "
                "support programmatic membership (plan_join needs "
                "Discovery.add)")
        t0 = time.monotonic()
        polls = 0
        deadline = t0 + max(timeout_s, 0.0)
        while True:
            polls += 1
            if self._backend_ready(addr):
                break
            if time.monotonic() >= deadline:
                self.metrics.planned_membership_total.inc(
                    op="join", outcome="timeout")
                raise TimeoutError(
                    f"backend {addr} not ready after {timeout_s:.1f}s "
                    "(ARKS_ELASTIC_JOIN_TIMEOUT_S)")
            time.sleep(min(0.05, max(deadline - time.monotonic(), 0.0)))
        primed = False
        if self.sketch_on and role == "decode":
            primed = self.sketches.prime(addr)
        add(role, addr)
        dt = time.monotonic() - t0
        self.metrics.planned_membership_total.inc(op="join", outcome="ok")
        self.metrics.join_seconds.set(dt, backend=addr)
        log.info("planned join: %s role=%s ready after %d poll(s) in "
                 "%.3fs (sketch primed=%s)", addr, role, polls, dt, primed)
        return {"addr": addr, "role": role, "seconds": dt,
                "ready_polls": polls, "sketch_primed": primed}

    def plan_leave(self, addr: str, role: str = "decode") -> dict:
        """Withdraw a backend from routing (scale-down / maintenance):
        remove it from membership and drop its sketch so placement stops
        crediting a cache that is about to disappear.  In-flight streams
        on the leaving backend finish naturally — the router only stops
        sending NEW work."""
        remove = getattr(self.discovery, "remove", None)
        if remove is None:
            raise TypeError(
                f"discovery {type(self.discovery).__name__} does not "
                "support programmatic membership (plan_leave needs "
                "Discovery.remove)")
        remove(role, addr)
        self.sketches.invalidate(addr)
        self.metrics.planned_membership_total.inc(op="leave", outcome="ok")
        log.info("planned leave: %s role=%s", addr, role)
        return {"addr": addr, "role": role}

    def _backend_ready(self, addr: str) -> bool:
        host, _, port = addr.partition(":")
        try:
            conn = http.client.HTTPConnection(host, int(port or 80),
                                              timeout=2.0)
            try:
                conn.request("GET", "/readiness")
                resp = conn.getresponse()
                resp.read()
                return resp.status == 200
            finally:
                conn.close()
        except (OSError, http.client.HTTPException, ValueError):
            return False

    # ------------------------------------------------------------------

    def _route(self, h) -> None:
        status = 500
        started = [False]  # response headers already sent to the client
        # Always drain the body first: an early error response with the body
        # unread desyncs HTTP/1.1 keep-alive connections.
        body = h.rfile.read(int(h.headers.get("Content-Length", 0)))
        # Continue the gateway-propagated trace (or root one for direct
        # clients); the pick span completes here and travels downstream in
        # the spans header — the engine's store is the assembly point.
        ctx = (trace_mod.TraceCtx.from_headers(h.headers)
               if _TRACE_ON else None)
        try:
            with logctx.bound(trace_id=ctx.trace_id if ctx else None):
                prefill, decode = self.discovery.backends()
                if self.unified:
                    # Unified deployments list their backends under
                    # "decode" (or only set ARKS_DECODE_ADDRS); there is
                    # no prefill tier to pick.
                    prefill = []
                self.backends_gauge.set(len(prefill), role="prefill")
                self.backends_gauge.set(len(decode), role="decode")
                if not decode or (not prefill and not self.unified):
                    status = 503
                    return h._error(503, "no ready prefill/decode backends")
                t0 = time.monotonic()
                hint_out: list = []
                p, candidates = self._pick(body, prefill, decode,
                                           hint_out=hint_out)
                if ctx is not None:
                    ctx.upstream.append({
                        "component": "router", "name": "router.pick",
                        "start": t0, "end": time.monotonic(),
                        "arg": candidates[0]})
                status = self._forward_failover(
                    h, body, p, candidates[0], candidates, started,
                    ctx=ctx, peer_hint=(hint_out[0] if hint_out else None))
        except (BrokenPipeError, ConnectionResetError):
            status = 499
        except Exception as e:
            log.exception("router failure")
            if started[0]:
                # Headers (and possibly chunks) already went out: a second
                # response would corrupt the stream — just drop the
                # connection so the client sees a clean truncation.
                h.close_connection = True
            else:
                try:
                    h._error(500, f"router error: {e}")
                except Exception as e2:
                    # Client hung up before the error response went out.
                    swallowed("router.error-response", e2)
        finally:
            self.requests_total.inc(status=str(status))

    def _pick(self, body: bytes, prefill: list[str],
              decode: list[str], hint_out: list | None = None
              ) -> tuple[str, tuple[str, ...]]:
        """(prefill addr, decode candidates in preference order).  The
        failover path walks the decode tuple in exactly this order, so
        sketch scoring shapes the retry sequence too — while the failover
        semantics themselves (when to move on, backoff, Retry-After) stay
        untouched.  Unified mode returns "" for prefill.  ``hint_out``
        (when given) receives the peer-hint backend: the one whose
        sketch covers the request deepest, for the X-Arks-Peer-Hint
        header when routing lands elsewhere."""
        if self.policy == "cache_aware":
            try:
                obj = json.loads(body)
            except (ValueError, UnicodeDecodeError):
                obj = None
            key = _prefix_key_obj(obj)
            if key is not None:
                p = _rendezvous(key, prefill) if prefill else ""
                return p, tuple(self._order_decode(obj, key, decode,
                                                   hint_out))
            if self.sketch_on:
                self.metrics.route_decisions_total.inc(reason="no_key")
        n = next(self._rr)
        p = prefill[n % len(prefill)] if prefill else ""
        i = n % len(decode)
        return p, tuple(decode[i:] + decode[:i])

    def _order_decode(self, obj, key: bytes, decode: list[str],
                      hint_out: list | None = None) -> list[str]:
        """Decode candidates by expected prefix hit depth, deepest first.

        Scoring walks the request's digest chain against each backend's
        sketch (token domain for pre-tokenized prompts — the engine's
        exact keys — else the text domain fed by the server's alignment
        ledger) and weights tier-0 blocks by 1 + ARKS_ROUTER_SKETCH_T0_
        WEIGHT over tier-1 blocks (a device hit is free; a host hit costs
        one H2D restore); tier-2 (disk) blocks weigh ARKS_ROUTER_SKETCH_
        DISK_WEIGHT — a disk hit costs a file read plus the restore, but
        still beats re-prefill.  Fallback ladder: no fresh sketch
        anywhere -> rendezvous (reason stale_sketch); tied scores,
        including the all-zero case -> least in-flight, then rendezvous
        among the still tied (tie_fallback); a unique deepest hit wins
        (sketch_hit).  ``hint_out`` receives the deepest-covering
        backend regardless of who wins routing — ties and load can send
        the request elsewhere, and the peer hint is how the warm blocks
        still get used (engine-side ARKS_PEER_FETCH)."""
        def rz(b: str) -> bytes:
            return hashlib.sha1(key + b"\x00" + b.encode()).digest()

        if not self.sketch_on:
            return sorted(decode, key=rz, reverse=True)
        m = self.metrics
        ids = _token_prompt(obj)
        text = None if ids is not None else sketch_mod.canonical_prompt_text(
            obj)
        scores: dict[str, tuple[int, int]] = {}
        chains: dict[tuple, list[bytes]] = {}
        saw_sketch = False
        for b in decode:
            bs = self.sketches.get(b)
            if bs is None:
                continue
            saw_sketch = True
            if ids is not None and bs.page_tokens > 0:
                domain, block = "token", bs.page_tokens
                if (domain, block) not in chains:
                    nb = min(len(ids) // block, self._max_blocks)
                    chains[(domain, block)] = sketch_mod.chain_digests(
                        ids, block, nb)
            elif text is not None and bs.text_chars > 0:
                domain, block = "text", bs.text_chars
                if (domain, block) not in chains:
                    digs: list[bytes] = []
                    for d in sketch_mod.iter_text_digests(text, block):
                        digs.append(d)
                        if len(digs) >= self._max_blocks:
                            break
                    chains[(domain, block)] = digs
            else:
                continue
            chain = chains[(domain, block)]
            if chain:
                scores[b] = bs.score_chain(chain, domain)
        if not saw_sketch:
            m.route_decisions_total.inc(reason="stale_sketch")
            return sorted(decode, key=rz, reverse=True)
        w = self._t0_weight
        dw = self._disk_weight

        def val(b: str) -> float:
            dev, host, disk = scores.get(b, (0, 0, 0))
            return dev * (1.0 + w) + host + disk * dw

        if hint_out is not None and scores:
            deepest = max(scores, key=lambda b: (sum(scores[b]), rz(b)))
            if sum(scores[deepest]) > 0:
                hint_out.append(deepest)
        best = max(val(b) for b in decode)
        tied = [b for b in decode if val(b) == best]
        if best > 0 and len(tied) == 1:
            chosen = tied[0]
            m.route_decisions_total.inc(reason="sketch_hit")
            dev, host, disk = scores[chosen]
            if dev:
                m.expected_hit_blocks_total.inc(dev, backend=chosen,
                                                tier="device")
            if host:
                m.expected_hit_blocks_total.inc(host, backend=chosen,
                                                tier="host")
            if disk:
                m.expected_hit_blocks_total.inc(disk, backend=chosen,
                                                tier="disk")
        else:
            with self._load_lock:
                load = {b: self._inflight.get(b, 0) for b in tied}
            least = min(load.values())
            quiet = [b for b in tied if load[b] == least]
            chosen = max(quiet, key=rz)
            m.route_decisions_total.inc(reason="tie_fallback")
        rest = sorted((b for b in decode if b != chosen),
                      key=lambda b: (val(b), rz(b)), reverse=True)
        return [chosen] + rest

    def _forward_failover(self, h, body: bytes, prefill_addr: str,
                          decode_addr: str, decode: list[str],
                          started: list[bool], ctx=None,
                          peer_hint: str | None = None) -> int:
        """Backend failover: the picked decode backend first, then every
        other ready one, retried for ONE bounded backoff round — a request
        moves to the next backend on a connection error or a 503
        (draining/recovering replica) IFF no response bytes have been
        streamed to the client yet.  When every backend 503s, the largest
        Retry-After the backends offered passes through so clients back
        off the amount the slowest replica asked for."""
        candidates = [decode_addr] + [b for b in decode if b != decode_addr]
        backoff = knobs.get_float("ARKS_ROUTER_RETRY_BACKOFF_S")
        retry_after: str | None = None
        last_err: Exception | None = None
        for attempt in range(2):
            if attempt:
                time.sleep(backoff)  # one bounded backoff round, then give up
            for cand in candidates:
                try:
                    with self._load_lock:
                        self._inflight[cand] = self._inflight.get(cand, 0) + 1
                    try:
                        status, ra = self._forward(h, body, prefill_addr,
                                                   cand, started, ctx=ctx,
                                                   peer_hint=peer_hint)
                    finally:
                        with self._load_lock:
                            self._inflight[cand] -= 1
                except (OSError, http.client.HTTPException) as e:
                    # The backend may have restarted: its sketch is no
                    # longer evidence of cache residency — drop it now
                    # instead of waiting out the staleness deadline.
                    self.sketches.invalidate(cand)
                    if started[0]:
                        # Bytes already reached the client: a retry would
                        # splice two streams — surface the truncation.
                        raise
                    last_err = e
                    self.retries_total.inc(reason="connect_error")
                    log.warning("decode backend %s unreachable (%s); "
                                "trying next", cand, e)
                    continue
                if status is None:
                    # 503 captured before any relay: replica draining or
                    # recovering — another backend may accept.
                    retry_after = ra or retry_after
                    self.retries_total.inc(reason="backend_503")
                    continue
                return status
        data = json.dumps({"error": {
            "message": ("no decode backend accepted the request"
                        + (f" (last error: {last_err})" if last_err else "")),
            "code": 503}}).encode()
        h.send_response(503)
        if retry_after:
            h.send_header("Retry-After", retry_after)
        h.send_header("Content-Type", "application/json")
        h.send_header("Content-Length", str(len(data)))
        h.end_headers()
        h.wfile.write(data)
        return 503

    def _forward(self, h, body: bytes, prefill_addr: str, decode_addr: str,
                 started: list[bool], ctx=None, peer_hint: str | None = None
                 ) -> tuple[int | None, str | None]:
        """Forward to one decode backend.  Returns (status, None) after
        relaying, or (None, retry_after) for a 503 swallowed BEFORE any
        byte reached the client (the failover input).  Raises OSError /
        http.client.HTTPException on connection failure."""
        if self.unified:
            path = h.path
            headers = {"Content-Type": "application/json"}
        else:
            path = "/v1/disagg" + h.path[len("/v1"):]
            headers = {"Content-Type": "application/json",
                       HDR_PREFILL_ADDR: prefill_addr}
        # SLO tier rides through to the decode backend (arks_tpu_torch.slo):
        # the OpenAI server maps it onto the engine priority scale, where
        # preemptive swap / queue aging act on it.  The gateway-minted
        # tenant identity rides along the same way — the engine's
        # weighted-fair admission keys on it.
        tier = h.headers.get(HDR_TIER)
        if tier:
            headers[HDR_TIER] = tier
        if peer_hint and peer_hint != decode_addr:
            # Only when routing landed AWAY from the deepest-covering
            # replica: fetching from yourself is a no-op.
            headers[HDR_PEER_HINT] = peer_hint
        tenant = h.headers.get(tenancy.HDR_TENANT)
        if tenant:
            headers[tenancy.HDR_TENANT] = tenant
        if ctx is not None:
            # Each attempt gets its own span id under the same trace id
            # (a retry is a new hop); the accumulated upstream spans ride
            # along for the engine-side assembly.
            fwd = ctx.child()
            headers[trace_mod.TRACEPARENT_HEADER] = fwd.traceparent()
            if fwd.upstream:
                headers[trace_mod.SPANS_HEADER] = trace_mod.spans_header(
                    fwd.upstream)
        host, _, port = decode_addr.partition(":")
        conn = http.client.HTTPConnection(host, int(port or 80), timeout=300)
        try:
            conn.request("POST", path, body=body, headers=headers)
            resp = conn.getresponse()
            if resp.status == 503:
                resp.read()  # drain for keep-alive hygiene
                return None, resp.headers.get("Retry-After")
            started[0] = True
            h.send_response(resp.status)
            ctype = resp.headers.get("Content-Type", "application/json")
            h.send_header("Content-Type", ctype)
            # Backpressure metadata must survive the relay: the backend's
            # Retry-After (queue_full / shed_deadline / pool-exhausted
            # 429s and 503s), the saturated tier, the shed tenant, and
            # the queue-saturation signal all reach the gateway/client
            # unchanged — stripping them here would turn precise backoff
            # into blind retry storms.
            for bh in ("Retry-After", HDR_TIER, tenancy.HDR_TENANT,
                       tenancy.HDR_SATURATION):
                bv = resp.headers.get(bh)
                if bv:
                    h.send_header(bh, bv)
            clen = resp.headers.get("Content-Length")
            if clen is not None:
                h.send_header("Content-Length", clen)
                h.end_headers()
                h.wfile.write(resp.read())
            else:
                h.send_header("Transfer-Encoding", "chunked")
                h.end_headers()
                while True:
                    chunk = resp.read1(65536)
                    if not chunk:
                        break
                    h.wfile.write(f"{len(chunk):x}\r\n".encode() + chunk
                                  + b"\r\n")
                    h.wfile.flush()
                h.wfile.write(b"0\r\n\r\n")
                h.wfile.flush()
            return resp.status, None
        finally:
            conn.close()

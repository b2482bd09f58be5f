"""Gateway data plane: auth, QoS, rate limiting, quota, weighted routing (a
copy of ``arks_tpu/gateway/server.py`` over the port's own modules).

The reference implements this as an Envoy ext_proc plugin
(pkg/gateway/); here the gateway IS the proxy (one less
moving part, same wire behaviors):

request path (handle_request.go:33-249):
  Bearer token -> 401 if absent; parse {model, stream,
  stream_options.include_usage}; resolve QoS by (token, model); validate the
  model against the namespace's endpoints; streaming REQUIRES
  include_usage=true (or usage can't be metered); pre-check rate limits and
  quota (429); count the request (rpm/rpd); forward with injected
  {model, namespace, username} headers.

response path (handle_response.go:80-268):
  non-streaming -> parse {usage} from the JSON body; streaming -> relay SSE
  frames while scanning for the final usage frame; then TPM/TPD DoLimit +
  quota IncrUsage({prompt,response,total}) + metrics.

routing (arksendpoint_controller.go:283-369 + dist/gateway.yaml:230-248):
  weighted choice over Endpoint.status.routes; passive ejection of backends
  after 3 consecutive 5xx/connect errors for 30s.  Unlike the reference, a
  backend's 503 goes on to the next candidate backend, as a connect error
  does, and reaches the client only from the last one: a replica drained
  by a rolling update answers 503 until the routes drop it.

defaults (types.go:24-64): rpm=100 when unset; tpm=rpm*1000 when unset.

The counters are ``ratelimiter.make_counter_backend``'s ``auto`` store (the
native library's when it builds, else the in-memory one) unless a
``rate_limiter`` is given, and streams are scanned by the native library's
``SseUsageScanner`` when it builds, else by ``PyUsageScanner``
(``make_usage_scanner``).
"""

from __future__ import annotations

import http.client
import json
import logging
import random
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from arks_tpu_torch import knobs
from arks_tpu_torch import slo as slo_mod
from arks_tpu_torch import tenancy
from arks_tpu_torch.control.resources import (
    QUOTA_PROMPT, QUOTA_RESPONSE, QUOTA_TOTAL, RL_RPM, RL_TPM,
)
from arks_tpu_torch.control.store import Store
from arks_tpu_torch.gateway.metrics import GatewayMetrics
from arks_tpu_torch.gateway.qos import QosProvider, TokenQos
from arks_tpu_torch.gateway.quota import QuotaService, QuotaStatusSyncer
from arks_tpu_torch.gateway.ratelimiter import (
    RateLimiter, REQUEST_RULES, RULES, TOKEN_RULES,
)
from arks_tpu_torch.obs import logctx
from arks_tpu_torch.obs import trace as trace_mod
from arks_tpu_torch.utils.swallow import swallowed

log = logging.getLogger("arks_tpu_torch.gateway")
logctx.install(log)

# End-to-end tracing: the gateway is the trace ROOT — it mints the W3C
# trace id, completes its admit span, and forwards both downstream
# (traceparent + x-arks-trace-spans); the engine's store assembles them.
_TRACE_ON = knobs.get_bool("ARKS_TRACE")

DEFAULT_RPM = 100            # types.go:24-64
DEFAULT_TPM_MULTIPLIER = 1000

EJECT_AFTER_CONSECUTIVE_5XX = 3   # dist/gateway.yaml:230-248
EJECT_SECONDS = 30.0

# Edge policies (dist/gateway.yaml:250-282): the reference fronts the plugin
# with Envoy's ClientTrafficPolicy 4MiB client buffer and a 5s ext_proc
# messageTimeout per processing stage.  Here the gateway IS the proxy, so it
# enforces both itself: oversized bodies are rejected with 413 before
# buffering, and the admission stage (body read + parse + QoS + limit
# checks) runs under a deadline that turns a slow stage into a clean 504
# instead of an unbounded latency hit (wedged counter backends are bounded
# by their own socket timeouts).
MAX_BODY_BYTES = 4 * 1024 * 1024
PROCESS_TIMEOUT_S = 5.0

# Memory bounds for per-key state that grows with CLIENT-chosen inputs
# (namespace/endpoint pairs, backend addresses).  Both trackers are
# LRU-evicted at these caps: hostile key/address churn costs the oldest
# entry its history (a fresh window / fresh failure count — benign),
# never unbounded gateway memory.
RATE_TRACKER_MAX_KEYS = 4096
EJECTOR_MAX_ADDRS = 1024

HDR_MODEL = "x-arks-model"
HDR_NAMESPACE = "x-arks-namespace"
HDR_USER = "x-arks-username"
# SLO tier (arks_tpu_torch.slo): validated against ARKS_SLO_TIERS at admission
# (unknown tier -> 400), forwarded to the backend, where the OpenAI server
# maps it onto the engine priority scale.  Echoed back on tier-capacity
# 503s so clients know WHICH tier to back off.
HDR_TIER = "x-arks-tier"


class _ApiError(Exception):
    def __init__(self, code: int, message: str, stage: str = "",
                 retry_after: int | None = None,
                 tenant: str | None = None):
        super().__init__(message)
        self.code, self.message, self.stage = code, message, stage
        # Emitted as a Retry-After header on the error response (cold-start
        # backpressure: retry, don't fail the request class).
        self.retry_after = retry_after
        # Backpressure errors raised while the token is already resolved
        # carry the tenant so the 429/503 can say WHO should slow down
        # even when the handler never got past admission.
        self.tenant = tenant


class PyUsageScanner:
    """Pure-Python SSE usage scan — the fallback for (and the test oracle
    of) arks_tpu_torch.gateway.native.SseUsageScanner."""

    def __init__(self) -> None:
        self._buf = b""
        self._usage: dict | None = None

    def feed(self, chunk: bytes) -> None:
        self._buf += chunk
        while b"\n\n" in self._buf or b"\r\n\r\n" in self._buf:
            a = self._buf.find(b"\n\n")
            b = self._buf.find(b"\r\n\r\n")
            if b != -1 and (a == -1 or b < a):
                frame, self._buf = self._buf[:b], self._buf[b + 4:]
            else:
                frame, self._buf = self._buf[:a], self._buf[a + 2:]
            for line in frame.splitlines():
                if not line.startswith(b"data:"):
                    continue
                data = line[5:].strip()
                if data == b"[DONE]":
                    continue
                try:
                    obj = json.loads(data)
                except (ValueError, json.JSONDecodeError):
                    continue
                u = obj.get("usage") if isinstance(obj, dict) else None
                # Replace only when the frame carries a countable usage
                # object: a later empty/non-numeric usage frame must not
                # clear previously captured counters (same rule as the
                # native scanner, keeping metering backend-independent).
                if isinstance(u, dict) and any(
                        isinstance(u.get(k), (int, float))
                        and not isinstance(u.get(k), bool)
                        for k in ("prompt_tokens", "completion_tokens",
                                  "total_tokens")):
                    self._usage = u

    def usage(self) -> dict | None:
        return self._usage


def make_usage_scanner():
    from arks_tpu_torch.gateway import native
    if native.available():
        return native.SseUsageScanner()
    return PyUsageScanner()


class RequestRateTracker:
    """Per-endpoint admitted-request rate (rpm), two-minute-window sliding
    estimate: prev-window count weighted by the un-elapsed fraction + the
    current window — cheap, lock-bounded, and smooth enough for the
    autoscaler (arks_tpu_torch.control.autoscaler) to damp on."""

    def __init__(self, max_keys: int = RATE_TRACKER_MAX_KEYS) -> None:
        self._lock = threading.Lock()
        self._max_keys = max_keys
        # Insertion order doubles as LRU order (record() moves its key to
        # the end): dict ordering makes next(iter(...)) the LRU victim.
        self._counts: dict[tuple[str, str], dict[int, int]] = {}

    def record(self, namespace: str, endpoint: str) -> None:
        m = int(time.time() // 60)
        key = (namespace, endpoint)
        with self._lock:
            w = self._counts.pop(key, None)
            if w is None:
                w = {}
                while len(self._counts) >= self._max_keys:
                    del self._counts[next(iter(self._counts))]
            self._counts[key] = w
            w[m] = w.get(m, 0) + 1
            for k in [k for k in w if k < m - 1]:
                del w[k]

    def rpm(self, namespace: str, endpoint: str) -> float:
        now = time.time()
        m = int(now // 60)
        frac = (now % 60) / 60
        with self._lock:
            w = self._counts.get((namespace, endpoint), {})
            return w.get(m - 1, 0) * (1 - frac) + w.get(m, 0)


class _Ejector:
    """Passive outlier detection per backend address.  State is bounded
    (EJECTOR_MAX_ADDRS, LRU): addresses come from the control store's
    routes, which endpoint churn can grow without limit."""

    def __init__(self, max_addrs: int = EJECTOR_MAX_ADDRS) -> None:
        self._lock = threading.Lock()
        self._max_addrs = max_addrs
        self._bad: dict[str, int] = {}
        self._ejected_until: dict[str, float] = {}

    def ok(self, addr: str) -> None:
        with self._lock:
            self._bad.pop(addr, None)

    def fail(self, addr: str) -> None:
        now = time.monotonic()
        with self._lock:
            # Expired ejections are dead weight — reap them before the
            # LRU bound so eviction only ever hits live state.
            for a in [a for a, t in self._ejected_until.items() if t <= now]:
                del self._ejected_until[a]
            n = self._bad.pop(addr, 0) + 1
            while len(self._bad) >= self._max_addrs:
                del self._bad[next(iter(self._bad))]
            self._bad[addr] = n
            if n >= EJECT_AFTER_CONSECUTIVE_5XX:
                while len(self._ejected_until) >= self._max_addrs:
                    del self._ejected_until[next(iter(self._ejected_until))]
                self._ejected_until[addr] = now + EJECT_SECONDS
                self._bad[addr] = 0

    def available(self, addrs: list[str]) -> list[str]:
        now = time.monotonic()
        with self._lock:
            live = [a for a in addrs if self._ejected_until.get(a, 0) <= now]
        # Max 100% ejection protection: if everything is ejected, try all.
        return live or addrs


class Gateway:
    def __init__(self, store: Store, host: str = "0.0.0.0", port: int = 8081,
                 rate_limiter: RateLimiter | None = None,
                 quota: QuotaService | None = None,
                 quota_sync_s: float = 2.0,
                 max_body_bytes: int = MAX_BODY_BYTES,
                 process_timeout_s: float = PROCESS_TIMEOUT_S):
        self.store = store
        self.host, self.port = host, port
        self.qos = QosProvider(store)
        self.limiter = rate_limiter or RateLimiter()
        self.quota = quota or QuotaService()
        self.syncer = QuotaStatusSyncer(store, self.quota, sync_s=quota_sync_s)
        self.metrics = GatewayMetrics()
        self.ejector = _Ejector()
        self.rate = RequestRateTracker()
        self.max_body_bytes = max_body_bytes
        self.process_timeout_s = process_timeout_s
        # Cold-start-aware admission: while a model has no ready backend
        # (scale-from-zero, weights still loading into a pool), QUEUE the
        # request — poll routing for up to this many seconds — instead of
        # an instant 503.  Past the window, 503 + Retry-After.
        self.cold_start_wait_s = knobs.get_float("ARKS_GW_COLD_START_WAIT_S")
        # SLO-tier ladder (ARKS_SLO_TIERS).  Empty = tier headers rejected.
        self.slo = slo_mod.from_env()
        # Edge shedding (ARKS_GW_SHED_INFLIGHT, 0 = off): once gateway
        # in-flight requests reach the cap, the tenant MOST over its
        # weighted fair share is rejected 429 here — before its flood
        # even reaches the engine queue.  Weights match the engine's
        # WDRR (ARKS_FAIR_WEIGHTS), so edge and engine agree on "share".
        self.shed_inflight_max = knobs.get_int("ARKS_GW_SHED_INFLIGHT")
        self.fair_weights = tenancy.weights_from_env()
        self.tenant_labels = tenancy.TenantLabels()
        self._inflight: dict[str, int] = {}
        self._inflight_lock = threading.Lock()
        # How long to keep draining (and metering) a backend stream after
        # the CLIENT hung up — usage must still be billed exactly once.
        self.disconnect_drain_s = knobs.get_float("ARKS_GW_DISCONNECT_DRAIN_S")
        self._httpd: ThreadingHTTPServer | None = None

    # ------------------------------------------------------------------

    def start(self, background: bool = True) -> None:
        gw = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _json(self, code: int, payload: dict,
                      headers: dict | None = None) -> None:
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for k, v in (headers or {}).items():
                    self.send_header(k, str(v))
                self.end_headers()
                self.wfile.write(data)

            def _error(self, code: int, message: str,
                       retry_after: int | None = None,
                       headers: dict | None = None) -> None:
                # error body parity (util.go:40-77)
                hdrs = dict(headers or {})
                if retry_after:
                    hdrs["Retry-After"] = retry_after
                self._json(code, {"error": {"message": message, "code": code}},
                           headers=hdrs or None)

            def do_GET(self):
                if self.path == "/v1/models":
                    try:
                        secret = gw._bearer(self.headers)
                        models = gw.qos.get_models_by_token(secret)
                        self._json(200, {"object": "list", "data": [
                            {"id": m, "object": "model", "owned_by": "arks-tpu"}
                            for m in models]})
                    except _ApiError as e:
                        self._error(e.code, e.message)
                elif self.path == "/metrics":
                    text = gw.metrics.registry.render().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(text)))
                    self.end_headers()
                    self.wfile.write(text)
                elif self.path in ("/healthz", "/readiness"):
                    self._json(200, {"status": "ok"})
                else:
                    self._error(404, f"no route {self.path}")

            def do_POST(self):
                if self.path not in ("/v1/chat/completions", "/v1/completions"):
                    return self._error(404, f"no route {self.path}")
                gw._handle_inference(self)

        class Server(ThreadingHTTPServer):
            # Absorb connection bursts (hundreds of concurrent clients
            # reconnecting at once): the default backlog of 5 makes the
            # kernel RST the overflow (measured by the reference's
            # tools/bench_gateway.py).
            request_queue_size = 512
            daemon_threads = True

        self._httpd = Server((self.host, self.port), Handler)
        self.port = self._httpd.server_port
        self.syncer.start()
        if background:
            threading.Thread(target=self._httpd.serve_forever, name="gateway",
                             daemon=True).start()
        else:
            self._httpd.serve_forever()

    def stop(self) -> None:
        self.syncer.stop()
        self.qos.stop()
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()

    # ------------------------------------------------------------------
    # Admission
    # ------------------------------------------------------------------

    @staticmethod
    def _bearer(headers) -> str:
        auth = headers.get("Authorization", "")
        if not auth.startswith("Bearer ") or not auth[7:].strip():
            raise _ApiError(401, "missing or malformed Authorization header",
                            "auth")
        return auth[7:].strip()

    def _effective_limits(self, qos: TokenQos) -> dict[str, int]:
        limits = dict(qos.rate_limits)
        if RL_RPM not in limits:
            limits[RL_RPM] = DEFAULT_RPM
        if RL_TPM not in limits:
            limits[RL_TPM] = limits[RL_RPM] * DEFAULT_TPM_MULTIPLIER
        return limits

    def _admit(self, handler) -> tuple[TokenQos, dict, dict[str, int]]:
        deadline = time.monotonic() + self.process_timeout_s
        secret = self._bearer(handler.headers)
        try:
            length = int(handler.headers.get("Content-Length", 0))
        except ValueError:
            handler.close_connection = True  # body never drained
            raise _ApiError(400, "invalid Content-Length", "parse")
        if length > self.max_body_bytes:
            # Client-buffer parity (dist/gateway.yaml:250-261): reject before
            # reading — buffering an unbounded body is the DoS vector.  The
            # unread body would desync this keep-alive connection, so drop it.
            handler.close_connection = True
            raise _ApiError(413, f"request body {length} bytes exceeds the "
                            f"{self.max_body_bytes}-byte limit", "parse")
        try:
            # Slow-loris protection: read incrementally (read1 returns what
            # has arrived, not a full block) and check the TOTAL deadline
            # between reads — a per-recv socket timeout alone would let a
            # client trickling one byte per few seconds pin this thread for
            # hours while every individual recv stays "fast".
            handler.connection.settimeout(self.process_timeout_s)
            chunks: list[bytes] = []
            got = 0
            while got < length:
                if time.monotonic() > deadline:
                    raise TimeoutError
                chunk = handler.rfile.read1(min(65536, length - got))
                if not chunk:
                    break
                chunks.append(chunk)
                got += len(chunk)
            body = json.loads(b"".join(chunks) or b"{}")
        except TimeoutError:
            handler.close_connection = True  # partial body left on the wire
            raise _ApiError(408, "timed out reading request body", "parse")
        except (ValueError, json.JSONDecodeError):
            raise _ApiError(400, "invalid JSON body", "parse")
        finally:
            handler.connection.settimeout(None)
        model = body.get("model", "")
        if not model:
            raise _ApiError(400, "missing model field", "parse")

        # SLO tier (after the body is drained so a 400 here keeps the
        # keep-alive connection in sync).  Typos must not silently demote
        # a latency-class request to the default tier — reject them.
        tier = (handler.headers.get(HDR_TIER) or "").strip() or None
        if tier is not None:
            if not self.slo:
                raise _ApiError(
                    400, f"{HDR_TIER} header sent but no SLO tiers are "
                    "configured (ARKS_SLO_TIERS)", "parse")
            if self.slo.get(tier) is None:
                raise _ApiError(
                    400, f"unknown SLO tier {tier!r} (configured: "
                    f"{', '.join(self.slo.names)})", "parse")

        qos = self.qos.get_qos_by_token(secret, model)
        if qos is None:
            if not self.qos.token_known(secret):
                raise _ApiError(401, "invalid token", "auth")
            raise _ApiError(403, f"token has no access to model {model!r}", "auth")
        if model not in self.qos.get_model_list(qos.namespace):
            raise _ApiError(404, f"model {model!r} not found", "route")

        # Streaming requires include_usage so usage can be metered
        # (handle_request.go:160-171).
        if body.get("stream", False):
            if not (body.get("stream_options") or {}).get("include_usage"):
                raise _ApiError(
                    400, "streaming requests require "
                    "stream_options.include_usage=true", "parse")

        limits = self._effective_limits(qos)
        for res in self.limiter.check_limit(
                qos.namespace, qos.username, model, limits,
                requested={r: 1 for r in REQUEST_RULES}):
            if res.over:
                self.metrics.rate_limit_hits_total.inc(
                    rule=res.rule, namespace=qos.namespace, user=qos.username)
                # Windows are wall-clock-aligned, so the exact moment this
                # rule resets is known: Retry-After = time to window edge.
                # Every 429 carries the header — clients and the router
                # back off with precision instead of guess-retrying.
                period = RULES[res.rule][0]
                raise _ApiError(429, f"rate limit exceeded: {res.rule} "
                                f"({res.current}/{res.limit})", "ratelimit",
                                retry_after=max(
                                    1, int(period - (time.time() % period))),
                                tenant=tenancy.tenant_id(
                                    qos.namespace, qos.username))
        if qos.quota_name:
            q_limits = self.qos.get_quota_limits(qos.namespace, qos.quota_name)
            over, typ = self.quota.check(qos.namespace, qos.quota_name, q_limits)
            if over:
                # Quota recovers on the syncer's status cadence, not a
                # rate window — a minute is the honest retry horizon.
                raise _ApiError(429, f"quota exceeded: {typ}", "quota",
                                retry_after=60,
                                tenant=tenancy.tenant_id(
                                    qos.namespace, qos.username))
            for typ, limit in q_limits.items():
                self.metrics.quota_limit.set(
                    limit, namespace=qos.namespace, quota=qos.quota_name, type=typ)

        # Processing-stage deadline (EnvoyExtensionPolicy 5s messageTimeout,
        # dist/gateway.yaml:263-282): a SLOW counter backend fails the
        # request with 504 instead of silently eating the latency budget.
        # (A fully wedged backend is bounded separately by its own socket
        # timeout, since a blocked call can't observe this deadline until
        # it returns.)
        if time.monotonic() > deadline:
            raise _ApiError(504, "request processing exceeded "
                            f"{self.process_timeout_s}s", "timeout")

        # Count the admitted request (rpm/rpd).
        self.limiter.do_limit(qos.namespace, qos.username, model,
                              {r: 1 for r in REQUEST_RULES})
        return qos, body, limits, tier

    # ------------------------------------------------------------------
    # Routing + proxy
    # ------------------------------------------------------------------

    def _pick_backends(self, namespace: str, model: str) -> list[str]:
        """Weighted-ordered backend candidates; cold-start-aware: a model
        with routes but no ready backend yet (scale-from-zero, weight pool
        still streaming) is POLLED for up to cold_start_wait_s before the
        503 — the request queues on the gateway instead of bouncing.
        Unknown models (404) fail fast."""
        deadline = time.monotonic() + self.cold_start_wait_s
        while True:
            try:
                return self._pick_backends_once(namespace, model)
            except _ApiError as e:
                if e.code != 503 or time.monotonic() >= deadline:
                    if e.code == 503 and e.retry_after is None:
                        e.retry_after = max(int(self.cold_start_wait_s), 1)
                    raise
            time.sleep(0.25)

    def _pick_backends_once(self, namespace: str, model: str) -> list[str]:
        ep = self.qos.get_endpoint(namespace, model)
        if ep is None:
            raise _ApiError(404, f"model {model!r} not found", "route")
        routes = ep.status.get("routes", [])
        weighted: list[tuple[str, int]] = []
        for r in routes:
            for addr in r.get("backend", {}).get("addresses", []):
                weighted.append((addr, max(r.get("weight", 1), 1)))
        if not weighted:
            raise _ApiError(503, f"no ready backends for model {model!r}", "route")
        addrs = self.ejector.available([a for a, _ in weighted])
        pool = [(a, w) for a, w in weighted if a in addrs]
        ordered: list[str] = []
        while pool:
            total = sum(w for _, w in pool)
            x = random.uniform(0, total)
            acc = 0.0
            for i, (a, w) in enumerate(pool):
                acc += w
                if x <= acc:
                    ordered.append(a)
                    pool.pop(i)
                    break
        return ordered

    def _handle_inference(self, handler) -> None:
        t0 = time.monotonic()
        qos = None
        status = 500
        tier = None
        ctx = (trace_mod.TraceCtx.from_headers(handler.headers)
               if _TRACE_ON else None)
        tenant = None
        try:
            with logctx.bound(trace_id=ctx.trace_id if ctx else None):
                qos, body, limits, tier = self._admit(handler)
                if ctx is not None:
                    ctx.upstream.append({
                        "component": "gateway", "name": "gateway.admit",
                        "start": t0, "end": time.monotonic(),
                        "arg": qos.username})
                # Admitted demand feeds the autoscaler's per-endpoint rate.
                self.rate.record(qos.namespace, qos.endpoint)
                tenant = tenancy.tenant_id(qos.namespace, qos.username)
                self._edge_admit(tenant)
                try:
                    status = self._proxy(handler, qos, body, limits, tier,
                                         tenant=tenant, ctx=ctx)
                finally:
                    self._edge_done(tenant)
        except _ApiError as e:
            status = e.code
            self.metrics.errors_total.inc(stage=e.stage or "other")
            ra = getattr(e, "retry_after", None)
            hdrs = {}
            if e.code in (429, 503):
                # Backpressure responses carry the full picture: WHO to
                # slow down (tenant), WHICH tier is saturated, and WHEN to
                # come back (Retry-After — every 429/503 has one).
                if tier is not None:
                    hdrs[HDR_TIER] = tier
                tnt = tenant or getattr(e, "tenant", None)
                if tnt is not None:
                    hdrs[tenancy.HDR_TENANT] = tnt
                if ra is None:
                    ra = 1
            try:
                handler._error(e.code, e.message, retry_after=ra,
                               headers=hdrs or None)
            except Exception as e2:
                # Client hung up before the error response went out.
                swallowed("gateway.error-response", e2)
        except Exception as e:
            log.exception("gateway failure")
            self.metrics.errors_total.inc(stage="internal")
            try:
                handler._error(500, f"gateway error: {e}")
            except Exception as e2:
                swallowed("gateway.error-response", e2)
        finally:
            labels = dict(status=str(status))
            if qos is not None:
                labels.update(namespace=qos.namespace, user=qos.username,
                              model=qos.endpoint)
            self.metrics.requests_total.inc(**labels)
            self.metrics.request_duration.observe(time.monotonic() - t0)

    def _edge_admit(self, tenant: str) -> None:
        """Pre-emptive edge shed: with the gateway at its in-flight cap
        (ARKS_GW_SHED_INFLIGHT), reject the tenant MOST over its weighted
        fair share — the flood pays, steady tenants keep flowing.  429 +
        Retry-After 1: this clears as soon as any in-flight completes."""
        if self.shed_inflight_max <= 0:
            with self._inflight_lock:
                self._inflight[tenant] = self._inflight.get(tenant, 0) + 1
            return
        w = tenancy.weight_of(self.fair_weights, tenant)
        with self._inflight_lock:
            total = sum(self._inflight.values())
            if total >= self.shed_inflight_max:
                mine = (self._inflight.get(tenant, 0) + 1) / w
                worst = max(
                    (n / tenancy.weight_of(self.fair_weights, t)
                     for t, n in self._inflight.items()), default=0.0)
                if mine >= worst:
                    self.metrics.shed_total.inc(
                        tenant=self.tenant_labels.label(tenant),
                        reason="inflight_overshare")
                    raise _ApiError(
                        429, f"gateway saturated ({total} in-flight >= "
                        f"{self.shed_inflight_max}) and tenant {tenant!r} "
                        "is at or above its fair share", "shed",
                        retry_after=1)
            self._inflight[tenant] = self._inflight.get(tenant, 0) + 1

    def _edge_done(self, tenant: str) -> None:
        with self._inflight_lock:
            n = self._inflight.get(tenant, 0) - 1
            if n <= 0:
                self._inflight.pop(tenant, None)
            else:
                self._inflight[tenant] = n

    def _proxy(self, handler, qos: TokenQos, body: dict,
               limits: dict[str, int], tier: str | None = None,
               tenant: str | None = None, ctx=None) -> int:
        payload = json.dumps(body).encode()
        stream = bool(body.get("stream", False))
        last_err: Exception | None = None
        trace_headers = {}
        if ctx is not None:
            fwd = ctx.child()
            trace_headers[trace_mod.TRACEPARENT_HEADER] = fwd.traceparent()
            if fwd.upstream:
                trace_headers[trace_mod.SPANS_HEADER] = \
                    trace_mod.spans_header(fwd.upstream)
        addrs = self._pick_backends(qos.namespace, qos.endpoint)
        for i, addr in enumerate(addrs):
            host, _, port = addr.partition(":")
            conn = http.client.HTTPConnection(host, int(port or 80), timeout=300)
            try:
                conn.request("POST", handler.path, body=payload, headers={
                    "Content-Type": "application/json",
                    # Routing headers parity (handle_request.go:208-231).
                    HDR_MODEL: qos.endpoint,
                    HDR_NAMESPACE: qos.namespace,
                    HDR_USER: qos.username,
                    # Tenant identity: minted HERE (namespace/username is
                    # what the token resolved to — clients cannot spoof
                    # it), consumed by the engine's weighted-fair queue.
                    **({tenancy.HDR_TENANT: tenant}
                       if tenant is not None else {}),
                    **({HDR_TIER: tier} if tier is not None else {}),
                    **trace_headers,
                })
                resp = conn.getresponse()
            except OSError as e:
                self.ejector.fail(addr)
                last_err = e
                conn.close()
                continue
            try:
                if resp.status >= 500:
                    self.ejector.fail(addr)
                else:
                    self.ejector.ok(addr)
                if resp.status == 503 and i + 1 < len(addrs):
                    # The backend took nothing (a replica draining in a
                    # rolling update until the routes drop it, or one at
                    # its capacity): the next backend gets the request.
                    # The reference relays this 503 to the client.
                    resp.read()
                    last_err = RuntimeError(f"{addr} answered 503")
                    continue
                def account(usage, _resp=resp):
                    # Billing must never corrupt an in-flight response:
                    # accounting failures are recorded, not raised.
                    if _resp.status >= 500 or not usage:
                        return
                    try:
                        self._account_usage(qos, usage, limits)
                    except Exception:
                        log.exception("usage accounting failed")
                        self.metrics.errors_total.inc(stage="accounting")
                if stream and resp.status == 200:
                    self._relay_stream(handler, resp, account)
                else:
                    self._relay_full(handler, resp, account)
                return resp.status
            finally:
                conn.close()
        raise _ApiError(503, f"all backends unreachable: {last_err}", "route",
                        retry_after=5)

    def _relay_full(self, handler, resp, account) -> None:
        data = resp.read()
        # Account before the body reaches the client so usage is visible the
        # moment the response is (billing ordering).
        if resp.status == 200:
            try:
                obj = json.loads(data)
            except (ValueError, json.JSONDecodeError):
                obj = None
            account(obj.get("usage") if isinstance(obj, dict) else None)
        handler.send_response(resp.status)
        handler.send_header("Content-Type",
                            resp.headers.get("Content-Type", "application/json"))
        handler.send_header("Content-Length", str(len(data)))
        # Cold-start backpressure travels end-to-end: the serving pod's
        # Retry-After (model_pool_exhausted) reaches the client.
        ra = resp.headers.get("Retry-After")
        if ra:
            handler.send_header("Retry-After", ra)
        # Tier-capacity 503s echo the tier so per-tier clients back off
        # independently; tenant-fair sheds echo the tenant and the
        # backend's queue-saturation signal the same way.
        for h in (HDR_TIER, tenancy.HDR_TENANT, tenancy.HDR_SATURATION):
            v = resp.headers.get(h)
            if v:
                handler.send_header(h, v)
        handler.end_headers()
        handler.wfile.write(data)

    def _relay_stream(self, handler, resp, account) -> None:
        """Relay SSE to the client, scanning frames for the usage object
        (handle_response.go:113-133). Robust to chunk fragmentation: frames
        are reassembled on blank-line boundaries.  The scan runs in the
        native library when available (arks_tpu_torch.gateway.native)."""
        handler.send_response(resp.status)
        handler.send_header("Content-Type",
                            resp.headers.get("Content-Type", "text/event-stream"))
        handler.send_header("Transfer-Encoding", "chunked")
        handler.end_headers()

        scanner = make_usage_scanner()
        t_proc = 0.0
        client_dead = False
        drain_deadline = None
        drained = True
        while True:
            chunk = resp.read1(65536)
            if not chunk:
                break
            if not client_dead:
                try:
                    handler.wfile.write(
                        f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n")
                    handler.wfile.flush()
                except OSError:
                    # Client hung up mid-stream.  The backend has already
                    # generated (and will bill) these tokens, so KEEP
                    # READING — the usage frame at the end of the stream
                    # is the only exact record.  Bounded: past the drain
                    # window we give up rather than babysit a slow
                    # backend for a client that's gone.
                    client_dead = True
                    drain_deadline = (time.monotonic()
                                      + self.disconnect_drain_s)
            tp = time.monotonic()
            scanner.feed(chunk)
            t_proc += time.monotonic() - tp
            if drain_deadline is not None and time.monotonic() > drain_deadline:
                drained = False
                break
        # Exactly-once metering: account() runs once per stream, with
        # whatever the scanner captured — a disconnect neither
        # double-counts (no retry path re-accounts) nor leaks tokens
        # (the drain usually reaches the usage frame).
        account(scanner.usage())
        if client_dead:
            self.metrics.client_disconnects_total.inc()
            if not drained or scanner.usage() is None:
                # Gave up before the usage frame: tokens the backend
                # billed that the gateway could not meter.  Alert on this.
                self.metrics.usage_unmetered_total.inc()
            handler.close_connection = True
        else:
            handler.wfile.write(b"0\r\n\r\n")
            handler.wfile.flush()
        self.metrics.response_process_duration.observe(t_proc * 1000)

    # ------------------------------------------------------------------
    # Usage accounting (handle_response.go:184-223)
    # ------------------------------------------------------------------

    def _account_usage(self, qos: TokenQos, usage: dict,
                       limits: dict[str, int]) -> None:
        prompt = int(usage.get("prompt_tokens", 0))
        completion = int(usage.get("completion_tokens", 0))
        total = int(usage.get("total_tokens", prompt + completion))
        self.limiter.do_limit(qos.namespace, qos.username, qos.endpoint,
                              {r: total for r in TOKEN_RULES})
        self.metrics.rate_limit_tokens.inc(
            total, namespace=qos.namespace, user=qos.username)
        if qos.quota_name:
            self.quota.incr_usage(qos.namespace, qos.quota_name, {
                QUOTA_PROMPT: prompt, QUOTA_RESPONSE: completion,
                QUOTA_TOTAL: total})
            for typ, used in self.quota.get_usage(
                    qos.namespace, qos.quota_name).items():
                self.metrics.quota_usage.set(
                    used, namespace=qos.namespace, quota=qos.quota_name, type=typ)
        for typ, amount in (("prompt", prompt), ("response", completion),
                            ("total", total)):
            self.metrics.token_usage.inc(
                amount, type=typ, namespace=qos.namespace, user=qos.username)
        self.metrics.token_distribution.observe(total)

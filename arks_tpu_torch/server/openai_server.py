"""OpenAI-compatible HTTP surface for the port's engine (port of the request
surface of ``arks_tpu/server/openai_server.py``).

- POST /v1/completions and /v1/chat/completions, streaming (SSE frames
  ``data: {...}`` ending with ``data: [DONE]``; with
  ``stream_options.include_usage`` the last data frame carries the usage
  and an empty choices list) and not, with usage and ``finish_reason``.
- Every OpenAI sampling field: stop strings and ids, presence/frequency
  penalties, ``logit_bias`` (clamped to ±100, at most 300 entries, ids in
  the vocab), ``min_tokens``, ``logprobs`` (completions: an int; chat:
  ``logprobs: true`` with ``top_logprobs``), ``seed``; guided decoding
  (``response_format`` json_object / json_schema / regex, and the
  ``guided_regex`` / ``guided_json`` / ``guided_choice`` extras); chat
  ``tools`` with ``tool_choice`` (a forced call becomes a guide; calls in
  the output come back as ``tool_calls``); ``n`` from 1 to 16 (seeded
  children take ``seed + j``); batched prompts; completions ``echo``.
  ``best_of`` is ignored.
- GET /v1/models (with a model pool, every registered model, each with
  its ``arks`` residency block), /health; GET /metrics (the engine's
  metric families, Prometheus text ``version=0.0.4``); GET /readiness:
  200 ``{"status": "ready", "admission": ..., "slo_burn": ...,
  "elastic": ...}`` once the server listens and the engine's loop has
  finished a step, 503 while draining, before that, while the engine
  recovers from a fault ("recovering") or is wedged ("wedged"), while it
  is scaled to zero ("scaled to zero (disarmed)"), or once the loop has
  stopped.  GET /v1/elastic/status (reachable while disarmed); POST
  /v1/elastic/resize answers 501 (no live resize on one card).  The
  reference's worker-gang and cache-sketch branches belong to subsystems
  the port does not have.
- Multi-model: a request's ``model`` field routes it to a pool model
  (404 for an unknown one); ``model_pool_exhausted`` answers 503 with
  ``Retry-After``, ``model_load_failed`` 500.
- Tracing: a single-choice request carries a W3C ``traceparent`` context
  (continued from the header, folding in ``x-arks-trace-spans``, or
  minted).  GET /v1/traces (the retained traces' index),
  /v1/traces/{trace or request id} (404 when unknown), /v1/traces/export
  (Chrome trace events, loadable in Perfetto).  POST /v1/profiler/start
  and /v1/profiler/stop open and close a ``torch.profiler`` window
  (operator tooling: served while draining, as the reference serves them
  ahead of its drain gate).
- Admission: ``x-arks-tenant`` names the request's fair-queue tenant;
  ``x-arks-tier`` maps onto its priority through ``ARKS_SLO_TIERS`` (an
  unknown tier is a 400).  A full queue answers 429 (the tenant's bound)
  or 503 (the global bound) with ``Retry-After``; a deadline shed 503.
- ``drain(timeout_s)`` (SIGTERM): readiness turns 503, new completions get
  503 "server is draining", in-flight requests finish, then the server
  stops.

Stdlib ``ThreadingHTTPServer``, as in the reference: request threads hand
work to the engine thread and read its output queue.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time
import uuid
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from arks_tpu_torch import slo as slo_mod
from arks_tpu_torch import tenancy
from arks_tpu_torch.engine import fairqueue
from arks_tpu_torch.engine import sampler as sampler_mod
from arks_tpu_torch.engine.engine import InferenceEngine
from arks_tpu_torch.engine.tokenizer import IncrementalDetokenizer
from arks_tpu_torch.engine.types import Request, SamplingParams
from arks_tpu_torch.obs import logctx
from arks_tpu_torch.obs import perfetto as perfetto_mod
from arks_tpu_torch.obs import trace as trace_mod
from arks_tpu_torch.server import tools as tools_mod

log = logging.getLogger("arks_tpu_torch.server")
logctx.install(log)

# The SLO tier header (the gateway and router forward it).
HDR_TIER = "x-arks-tier"


def _find_stop(text: str, stop_strings: list[str], min_end: int = 0
               ) -> int | None:
    """Earliest index at which any stop string begins, else None.  A match
    whose END falls at or before ``min_end`` is ignored: text before that
    boundary was generated under min_tokens and is exempt from stopping,
    but a stop straddling the boundary still counts."""
    best = None
    for s in stop_strings:
        start = 0
        while True:
            i = text.find(s, start)
            if i < 0:
                break
            if i + len(s) > min_end:
                if best is None or i < best:
                    best = i
                break
            start = i + 1
    return best


def sampling_from_body(body: dict, tokenizer, engine=None
                       ) -> tuple[SamplingParams, list[str]]:
    """Engine sampling params + the multi-token stop strings the server
    matches on text.  Raises ValueError (HTTP 400) on bad fields.  With
    ``engine``, logit_bias ids are checked against the vocab, the
    min_tokens suppress set against its column budget, and a guide's
    pattern parsed (its DFA build runs later, off this thread)."""
    stop = body.get("stop") or []
    if isinstance(stop, str):
        stop = [stop]
    stop_ids = [int(t) for t in (body.get("stop_token_ids") or [])]
    stop_strings: list[str] = []
    for s in stop:
        ids = tokenizer.encode(s)
        if len(ids) == 1:
            stop_ids.append(ids[0])
        else:
            stop_strings.append(s)
    # logprobs: completions take an int (top-N alternatives per token,
    # 0 = chosen only); chat takes logprobs=true + top_logprobs=N.  The
    # engine param is None (off) / 0 (chosen only) / N (plus top-N).
    lp = body.get("logprobs")
    if lp is True:
        n_lp = int(body.get("top_logprobs") or 0)
    elif lp is None or lp is False:
        n_lp = None
    else:
        n_lp = int(lp)
    raw_bias = body.get("logit_bias") or {}
    if not isinstance(raw_bias, dict):
        raise ValueError("logit_bias must be an object of token_id -> bias")
    if len(raw_bias) > sampler_mod.LOGIT_BIAS_MAX:
        raise ValueError(f"logit_bias supports at most "
                         f"{sampler_mod.LOGIT_BIAS_MAX} entries")
    logit_bias = tuple((int(t), max(-100.0, min(100.0, float(b))))
                       for t, b in raw_bias.items())
    if engine is not None and logit_bias:
        vocab = engine.cfg.vocab_size
        bad = [t for t, _ in logit_bias if not 0 <= t < vocab]
        if bad:
            raise ValueError(
                f"logit_bias token ids out of range [0, {vocab}): {bad[:5]}")
    min_tokens = max(int(body.get("min_tokens", 0)), 0)
    guide = None
    rf = body.get("response_format")
    if isinstance(rf, dict) and rf.get("type"):
        rft = rf["type"]
        if rft == "json_object":
            guide = ("json", "")
        elif rft == "regex" and rf.get("regex"):
            guide = ("regex", str(rf["regex"]))
        elif rft == "json_schema":
            # {"type": "json_schema", "json_schema": {"name": ...,
            # "schema": {...}}}, or a bare "schema" key.  The key keeps the
            # body's own property order (declaration order is the
            # contract).
            wrapper = rf.get("json_schema")
            schema = (wrapper.get("schema") if isinstance(wrapper, dict)
                      else rf.get("schema"))
            if not isinstance(schema, dict):
                raise ValueError("response_format json_schema needs "
                                 "json_schema.schema")
            guide = ("json_schema", json.dumps(schema))
        elif rft != "text":
            raise ValueError(f"unknown response_format type {rft!r}")
    if body.get("guided_regex"):
        guide = ("regex", str(body["guided_regex"]))
    if isinstance(body.get("guided_json"), dict):
        guide = ("json_schema", json.dumps(body["guided_json"]))
    if body.get("guided_choice") is not None:
        choices = body["guided_choice"]
        if (not isinstance(choices, list) or not choices
                or any(not isinstance(c, str) for c in choices)):
            raise ValueError(
                "guided_choice must be a non-empty array of strings")
        guide = ("choice", json.dumps(choices))
    if guide is not None and engine is not None:
        engine.guides.validate(*guide)
    # Below 0 is the fair queue's urgent lane, which no client may reach.
    priority = int(body.get("priority") or 0)
    if priority < 0:
        raise ValueError("priority must be >= 0 (lower is served sooner)")
    params = SamplingParams(
        max_tokens=int(body.get("max_tokens")
                       or body.get("max_completion_tokens") or 256),
        temperature=float(body.get("temperature", 1.0)),
        top_p=float(body.get("top_p", 1.0)),
        top_k=int(body.get("top_k", 0)),
        seed=body.get("seed"),
        ignore_eos=bool(body.get("ignore_eos", False)),
        stop_token_ids=tuple(stop_ids),
        presence_penalty=float(body.get("presence_penalty", 0.0)),
        frequency_penalty=float(body.get("frequency_penalty", 0.0)),
        logprobs=None if n_lp is None else min(
            max(n_lp, 0), sampler_mod.TOP_LOGPROBS_MAX),
        logit_bias=logit_bias,
        min_tokens=min_tokens,
        priority=priority,
        guide=guide)
    if engine is not None and min_tokens and len(
            engine.min_tokens_suppress_ids(params)) > sampler_mod.SUPPRESS_MAX:
        raise ValueError(
            f"min_tokens supports at most {sampler_mod.SUPPRESS_MAX} "
            "eos/stop token ids to suppress (silently dropping one could "
            "end the stream before the minimum)")
    return params, stop_strings


class OpenAIServer:
    """HTTP front of one engine.  The engine's step loop must be running
    (``engine.start()``) for requests to complete."""

    def __init__(self, engine: InferenceEngine, served_model_name: str,
                 host: str = "127.0.0.1", port: int = 8080) -> None:
        self.engine = engine
        self.served_model_name = served_model_name
        self.host = host
        self.port = port
        self.slo = slo_mod.from_env()
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._ready = threading.Event()
        # Graceful drain: ``_active`` counts completion handlers between
        # their admission check and their last byte; the check and the
        # increment are one step under ``_active_lock``, so a drain that
        # reads 0 has no handler slipping in after it.
        self.draining = False
        self._active = 0
        self._active_lock = threading.Lock()
        self._stopped = False

    def start(self, background: bool = True) -> None:
        # The handler class reaches this server through a weak proxy: a
        # class is always in a reference cycle (its MRO holds it), so a
        # strong closure would keep the server, its engine and the weights
        # alive past ``del`` until a GC pass.
        server = weakref.proxy(self)

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
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

            def _error(self, code: int, message: str) -> None:
                self._json(code, {"error": {"message": message,
                                            "code": code}})

            def do_GET(self):
                if self.path == "/v1/models":
                    self._json(200, server.models_payload())
                elif self.path == "/v1/elastic/status":
                    # Reachable while disarmed, unlike /readiness.
                    self._json(200, server.engine.elastic_status())
                elif self.path in ("/health", "/healthz"):
                    self._json(200, {"status": "ok"})
                elif self.path == "/metrics":
                    text = server.engine.metrics.registry.render().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(text)))
                    self.end_headers()
                    self.wfile.write(text)
                elif self.path == "/readiness":
                    code, payload = server.readiness()
                    if code == 200:
                        self._json(200, payload)
                    else:
                        self._error(code, payload)
                elif self.path == "/v1/traces/export":
                    # Chrome trace-event JSON of every retained trace —
                    # open at ui.perfetto.dev / chrome://tracing.
                    tracer = server.engine.trace
                    tracer.flush()
                    self._json(200, perfetto_mod.chrome_trace(
                        tracer.store.all(), tracer.phase_spans()))
                elif self.path == "/v1/traces":
                    tracer = server.engine.trace
                    tracer.flush()
                    self._json(200, {"traces": [
                        {"trace_id": t["trace_id"],
                         "request_id": t["request_id"],
                         "flags": t["flags"], "tier": t.get("tier"),
                         "spans": len(t["spans"])}
                        for t in tracer.store.all()]})
                elif self.path.startswith("/v1/traces/"):
                    # By trace id OR request id.
                    tracer = server.engine.trace
                    tracer.flush()
                    tr = tracer.store.get(self.path[len("/v1/traces/"):])
                    if tr is None:
                        self._error(404, "trace not found (expired, "
                                    "sampled out, or still in flight)")
                    else:
                        self._json(200, tr)
                else:
                    self._error(404, f"no route {self.path}")

            def do_POST(self):
                if self.path == "/v1/elastic/resize":
                    # The reference's answer for an engine without live
                    # resize (one card: no topology to change).
                    return self._error(
                        501, "engine has no elastic resize support")
                if self.path not in ("/v1/completions",
                                     "/v1/chat/completions",
                                     "/v1/profiler/start",
                                     "/v1/profiler/stop"):
                    return self._error(404, f"no route {self.path}")
                try:
                    n = int(self.headers.get("Content-Length") or 0)
                    body = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(body, dict):
                        raise ValueError("request body must be an object")
                except ValueError as e:
                    return self._error(400, f"bad request body: {e}")
                if self.path == "/v1/profiler/start":
                    # A torch.profiler window (operator tooling, ahead of
                    # the drain gate like the GET diagnostics).
                    return self._json(200, server.engine.profiler.start(
                        body.get("logdir") or None))
                if self.path == "/v1/profiler/stop":
                    return self._json(200, server.engine.profiler.stop())
                with server._active_lock:
                    if server.draining:
                        return self._error(503, "server is draining")
                    server._active += 1
                try:
                    server.handle_completion(
                        self, body, chat=self.path == "/v1/chat/completions")
                except BrokenPipeError:
                    pass
                except Exception as e:  # engine/request failure -> 500
                    log.exception("request handler failure on %s",
                                  self.path)
                    try:
                        self._error(500, f"internal error: {e}")
                    except OSError:
                        pass  # the client hung up first
                finally:
                    with server._active_lock:
                        server._active -= 1

        class Server(ThreadingHTTPServer):
            # A burst of concurrent connects overflows the default backlog
            # of 5 (the kernel resets the overflow).
            request_queue_size = 512
            daemon_threads = True

        httpd = Server((self.host, self.port), Handler)
        with self._active_lock:
            self._httpd = httpd
            stopped = self._stopped
        if stopped:
            # stop() or drain() ran before the socket was bound.
            httpd.server_close()
            return
        self.port = httpd.server_address[1]
        self._ready.set()
        if background:
            self._thread = threading.Thread(
                target=httpd.serve_forever, name="http", daemon=True)
            self._thread.start()
        else:
            httpd.serve_forever()

    def stop(self) -> None:
        with self._active_lock:
            if self._stopped:
                return
            self._stopped = True
            httpd = self._httpd
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def readiness(self) -> tuple[int, dict | str]:
        """(200, the ready payload) or (503, the reason)."""
        if self.draining:
            return 503, "draining"
        if not self._ready.is_set():
            return 503, "not ready"
        if self.engine.state != "serving":
            # Fault recovery in progress ("recovering") or a wedged device
            # awaiting its exit ("wedged"): routes pull this backend;
            # in-flight streams keep draining.
            return 503, self.engine.state
        if not self.engine.armed:
            # Scaled to zero: no device state exists until demand re-arms.
            return 503, "scaled to zero (disarmed)"
        if not self.engine.warm:
            return 503, "not ready"
        if not self.engine.serving:
            return 503, "engine loop stopped"
        return 200, {"status": "ready",
                     "admission": self.engine.saturation(),
                     "slo_burn": self.engine.slo_burn(),
                     "elastic": self.engine.elastic_status()}

    def models_payload(self) -> dict:
        """``/v1/models``: the primary under the served name, and with a
        model pool every other registered model; each pooled one carries
        its ``arks`` residency block (extra metadata OpenAI clients
        ignore)."""
        data = [{"id": self.served_model_name, "object": "model",
                 "created": 0, "owned_by": "arks"}]
        pool = self.engine.pool
        if pool is None:
            return {"object": "list", "data": data}
        primary = self.engine.served_models()[0]
        for row in pool.snapshot():
            arks = {"state": row["state"], "pinned": row["pinned"],
                    "resident_bytes": row["resident_bytes"],
                    "cold_starts": row["cold_starts"]}
            if row["name"] == primary:
                data[0]["arks"] = arks
                continue
            data.append({"id": row["name"], "object": "model", "created": 0,
                         "owned_by": "arks", "arks": arks})
        return {"object": "list", "data": data}

    def drain(self, timeout_s: float = 20.0) -> None:
        """Graceful shutdown: readiness turns 503 (routes pull this
        backend), new completions get 503, in-flight requests finish
        (bounded by ``timeout_s``), then the HTTP server stops."""
        self.draining = True
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            # No live completion handler AND an idle engine: the handler
            # count covers what the engine cannot see (tokenizing before
            # add_request, the tail frames of a stream).
            with self._active_lock:
                active = self._active
            if active == 0 and self.engine.idle:
                break
            time.sleep(0.1)
        self.stop()

    # ------------------------------------------------------------------

    def _prompt_ids_batch(self, body: dict, chat: bool,
                          tools: list | None = None) -> list[list[int]]:
        """One id-list per prompt.  Chat is always one prompt; completions
        take a string, a token-id list, or a list of strings (the batch
        form: one choice per prompt)."""
        tok = self.engine.tokenizer
        if chat:
            messages = body.get("messages") or []
            if not isinstance(messages, list) or not messages:
                raise ValueError("messages must be a non-empty list")
            return [tok.apply_chat_template(messages, tools=tools)]
        prompt = body.get("prompt", "")
        if isinstance(prompt, list):
            if all(isinstance(p, int) for p in prompt) and prompt:
                batch = [[int(t) for t in prompt]]
            elif all(isinstance(p, str) for p in prompt) and prompt:
                batch = [tok.encode(p) for p in prompt]
            else:
                raise ValueError(
                    "prompt list must be all strings or all token ids")
        else:
            batch = [tok.encode(str(prompt))]
        for ids in batch:
            if not ids:
                raise ValueError("prompt must not be empty")
        return batch

    def handle_completion(self, h, body: dict, chat: bool) -> None:
        model = body.get("model") or self.served_model_name
        # The served name is the primary's alias; another name routes to a
        # pool model (engine_model None = the primary).
        engine_model = None
        if model != self.served_model_name:
            served = self.engine.served_models() \
                if self.engine.pool is not None else []
            if model not in served:
                return h._error(404, f"model {model!r} not found")
            if model != served[0]:
                engine_model = model
        try:
            tools, tool_choice = (tools_mod.validate_tools(body) if chat
                                  else (None, "none"))
            tools_on = bool(tools) and tool_choice != "none"
            batch = self._prompt_ids_batch(body, chat,
                                           tools=tools if tools_on else None)
            params, stop_strings = sampling_from_body(
                body, self.engine.tokenizer, self.engine)
            # The tier header wins over a body "priority".
            tier = (h.headers.get(HDR_TIER) or "").strip() or None
            if tier is not None:
                pri = self.slo.priority_of(tier) if self.slo else None
                if pri is None:
                    raise ValueError(
                        f"unknown SLO tier {tier!r} (configured: "
                        f"{', '.join(self.slo.names) or 'none'})")
                params = dataclasses.replace(params, priority=pri)
            tools_ctx = None
            if tools_on:
                tools_ctx = tools_mod.tool_parser()
                forced = tools_mod.forced_call_guide(tools, tool_choice)
                if forced is not None:
                    if params.guide is not None:
                        raise ValueError(
                            "tool_choice required/named cannot combine "
                            "with response_format/guided_regex")
                    self.engine.guides.validate(*forced)
                    params = dataclasses.replace(params, guide=forced)
            # OpenAI n: independent samples per prompt (choices are
            # prompt-major); seeded requests take child seeds seed + j.
            n = body.get("n", 1)
            if n is None:
                n = 1
            if isinstance(n, bool) or not isinstance(n, int):
                raise ValueError("n must be an integer")
            if not 1 <= n <= 16:
                raise ValueError("n must be between 1 and 16")
        except ValueError as e:
            return h._error(400, str(e))
        stream = bool(body.get("stream", False))
        if stream and (len(batch) > 1 or n > 1):
            return h._error(
                400, "streaming is not supported for batched prompts or n > 1")
        echo = bool(body.get("echo", False))
        if echo and chat:
            return h._error(400, "echo is a completions-only parameter")
        if echo and stream:
            return h._error(400, "echo is not supported with streaming")
        # Oversized prompts are refused before queueing (never truncated).
        limit = self.engine.max_prompt_len
        for prompt_ids in batch:
            if len(prompt_ids) > limit:
                return self._context_length_error(h, len(prompt_ids), limit)
        # W3C trace context: continue the gateway/router-propagated trace
        # (folding in their completed spans from the x-arks-trace-spans
        # header) or mint a fresh root.  Only a single-choice request
        # carries it: sibling choices would collide in the trace store
        # under one trace id, so they mint engine-local ids.
        ctx = (trace_mod.TraceCtx.from_headers(h.headers)
               if self.engine.trace.enabled else None)
        single = len(batch) == 1 and n == 1
        # Untenanted clients share the fair queue's default lane.
        tenant = (h.headers.get(tenancy.HDR_TENANT) or "").strip() or None
        reqs = []
        for prompt_ids in batch:
            for j in range(n):
                p = params
                if n > 1 and params.seed is not None:
                    p = dataclasses.replace(params, seed=params.seed + j)
                req = Request(request_id=f"req-{uuid.uuid4().hex[:16]}",
                              prompt_ids=list(prompt_ids), params=p,
                              tenant=tenant, trace=ctx if single else None,
                              model=engine_model)
                try:
                    with logctx.bound(req.request_id,
                                      ctx.trace_id if ctx is not None
                                      else None):
                        self.engine.add_request(req)
                except fairqueue.QueueFullError as e:
                    # A batch admits whole or not at all.
                    for prev in reqs:
                        self.engine.abort(prev.request_id)
                    return self._queue_full_error(h, e)
                reqs.append(req)
        if len(reqs) > 1:
            self._batch_response(h, reqs, model, stop_strings, chat=chat,
                                 echo=echo, tools_ctx=tools_ctx)
        else:
            self._respond(h, reqs[0], chat, model, body, stop_strings,
                          echo=echo, tools_ctx=tools_ctx)

    def _queue_full_error(self, h, e: fairqueue.QueueFullError) -> None:
        """A bounded-queue refusal: 429 for the tenant's bound (the
        caller's own backlog), 503 for the global one (this backend is
        saturated), with the drain-rate ``Retry-After`` and the
        saturation signal."""
        sat = self.engine.saturation()
        headers = {"Retry-After": str(e.retry_after),
                   tenancy.HDR_SATURATION: f"{sat['saturation']:.2f}"}
        if e.tenant:
            headers[tenancy.HDR_TENANT] = e.tenant
        if e.scope == "tenant":
            h._json(429, {"error": {
                "message": (f"tenant queue is full ({e.depth}/{e.limit} "
                            "queued requests for this tenant)"),
                "type": "rate_limit_error",
                "code": "tenant_queue_full"}}, headers=headers)
        else:
            h._json(503, {"error": {
                "message": (f"admission queue is full ({e.depth}/{e.limit} "
                            "queued requests)"),
                "type": "server_error", "code": "queue_full"}},
                headers=headers)

    def _context_length_error(self, h, got: int, limit: int) -> None:
        h._json(400, {"error": {
            "message": (f"This model's maximum context length is {limit} "
                        f"tokens, but your prompt has {got} tokens."),
            "type": "invalid_request_error",
            "code": "context_length_exceeded"}})

    def _request_error(self, h, fin) -> None:
        """Map a finish_reason="error" output to HTTP: client-caused
        rejections (context length, a guide that failed to compile) are
        400s, an engine fault a 500."""
        if fin.error == "context_length_exceeded":
            return self._context_length_error(
                h, fin.num_prompt_tokens, self.engine.max_prompt_len)
        if fin.error and fin.error.startswith("engine_fault"):
            return h._json(500, {"error": {
                "message": ("The server had an error while processing "
                            f"your request ({fin.error})."),
                "type": "server_error", "code": "engine_fault"}})
        if fin.error and fin.error.startswith("shed_deadline"):
            # The queue wait spent the tier's TTFT budget: capacity, not
            # the client's fault.
            sat = self.engine.saturation()
            return h._json(503, {"error": {
                "message": f"request shed before prefill ({fin.error})",
                "type": "server_error", "code": "shed_deadline"}},
                headers={"Retry-After": str(self.engine.queue_retry_after()),
                         tenancy.HDR_SATURATION: f"{sat['saturation']:.2f}"})
        if fin.error and fin.error.startswith("model_pool_exhausted"):
            # Capacity, not the client's fault: the pool cannot fit the
            # model right now.
            return h._json(503, {"error": {
                "message": f"model is not loadable right now ({fin.error})",
                "type": "server_error", "code": "model_pool_exhausted"}},
                headers={"Retry-After": "5"})
        if fin.error and fin.error.startswith("model_load_failed"):
            return h._json(500, {"error": {
                "message": f"model failed to load ({fin.error})",
                "type": "server_error", "code": "model_load_failed"}})
        if fin.error and fin.error.startswith("model_not_found"):
            return h._error(404, fin.error)
        return h._error(400, fin.error or "request rejected")

    def _respond(self, h, req: Request, chat: bool, model: str, body: dict,
                 stop_strings: list[str], echo: bool = False,
                 tools_ctx: str | None = None) -> None:
        if bool(body.get("stream", False)):
            # Peek the first output before committing to SSE: an admission
            # rejection maps to a clean HTTP error, not an event stream.
            first = req.outputs.get()
            if first.finished and first.finish_reason == "error":
                return self._request_error(h, first)
            include_usage = bool(
                (body.get("stream_options") or {}).get("include_usage"))
            if tools_ctx is not None and chat:
                return self._stream_tools_response(
                    h, req, model, include_usage, stop_strings, tools_ctx,
                    first_out=first)
            self._stream_response(h, req, chat, model, include_usage,
                                  stop_strings, first_out=first)
        else:
            self._full_response(h, req, chat, model, stop_strings, echo=echo,
                                tools_ctx=tools_ctx)

    # ------------------------------------------------------------------

    def _collect_text(self, req: Request, stop_strings: list[str]):
        """Drain a request, cutting at stop strings (min_tokens exempts the
        text generated below the minimum).  Returns (text, finish_reason,
        final output, token_ids, logprob entries, per-token text
        pieces)."""
        detok = IncrementalDetokenizer(self.engine.tokenizer)
        # Per-token pieces from the SAME incremental stream keep stop cuts
        # and text_offset aligned; only paid when logprobs are on.
        track = req.params.logprobs is not None
        text = ""
        tokens: list[int] = []
        lps: list = []
        pieces: list[str] = []
        min_tok = int(req.params.min_tokens or 0)
        exempt = 0
        while True:
            out = req.outputs.get()
            start_len = len(tokens)
            if track:
                for j, t in enumerate(out.token_ids):
                    piece = detok.push([t])
                    text += piece
                    pieces.append(piece)
                    if stop_strings and start_len + j + 1 < min_tok:
                        exempt = len(text)
            elif stop_strings and start_len < min_tok:
                for j, t in enumerate(out.token_ids):
                    text += detok.push([t])
                    if start_len + j + 1 < min_tok:
                        exempt = len(text)
            else:
                text += detok.push(out.token_ids)
            tokens.extend(out.token_ids)
            if out.logprobs:
                lps.extend(out.logprobs)
            if out.finished:
                tail = detok.flush()
                text += tail
                if track and pieces and tail:
                    pieces[-1] += tail
            if stop_strings and len(tokens) >= min_tok:
                cut = _find_stop(text, stop_strings, min_end=exempt)
                if cut is not None:
                    text = text[:cut]
                    if not out.finished:
                        self.engine.abort(req.request_id)
                        while not out.finished:
                            out = req.outputs.get()
                    tokens, lps, pieces = self._trim_to_text(
                        tokens, lps, pieces, cut)
                    return text, "stop", out, tokens, lps, pieces
            if out.finished:
                return text, out.finish_reason, out, tokens, lps, pieces

    def _trim_to_text(self, tokens: list[int], lps: list, pieces: list[str],
                      cut: int):
        """Keep the longest token prefix whose streamed text fits in
        ``cut`` characters (a token straddling the cut is dropped)."""
        if not pieces and tokens:
            tok = self.engine.tokenizer
            pieces = (tok.decode([t]) for t in tokens)
        keep, acc, kept = 0, 0, []
        for piece in pieces:
            if acc + len(piece) > cut:
                break
            acc += len(piece)
            keep += 1
            kept.append(piece)
        return tokens[:keep], lps[:keep], kept

    def _lp_completions_obj(self, token_ids: list[int], lps: list,
                            top_n: int, pieces: list[str] | None = None,
                            offset_base: int = 0) -> dict:
        """Completions logprobs object (tokens / token_logprobs /
        top_logprobs / text_offset); alternatives decode in isolation,
        ``offset_base`` shifts text_offset past echoed prompt text."""
        tok = self.engine.tokenizer
        tokens, token_lps, tops, offsets = [], [], [], []
        off = offset_base
        for i, (tid, (clp, top)) in enumerate(zip(token_ids, lps)):
            s = pieces[i] if pieces is not None and i < len(pieces) \
                else tok.decode([tid])
            tokens.append(s)
            token_lps.append(clp)
            tops.append({tok.decode([j]): v for j, v in top[:top_n]})
            offsets.append(off)
            off += len(s)
        return {"tokens": tokens, "token_logprobs": token_lps,
                "top_logprobs": tops, "text_offset": offsets}

    def _lp_chat_content(self, token_ids: list[int], lps: list, top_n: int,
                         pieces: list[str] | None = None) -> list[dict]:
        """Chat logprobs.content entries ({token, logprob, bytes,
        top_logprobs})."""
        tok = self.engine.tokenizer

        def entry(text: str, lp_val: float) -> dict:
            return {"token": text, "logprob": lp_val,
                    "bytes": list(text.encode("utf-8", "surrogatepass"))}

        out = []
        for i, (tid, (clp, top)) in enumerate(zip(token_ids, lps)):
            s = pieces[i] if pieces is not None and i < len(pieces) \
                else tok.decode([tid])
            e = entry(s, clp)
            e["top_logprobs"] = [entry(tok.decode([j]), v)
                                 for j, v in top[:top_n]]
            out.append(e)
        return out

    def _batch_response(self, h, reqs: list[Request], model: str,
                        stop_strings: list[str], chat: bool = False,
                        echo: bool = False,
                        tools_ctx: str | None = None) -> None:
        """Multi-choice responses: batched prompts and/or n > 1 (one
        engine request per choice, prompt-major indexes)."""
        choices, usage = [], {"prompt_tokens": 0, "completion_tokens": 0,
                              "total_tokens": 0}
        echo_cache: dict = {}
        for i, req in enumerate(reqs):
            text, finish_reason, fin, toks, lps, pieces = self._collect_text(
                req, stop_strings)
            if finish_reason == "error":
                # One rejected choice fails the whole batch; release the
                # siblings' slots.
                for r in reqs:
                    self.engine.abort(r.request_id)
                return self._request_error(h, fin)
            if chat:
                message, finish_reason = self._chat_message(
                    text, finish_reason, tools_ctx)
                choice = {"index": i, "message": message,
                          "finish_reason": finish_reason}
                if req.params.logprobs is not None and lps:
                    choice["logprobs"] = {"content": self._lp_chat_content(
                        toks, lps, req.params.logprobs, pieces)}
            else:
                prefix = ""
                if echo:
                    key = tuple(req.prompt_ids)
                    if key not in echo_cache:  # n children share a prompt
                        echo_cache[key] = self.engine.tokenizer.decode(
                            req.prompt_ids)
                    prefix = echo_cache[key]
                    text = prefix + text
                choice = {"index": i, "text": text,
                          "finish_reason": finish_reason}
                if req.params.logprobs is not None and lps:
                    choice["logprobs"] = self._lp_completions_obj(
                        toks, lps, req.params.logprobs, pieces,
                        offset_base=len(prefix))
            choices.append(choice)
            usage["prompt_tokens"] += fin.num_prompt_tokens
            usage["completion_tokens"] += fin.num_generated_tokens
        usage["total_tokens"] = (usage["prompt_tokens"]
                                 + usage["completion_tokens"])
        h._json(200, {
            "id": reqs[0].request_id,
            "object": "chat.completion" if chat else "text_completion",
            "created": int(time.time()), "model": model,
            "choices": choices, "usage": usage})

    def _chat_message(self, text: str, finish_reason: str,
                      tools_ctx: str | None) -> tuple[dict, str]:
        """Assistant message (+ effective finish_reason): with active
        tools the text is parsed for calls; a call turns "stop" into
        "tool_calls" (never a truncation: clients must see length
        limits)."""
        if tools_ctx is not None:
            content, calls = tools_mod.parse_tool_calls(text, tools_ctx)
            if calls:
                msg = {"role": "assistant", "content": content,
                       "tool_calls": calls}
                fr = ("tool_calls" if finish_reason == "stop"
                      else finish_reason)
                return msg, fr
        return {"role": "assistant", "content": text}, finish_reason

    def _full_response(self, h, req: Request, chat: bool, model: str,
                       stop_strings: list[str], echo: bool = False,
                       tools_ctx: str | None = None) -> None:
        text, finish_reason, fin, toks, lps, pieces = self._collect_text(
            req, stop_strings)
        echo_prefix = ""
        if echo and not chat:
            echo_prefix = self.engine.tokenizer.decode(req.prompt_ids)
            text = echo_prefix + text
        if finish_reason == "error":
            return self._request_error(h, fin)
        usage = {
            "prompt_tokens": fin.num_prompt_tokens,
            "completion_tokens": fin.num_generated_tokens,
            "total_tokens": fin.num_prompt_tokens + fin.num_generated_tokens}
        n_lp = req.params.logprobs
        if chat:
            message, finish_reason = self._chat_message(text, finish_reason,
                                                        tools_ctx)
            choice = {"index": 0, "message": message,
                      "finish_reason": finish_reason}
            if n_lp is not None and lps:
                choice["logprobs"] = {
                    "content": self._lp_chat_content(toks, lps, n_lp, pieces)}
        else:
            choice = {"index": 0, "text": text,
                      "finish_reason": finish_reason}
            if n_lp is not None and lps:
                choice["logprobs"] = self._lp_completions_obj(
                    toks, lps, n_lp, pieces, offset_base=len(echo_prefix))
        h._json(200, {
            "id": req.request_id,
            "object": "chat.completion" if chat else "text_completion",
            "created": int(time.time()), "model": model,
            "choices": [choice], "usage": usage})

    @staticmethod
    def _sse_start(h):
        """Send the SSE headers; returns the frame writer."""
        h.send_response(200)
        h.send_header("Content-Type", "text/event-stream")
        h.send_header("Cache-Control", "no-cache")
        h.send_header("Transfer-Encoding", "chunked")
        h.send_header("Connection", "close")
        h.end_headers()
        h.close_connection = True

        def send_frame(obj) -> None:
            data = b"data: " + (obj if isinstance(obj, bytes)
                                else json.dumps(obj).encode()) + b"\n\n"
            h.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            h.wfile.flush()

        return send_frame

    @staticmethod
    def _sse_end(h, send_frame) -> None:
        send_frame(b"[DONE]")
        h.wfile.write(b"0\r\n\r\n")
        h.wfile.flush()

    def _stream_tools_response(self, h, req: Request, model: str,
                               include_usage: bool, stop_strings: list[str],
                               parser: str, first_out=None) -> None:
        """Chat streaming with active tools: content streams until a
        tool-call marker appears; from there the text buffers and leaves
        as ``delta.tool_calls`` when the stream ends (each call's
        arguments in one delta).  Stop strings apply over the full text,
        as on the non-stream path (the stream buffers fully when any are
        set), min_tokens exemption included."""
        send_frame = self._sse_start(h)
        rid = req.request_id
        created = int(time.time())

        def chunk(delta: dict | None, finish: str | None = None,
                  usage: dict | None = None,
                  empty_choices: bool = False) -> dict:
            choices = [] if empty_choices else [
                {"index": 0, "delta": delta or {}, "finish_reason": finish}]
            payload = {"id": rid, "object": "chat.completion.chunk",
                       "created": created, "model": model,
                       "choices": choices}
            if usage is not None:
                payload["usage"] = usage
            return payload

        detok = IncrementalDetokenizer(self.engine.tokenizer)
        text = ""
        emitted = 0
        buffering = bool(stop_strings)
        hold = len(tools_mod.TOOL_OPEN) - 1
        fin = None
        min_tok = int(req.params.min_tokens or 0)
        ntok = 0
        exempt = 0
        try:
            send_frame(chunk({"role": "assistant"}))
            while True:
                out = first_out if first_out is not None \
                    else req.outputs.get()
                first_out = None
                prev_ntok = ntok
                ntok += len(out.token_ids)
                if stop_strings and prev_ntok < min_tok:
                    for j, t in enumerate(out.token_ids):
                        text += detok.push([t])
                        if prev_ntok + j + 1 < min_tok:
                            exempt = len(text)
                else:
                    text += detok.push(out.token_ids)
                if out.finished:
                    text += detok.flush()
                    fin = out
                if not buffering:
                    m = text.find(tools_mod.TOOL_OPEN)
                    if m >= 0:
                        if m > emitted:
                            send_frame(chunk({"content": text[emitted:m]}))
                            emitted = m
                        buffering = True
                    elif (parser in ("auto", "llama3")
                          and text.lstrip()[:1] == "{"):
                        buffering = True  # llama3: the message is a call
                    elif not out.finished:
                        # Hold back a window so a straddling marker is not
                        # half-emitted as content.
                        safe = len(text) - hold
                        if safe > emitted:
                            send_frame(chunk({"content": text[emitted:safe]}))
                            emitted = safe
                if out.finished:
                    break
            finish = fin.finish_reason
            if stop_strings and ntok >= min_tok:
                cut = _find_stop(text, stop_strings, min_end=exempt)
                if cut is not None:
                    text = text[:cut]
                    finish = "stop"
            content, calls = tools_mod.parse_tool_calls(text, parser)
            if calls:
                # Leftover content in RAW coordinates: outside the call
                # spans and past what was already streamed.
                pos = emitted
                rest_parts = []
                for s, e in tools_mod.call_spans(text, parser):
                    if s > pos:
                        rest_parts.append(text[pos:s])
                    pos = max(pos, e)
                if pos < len(text):
                    rest_parts.append(text[pos:])
                rest = "".join(rest_parts)
                if rest:
                    send_frame(chunk({"content": rest}))
                for idx, call in enumerate(calls):
                    send_frame(chunk({"tool_calls": [{
                        "index": idx, "id": call["id"], "type": "function",
                        "function": dict(call["function"])}]}))
                if finish == "stop":
                    finish = "tool_calls"
            elif len(text) > emitted:
                send_frame(chunk({"content": text[emitted:]}))
            send_frame(chunk(None, finish=finish))
            if include_usage:
                send_frame(chunk(None, usage={
                    "prompt_tokens": fin.num_prompt_tokens,
                    "completion_tokens": fin.num_generated_tokens,
                    "total_tokens": (fin.num_prompt_tokens
                                     + fin.num_generated_tokens)},
                    empty_choices=True))
            self._sse_end(h, send_frame)
        except (BrokenPipeError, ConnectionResetError):
            self.engine.abort(req.request_id)

    def _stream_response(self, h, req: Request, chat: bool, model: str,
                         include_usage: bool, stop_strings: list[str],
                         first_out=None) -> None:
        send_frame = self._sse_start(h)
        rid = req.request_id
        created = int(time.time())
        obj = "chat.completion.chunk" if chat else "text_completion"
        n_lp = req.params.logprobs
        # Logprob entries flush with the frames that carry their text,
        # never ahead of it: entries in the stop-string hold-back tail
        # wait (a later cut may drop them), so the streamed entries equal
        # the non-stream response's.
        pend_lp_toks: list[int] = []
        pend_lps: list = []
        pend_pieces: list[str] = []
        lp_flush_n: list[int | None] = [None]

        def lp_within(pending_text: str, boundary: int) -> int:
            """How many pending entries' text ends within the first
            ``boundary`` chars of ``pending_text``."""
            acc = len(pending_text) - sum(len(p) for p in pend_pieces)
            keep = 0
            for p in pend_pieces:
                if acc + len(p) > boundary:
                    break
                acc += len(p)
                keep += 1
            return keep

        def take_lp():
            if n_lp is None or not pend_lps:
                return None
            n = lp_flush_n[0]
            n = len(pend_lps) if n is None else min(n, len(pend_lps))
            if n <= 0:
                return None
            toks_, lps_, pieces_ = (pend_lp_toks[:n], pend_lps[:n],
                                    pend_pieces[:n])
            del pend_lp_toks[:n]
            del pend_lps[:n]
            del pend_pieces[:n]
            if chat:
                return {"content": self._lp_chat_content(
                    toks_, lps_, n_lp, pieces_)}
            return self._lp_completions_obj(toks_, lps_, n_lp, pieces_)

        def chunk(delta_text: str | None, finish: str | None = None,
                  role: str | None = None, usage: dict | None = None,
                  empty_choices: bool = False) -> dict:
            if empty_choices:
                choices = []
            elif chat:
                delta: dict = {}
                if role:
                    delta["role"] = role
                if delta_text:
                    delta["content"] = delta_text
                choices = [{"index": 0, "delta": delta,
                            "finish_reason": finish}]
            else:
                choices = [{"index": 0, "text": delta_text or "",
                            "finish_reason": finish}]
            if choices and (delta_text or finish):
                lp_obj = take_lp()
                if lp_obj is not None:
                    choices[0]["logprobs"] = lp_obj
            payload = {"id": rid, "object": obj, "created": created,
                       "model": model, "choices": choices}
            if usage is not None:
                payload["usage"] = usage
            return payload

        detok = IncrementalDetokenizer(self.engine.tokenizer)
        fin = None
        # Text not yet emitted; held back enough to catch a stop string
        # across two deltas.
        pending = ""
        hold = max((len(s) for s in stop_strings), default=1) - 1
        min_tok = int(req.params.min_tokens or 0)
        ntok = 0
        exempt = 0
        try:
            if chat:
                send_frame(chunk(None, role="assistant"))
            while True:
                out = first_out if first_out is not None \
                    else req.outputs.get()
                first_out = None
                prev_ntok = ntok
                ntok += len(out.token_ids)
                if n_lp is not None:
                    for j, t in enumerate(out.token_ids):
                        piece = detok.push([t])
                        pending += piece
                        if out.logprobs:
                            pend_pieces.append(piece)
                        if stop_strings and prev_ntok + j + 1 < min_tok:
                            exempt = len(pending)
                    if out.logprobs:
                        pend_lp_toks.extend(out.token_ids)
                        pend_lps.extend(out.logprobs)
                elif stop_strings and prev_ntok < min_tok:
                    for j, t in enumerate(out.token_ids):
                        pending += detok.push([t])
                        if prev_ntok + j + 1 < min_tok:
                            exempt = len(pending)
                else:
                    pending += detok.push(out.token_ids)
                if out.finished:
                    # The window residue can complete a stop string: flush
                    # it before the check, as the non-stream path does.
                    tail = detok.flush()
                    pending += tail
                    if pend_pieces and tail:
                        pend_pieces[-1] += tail
                if stop_strings and ntok >= min_tok:
                    cut = _find_stop(pending, stop_strings, min_end=exempt)
                    if cut is not None:
                        keep = lp_within(pending, cut)
                        del pend_lp_toks[keep:]
                        del pend_lps[keep:]
                        del pend_pieces[keep:]
                        if pending[:cut]:
                            send_frame(chunk(pending[:cut]))
                        self.engine.abort(req.request_id)
                        while not out.finished:
                            out = req.outputs.get()
                        fin = out
                        send_frame(chunk(None, finish="stop"))
                        break
                if out.finished:
                    if pending:
                        send_frame(chunk(pending))
                    send_frame(chunk(None, finish=out.finish_reason))
                    fin = out
                    break
                safe = len(pending) - hold
                if safe > 0:
                    lp_flush_n[0] = lp_within(pending, safe)
                    send_frame(chunk(pending[:safe]))
                    lp_flush_n[0] = None
                    pending = pending[safe:]
                    exempt = max(0, exempt - safe)
            if include_usage and fin is not None:
                send_frame(chunk(None, usage={
                    "prompt_tokens": fin.num_prompt_tokens,
                    "completion_tokens": fin.num_generated_tokens,
                    "total_tokens": (fin.num_prompt_tokens
                                     + fin.num_generated_tokens)},
                    empty_choices=True))
            self._sse_end(h, send_frame)
        except (BrokenPipeError, ConnectionResetError):
            # Client went away: free the slot instead of decoding for nobody.
            self.engine.abort(req.request_id)

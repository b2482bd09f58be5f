"""OpenAI-compatible HTTP surface for the port's engine (port of the main
path of ``arks_tpu/server/openai_server.py``).

- POST /v1/completions and /v1/chat/completions, streaming (SSE frames
  ``data: {...}`` ending with ``data: [DONE]``; with
  ``stream_options.include_usage`` the last data frame carries the usage
  and an empty choices list) and not, with usage and ``finish_reason``.
- GET /v1/models, /health.

Stdlib ``ThreadingHTTPServer``, as in the reference: request threads hand
work to the engine thread and read its output queue.  Request fields of
later slices (penalties, logit_bias, logprobs, min_tokens, guides, tools,
n > 1, batched prompts, echo) are answered with HTTP 400.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from arks_tpu_torch.engine.engine import InferenceEngine, unserved_params
from arks_tpu_torch.engine.tokenizer import IncrementalDetokenizer
from arks_tpu_torch.engine.types import Request, SamplingParams

log = logging.getLogger("arks_tpu_torch.server")

# Body fields of features this slice does not serve -> their name.
_UNSERVED_FIELDS = {"logprobs": "logprobs", "top_logprobs": "logprobs",
                    "response_format": "guided decoding",
                    "guided_regex": "guided decoding",
                    "guided_json": "guided decoding",
                    "guided_choice": "guided decoding", "tools": "tools",
                    "echo": "echo", "best_of": "best_of"}


def _find_stop(text: str, stop_strings: list[str]) -> int | None:
    """Earliest index at which any stop string begins, else None."""
    hits = [i for i in (text.find(s) for s in stop_strings) if i >= 0]
    return min(hits) if hits else None


def sampling_from_body(body: dict, tokenizer) -> tuple[SamplingParams,
                                                       list[str]]:
    """Engine sampling params + the multi-token stop strings the server
    matches on text.  Raises ValueError (HTTP 400) on bad or unserved
    fields."""
    for field, what in _UNSERVED_FIELDS.items():
        val = body.get(field)
        if val is None or val is False or (field == "tools" and val == []) \
                or (field == "best_of" and val == 1):
            continue
        if (field == "response_format" and isinstance(val, dict)
                and val.get("type", "text") == "text"):
            continue
        raise ValueError(f"{what} is not served by this server yet")
    if int(body.get("n") or 1) != 1:
        raise ValueError("n > 1 is not served by this server yet")
    stop = body.get("stop") or []
    if isinstance(stop, str):
        stop = [stop]
    stop_ids = [int(t) for t in (body.get("stop_token_ids") or [])]
    stop_strings: list[str] = []
    for s in stop:
        ids = tokenizer.encode(s)
        if len(ids) == 1:
            stop_ids.append(ids[0])
        elif s:
            stop_strings.append(s)
    params = SamplingParams(
        max_tokens=int(body.get("max_tokens")
                       or body.get("max_completion_tokens") or 256),
        temperature=float(body.get("temperature", 1.0)),
        top_p=float(body.get("top_p", 1.0)),
        top_k=int(body.get("top_k", 0)),
        seed=body.get("seed"),
        ignore_eos=bool(body.get("ignore_eos", False)),
        stop_token_ids=tuple(stop_ids),
        presence_penalty=float(body.get("presence_penalty") or 0.0),
        frequency_penalty=float(body.get("frequency_penalty") or 0.0),
        logit_bias=tuple((int(t), float(b)) for t, b in
                         (body.get("logit_bias") or {}).items()),
        min_tokens=int(body.get("min_tokens") or 0),
        priority=int(body.get("priority") or 0))
    what = unserved_params(params)
    if what is not None:
        raise ValueError(f"{what} is not served by this server yet")
    if params.max_tokens < 1:
        raise ValueError("max_tokens must be >= 1")
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
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def start(self, background: bool = True) -> None:
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def _json(self, code: int, payload: dict) -> None:
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _error(self, code: int, message: str,
                       code_name: str | None = None) -> None:
                self._json(code, {"error": {
                    "message": message, "code": code_name,
                    "type": ("invalid_request_error" if code < 500
                             else "server_error")}})

            def do_GET(self):
                if self.path == "/v1/models":
                    self._json(200, {"object": "list", "data": [{
                        "id": server.served_model_name, "object": "model",
                        "created": 0, "owned_by": "arks"}]})
                elif self.path in ("/health", "/healthz"):
                    self._json(200, {"status": "ok"})
                else:
                    self._error(404, f"no route {self.path}")

            def do_POST(self):
                if self.path not in ("/v1/completions",
                                     "/v1/chat/completions"):
                    return self._error(404, f"no route {self.path}")
                try:
                    n = int(self.headers.get("Content-Length") or 0)
                    body = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(body, dict):
                        raise ValueError("request body must be an object")
                except ValueError as e:
                    return self._error(400, f"bad request body: {e}")
                server.handle_completion(
                    self, body, chat=self.path == "/v1/chat/completions")

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        if background:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, name="http", daemon=True)
            self._thread.start()
        else:
            self._httpd.serve_forever()

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    # ------------------------------------------------------------------

    def _prompt_ids(self, body: dict, chat: bool) -> list[int]:
        tok = self.engine.tokenizer
        if chat:
            messages = body.get("messages")
            if not isinstance(messages, list) or not messages:
                raise ValueError("messages must be a non-empty list")
            return tok.apply_chat_template(messages)
        prompt = body.get("prompt", "")
        if isinstance(prompt, list) and prompt and all(
                isinstance(p, int) for p in prompt):
            ids = [int(t) for t in prompt]
        elif isinstance(prompt, list):
            if len(prompt) != 1 or not isinstance(prompt[0], str):
                raise ValueError("batched prompts are not served by this "
                                 "server yet")
            ids = tok.encode(prompt[0])
        else:
            ids = tok.encode(str(prompt))
        if not ids:
            raise ValueError("prompt must not be empty")
        return ids

    def handle_completion(self, h, body: dict, chat: bool) -> None:
        model = body.get("model") or self.served_model_name
        if model != self.served_model_name:
            return h._error(404, f"model {model!r} not found")
        try:
            ids = self._prompt_ids(body, chat)
            params, stop_strings = sampling_from_body(body,
                                                      self.engine.tokenizer)
        except (ValueError, NotImplementedError) as e:
            return h._error(400, str(e))
        limit = self.engine.max_prompt_len
        if len(ids) > limit:
            return h._error(
                400, f"This model's maximum context length is {limit} "
                f"tokens, but your prompt has {len(ids)} tokens.",
                "context_length_exceeded")
        req = Request(request_id=f"req-{uuid.uuid4().hex[:16]}",
                      prompt_ids=ids, params=params)
        self.engine.add_request(req)
        if body.get("stream"):
            include_usage = bool(
                (body.get("stream_options") or {}).get("include_usage"))
            self._stream_response(h, req, chat, model, include_usage,
                                  stop_strings)
        else:
            self._full_response(h, req, chat, model, stop_strings)

    @staticmethod
    def _engine_error(h, out) -> None:
        if out.error == "context_length_exceeded":
            return h._error(400, "prompt exceeds the context length",
                            out.error)
        return h._error(500, out.error or "engine error", "engine_fault")

    def _full_response(self, h, req: Request, chat: bool, model: str,
                       stop_strings: list[str]) -> None:
        detok = IncrementalDetokenizer(self.engine.tokenizer)
        text = ""
        while True:
            out = req.outputs.get()
            text += detok.push(out.token_ids)
            if out.finished:
                text += detok.flush()
            cut = _find_stop(text, stop_strings) if stop_strings else None
            if cut is not None:
                text = text[:cut]
                if not out.finished:
                    self.engine.abort(req.request_id)
                    while not out.finished:
                        out = req.outputs.get()
                reason = "stop"
                break
            if out.finished:
                reason = out.finish_reason
                break
        if reason == "error":
            return self._engine_error(h, out)
        usage = {"prompt_tokens": out.num_prompt_tokens,
                 "completion_tokens": out.num_generated_tokens,
                 "total_tokens": out.num_prompt_tokens
                 + out.num_generated_tokens}
        if chat:
            choice = {"index": 0, "finish_reason": reason,
                      "message": {"role": "assistant", "content": text}}
        else:
            choice = {"index": 0, "text": text, "finish_reason": reason}
        h._json(200, {
            "id": req.request_id,
            "object": "chat.completion" if chat else "text_completion",
            "created": int(time.time()), "model": model,
            "choices": [choice], "usage": usage})

    def _stream_response(self, h, req: Request, chat: bool, model: str,
                         include_usage: bool,
                         stop_strings: list[str]) -> None:
        # Peek the first output before committing to SSE: an admission
        # rejection maps to a clean HTTP error, not an event stream.
        first = req.outputs.get()
        if first.finished and first.finish_reason == "error":
            return self._engine_error(h, first)
        h.send_response(200)
        h.send_header("Content-Type", "text/event-stream")
        h.send_header("Cache-Control", "no-cache")
        h.send_header("Transfer-Encoding", "chunked")
        h.send_header("Connection", "close")
        h.end_headers()
        h.close_connection = True
        rid, created = req.request_id, int(time.time())
        obj = "chat.completion.chunk" if chat else "text_completion"

        def send(payload) -> None:
            data = b"data: " + (payload if isinstance(payload, bytes)
                                else json.dumps(payload).encode()) + b"\n\n"
            h.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            h.wfile.flush()

        def frame(text: str | None, finish: str | None = None,
                  role: str | None = None) -> dict:
            if chat:
                delta = {}
                if role:
                    delta["role"] = role
                if text:
                    delta["content"] = text
                choice = {"index": 0, "delta": delta, "finish_reason": finish}
            else:
                choice = {"index": 0, "text": text or "",
                          "finish_reason": finish}
            return {"id": rid, "object": obj, "created": created,
                    "model": model, "choices": [choice]}

        detok = IncrementalDetokenizer(self.engine.tokenizer)
        # Hold back enough tail to catch a stop string across two deltas.
        hold = max((len(s) for s in stop_strings), default=1) - 1
        pending = ""
        out = first
        try:
            if chat:
                send(frame(None, role="assistant"))
            while True:
                pending += detok.push(out.token_ids)
                if out.finished:
                    pending += detok.flush()
                cut = (_find_stop(pending, stop_strings)
                       if stop_strings else None)
                if cut is not None:
                    if pending[:cut]:
                        send(frame(pending[:cut]))
                    self.engine.abort(req.request_id)
                    while not out.finished:
                        out = req.outputs.get()
                    send(frame(None, finish="stop"))
                    break
                if out.finished:
                    if pending:
                        send(frame(pending))
                    send(frame(None, finish=out.finish_reason))
                    break
                safe = len(pending) - hold
                if safe > 0:
                    send(frame(pending[:safe]))
                    pending = pending[safe:]
                out = req.outputs.get()
            if include_usage:
                send({"id": rid, "object": obj, "created": created,
                      "model": model, "choices": [], "usage": {
                          "prompt_tokens": out.num_prompt_tokens,
                          "completion_tokens": out.num_generated_tokens,
                          "total_tokens": out.num_prompt_tokens
                          + out.num_generated_tokens}})
            send(b"[DONE]")
            h.wfile.write(b"0\r\n\r\n")
            h.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            # Client went away: free the slot instead of decoding for nobody.
            self.engine.abort(req.request_id)

"""Prefill/decode-disaggregated serving (the port of
``arks_tpu/server/disagg.py``): ``python -m arks_tpu_torch.server
--disaggregation-mode prefill|decode``.

- **PrefillServer** serves ``POST /v1/prefill``: it tokenizes the OpenAI
  body (``_chat`` marks a chat body), runs the engine's detached prefill
  and answers the first token and the prompt's K/V as one AKV1 message
  (``engine/kv_transfer.py``).  Its engine never starts its step loop; the
  completion endpoints answer 501, so misrouted traffic fails loudly.
- **DecodeServer** is an OpenAIServer that also serves ``POST
  /v1/disagg/completions`` and ``/v1/disagg/chat/completions``: it PULLS
  the K/V from the prefill server named in ``X-Arks-Prefill-Addr``, admits
  the request with them into its own batch, and streams the completion.
  A prompt past the prefill limit answers 400 ``context_length_exceeded``;
  a failed pull answers 502 (never a local prefill); ``n > 1`` and
  ``echo`` are refused.

The first token is sampled with ``key(seed)`` on the prefill side and the
stream continues from ``fold_in(key(seed), 1)`` on the decode side, so a
seeded disaggregated stream is the one a single engine gives.
"""

from __future__ import annotations

import http.client
import json
import logging
import uuid

from arks_tpu_torch.engine import kv_transfer
from arks_tpu_torch.engine.engine import ContextLengthExceededError
from arks_tpu_torch.engine.guides import GuideError
from arks_tpu_torch.engine.types import PrefilledState, Request
from arks_tpu_torch.server.openai_server import (OpenAIServer,
                                                 sampling_from_body)

log = logging.getLogger("arks_tpu_torch.disagg")

PREFILL_PATH = "/v1/prefill"
HDR_PREFILL_ADDR = "X-Arks-Prefill-Addr"


def _context_error(h, message: str) -> None:
    h._json(400, {"error": {"message": message,
                            "type": "invalid_request_error",
                            "code": "context_length_exceeded"}})


def prefilled_state(meta: dict, k, v) -> PrefilledState:
    """The ``PrefilledState`` of a ``/v1/prefill`` answer (its unpacked
    meta and K/V)."""
    # JSON gives the logprob entry back as nested lists.
    first_lp = meta.get("first_lp")
    if first_lp is not None:
        first_lp = (float(first_lp[0]),
                    [(int(i), float(lp)) for i, lp in first_lp[1]])
    return PrefilledState(
        first_token=int(meta["first_token"]),
        num_prompt=int(meta["num_prompt"]), seed=int(meta["seed"]),
        k=k, v=v, first_lp=first_lp, guide_row=int(meta.get("guide_row", 0)),
        prompt_ids=[int(t) for t in meta.get("prompt_ids") or []],
        kv_dtype=str(k.dtype).replace("torch.", ""))


def prefill_meta(pf) -> dict:
    """The AKV1 meta of a ``PrefilledState`` (what ``/v1/prefill`` sends
    beside its K/V)."""
    meta = {"first_token": pf.first_token, "num_prompt": pf.num_prompt,
            "seed": pf.seed}
    if pf.prompt_ids:
        # The decode side keys the K/V by chain digest.
        meta["prompt_ids"] = [int(t) for t in pf.prompt_ids]
    if pf.guide_row:
        # The DFA row after the first token, relative to the guide's
        # start row.
        meta["guide_row"] = pf.guide_row
    if pf.first_lp is not None:
        meta["first_lp"] = pf.first_lp
    return meta


class PrefillServer(OpenAIServer):
    """``POST /v1/prefill`` on an engine that never starts its loop."""

    post_routes = (PREFILL_PATH,)
    needs_loop = False

    def handle_completion(self, h, body: dict, chat: bool) -> None:
        h._error(501, "this is a prefill-only server; use /v1/prefill")

    def handle_post(self, h, body: dict, path: str) -> bool:
        if path != PREFILL_PATH:
            return False
        chat = bool(body.get("_chat", False))
        try:
            batch = self._prompt_ids_batch(body, chat)
            if len(batch) > 1:
                raise ValueError(
                    "disaggregated serving takes one prompt per request")
            params, _ = sampling_from_body(body, self.engine.tokenizer,
                                           self.engine)
            if (body.get("n") or 1) != 1:
                raise ValueError(
                    "disaggregated serving does not support n > 1")
        except ValueError as e:
            h._error(400, str(e))
            return True
        try:
            pf = self.engine.prefill_detached(batch[0], params)
        except ContextLengthExceededError as e:
            _context_error(h, str(e))
            return True
        except GuideError as e:
            # A guide that cannot compile is the request's fault.
            h._error(400, str(e))
            return True
        payload = kv_transfer.pack(prefill_meta(pf), [pf.k, pf.v])
        h.send_response(200)
        h.send_header("Content-Type", "application/octet-stream")
        h.send_header("Content-Length", str(len(payload)))
        h.end_headers()
        h.wfile.write(payload)
        return True


class DecodeServer(OpenAIServer):
    """OpenAIServer plus ``/v1/disagg/*`` for router-coordinated
    requests."""

    post_routes = ("/v1/disagg/completions", "/v1/disagg/chat/completions")

    def handle_post(self, h, body: dict, path: str) -> bool:
        if path not in self.post_routes:
            return False
        self._handle_disagg(h, body, chat=path.endswith("/chat/completions"))
        return True

    def _handle_disagg(self, h, body: dict, chat: bool) -> None:
        prefill_addr = h.headers.get(HDR_PREFILL_ADDR, "")
        if not prefill_addr:
            return h._error(400, f"missing {HDR_PREFILL_ADDR} header")
        model = body.get("model") or self.served_model_name
        if model != self.served_model_name:
            return h._error(404, f"model {model!r} not found")
        try:
            meta, (k, v) = self.pull_kv(prefill_addr, body, chat)
        except ContextLengthExceededError as e:
            # The client's input, not a backend fault: a 502 would make
            # routers retry an unservable request.
            return _context_error(h, str(e))
        except Exception as e:
            log.warning("prefill pull from %s failed", prefill_addr,
                        exc_info=True)
            return h._error(502, f"prefill pull failed: {e}")
        try:
            params, stop_strings = sampling_from_body(
                body, self.engine.tokenizer, self.engine)
        except ValueError as e:
            return h._error(400, str(e))
        if (body.get("n") or 1) != 1:
            return h._error(400,
                            "disaggregated serving does not support n > 1")
        if body.get("echo"):
            return h._error(400,
                            "disaggregated serving does not support echo")
        req = Request(request_id=f"req-{uuid.uuid4().hex[:16]}",
                      prompt_ids=[], params=params,
                      prefilled=prefilled_state(meta, k, v))
        self.engine.add_request(req)
        self._respond(h, req, chat, model, body, stop_strings)

    @staticmethod
    def pull_kv(addr: str, body: dict, chat: bool):
        """POST the body to the prefill server's ``/v1/prefill`` and unpack
        its answer: (meta, [k, v]).  A 400 ``context_length_exceeded``
        raises ContextLengthExceededError; any other failure raises."""
        host, _, port = addr.partition(":")
        conn = http.client.HTTPConnection(host, int(port or 80), timeout=300)
        try:
            payload = dict(body, _chat=chat)
            conn.request("POST", PREFILL_PATH,
                         body=json.dumps(payload).encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                if resp.status == 400:
                    try:
                        err = json.loads(data).get("error") or {}
                    except ValueError:
                        err = {}
                    if err.get("code") == "context_length_exceeded":
                        raise ContextLengthExceededError(
                            err.get("message") or "context length exceeded")
                raise RuntimeError(f"prefill {addr} -> {resp.status}: "
                                   f"{data[:200]!r}")
            return kv_transfer.unpack(data)
        finally:
            conn.close()

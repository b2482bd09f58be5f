"""Request/response dataclasses for the serving engine (copy of
``arks_tpu/engine/types.py``).  ``SamplingParams`` keeps every field of the
reference, and the port's engine serves each of them, so one request means
the same thing to both engines, and ``Request`` carries the reference's
fields: a disaggregated decode side's ``prefilled`` state and the router's
``peer_hint``."""

from __future__ import annotations

import dataclasses
import queue
import time


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    max_tokens: int = 256
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0          # 0 = disabled
    stop_token_ids: tuple[int, ...] = ()
    ignore_eos: bool = False
    seed: int | None = None
    # OpenAI presence/frequency penalties over OUTPUT tokens (vLLM
    # semantics): logits -= presence*1[seen] + frequency*count.
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    # None = no logprobs; 0 = chosen-token logprob only; N>0 = plus the
    # top-N alternatives.
    logprobs: int | None = None
    # OpenAI logit_bias as (token_id, bias) pairs.
    logit_bias: tuple[tuple[int, float], ...] = ()
    # vLLM-style min_tokens: eos/stop token ids are suppressed until at
    # least this many tokens have been generated.
    min_tokens: int = 0
    # Admission priority (LOWER value admits first; equal priorities FIFO).
    priority: int = 0
    # Guided decoding: ("json", "") or ("regex", pattern).
    guide: tuple[str, str] | None = None


@dataclasses.dataclass
class PrefilledState:
    """A detached prefill's result, moved from a prefill engine to a decode
    engine (``server/disagg.py``, over the AKV1 wire).

    K/V are ``[L, 1, T, Hkv, D]`` host tensors (T = the prefill bucket) in
    the prefill engine's compute dtype; the decode engine inserts them
    into its own cache (quantizing for an int8/int4 pool).  The prefill
    side sampled the first token with ``key(seed)``; the decode side
    continues from ``fold_in(key(seed), 1)``, so the stream is the one a
    single engine would have produced with that seed."""

    first_token: int
    num_prompt: int
    seed: int
    k: object
    v: object
    # The first token's logprob entry (chosen, [(id, logprob), ...]) when
    # the request asked for logprobs.
    first_lp: object | None = None
    # The guide's DFA row after the first token, RELATIVE to the guide's
    # start row (the decode side rebases it onto its own guide table).
    guide_row: int = 0
    # The prompt's ids: the decode side keys the inserted pages by chain
    # digest (device index, host tier).  Empty from a peer that sends none.
    prompt_ids: list | None = None
    # Informational: the dtype the K/V travel in.
    kv_dtype: str = "bf16"


@dataclasses.dataclass
class Request:
    request_id: str
    prompt_ids: list[int]
    params: SamplingParams
    arrival_time: float = dataclasses.field(default_factory=time.monotonic)
    # Per-request output stream: the engine puts RequestOutput items here;
    # the server consumes them until one arrives with ``finished``.
    outputs: "queue.Queue[RequestOutput]" = dataclasses.field(
        default_factory=queue.Queue)
    # Engine-assigned sampling seed (set once at admission when
    # params.seed is None).
    assigned_seed: int | None = None
    # Tenant identity (``x-arks-tenant``; arks_tpu_torch.tenancy): the fair
    # queue's lane.  None = the default tenant.
    tenant: str | None = None
    # End-to-end tracing: the W3C trace context for this request
    # (arks_tpu_torch.obs.trace.TraceCtx), carrying the gateway-minted trace
    # id and any upstream (gateway/router) spans.  None = untraced or an
    # engine-local request; the engine mints a local trace id on demand.
    trace: object | None = None
    # Multi-model serving: the pool model this request targets (None = the
    # engine's primary).  A request for another registered model parks
    # until the engine switches to it.
    model: str | None = None
    # Disaggregated serving: K/V prefilled by another engine; when set,
    # this engine inserts them instead of running the prefill.
    prefilled: PrefilledState | None = None
    # Fleet prefix cache: the peer ("host:port") the router believes
    # holds this prompt's warm prefix blocks (``x-arks-peer-hint``); with
    # ARKS_PEER_FETCH an admission miss fetches the blocks from it.
    peer_hint: str | None = None


@dataclasses.dataclass
class RequestOutput:
    request_id: str
    token_ids: list[int]          # newly generated token ids in this chunk
    finished: bool = False
    finish_reason: str | None = None   # "stop" | "length" | "abort" | "error"
    num_prompt_tokens: int = 0
    num_generated_tokens: int = 0      # cumulative, set when finished
    ttft_s: float | None = None        # set on the first chunk
    # Machine-readable rejection code when finish_reason == "error"
    # (e.g. "context_length_exceeded" -> HTTP 400 at the server).
    error: str | None = None
    # Per-token logprob entries for token_ids (when params.logprobs is
    # not None): (chosen_logprob, [(token_id, logprob), ...]).
    logprobs: list | None = None

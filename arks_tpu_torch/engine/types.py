"""Request/response dataclasses for the serving engine (copy of
``arks_tpu/engine/types.py``).  ``SamplingParams`` keeps every field of the
reference, and the port's engine serves each of them, so one request means
the same thing to both engines.  ``Request`` drops the fields of features
that are later slices (disaggregated prefill, model pool, tracing, peer
fetch)."""

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

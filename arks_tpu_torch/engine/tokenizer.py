"""Tokenizer adapters + incremental stream decoding (copy of
``arks_tpu/engine/tokenizer.py``).

Real deployments load the HuggingFace tokenizer shipped with the model;
tests and random-weight runs use ByteTokenizer, which needs no assets.
Tool declarations (``tools=``) render as the template's own tools section,
or as a system turn of ``server/tools.tools_system_text`` where the
template has none (always on ByteTokenizer).

Each tokenizer provides ``make_stream_decoder()`` returning an object with
``push(ids) -> str`` / ``flush() -> str`` that emits text incrementally in
amortized O(tokens) total (NOT re-decoding the full history per chunk):

- ByteTokenizer: exact, via codecs' incremental UTF-8 decoder.
- HFTokenizer: the convert_ids_to_tokens / convert_tokens_to_string
  prefix-window algorithm (the standard trick for BPE/SentencePiece, where
  decode(a+b) != decode(a)+decode(b) because of leading-space handling).
"""

from __future__ import annotations

import codecs
import logging
from typing import Protocol, Sequence


class StreamDecoder(Protocol):
    def push(self, ids: Sequence[int]) -> str: ...
    def flush(self) -> str: ...


class Tokenizer(Protocol):
    def encode(self, text: str) -> list[int]: ...
    def decode(self, ids: Sequence[int]) -> str: ...
    def apply_chat_template(self, messages: list[dict],
                            tools: list | None = None) -> list[int]: ...
    def make_stream_decoder(self) -> StreamDecoder: ...
    @property
    def eos_token_ids(self) -> tuple[int, ...]: ...


# ---------------------------------------------------------------------------
# Byte-level tokenizer (tests / no-asset rigs)
# ---------------------------------------------------------------------------


class ByteTokenizer:
    """Bytes + a few specials. Vocab: 0=eos/pad, 1=bos, 2..257 = bytes."""

    OFFSET = 2

    def __init__(self) -> None:
        self.vocab_size = 258

    @property
    def eos_token_ids(self) -> tuple[int, ...]:
        return (0,)

    def encode(self, text: str) -> list[int]:
        return [b + self.OFFSET for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        # Total over any id: random-weight test models emit ids beyond the
        # byte range; wrap them instead of raising.
        data = bytes((i - self.OFFSET) % 256 for i in ids if i >= self.OFFSET)
        return data.decode("utf-8", errors="replace")

    def apply_chat_template(self, messages: list[dict],
                            tools: list | None = None) -> list[int]:
        parts = []
        if tools:
            from arks_tpu_torch.server.tools import tools_system_text
            parts.append(f"<system>{tools_system_text(tools)}</system>")
        for m in messages:
            body = m.get("content") or ""
            for tc in m.get("tool_calls") or ():
                fn = tc.get("function", {})
                body += (f"<tool_call>{{\"name\": \"{fn.get('name')}\", "
                         f"\"arguments\": {fn.get('arguments')}}}"
                         "</tool_call>")
            parts.append(f"<{m['role']}>{body}</{m['role']}>")
        return [1] + self.encode("".join(parts))

    def make_stream_decoder(self) -> StreamDecoder:
        return _ByteStreamDecoder(self)


class _ByteStreamDecoder:
    """Exact incremental UTF-8 decode; O(1) state."""

    def __init__(self, tok: ByteTokenizer) -> None:
        self._tok = tok
        self._dec = codecs.getincrementaldecoder("utf-8")("replace")

    def push(self, ids: Sequence[int]) -> str:
        data = bytes((i - ByteTokenizer.OFFSET) % 256
                     for i in ids if i >= ByteTokenizer.OFFSET)
        return self._dec.decode(data, final=False)

    def flush(self) -> str:
        return self._dec.decode(b"", final=True)


# ---------------------------------------------------------------------------
# HuggingFace tokenizer
# ---------------------------------------------------------------------------


class HFTokenizer:
    """transformers.AutoTokenizer adapter (loaded from the model volume)."""

    def __init__(self, path: str) -> None:
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path)

    @property
    def eos_token_ids(self) -> tuple[int, ...]:
        ids = []
        if self._tok.eos_token_id is not None:
            ids.append(self._tok.eos_token_id)
        return tuple(ids)

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text, add_special_tokens=False)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)

    def apply_chat_template(self, messages: list[dict],
                            tools: list | None = None) -> list[int]:
        if tools:
            try:
                # Modern templates (Qwen2.5, Llama-3.1, Hermes) render
                # tools natively.
                return self._tok.apply_chat_template(
                    messages, tools=tools, add_generation_prompt=True)
            except Exception as e:
                # Template without tools support: declare them in a system
                # message using the hermes convention the parser expects.
                logging.getLogger("arks_tpu_torch.tokenizer").debug(
                    "chat template has no tools section (%s); declaring "
                    "them in a system turn", e)
                from arks_tpu_torch.server.tools import tools_system_text
                messages = ([{"role": "system",
                              "content": tools_system_text(tools)}]
                            + list(messages))
        return self._tok.apply_chat_template(messages, add_generation_prompt=True)

    def make_stream_decoder(self) -> StreamDecoder:
        return _HFStreamDecoder(self._tok)


class _HFStreamDecoder:
    """Prefix-window incremental detokenization.

    Keeps token strings (not ids) and two offsets: ``prefix`` marks text
    already emitted; ``read`` trails by a small window so multi-token
    characters/leading-space merges resolve before emission.  Per push, only
    the window (not the whole history) is re-stringified — amortized O(1)
    per token.
    """

    def __init__(self, tok) -> None:
        self._tok = tok
        # transformers recomputes all_special_tokens per access; cache it —
        # this runs once per streamed chunk on the hot path.
        self._special = set(tok.all_special_tokens)
        self._tokens: list[str] = []
        self._prefix = 0  # token index: everything before is emitted
        self._emitted_in_window = 0  # chars of window text already emitted

    def _window_text(self) -> str:
        return self._tok.convert_tokens_to_string(self._tokens[self._prefix:])

    def push(self, ids: Sequence[int]) -> str:
        if not ids:
            return ""
        new = self._tok.convert_ids_to_tokens(list(ids))
        self._tokens.extend(t for t in new if t not in self._special)
        text = self._window_text()
        safe_end = len(text) - 1 if text.endswith("�") else len(text)
        out = text[self._emitted_in_window:safe_end]
        self._emitted_in_window = max(self._emitted_in_window, safe_end)
        # Advance the window once it's large and cleanly decoded, so each
        # push re-stringifies a bounded number of tokens.
        if len(self._tokens) - self._prefix > 16 and not text.endswith("�"):
            self._prefix = len(self._tokens)
            self._emitted_in_window = 0
        return out

    def flush(self) -> str:
        text = self._window_text()
        out = text[self._emitted_in_window:]
        self._emitted_in_window = len(text)
        return out


def load_tokenizer(path: str | None, strict: bool = False) -> Tokenizer:
    """Best available tokenizer for a model dir (same policy as
    ``weights.load_params``: real assets > byte-level fallback).

    A directory with real weights but no tokenizer assets is usually a
    misconfiguration (wrong mount, partial download); pass ``strict=True``
    to fail instead of falling back.
    """
    if path is None:
        return ByteTokenizer()
    import os

    probed = ("tokenizer.json", "tokenizer_config.json", "tokenizer.model")
    if any(os.path.exists(os.path.join(path, f)) for f in probed):
        return HFTokenizer(path)
    msg = (f"no tokenizer assets in {path!r} "
           f"(looked for {', '.join(probed)})")
    if strict:
        raise FileNotFoundError(msg)
    logging.getLogger("arks_tpu_torch.tokenizer").warning(
        "%s — falling back to byte-level tokenizer", msg)
    return ByteTokenizer()


class IncrementalDetokenizer:
    """Convenience wrapper: one stream decoder bound to a tokenizer."""

    def __init__(self, tokenizer: Tokenizer) -> None:
        self._dec = tokenizer.make_stream_decoder()

    def push(self, ids: Sequence[int]) -> str:
        return self._dec.push(ids)

    def flush(self) -> str:
        return self._dec.flush()

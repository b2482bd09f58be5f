"""OpenAI tool calling for /v1/chat/completions (the port's own copy of
``arks_tpu/server/tools.py``; plain Python, no torch).

Tools render into the prompt through the chat template, and the model's
output is parsed back into structured calls.

Two wire formats cover the supported model families:
  - "hermes": ``<tool_call>{"name": ..., "arguments": {...}}</tool_call>``
    blocks (Qwen2.5, Hermes, and most chat templates with native tool
    support emit this).
  - "llama3": the whole message is one JSON object
    ``{"name": ..., "parameters": {...}}`` (Llama-3.1 json tool calling).
``parse_tool_calls`` auto-detects unless the server pins a parser
(``ARKS_TOOL_PARSER``: auto, hermes, llama3, mistral or qwen; default
auto).

Forced calls (``tool_choice: "required"`` or a named function) compile to
a guided-decoding regex over the hermes format — the DFA makes the model
EMIT a syntactically valid call; no retry loops.
"""

from __future__ import annotations

import json
import re
import uuid

from arks_tpu_torch import knobs

TOOL_OPEN = "<tool_call>"
TOOL_CLOSE = "</tool_call>"

# Function names are interpolated into the forced-call regex AND into the
# JSON the DFA makes the model emit: anything beyond this set (quotes,
# braces, backslashes, whitespace...) would corrupt the grammar into a DFA
# whose forced output parse_tool_calls cannot parse back.  OpenAI's own
# contract is the same alphabet.
_FN_NAME_RE = re.compile(r"[A-Za-z0-9_.-]+")


TOOL_PARSERS = ("auto", "hermes", "llama3", "mistral", "qwen")


def tool_parser() -> str:
    """``ARKS_TOOL_PARSER``, the parser dialect for generated tool calls
    (default "auto")."""
    return knobs.get_enum("ARKS_TOOL_PARSER", TOOL_PARSERS)


def validate_tools(body: dict) -> tuple[list | None, object]:
    """Returns (tools, tool_choice) validated, or raises ValueError.
    tool_choice: "auto" | "none" | "required" | {"type": "function",
    "function": {"name": ...}}."""
    tools = body.get("tools")
    if tools is None:
        return None, "none"
    if not isinstance(tools, list) or not tools:
        raise ValueError("tools must be a non-empty list")
    for t in tools:
        if not isinstance(t, dict) or t.get("type") != "function":
            raise ValueError('each tool must have type "function"')
        fn = t.get("function") or {}
        if not isinstance(fn.get("name"), str) or not fn["name"]:
            raise ValueError("each tool function needs a name")
        if not _FN_NAME_RE.fullmatch(fn["name"]):
            raise ValueError(
                f"tool function name {fn['name']!r} must match "
                "[A-Za-z0-9_.-]+ (other characters would corrupt the "
                "forced-call grammar)")
    choice = body.get("tool_choice", "auto")
    if isinstance(choice, str):
        if choice not in ("auto", "none", "required"):
            raise ValueError(f"unknown tool_choice {choice!r}")
    elif isinstance(choice, dict):
        name = (choice.get("function") or {}).get("name")
        if not name:
            raise ValueError("tool_choice object needs function.name")
        known = {t["function"]["name"] for t in tools}
        if name not in known:
            raise ValueError(f"tool_choice names unknown function {name!r}")
    else:
        raise ValueError("tool_choice must be a string or an object")
    return tools, choice


def _re_escape(s: str) -> str:
    """Escape for the engine's byte-regex dialect (ASCII metacharacters)."""
    return re.sub(r"([\\.^$|?*+()\[\]{}])", r"\\\1", s)


# A FLAT JSON object (string keys; string/number/bool/null values, no
# nesting or escapes) — the argument shape the forced-call DFA holds the
# model to.  Always parseable, so a forced call can never fail extraction;
# nested argument objects need tool_choice "auto" (model-formatted).
_JSTR = r'"[^"\\\x00-\x1f]*"'
_JVAL = f"({_JSTR}|-?[0-9]+(\\.[0-9]+)?|true|false|null)"
_FLAT_OBJ = (r"\{ ?(" + _JSTR + ": ?" + _JVAL
             + r"(, ?" + _JSTR + ": ?" + _JVAL + r")*)? ?\}")


def forced_call_guide(tools: list, choice) -> tuple[str, str] | None:
    """Guide spec forcing a hermes-format call, for tool_choice
    "required" (any listed function) or a named function.  The wrapper,
    the name, and a flat-JSON argument object are all DFA-enforced, so
    the emitted call is parseable by construction."""
    if choice == "required":
        names = [t["function"]["name"] for t in tools]
    elif isinstance(choice, dict):
        names = [choice["function"]["name"]]
    else:
        return None
    name_alt = "(" + "|".join(_re_escape(n) for n in names) + ")"
    pat = (_re_escape(TOOL_OPEN) + r"\n?" + r'\{"name": ?"' + name_alt
           + r'", ?"arguments": ?' + _FLAT_OBJ + r'\}' + r"\n?"
           + _re_escape(TOOL_CLOSE))
    return ("regex", pat)


def tools_system_text(tools: list) -> str:
    """Textual tool declaration for templates without native tools
    support (hermes convention, which the parser round-trips)."""
    decls = "\n".join(json.dumps(t["function"], ensure_ascii=False)
                      for t in tools)
    return (
        "You have access to the following functions. To call one, reply "
        "with a <tool_call>{\"name\": <function-name>, \"arguments\": "
        "<args-json-object>}</tool_call> block.\n<tools>\n" + decls
        + "\n</tools>")


def parse_tool_calls(text: str, parser: str = "auto"
                     ) -> tuple[str | None, list[dict]]:
    """(content, tool_calls) from generated text.  content is None when
    the message is nothing but calls (OpenAI convention); tool_calls is []
    when no call was found."""
    if parser in ("auto", "hermes") and TOOL_OPEN in text:
        calls = []
        content_parts = []
        pos = 0
        while True:
            i = text.find(TOOL_OPEN, pos)
            if i < 0:
                content_parts.append(text[pos:])
                break
            content_parts.append(text[:i] if pos == 0 else text[pos:i])
            j = text.find(TOOL_CLOSE, i)
            body = text[i + len(TOOL_OPEN): j if j >= 0 else len(text)]
            call = _parse_one(body)
            if call is not None:
                calls.append(call)
            else:
                content_parts.append(text[i: (j + len(TOOL_CLOSE))
                                          if j >= 0 else len(text)])
            if j < 0:
                break
            pos = j + len(TOOL_CLOSE)
        if calls:
            content = "".join(content_parts).strip()
            return (content or None), calls
    if parser in ("auto", "llama3"):
        stripped = text.strip()
        if stripped.startswith("{") and stripped.endswith("}"):
            call = _parse_one(stripped)
            if call is not None:
                return None, [call]
    return text, []


def call_spans(text: str, parser: str = "auto") -> list[tuple[int, int]]:
    """[start, end) RAW-text spans of recognized tool-call blocks — the
    regions parse_tool_calls removes from content.  Streaming uses these
    to emit leftover content in raw coordinates (parse_tool_calls returns
    STRIPPED content, whose offsets do not line up with what was already
    streamed)."""
    spans: list[tuple[int, int]] = []
    if parser in ("auto", "hermes") and TOOL_OPEN in text:
        pos = 0
        while True:
            i = text.find(TOOL_OPEN, pos)
            if i < 0:
                break
            j = text.find(TOOL_CLOSE, i)
            end = (j + len(TOOL_CLOSE)) if j >= 0 else len(text)
            body = text[i + len(TOOL_OPEN): j if j >= 0 else len(text)]
            if _parse_one(body) is not None:
                spans.append((i, end))
            if j < 0:
                break
            pos = end
        if spans:
            return spans
    if parser in ("auto", "llama3"):
        stripped = text.strip()
        if (stripped.startswith("{") and stripped.endswith("}")
                and _parse_one(stripped) is not None):
            return [(0, len(text))]
    return spans


def _parse_one(body: str) -> dict | None:
    try:
        obj = json.loads(body.strip())
    except json.JSONDecodeError:
        return None
    if not isinstance(obj, dict) or not isinstance(obj.get("name"), str):
        return None
    args = obj.get("arguments", obj.get("parameters", {}))
    if not isinstance(args, (dict, list, str, int, float, bool)):
        return None
    return {
        "id": f"call_{uuid.uuid4().hex[:24]}",
        "type": "function",
        "function": {
            "name": obj["name"],
            # OpenAI wire format: arguments is a JSON STRING.
            "arguments": (args if isinstance(args, str)
                          else json.dumps(args, ensure_ascii=False)),
        },
    }

"""Guided decoding: grammars compiled to token-transition tables on the
device (the port's own copy of ``arks_tpu/engine/guides.py``; host-side
numpy throughout, nothing here touches torch).

A guide is an outlines-style token-level DFA carried as per-slot device
state, so the decode loop never returns logits to the host to constrain
them:

  1. The pattern (a byte-level regex; JSON mode is a depth-bounded JSON
     grammar rendered as one) compiles to a character DFA on the host.
  2. Every vocab token's byte string is walked through the char DFA from
     every DFA state at once (vectorized numpy), yielding the token-level
     transition matrix T[state, token] -> next state | dead.
  3. T factors through token EQUIVALENCE CLASSES (tokens with identical
     behavior across all states — the columns of T deduplicated), so the
     device carries only ``class_of_token [V]`` plus a small
     ``trans [states, classes]`` table instead of a [states, V] matrix.
  4. ``sampler.shaped`` masks disallowed tokens to -1e30
     (``trans[row][class[v]] < 0``) and ``sampler.sample`` advances the
     per-slot row after each step; the engine runs both only for batches
     that hold a guided lane.

All guides live in two fixed-budget arrays (``class_ids [G, V]``,
``trans [R, C]``) allocated at engine init; the engine re-uploads their
CONTENTS when the compiler's version bumps.

The registry is a NON-BLOCKING compile pipeline with LRU eviction:

  - Compilation runs OUTSIDE the registry lock, on a small bounded
    worker pool (``ARKS_GUIDE_COMPILE_WORKERS``); the lock is held only
    to check the registry and to pack/publish the finished tables, so a
    cold JSON-mode compile at a 152k vocab never stalls the engine
    thread or other server threads.
  - Concurrent requests for the same (kind, pattern) dedupe onto ONE
    compile through a per-key in-flight ticket (``ensure``/``compile``).
  - When the guide or row budget fills, the least-recently-used guide
    with no active slot (``acquire``/``release`` refcounts, maintained
    by the engine per running/parked slot) is evicted: its id and row
    span return to free lists, ``version`` bumps so device copies
    refresh, and only when EVERY registered guide is pinned does a new
    pattern fail with GuideError (HTTP 400).  Guides never move once
    packed — live slots carry absolute device rows — so eviction frees
    spans instead of compacting over them.

Settings (environment, read when used): ``ARKS_GUIDE_MAX`` (8 guides),
``ARKS_GUIDE_ROWS`` (4096 rows), ``ARKS_GUIDE_CLASSES`` (2048 classes),
``ARKS_GUIDE_COMPILE_WORKERS`` (2) and ``ARKS_JSON_DEPTH`` (3).  Metrics
go to an optional sink (``metrics=``); without one they are not kept.
"""

from __future__ import annotations

import bisect
import json
import threading
import time

import numpy as np

from arks_tpu_torch import knobs


# Integer settings (ARKS_GUIDE_*, ARKS_JSON_DEPTH) through the port's reader.
knob = knobs.get_int


__all__ = ["GuideError", "GuideCompiler", "compile_regex_dfa",
           "json_mode_regex", "json_schema_regex"]


class GuideError(ValueError):
    """Invalid pattern or exceeded guide-table budget (HTTP 400 at the
    server — never an engine-thread fault)."""


# ---------------------------------------------------------------------------
# Byte-level regex -> character DFA
# ---------------------------------------------------------------------------
# The pattern language is the practical subset guided-decoding grammars
# use: literals, '.', classes with ranges/negation, escapes (\d \w \s \n
# \t \r \xHH and escaped metacharacters), groups, alternation, and the
# * + ? {m} {m,} {m,n} quantifiers.  Semantics are fullmatch, over BYTES:
# non-ASCII literals expand to their UTF-8 byte sequence, and negated
# classes admit continuation bytes (0x80+), so UTF-8 text flows through
# string-shaped grammars without unicode special-casing.

_ALL = (1 << 256) - 1
_DIGIT = sum(1 << b for b in range(0x30, 0x3A))
_WORD = (_DIGIT | sum(1 << b for b in range(0x41, 0x5B))
         | sum(1 << b for b in range(0x61, 0x7B)) | (1 << 0x5F))
_SPACE = sum(1 << b for b in b" \t\n\r\f\v")
_DOT = _ALL & ~(1 << 0x0A)


class _Parser:
    """Recursive-descent parser producing an AST of tuples:
    ('lit', mask) | ('cat', a, b) | ('alt', a, b) | ('star', a) |
    ('plus', a) | ('opt', a) | ('eps',)."""

    def __init__(self, pattern: str) -> None:
        self.p = pattern
        self.i = 0

    def parse(self):
        node = self._alt()
        if self.i != len(self.p):
            raise GuideError(f"unexpected {self.p[self.i]!r} at {self.i}")
        return node

    def _alt(self):
        node = self._concat()
        while self._peek() == "|":
            self.i += 1
            node = ("alt", node, self._concat())
        return node

    def _concat(self):
        node = ("eps",)
        while self._peek() not in ("", "|", ")"):
            node = ("cat", node, self._rep())
        return node

    def _rep(self):
        node = self._atom()
        c = self._peek()
        if c == "*":
            self.i += 1
            node = ("star", node)
        elif c == "+":
            self.i += 1
            node = ("plus", node)
        elif c == "?":
            self.i += 1
            node = ("opt", node)
        elif c == "{":
            node = self._bounded(node)
        return node

    def _bounded(self, node):
        j = self.p.find("}", self.i)
        if j < 0:
            raise GuideError("unterminated {} quantifier")
        spec = self.p[self.i + 1: j]
        self.i = j + 1
        try:
            if "," not in spec:
                lo, hi = int(spec), int(spec)
            else:
                lo_s, hi_s = spec.split(",", 1)
                lo = int(lo_s)
                hi = int(hi_s) if hi_s else None
        except ValueError:
            raise GuideError(f"bad quantifier {{{spec}}}") from None
        if hi is not None and hi < lo:
            raise GuideError(f"bad quantifier {{{spec}}}")
        out = ("eps",)
        for _ in range(lo):
            out = ("cat", out, node)
        if hi is None:
            out = ("cat", out, ("star", node))
        else:
            for _ in range(hi - lo):
                out = ("cat", out, ("opt", node))
        return out

    def _atom(self):
        c = self._peek()
        if c == "(":
            self.i += 1
            if self.p[self.i: self.i + 2] == "?:":
                self.i += 2
            node = self._alt()
            if self._peek() != ")":
                raise GuideError("unbalanced parenthesis")
            self.i += 1
            return node
        if c == "[":
            return ("lit", self._cls())
        if c == ".":
            self.i += 1
            return ("lit", _DOT)
        if c == "\\":
            return ("lit", self._escape())
        if c in ("*", "+", "?", "{", ""):
            raise GuideError(f"dangling quantifier or empty atom at {self.i}")
        self.i += 1
        mask_bytes = c.encode("utf-8")
        node = ("lit", 1 << mask_bytes[0])
        for b in mask_bytes[1:]:  # non-ASCII literal -> UTF-8 byte concat
            node = ("cat", node, ("lit", 1 << b))
        return node

    def _escape(self) -> int:
        self.i += 1  # past backslash
        if self.i >= len(self.p):
            raise GuideError("dangling escape")
        c = self.p[self.i]
        self.i += 1
        table = {"d": _DIGIT, "D": _ALL & ~_DIGIT, "w": _WORD,
                 "W": _ALL & ~_WORD, "s": _SPACE, "S": _ALL & ~_SPACE,
                 "n": 1 << 0x0A, "t": 1 << 0x09, "r": 1 << 0x0D,
                 "f": 1 << 0x0C, "v": 1 << 0x0B, "0": 1 << 0x00}
        if c in table:
            return table[c]
        if c == "x":
            h = self.p[self.i: self.i + 2]
            if len(h) < 2:
                raise GuideError("bad \\x escape")
            self.i += 2
            return 1 << int(h, 16)
        if ord(c) > 127:
            # Non-ASCII is multi-byte in UTF-8; a single-byte mask at
            # ord(c) would match the wrong raw byte.
            raise GuideError(
                f"escaped non-ASCII character {c!r}; use \\xHH bytes")
        return 1 << ord(c)  # escaped metacharacter / punctuation

    def _cls(self) -> int:
        self.i += 1  # past '['
        negate = self._peek() == "^"
        if negate:
            self.i += 1
        mask = 0
        first = True
        while True:
            c = self._peek()
            if c == "":
                raise GuideError("unterminated character class")
            if c == "]" and not first:
                self.i += 1
                break
            first = False
            if c == "\\":
                m = self._escape()
            else:
                self.i += 1
                bs = c.encode("utf-8")
                if len(bs) > 1:
                    raise GuideError(
                        "non-ASCII literals are not supported inside "
                        "character classes (use \\xHH byte ranges)")
                m = 1 << bs[0]
            # Range?  Only when both ends are single bytes.
            if (self._peek() == "-" and self.i + 1 < len(self.p)
                    and self.p[self.i + 1] != "]"):
                self.i += 1
                c2 = self._peek()
                if c2 == "\\":
                    m2 = self._escape()
                else:
                    self.i += 1
                    m2 = 1 << ord(c2)
                lo, hi = m.bit_length() - 1, m2.bit_length() - 1
                if (m.bit_count() != 1 or m2.bit_count() != 1 or hi < lo
                        or hi > 255):
                    raise GuideError("bad character-class range (bounds "
                                     "must be single bytes)")
                m = sum(1 << b for b in range(lo, hi + 1))
            mask |= m
        return (mask ^ _ALL) if negate else mask

    def _peek(self) -> str:
        return self.p[self.i] if self.i < len(self.p) else ""


def _nfa(ast):
    """Thompson construction.  Returns (n_states, eps adjacency list,
    char transitions [(src, mask, dst)], start, accept)."""
    eps: list[list[int]] = []
    chars: list[tuple[int, int, int]] = []

    def new() -> int:
        eps.append([])
        return len(eps) - 1

    def build(node) -> tuple[int, int]:
        kind = node[0]
        if kind == "eps":
            s = new()
            return s, s
        if kind == "lit":
            s, t = new(), new()
            chars.append((s, node[1], t))
            return s, t
        if kind == "cat":
            s1, t1 = build(node[1])
            s2, t2 = build(node[2])
            eps[t1].append(s2)
            return s1, t2
        if kind == "alt":
            s, t = new(), new()
            s1, t1 = build(node[1])
            s2, t2 = build(node[2])
            eps[s] += [s1, s2]
            eps[t1].append(t)
            eps[t2].append(t)
            return s, t
        if kind in ("star", "opt", "plus"):
            s, t = new(), new()
            s1, t1 = build(node[1])
            eps[s].append(s1)
            eps[t1].append(t)
            if kind in ("star", "opt"):
                eps[s].append(t)
            if kind in ("star", "plus"):
                eps[t1].append(s1)
            return s, t
        raise AssertionError(kind)

    start, accept = build(ast)
    return len(eps), eps, chars, start, accept


def compile_regex_dfa(pattern: str) -> tuple[np.ndarray, np.ndarray]:
    """Byte-level pattern -> minimized character DFA.

    Returns (table [S, 256] int32 with -1 = dead, accept [S] bool);
    state 0 is the start state.  Fullmatch semantics."""
    n, eps, chars, start, accept = _nfa(_Parser(pattern).parse())

    # Byte equivalence classes: bytes with identical membership across all
    # literal masks behave identically; subset-construct over classes.
    masks = sorted({m for _, m, _ in chars})
    sig = np.zeros((256, len(masks)), bool)
    for k, m in enumerate(masks):
        arr = np.frombuffer(
            m.to_bytes(32, "little"), np.uint8)
        sig[:, k] = (np.unpackbits(arr, bitorder="little") != 0)
    _, byte_cls = np.unique(sig, axis=0, return_inverse=True)
    ncls = int(byte_cls.max()) + 1
    cls_rep = np.zeros(ncls, np.int64)  # one representative byte per class
    for b in range(255, -1, -1):
        cls_rep[byte_cls[b]] = b

    # Per-NFA-state transitions grouped by byte class (target bitmask).
    delta: list[dict[int, int]] = [dict() for _ in range(n)]
    for s, m, t in chars:
        for c in range(ncls):
            if (m >> int(cls_rep[c])) & 1:
                delta[s][c] = delta[s].get(c, 0) | (1 << t)

    # Epsilon closures as bitmask ints, memoized bottom-up.
    closure = [0] * n
    done = [False] * n
    def close(s: int) -> int:
        if done[s]:
            return closure[s]
        seen = {s}
        stack = [s]
        acc = 1 << s
        while stack:
            u = stack.pop()
            for v in eps[u]:
                if v not in seen:
                    seen.add(v)
                    acc |= 1 << v
                    stack.append(v)
        closure[s] = acc
        done[s] = True
        return acc

    def close_set(mask: int) -> int:
        acc = 0
        while mask:
            low = mask & -mask
            acc |= close(low.bit_length() - 1)
            mask &= mask - 1
        return acc

    start_set = close(start)
    states: dict[int, int] = {start_set: 0}
    order = [start_set]
    rows: list[list[int]] = []
    i = 0
    while i < len(order):
        cur = order[i]
        i += 1
        row = [-1] * ncls
        for c in range(ncls):
            tgt = 0
            m = cur
            while m:
                low = m & -m
                s = low.bit_length() - 1
                tgt |= delta[s].get(c, 0)
                m &= m - 1
            if tgt:
                tgt = close_set(tgt)
                if tgt not in states:
                    states[tgt] = len(order)
                    order.append(tgt)
                row[c] = states[tgt]
        rows.append(row)
    S = len(order)
    cls_table = np.array(rows, np.int32).reshape(S, ncls)
    acc = np.array([(st >> accept) & 1 for st in order], bool)

    # Moore minimization over the class alphabet.
    part = acc.astype(np.int64)
    while True:
        mapped = np.where(cls_table >= 0, part[np.maximum(cls_table, 0)], -1)
        key = np.concatenate([part[:, None], mapped], axis=1)
        _, new_part = np.unique(key, axis=0, return_inverse=True)
        if (new_part == part).all():
            break
        part = new_part
    # Renumber with the start state's block first.
    remap = -np.ones(int(part.max()) + 1, np.int64)
    nxt = 0
    for s in range(S):
        if remap[part[s]] < 0:
            remap[part[s]] = nxt
            nxt += 1
    part = remap[part]
    Sm = nxt
    min_cls = -np.ones((Sm, ncls), np.int32)
    min_acc = np.zeros(Sm, bool)
    for s in range(S):
        ps = part[s]
        min_acc[ps] |= acc[s]
        row = cls_table[s]
        min_cls[ps] = np.where(row >= 0, part[np.maximum(row, 0)], -1)

    table = min_cls[:, byte_cls]  # [Sm, 256]
    return np.ascontiguousarray(table), min_acc


# ---------------------------------------------------------------------------
# JSON mode (depth-bounded JSON grammar as a regex)
# ---------------------------------------------------------------------------

# BOUNDED whitespace between JSON tokens: an unbounded star would let a
# sampling model wander in whitespace forever (whitespace is legal, eos
# is not, and nothing forces progress) — the standard guided-decoding
# recipe (outlines) bounds it for exactly this reason.  Accepting parsers
# are unaffected; generation just cannot stall.
_WS = r"[ \t\n\r]{0,2}"
_STR = r'"([^"\\\x00-\x1f]|\\(["\\/bfnrt]|u[0-9a-fA-F]{4}))*"'
_NUM = r"\-?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][\+\-]?[0-9]+)?"


def json_mode_regex(depth: int | None = None) -> str:
    """A JSON OBJECT with nesting bounded at ``depth`` containers (the one
    non-regular feature of JSON; vLLM's grammar backend tracks it with a
    pushdown stack, here it is unrolled into the DFA).  Default depth via
    ARKS_JSON_DEPTH (3): state count grows ~2x per level."""
    if depth is None:
        depth = knob("ARKS_JSON_DEPTH")

    def value(d: int) -> str:
        alts = [_STR, _NUM, "true", "false", "null"]
        if d > 0:
            alts += [obj(d), arr(d)]
        return "(" + "|".join(alts) + ")"

    def obj(d: int) -> str:
        v = value(d - 1)
        member = f"{_STR}{_WS}:{_WS}{v}"
        return (r"\{" + _WS + f"({member}({_WS},{_WS}{member})*)?"
                + _WS + r"\}")

    def arr(d: int) -> str:
        v = value(d - 1)
        return r"\[" + _WS + f"({v}({_WS},{_WS}{v})*)?" + _WS + r"\]"

    if depth < 1:
        raise GuideError("json depth must be >= 1")
    return _WS + obj(depth) + _WS


# ---------------------------------------------------------------------------
# JSON-schema -> regex (the outlines-style subset)
# ---------------------------------------------------------------------------

def _rx_quote(s: str) -> str:
    """Escape a literal for the byte-regex dialect (non-ASCII expands to
    UTF-8 bytes in the parser's literal path, so only ASCII
    metacharacters need escaping)."""
    out = []
    for ch in s:
        if ch in r"\.^$|?*+()[]{}-":
            out.append("\\" + ch)
        else:
            out.append(ch)
    return "".join(out)


def _json_literal(value) -> str:
    return _rx_quote(json.dumps(value, ensure_ascii=False))


def json_schema_regex(schema: dict, depth: int | None = None) -> str:
    """A regex matching JSON documents that satisfy ``schema`` — the
    practical subset structured-output schemas use (object properties in
    declaration order, string/integer/number/boolean/null, enum/const,
    arrays with item schemas and min/maxItems, anyOf/oneOf, local $refs).
    Unsupported constructs raise GuideError rather than silently
    loosening; numeric minimum/maximum are ignored (not regular).
    ``depth`` bounds untyped-value nesting and $ref recursion."""
    if depth is None:
        depth = knob("ARKS_JSON_DEPTH")
    defs = {}
    for key in ("$defs", "definitions"):
        defs.update(schema.get(key) or {})

    def resolve(s, d):
        ref = s.get("$ref")
        if ref is None:
            return s
        name = ref.rsplit("/", 1)[-1]
        if name not in defs:
            raise GuideError(f"unresolvable $ref {ref!r}")
        if d <= 0:
            raise GuideError(
                f"$ref {ref!r} recursion exceeds depth {depth} "
                "(raise ARKS_JSON_DEPTH for deeper nesting)")
        return defs[name]

    def value(s, d) -> str:
        if not isinstance(s, dict):
            raise GuideError("schema nodes must be objects")
        if "$ref" in s:
            return value(resolve(s, d), d - 1)
        if "const" in s:
            return _json_literal(s["const"])
        if "enum" in s:
            if not s["enum"]:
                raise GuideError("empty enum")
            return "(" + "|".join(_json_literal(v) for v in s["enum"]) + ")"
        for comb in ("anyOf", "oneOf"):
            if comb in s:
                return ("(" + "|".join(value(sub, d) for sub in s[comb])
                        + ")")
        typ = s.get("type")
        if isinstance(typ, list):
            return "(" + "|".join(value({**s, "type": t}, d) for t in typ) + ")"
        if typ == "string":
            lo = s.get("minLength")
            hi = s.get("maxLength")
            if lo is not None or hi is not None:
                # Bounded strings count CHARS, approximated as bytes with
                # escapes excluded (bounded + escapes is not regular in
                # byte space).  minLength alone keeps the tail UNBOUNDED
                # ({lo,}) — inventing a max would both reject valid
                # documents and unroll ~max DFA states per property.
                bound = "{%d,%s}" % (int(lo or 0),
                                     "" if hi is None else int(hi))
                return '"[^"\\\\\\x00-\\x1f]%s"' % bound
            return _STR
        if typ == "integer":
            return r"\-?(0|[1-9][0-9]*)"
        if typ == "number":
            return _NUM
        if typ == "boolean":
            return "(true|false)"
        if typ == "null":
            return "null"
        if typ == "array":
            item = s.get("items")
            inner = value(item, d - 1) if item else _any_value(d - 1)
            lo = int(s.get("minItems", 0))
            hi = s.get("maxItems")
            if hi is not None and int(hi) == 0:
                return r"\[" + _WS + r"\]"
            rep = (f"({_WS},{_WS}{inner})" + "{%d,%s}"
                   % (max(lo - 1, 0), "" if hi is None else int(hi) - 1))
            seq = f"{inner}{rep}"
            if lo == 0:
                seq = f"({seq})?"
            return r"\[" + _WS + seq + _WS + r"\]"
        if typ == "object" or "properties" in s:
            return obj(s, d)
        if typ is None:
            return _any_value(d)
        raise GuideError(f"unsupported schema type {typ!r}")

    def _any_value(d: int) -> str:
        alts = [_STR, _NUM, "true", "false", "null"]
        if d > 0:
            alts += [obj({"additionalProperties": True}, d),
                     r"\[" + _WS
                     + f"({_any_value(d - 1)}({_WS},{_WS}{_any_value(d - 1)})*)?"
                     + _WS + r"\]"]
        return "(" + "|".join(alts) + ")"

    def obj(s, d) -> str:
        props = s.get("properties") or {}
        if not props:
            # Free-form object (JSON-mode member grammar).
            member = f"{_STR}{_WS}:{_WS}{_any_value(d - 1)}"
            return (r"\{" + _WS + f"({member}({_WS},{_WS}{member})*)?"
                    + _WS + r"\}")
        required = set(s.get("required", list(props)))
        missing = required - set(props)
        if missing:
            raise GuideError(
                f"required properties {sorted(missing)} are not declared "
                "in properties (the guide would silently drop them)")
        parts = []
        seen_required = False
        for name, sub in props.items():
            member = (_json_literal(name) + f"{_WS}:{_WS}"
                      + value(sub, d - 1))
            if name in required:
                prefix = f"{_WS},{_WS}" if seen_required or parts else ""
                parts.append(prefix + member)
                seen_required = True
            else:
                if not seen_required and not parts:
                    raise GuideError(
                        "optional properties before the first required "
                        "one are not supported (declare a required "
                        "property first, or mark all required)")
                parts.append(f"({_WS},{_WS}{member})?")
        return r"\{" + _WS + "".join(parts) + _WS + r"\}"

    return _WS + value(schema, depth) + _WS


# ---------------------------------------------------------------------------
# Token byte table
# ---------------------------------------------------------------------------

# The standard GPT-2 byte<->unicode mapping used by every byte-level BPE
# vocab (GPT-2, Llama-3, Qwen2 tiktoken-style tokenizers).
def _bytes_to_unicode() -> dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def token_byte_table(tokenizer, vocab_size: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    """(bytes [V, L] uint8, lens [V] int32) for every vocab id.  Ids with
    no byte representation (specials, padding rows past the tokenizer
    vocab) get length 0 and are disallowed under every guide."""
    from arks_tpu_torch.engine.tokenizer import ByteTokenizer

    per: list[bytes] = [b""] * vocab_size
    if isinstance(tokenizer, ByteTokenizer):
        off = ByteTokenizer.OFFSET
        for i in range(off, min(vocab_size, off + 256)):
            per[i] = bytes([i - off])
    else:
        hf = getattr(tokenizer, "_tok", tokenizer)
        uni2byte = {u: b for b, u in _bytes_to_unicode().items()}
        special = set(getattr(hf, "all_special_ids", []) or [])
        n = min(vocab_size, int(getattr(hf, "vocab_size", vocab_size))
                + len(getattr(hf, "added_tokens_decoder", {}) or {}))
        toks = hf.convert_ids_to_tokens(list(range(n)))
        for i, t in enumerate(toks):
            if t is None or i in special:
                continue
            if t.startswith("<0x") and t.endswith(">") and len(t) == 6:
                try:
                    per[i] = bytes([int(t[3:5], 16)])  # sentencepiece byte
                    continue
                except ValueError:
                    pass
            if all(ch in uni2byte for ch in t):
                per[i] = bytes(uni2byte[ch] for ch in t)  # byte-level BPE
            else:
                per[i] = t.replace("▁", " ").encode("utf-8")  # spm

    lens = np.array([len(b) for b in per], np.int32)
    L = max(1, int(lens.max()))
    arr = np.zeros((vocab_size, L), np.uint8)
    for i, b in enumerate(per):
        arr[i, : len(b)] = np.frombuffer(b, np.uint8)
    return arr, lens


# ---------------------------------------------------------------------------
# Char DFA -> token-level classes + transition table
# ---------------------------------------------------------------------------

def token_transition_tables(char_table: np.ndarray, accept: np.ndarray,
                            tok_bytes: np.ndarray, tok_lens: np.ndarray,
                            eos_ids: tuple[int, ...]
                            ) -> tuple[np.ndarray, np.ndarray]:
    """(class_id [V] int32, trans [S+1, C] int32) — token-level DFA in
    factored form.  Row S (the last) is the TERMINAL state entered by
    sampling EOS in an accepting state; it allows everything (the host
    finishes the request at the next boundary, and an all-masked row
    would degenerate the sampling distribution for nothing).

    next-state encoding: -1 = token disallowed, else absolute row."""
    S = char_table.shape[0]
    V = tok_bytes.shape[0]
    dead = S + 1  # transient absorbing index during the walk
    ct = np.where(char_table < 0, dead, char_table).astype(np.int32)
    ct = np.vstack([ct, np.full((2, 256), dead, np.int32)])  # term+dead rows

    T = np.empty((S, V), np.int32)
    Lmax = tok_bytes.shape[1]
    chunk = max(1, int(2e8) // max(V, 1))  # ~800MB transient cap
    for s0 in range(0, S, chunk):
        s1 = min(S, s0 + chunk)
        st = np.repeat(np.arange(s0, s1, dtype=np.int32)[:, None], V, axis=1)
        for j in range(Lmax):
            live = (j < tok_lens)[None, :]
            st = np.where(live, ct[st, tok_bytes[:, j][None, :]], st)
        T[s0:s1] = np.where(st >= dead, -1, st)
    T[:, tok_lens == 0] = -1  # specials/padding never advance a guide

    # EOS: allowed exactly in accepting states, entering the terminal row.
    for e in eos_ids:
        if 0 <= e < V:
            T[:, e] = np.where(accept, S, -1)
    term_row = np.full((1, V), S, np.int32)  # terminal: all tokens self-loop
    T = np.vstack([T, term_row])

    # Factor through token classes: dedupe the columns of T.
    _, class_id, inv = np.unique(T.T, axis=0, return_index=True,
                                 return_inverse=True)
    trans = T[:, class_id]  # [S+1, C]
    return inv.astype(np.int32), np.ascontiguousarray(trans.astype(np.int32))


# ---------------------------------------------------------------------------
# Registry: guides packed into fixed-budget arrays
# ---------------------------------------------------------------------------

class Guide:
    __slots__ = ("guide_id", "start_row", "n_states", "n_classes",
                 "key", "refcount", "lru")

    def __init__(self, guide_id: int, start_row: int, n_states: int,
                 n_classes: int, key: tuple[str, str] | None = None) -> None:
        self.guide_id = guide_id
        self.start_row = start_row
        self.n_states = n_states
        self.n_classes = n_classes
        self.key = key
        self.refcount = 0   # active/parked slots using this guide (engine)
        self.lru = 0        # last-touched tick (compiler lock held)


class CompileTicket:
    """Per-key in-flight compile record: concurrent requests for the same
    (kind, pattern) all wait on ONE of these instead of compiling N times.
    ``event`` is set when the compile finished; exactly one of the guide
    being in the registry or ``error`` being set holds afterwards."""

    __slots__ = ("event", "error")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.error: str | None = None


class GuideCompiler:
    """Compiles and packs guides; owns the HOST tables.  The engine
    re-uploads device copies when ``version`` bumps (engine thread, between
    dispatches).

    Budgets are fixed at init so device shapes never change:
      class_ids [max_guides, V] int32  (class of token v under guide g)
      trans     [max_rows,  max_classes] int32 (ABSOLUTE next row | -1)

    Concurrency contract:
      - ``ensure`` (non-blocking) and ``compile`` (blocking) dedupe onto a
        per-key CompileTicket; the expensive DFA/token-table build runs
        with NO lock held (``ensure`` on a pool worker, ``compile`` on the
        caller's thread), and the lock is re-taken only to publish.
      - ``acquire``/``release`` refcount guides per live slot; eviction
        (triggered by a publish that needs an id or rows) only ever
        removes refcount-0 guides, so a published guide's absolute rows
        stay valid for as long as any slot decodes under it.
      - Row→guide resolution (``next_row``/``allowed``) reads an immutable
        interval-index snapshot — no lock, no O(guides) scan."""

    def __init__(self, tokenizer, vocab_size: int,
                 eos_ids: tuple[int, ...] = (),
                 max_guides: int | None = None,
                 max_rows: int | None = None,
                 max_classes: int | None = None,
                 metrics=None) -> None:
        self.vocab_size = vocab_size
        self.max_guides = max_guides or knob("ARKS_GUIDE_MAX")
        self.max_rows = max_rows or knob("ARKS_GUIDE_ROWS")
        self.max_classes = max_classes or knob("ARKS_GUIDE_CLASSES")
        self._tokenizer = tokenizer
        self._eos_ids = tuple(eos_ids)
        self._tok_table: tuple[np.ndarray, np.ndarray] | None = None
        self._tok_lock = threading.Lock()
        self.class_ids = np.zeros((self.max_guides, vocab_size), np.int32)
        self.trans = np.full((self.max_rows, self.max_classes), -1, np.int32)
        self._registry: dict[tuple[str, str], Guide] = {}
        self._inflight: dict[tuple[str, str], CompileTicket] = {}
        self._free_ids: list[int] = list(range(self.max_guides))
        self._free_spans: list[tuple[int, int]] = [(0, self.max_rows)]
        # Immutable (starts, (start, end, gid)) snapshot for lock-free
        # row→guide bisect on the hot path; rebuilt under the lock on
        # every registry change and swapped atomically.
        self._row_index: tuple[tuple, tuple] = ((), ())
        self._lru_tick = 0
        self._executor = None
        self._metrics = metrics  # namespace of prom metric objects | None
        self.version = 0
        self._lock = threading.Lock()  # registry/publish only, never compile

    # -- public ----------------------------------------------------------

    def validate(self, kind: str, pattern: str = "") -> None:
        """Cheap syntactic check (render + parse, no DFA/token tables):
        raises GuideError for malformed patterns/schemas so callers can
        400 on THEIR thread before the expensive build is ever scheduled."""
        _Parser(self._render(kind, pattern)).parse()

    def ensure(self, kind: str, pattern: str = "") -> "Guide | CompileTicket":
        """Non-blocking: the published Guide on a registry hit (LRU
        touched), else the in-flight CompileTicket — scheduling the build
        on the worker pool if nobody owns it yet.  Never blocks, never
        raises; compile failures surface through ``ticket.error``."""
        key = (kind, pattern)
        g, ticket, owner = self._claim(key)
        if g is not None:
            return g
        if owner:
            self._m_inc("misses")
            self._pool().submit(self._compile_job, key, ticket)
        return ticket

    def compile(self, kind: str, pattern: str = "") -> Guide:
        """Blocking compile: registry hit, or wait on (join) the in-flight
        compile, or run the build on the CALLER's thread.  Idempotent per
        (kind, pattern); raises GuideError on bad patterns or budgets
        exhausted with every guide pinned."""
        key = (kind, pattern)
        first = True
        while True:
            g, ticket, owner = self._claim(key, count_hit=first)
            first = False
            if g is not None:
                return g
            if owner:
                self._m_inc("misses")
                self._compile_job(key, ticket)
            else:
                ticket.event.wait()
            if ticket.error is not None:
                raise GuideError(ticket.error)
            # Published: loop re-claims from the registry.  (A guide
            # evicted in the microseconds before our re-claim just
            # triggers one more compile round.)

    def acquire(self, kind: str, pattern: str = "") -> Guide:
        """Pin a published guide (refcount +1, LRU touch).  The engine
        holds one pin per admitted request from admission through finish;
        pinned guides are never evicted, so their absolute device rows
        stay stable for the slot's lifetime.  Raises GuideError when the
        guide is not (or no longer) registered."""
        with self._lock:
            g = self._registry.get((kind, pattern))
            if g is None:
                raise GuideError(
                    f"guide {kind}:{pattern!r} is not registered")
            g.refcount += 1
            self._touch_locked(g)
            return g

    def release(self, kind: str, pattern: str = "") -> None:
        with self._lock:
            g = self._registry.get((kind, pattern))
            if g is not None and g.refcount > 0:
                g.refcount -= 1

    def lookup(self, kind: str, pattern: str = "") -> Guide | None:
        return self._registry.get((kind, pattern))

    def snapshot(self) -> tuple[np.ndarray, np.ndarray, int]:
        """Consistent (class_ids copy, trans copy, version) for the device
        upload."""
        with self._lock:
            return self.class_ids.copy(), self.trans.copy(), self.version

    def next_row(self, row: int, token: int) -> int:
        """Host-side single-token advance (absolute row coords) for the
        first-token paths, where the engine knows the sampled id before
        writing the slot's sampling state."""
        gid = self._guide_of_row(row)
        nxt = int(self.trans[row, int(self.class_ids[gid, token])])
        return row if nxt < 0 else nxt

    def allowed(self, row: int) -> np.ndarray:
        """Host-side [V] bool mask (tests / debugging)."""
        gid = self._guide_of_row(row)
        return self.trans[row, self.class_ids[gid]] >= 0

    # -- compile pipeline -------------------------------------------------

    def _claim(self, key, count_hit: bool = True):
        """(guide, ticket, owner): registry hit -> (g, None, False); an
        existing in-flight compile -> (None, ticket, False); otherwise this
        caller owns a fresh ticket -> (None, ticket, True)."""
        with self._lock:
            g = self._registry.get(key)
            if g is not None:
                self._touch_locked(g)
                if count_hit:
                    self._m_inc("hits")
                return g, None, False
            ticket = self._inflight.get(key)
            if ticket is not None:
                return None, ticket, False
            ticket = CompileTicket()
            self._inflight[key] = ticket
            return None, ticket, True

    def _compile_job(self, key, ticket: CompileTicket) -> None:
        """Owner-side build + publish.  Runs UNLOCKED except for the final
        publish; never raises (errors land on the ticket for every waiter
        — blocking compile() callers and engine-parked requests alike)."""
        t0 = time.monotonic()
        try:
            rx = self._render(*key)
            cls, trans = self._build(rx)
            with self._lock:
                self._publish_locked(key, cls, trans)
            if self._metrics is not None:
                self._metrics.compile_seconds.observe(time.monotonic() - t0)
        except GuideError as e:
            ticket.error = str(e)
        except Exception as e:  # worker pool must never die silently
            ticket.error = f"{type(e).__name__}: {e}"
        finally:
            with self._lock:
                self._inflight.pop(key, None)
            ticket.event.set()

    def _render(self, kind: str, pattern: str) -> str:
        if kind == "json":
            return json_mode_regex(int(pattern) if pattern else None)
        if kind == "regex":
            return pattern
        if kind == "json_schema":
            try:
                return json_schema_regex(json.loads(pattern))
            except json.JSONDecodeError as e:
                raise GuideError(f"invalid json_schema: {e}") from None
        if kind == "choice":
            # vLLM-style guided_choice: the pattern is a JSON array of
            # literal strings, compiled as an escaped alternation over the
            # same DFA machinery — the decoder can only emit one of the
            # choices verbatim.
            try:
                choices = json.loads(pattern)
            except json.JSONDecodeError as e:
                raise GuideError(f"invalid choice list: {e}") from None
            if (not isinstance(choices, list) or not choices
                    or not all(isinstance(c, str) for c in choices)):
                raise GuideError(
                    "guided_choice requires a non-empty array of strings")
            return "|".join(_rx_quote(c) for c in choices)
        raise GuideError(f"unknown guide kind {kind!r}")

    def _build(self, rx: str) -> tuple[np.ndarray, np.ndarray]:
        """The expensive part (char DFA + vocab walk), lock-free.  An
        instance method so tests can wrap it (compile counting, artificial
        slowdowns) without touching module functions."""
        char_table, accept = compile_regex_dfa(rx)
        with self._tok_lock:
            if self._tok_table is None:
                self._tok_table = token_byte_table(self._tokenizer,
                                                   self.vocab_size)
            tok_table = self._tok_table
        return token_transition_tables(char_table, accept, *tok_table,
                                       self._eos_ids)

    def _pool(self):
        with self._lock:
            if self._executor is None:
                from concurrent.futures import ThreadPoolExecutor
                n = max(1, knob("ARKS_GUIDE_COMPILE_WORKERS"))
                self._executor = ThreadPoolExecutor(
                    max_workers=n, thread_name_prefix="guide-compile")
            return self._executor

    # -- packing / eviction (lock held) -----------------------------------

    def _publish_locked(self, key, cls: np.ndarray,
                        trans: np.ndarray) -> Guide:
        n_states, n_classes = trans.shape
        if n_classes > self.max_classes:
            raise GuideError(
                f"guide has {n_classes} token classes > budget "
                f"{self.max_classes}; raise ARKS_GUIDE_CLASSES")
        if n_states > self.max_rows:
            raise GuideError(
                f"guide row budget exhausted ({n_states} states needed, "
                f"{self.max_rows} total rows; raise ARKS_GUIDE_ROWS)")
        while not self._free_ids:
            if not self._evict_one_locked():
                raise GuideError(
                    f"guide budget exhausted ({self.max_guides} guides, "
                    "all with active slots; raise ARKS_GUIDE_MAX)")
        base = self._take_span_locked(n_states)
        while base is None:
            if not self._evict_one_locked():
                raise GuideError(
                    f"guide row budget exhausted ({n_states} states "
                    f"needed, {sum(ln for _, ln in self._free_spans)} rows "
                    "free and every registered guide pinned; raise "
                    "ARKS_GUIDE_ROWS)")
            base = self._take_span_locked(n_states)
        gid = self._free_ids.pop(0)
        g = Guide(gid, base, n_states, n_classes, key=key)
        self.class_ids[gid] = cls
        # Clear the FULL row width first: a previous tenant of this span
        # may have had more classes than the new guide fills.
        self.trans[base: base + n_states] = -1
        self.trans[base: base + n_states, :n_classes] = np.where(
            trans >= 0, trans + base, -1)
        self._registry[key] = g
        self._touch_locked(g)
        self.version += 1
        self._rebuild_row_index_locked()
        self._update_gauges_locked()
        return g

    def _evict_one_locked(self) -> bool:
        """Evict the LRU guide with no active slot; False when every
        registered guide is pinned (or the registry is empty)."""
        victims = [g for g in self._registry.values() if g.refcount <= 0]
        if not victims:
            return False
        v = min(victims, key=lambda g: g.lru)
        del self._registry[v.key]
        bisect.insort(self._free_ids, v.guide_id)
        self._free_span_locked(v.start_row, v.n_states)
        self.trans[v.start_row: v.start_row + v.n_states] = -1
        self.version += 1  # device copies must refresh before id/row reuse
        self._rebuild_row_index_locked()
        self._update_gauges_locked()
        self._m_inc("evictions")
        return True

    def _take_span_locked(self, n: int) -> int | None:
        """First-fit allocation from the free row spans; None when no
        contiguous span covers ``n`` rows."""
        for i, (s, ln) in enumerate(self._free_spans):
            if ln >= n:
                if ln == n:
                    self._free_spans.pop(i)
                else:
                    self._free_spans[i] = (s + n, ln - n)
                return s
        return None

    def _free_span_locked(self, start: int, n: int) -> None:
        spans = self._free_spans
        spans.insert(bisect.bisect_left(spans, (start, 0)), (start, n))
        merged: list[tuple[int, int]] = []
        for s, ln in spans:
            if merged and merged[-1][0] + merged[-1][1] == s:
                merged[-1] = (merged[-1][0], merged[-1][1] + ln)
            else:
                merged.append((s, ln))
        self._free_spans = merged

    def _rebuild_row_index_locked(self) -> None:
        entries = sorted((g.start_row, g.start_row + g.n_states, g.guide_id)
                         for g in self._registry.values())
        self._row_index = (tuple(e[0] for e in entries), tuple(entries))

    def _touch_locked(self, g: Guide) -> None:
        self._lru_tick += 1
        g.lru = self._lru_tick

    def _update_gauges_locked(self) -> None:
        if self._metrics is None:
            return
        self._metrics.guides_in_use.set(len(self._registry))
        self._metrics.rows_in_use.set(
            self.max_rows - sum(ln for _, ln in self._free_spans))

    def _m_inc(self, name: str) -> None:
        if self._metrics is not None:
            getattr(self._metrics, name).inc(1)

    # -- internal --------------------------------------------------------

    def _guide_of_row(self, row: int) -> int:
        # Lock-free: bisect an immutable interval-index snapshot (replaced
        # atomically under the lock on registry changes) instead of the old
        # O(guides) scan under the lock — this sits on the engine thread's
        # first-token path.
        starts, entries = self._row_index
        i = bisect.bisect_right(starts, row) - 1
        if i >= 0:
            s, e, gid = entries[i]
            if s <= row < e:
                return gid
        raise GuideError(f"row {row} belongs to no registered guide")

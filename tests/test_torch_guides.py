"""The port's guided decoding (``arks_tpu_torch/engine/guides.py``, its own
copy) against the reference's (``arks_tpu/engine/guides.py``): the
character DFA arrays of ``compile_regex_dfa`` on the patterns the
reference's tests use, the regexes ``json_mode_regex`` and
``json_schema_regex`` render, the token byte table, the token-level
transition tables, the compiler's packed registry through publishes and
LRU eviction, and the same errors for bad patterns and exhausted budgets.
Then the settings the port reads (``ARKS_GUIDE_*``, ``ARKS_JSON_DEPTH``)
and the engine's cold-guide path: a request whose guide is still compiling
is parked without blocking a plain request (and parks again when re-queued
before the compile ends), and a failed compile ends it with an error."""

import json

import numpy as np
import pytest
import torch

from arks_tpu.engine import guides as jg
from arks_tpu.engine.tokenizer import ByteTokenizer as JBT
from arks_tpu_torch.engine import guides as tg
from arks_tpu_torch.engine.tokenizer import ByteTokenizer

torch.set_num_threads(2)

REGEXES = [r"[a-c]+x?", r"(foo|ba*r)\d{2,3}", r"[^x]\.", r".",
           r"(yes|no)[0-9]{2,4}", r"[\w\s]{0,5}end\n?", r"\x41[\t\r]*é",
           "[0-9]+(\\.[0-9]+)?(e-?[0-9]+)?"]
BAD = ["(", "a{2,1}", "[z-a]", "*a", "a{x}", "[a-Ā]", "\\é"]
SCHEMAS = [
    {"type": "object", "properties": {
        "name": {"type": "string", "maxLength": 10},
        "age": {"type": "integer"},
        "tags": {"type": "array", "items": {"type": "string"},
                 "minItems": 1, "maxItems": 2},
        "mood": {"enum": ["happy", "sad", 3]},
        "nick": {"type": "string"}},
     "required": ["name", "age", "tags", "mood"]},
    {"anyOf": [{"const": "yes"}, {"type": "object", "properties": {
        "next": {"$ref": "#/$defs/node"}}, "required": ["next"]}],
     "$defs": {"node": {"type": "null"}}},
    {"type": "string", "minLength": 2},
    {"type": "object", "properties": {'a"b': {"type": "null"}}},
    {"type": "array", "items": {"type": "number"}, "maxItems": 3},
    {"type": "boolean"},
]
BAD_SCHEMAS = [
    {"type": "object", "properties": {"opt": {"type": "integer"}},
     "required": []},
    {"type": "object", "properties": {"a": {"type": "integer"}},
     "required": ["a", "b"]},
]


def _same_arrays(a, b):
    for x, y in zip(a, b, strict=True):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("pattern", REGEXES)
def test_regex_dfa_identical(pattern):
    _same_arrays(tg.compile_regex_dfa(pattern),
                 jg.compile_regex_dfa(pattern))


@pytest.mark.parametrize("pattern", BAD)
def test_bad_patterns_raise_the_same(pattern):
    with pytest.raises(jg.GuideError) as want:
        jg.compile_regex_dfa(pattern)
    with pytest.raises(tg.GuideError) as got:
        tg.compile_regex_dfa(pattern)
    assert str(got.value) == str(want.value)
    assert issubclass(tg.GuideError, ValueError)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_json_mode_regex_and_dfa_identical(depth):
    rx = tg.json_mode_regex(depth)
    assert rx == jg.json_mode_regex(depth)
    if depth < 3:
        _same_arrays(tg.compile_regex_dfa(rx), jg.compile_regex_dfa(rx))


@pytest.mark.parametrize("i", range(len(SCHEMAS)))
def test_json_schema_regex_and_dfa_identical(i):
    rx = tg.json_schema_regex(SCHEMAS[i])
    assert rx == jg.json_schema_regex(SCHEMAS[i])
    _same_arrays(tg.compile_regex_dfa(rx), jg.compile_regex_dfa(rx))


@pytest.mark.parametrize("i", range(len(BAD_SCHEMAS)))
def test_bad_schemas_raise_the_same(i):
    with pytest.raises(jg.GuideError) as want:
        jg.json_schema_regex(BAD_SCHEMAS[i])
    with pytest.raises(tg.GuideError) as got:
        tg.json_schema_regex(BAD_SCHEMAS[i])
    assert str(got.value) == str(want.value)


def test_token_byte_table_identical():
    _same_arrays(tg.token_byte_table(ByteTokenizer(), 300),
                 jg.token_byte_table(JBT(), 300))


@pytest.mark.parametrize("pattern", [r"(yes|no)[0-9]{2,4}", r"[a-c]+x?",
                                     "json2", "schema0"])
def test_token_transition_tables_identical(pattern):
    if pattern == "json2":
        pattern = tg.json_mode_regex(2)
    elif pattern == "schema0":
        pattern = tg.json_schema_regex(SCHEMAS[0])
    bt = tg.token_byte_table(ByteTokenizer(), 300)
    got = tg.token_transition_tables(*tg.compile_regex_dfa(pattern), *bt,
                                     (0,))
    want = jg.token_transition_tables(*jg.compile_regex_dfa(pattern), *bt,
                                      (0,))
    _same_arrays(got, want)


def _compilers(**kw):
    return (tg.GuideCompiler(ByteTokenizer(), 258, eos_ids=(0,), **kw),
            jg.GuideCompiler(JBT(), 258, eos_ids=(0,), **kw))


def _same_registry(t, j):
    np.testing.assert_array_equal(t.class_ids, j.class_ids)
    np.testing.assert_array_equal(t.trans, j.trans)
    assert t.version == j.version
    assert {k: (g.guide_id, g.start_row, g.n_states, g.n_classes)
            for k, g in t._registry.items()} == \
        {k: (g.guide_id, g.start_row, g.n_states, g.n_classes)
         for k, g in j._registry.items()}


def test_compiler_registry_and_walk_identical():
    t, j = _compilers()
    for kind, pat in [("json", ""), ("regex", "[0-9]+"),
                      ("json_schema", json.dumps(SCHEMAS[0])),
                      ("choice", '["alpha", "beta"]'), ("json", "2")]:
        gt, gj = t.compile(kind, pat), j.compile(kind, pat)
        _same_registry(t, j)
        row_t, row_j = gt.start_row, gj.start_row
        for tid in ByteTokenizer().encode('{"a": [1, true]}alpha42'):
            np.testing.assert_array_equal(t.allowed(row_t),
                                          j.allowed(row_j))
            row_t, row_j = t.next_row(row_t, tid), j.next_row(row_j, tid)
            assert row_t == row_j
    assert t.compile("json", "") is t.lookup("json", "")
    snap = t.snapshot()
    assert snap[2] == t.version and snap[1] is not t.trans


def test_compiler_eviction_and_budgets_identical():
    """LRU eviction of unpinned guides, pins that hold, and the same
    GuideError when every guide is pinned or a guide needs more rows than
    the budget."""
    t, j = _compilers(max_guides=2, max_rows=64)
    for c in (t, j):
        c.compile("regex", "(yes|no)")
        c.acquire("regex", "(yes|no)")
        c.compile("regex", "[0-9]+")
        c.compile("regex", "[a-c]+x?")       # evicts [0-9]+ (LRU, unpinned)
    _same_registry(t, j)
    assert t.lookup("regex", "[0-9]+") is None
    for c in (t, j):
        c.acquire("regex", "[a-c]+x?")
    with pytest.raises(jg.GuideError) as want:
        j.compile("regex", "q+")
    with pytest.raises(tg.GuideError) as got:
        t.compile("regex", "q+")
    assert str(got.value) == str(want.value)
    for c in (t, j):
        c.release("regex", "(yes|no)")
        c.compile("regex", "q+")
    _same_registry(t, j)
    small_t, small_j = _compilers(max_rows=4)
    with pytest.raises(jg.GuideError) as want:
        small_j.compile("json")
    with pytest.raises(tg.GuideError) as got:
        small_t.compile("json")
    assert str(got.value) == str(want.value)


def test_ensure_dedupes_and_reports_errors():
    t, _ = _compilers()
    builds = []
    build = t._build

    def counted(rx):
        builds.append(rx)
        return build(rx)

    t._build = counted
    tickets = [t.ensure("regex", "(ab)+") for _ in range(3)]
    for tk in tickets:
        if isinstance(tk, tg.CompileTicket):
            assert tk.event.wait(30) and tk.error is None
    assert len(builds) == 1
    assert isinstance(t.ensure("regex", "(ab)+"), tg.Guide)
    bad = t.ensure("json_schema", "{not json")
    assert bad.event.wait(30) and "invalid json_schema" in bad.error


def test_settings_read_like_the_reference(monkeypatch):
    for name, default in [("ARKS_GUIDE_MAX", 8), ("ARKS_GUIDE_ROWS", 4096),
                          ("ARKS_GUIDE_CLASSES", 2048),
                          ("ARKS_GUIDE_COMPILE_WORKERS", 2),
                          ("ARKS_JSON_DEPTH", 3)]:
        monkeypatch.delenv(name, raising=False)
        assert tg.knob(name) == default
        monkeypatch.setenv(name, "")
        assert tg.knob(name) == default
        monkeypatch.setenv(name, "5")
        assert tg.knob(name) == 5
        monkeypatch.setenv(name, "x")
        with pytest.raises(ValueError):
            tg.knob(name)
        monkeypatch.delenv(name)
    monkeypatch.setenv("ARKS_GUIDE_MAX", "3")
    monkeypatch.setenv("ARKS_GUIDE_ROWS", "100")
    t = tg.GuideCompiler(ByteTokenizer(), 258)
    assert t.class_ids.shape == (3, 258) and t.trans.shape == (100, 2048)
    monkeypatch.setenv("ARKS_JSON_DEPTH", "2")
    assert tg.json_mode_regex() == jg.json_mode_regex(2)


# ---------------------------------------------------------------------------
# The engine's cold-guide path
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engine():
    from arks_tpu_torch.engine import EngineConfig, InferenceEngine
    from arks_tpu_torch.models import get_config

    return InferenceEngine(get_config("tiny"), EngineConfig(
        model="tiny", num_slots=2, max_cache_len=64, prefill_chunk=16,
        dtype="float32"), ByteTokenizer(), device="cpu")


def _collect(req):
    ids = []
    while True:
        out = req.outputs.get(timeout=60)
        ids += out.token_ids
        if out.finished:
            return ids, out


def test_cold_guide_parks_without_blocking_a_plain_request(engine):
    import threading

    from arks_tpu_torch.engine import Request, SamplingParams

    release = threading.Event()
    build = engine.guides._build

    def slow(rx):
        release.wait(60)
        return build(rx)

    engine.guides._build = slow
    try:
        guided = Request("g", [5, 6, 7], SamplingParams(
            max_tokens=6, temperature=0.0, guide=("regex", "z[0-9]+")))
        plain = Request("p", [8, 9], SamplingParams(max_tokens=4,
                                                    temperature=0.0))
        engine.add_request(guided)
        engine.add_request(plain)
        for _ in range(200):
            engine.step(block_s=0.005)
            if plain.outputs.qsize() and not engine._slots:
                break
        ids, fin = _collect(plain)
        assert fin.finish_reason == "length" and len(ids) == 4
        assert [r.request_id for r, _ in engine._awaiting_guide] == ["g"]
        assert not engine.idle
        # A compiler rebuild re-queues parked requests; re-admission parks
        # them again on the compile still in flight.
        engine._requeue_awaiting_guide()
        assert not engine._awaiting_guide and engine._queue.qsize() == 1
        engine.step(block_s=0.005)
        assert [r.request_id for r, _ in engine._awaiting_guide] == ["g"]
        release.set()
        for _ in range(400):
            engine.step(block_s=0.005)
            if engine.idle:
                break
        ids, fin = _collect(guided)
        text = ByteTokenizer().decode(ids)
        assert text.startswith("z") and text[1:].isdigit()
        assert not engine._guide_pins
    finally:
        engine.guides._build = build
        release.set()


def test_failed_compile_ends_the_request_with_an_error(engine):
    from arks_tpu_torch.engine import Request, SamplingParams

    build = engine.guides._build

    def failing(rx):
        raise tg.GuideError("budget exhausted (test)")

    engine.guides._build = failing
    try:
        req = Request("f", [5, 6], SamplingParams(
            max_tokens=4, temperature=0.0, guide=("regex", "w+")))
        engine.add_request(req)
        for _ in range(400):
            engine.step(block_s=0.005)
            if engine.idle:
                break
        ids, fin = _collect(req)
        assert ids == [] and fin.finish_reason == "error"
        assert fin.error == "guide_compile_failed: budget exhausted (test)"
    finally:
        engine.guides._build = build
    with pytest.raises(tg.GuideError):
        engine.add_request(Request("b", [5], SamplingParams(
            guide=("regex", "("))))

"""The port's request-level sampling against the reference's
(``arks_tpu/engine/sampler.py`` and the JAX engine).

- Every function of ``arks_tpu_torch/engine/sampler.py`` bit for bit on
  the same inputs: penalties, logit_bias with duplicate ids and padded
  columns, the min_tokens suppression with and without lengths, the guide
  mask and advance over real guide tables, counts, slot writes and clears,
  transient states, the host columns, liveness, the filtered window, and
  ``sample`` with every pass on (greedy and seeded lanes, inactive lanes).
  Logprob values within 1e-5, their ids exact.
- The host gates (``sampler.Gates``) give what the reference's device
  predicates give.
- Token streams of the port's engine identical to the JAX engine's on the
  same f32 ``tiny`` weights, greedy and seeded, on the mixed scheduler
  (paged f32 pool) and the legacy one (slot cache): penalties, bias,
  min_tokens with a stop id, logprobs, and each guide kind (JSON mode,
  regex, JSON schema, choice), among them a guide still compiling when its
  request is admitted (parked, then served).
- ``cuda``-marked: the shaping, count and guide functions on CUDA tensors
  bit for bit against the same calls on the CPU (they skip without a
  card; this file imports JAX only inside its CPU fixtures, so
  ``python -m pytest --noconftest -m cuda`` runs them where JAX is
  absent)."""

import threading

import numpy as np
import pytest
import torch

from arks_tpu_torch.engine import sampler as ts
from arks_tpu_torch.engine.guides import GuideCompiler
from arks_tpu_torch.engine.tokenizer import ByteTokenizer

torch.set_num_threads(2)

B, V = 5, 258          # ByteTokenizer's vocab: the guide tables fit it
PATTERNS = [("json", ""), ("regex", "(yes|no)[0-9]{2,4}"),
            ("choice", '["alpha", "beta"]')]


def _cols(seed):
    """Numpy columns of a B-lane state with every feature on some lane:
    penalties on lanes 0 and 2, duplicate and padded bias ids, a
    suppression that holds on lane 1 only, guides on lanes 0, 3 and 4,
    greedy lanes 0 and 3."""
    rng = np.random.default_rng(seed)
    c = dict(
        logits=(rng.standard_normal((B, V)) * 3).astype(np.float32),
        temperature=np.array([0.0, 0.8, 1.2, 0.0, 0.6], np.float32),
        top_p=np.array([1.0, 0.9, 0.95, 1.0, 0.8], np.float32),
        top_k=np.array([0, 20, 0, 5, 40], np.int32),
        key=np.stack([np.array([0, 11 + seed * 7 + i], np.uint32)
                      for i in range(B)]),
        presence=np.array([0.5, 0.0, 1.25, 0.0, 0.0], np.float32),
        frequency=np.array([0.3, 0.0, 0.0, 0.0, 0.0], np.float32),
        counts=rng.integers(0, 3, (B, V)).astype(np.int32),
        bias_ids=np.full((B, ts.LOGIT_BIAS_MAX), -1, np.int32),
        bias_vals=np.zeros((B, ts.LOGIT_BIAS_MAX), np.float32),
        suppress_ids=np.full((B, ts.SUPPRESS_MAX), -1, np.int32),
        min_until=np.array([0, 10, 0, 3, 0], np.int32),
        guide=np.array([0, -1, -1, 1, 2], np.int32),
        guide_row=np.zeros((B,), np.int32),
        lengths=np.array([5, 9, 4, 3, 7], np.int32))
    c["bias_ids"][0, :4] = [5, 5, 7, 5]
    c["bias_vals"][0, :4] = [1.1, 2.3, -100.0, 0.37]
    c["bias_ids"][2, :2] = [0, 9]
    c["bias_vals"][2, :2] = [0.7, 1e-3]
    c["bias_ids"][4, 299] = 40
    c["bias_vals"][4, 299] = 12.5
    c["suppress_ids"][1, :2] = [3, 4]
    c["suppress_ids"][3, :1] = [0]
    return c


_FIELDS = ("temperature", "top_p", "top_k", "key", "presence", "frequency",
           "counts", "bias_ids", "bias_vals", "suppress_ids", "min_until",
           "guide", "guide_row")


def _tstate(c, device="cpu"):
    return ts.SamplingState(*(
        torch.from_numpy(c[f].astype(np.int64) if f == "key"
                         else c[f].copy()).to(device) for f in _FIELDS))


def _tables(device="cpu"):
    """The port's guide tables with PATTERNS compiled (guide ids 0-2),
    and each guide's start row."""
    tok = ByteTokenizer()
    gc = GuideCompiler(tok, tok.vocab_size, eos_ids=(0,))
    starts = [gc.compile(*p).start_row for p in PATTERNS]
    return gc, (torch.from_numpy(gc.class_ids).to(device),
                torch.from_numpy(gc.trans).to(device)), starts


def _with_rows(c, gc, starts, steps=3):
    """Lanes' guide rows a few tokens into their guides (greedy under the
    guide's own allowed set), so the masks read mid-grammar rows."""
    c = dict(c)
    rows = c["guide_row"].copy()
    for lane, g in enumerate(c["guide"]):
        if g < 0:
            continue
        row = starts[g]
        for _ in range(steps):
            allowed = np.flatnonzero(gc.allowed(row))
            row = gc.next_row(row, int(allowed[-1]))
        rows[lane] = row
    c["guide_row"] = rows
    return c


def _same(got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype.itemsize == \
        want.dtype.itemsize
    np.testing.assert_array_equal(got.view(f"i{got.dtype.itemsize}"),
                                  want.view(f"i{want.dtype.itemsize}"))


# ---------------------------------------------------------------------------
# Functions, bit for bit against the reference (CPU)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref():
    """The reference's sampler, its guide compiler on the same patterns,
    and a builder of its state."""
    import jax.numpy as jnp

    from arks_tpu.engine import guides as jguides
    from arks_tpu.engine import sampler as js
    from arks_tpu.engine.tokenizer import ByteTokenizer as JBT

    tok = JBT()
    gc = jguides.GuideCompiler(tok, tok.vocab_size, eos_ids=(0,))
    for p in PATTERNS:
        gc.compile(*p)

    def state(c):
        return js.SamplingState(*(jnp.asarray(c[f]) for f in _FIELDS))

    return js, (jnp.asarray(gc.class_ids), jnp.asarray(gc.trans)), state, \
        jnp


@pytest.mark.parametrize("seed", [0, 1])
def test_penalized_and_shaped_bit_exact(ref, seed):
    js, jtab, jstate, jnp = ref
    gc, tab, starts = _tables()
    c = _with_rows(_cols(seed), gc, starts)
    lg = jnp.asarray(c["logits"])
    _same(ts.penalized(torch.from_numpy(c["logits"]), _tstate(c)),
          js.penalized(lg, jstate(c)))
    for lengths in (None, c["lengths"]):
        want = js.shaped(lg, jstate(c),
                         None if lengths is None else jnp.asarray(lengths),
                         guide_tables=jtab)
        got = ts.shaped(torch.from_numpy(c["logits"]), _tstate(c),
                        None if lengths is None
                        else torch.from_numpy(lengths), tab)
        _same(got, want)


def test_bias_duplicates_accumulate_in_order(ref):
    """Three entries on one id add up as the reference's scatter-add
    does, and a padded column adds 0.0 to id 0."""
    js, _, jstate, jnp = ref
    c = _cols(3)
    for f in ("presence", "frequency", "min_until"):
        c[f] = np.zeros_like(c[f])
    c["guide"] = np.full((B,), -1, np.int32)
    c["bias_ids"][1, :3] = [0, 0, 0]
    c["bias_vals"][1, :3] = [0.1, 0.2, 0.3]
    c["logits"][1, 0] = -0.0
    got = ts.shaped(torch.from_numpy(c["logits"]), _tstate(c))
    want = js.shaped(jnp.asarray(c["logits"]), jstate(c))
    _same(got, want)
    assert got[0, 5] == np.float32(c["logits"][0, 5]) + np.float32(1.1) \
        + np.float32(2.3) + np.float32(0.37)


def test_count_tokens_bit_exact(ref):
    js, _, jstate, jnp = ref
    c = _cols(4)
    tok = np.array([3, 3, 5, 0, 257], np.int32)
    for active in (None, np.array([True, False, True, True, False])):
        want = js.count_tokens(jstate(c), jnp.asarray(tok),
                               None if active is None
                               else jnp.asarray(active))
        got = ts.count_tokens(_tstate(c), torch.from_numpy(tok),
                              None if active is None
                              else torch.from_numpy(active))
        _same(got.counts, want.counts)


def test_guide_mask_and_advance_bit_exact(ref):
    js, jtab, jstate, jnp = ref
    gc, tab, starts = _tables()
    np.testing.assert_array_equal(tab[0].numpy(), np.asarray(jtab[0]))
    np.testing.assert_array_equal(tab[1].numpy(), np.asarray(jtab[1]))
    c = _with_rows(_cols(5), gc, starts, steps=2)
    _same(ts.guide_mask(torch.from_numpy(c["logits"]), _tstate(c), tab),
          js.guide_mask(jnp.asarray(c["logits"]), jstate(c), jtab))
    ids = np.array([40, 41, 42, 121, 98], np.int32)
    for active in (None, np.array([True, True, False, True, False])):
        want = js.guide_advance(jstate(c), jnp.asarray(ids), jtab,
                                None if active is None
                                else jnp.asarray(active))
        got = ts.guide_advance(_tstate(c), torch.from_numpy(ids), tab,
                               None if active is None
                               else torch.from_numpy(active))
        _same(got.guide_row, want.guide_row)


def test_slot_writes_and_clears_bit_exact(ref):
    js, _, jstate, jnp = ref
    c = _cols(6)
    rng = np.random.default_rng(6)
    slots = np.array([3, 1], np.int32)
    new = dict(temperature=np.array([0.7, 0.0], np.float32),
               top_p=np.array([0.9, 1.0], np.float32),
               top_k=np.array([7, 0], np.int32),
               keys=np.array([[0, 5], [0, 6]], np.uint32),
               presence=np.array([0.25, 0.0], np.float32),
               frequency=np.array([0.0, 1.5], np.float32),
               bias_ids=rng.integers(-1, V, (2, ts.LOGIT_BIAS_MAX)).astype(
                   np.int32),
               bias_vals=rng.standard_normal((2, ts.LOGIT_BIAS_MAX)).astype(
                   np.float32),
               suppress_ids=np.full((2, ts.SUPPRESS_MAX), 2, np.int32),
               min_until=np.array([9, 0], np.int32),
               guide=np.array([1, -1], np.int32),
               guide_row=np.array([17, 0], np.int32))
    want = js.set_slots(jstate(c), jnp.asarray(slots), *(
        jnp.asarray(v) for v in new.values()))
    got = ts.set_slots(_tstate(c), slots, *(
        v.astype(np.int64) if k == "keys" else v for k, v in new.items()))
    for f in _FIELDS:
        _same(getattr(got, f), np.asarray(getattr(want, f)).astype(
            np.int64) if f == "key" else getattr(want, f))
    # Defaults for the shaping columns left out, one slot at a time.
    want = js.set_slot(jstate(c), 2, 0.5, 0.9, 3, jnp.asarray([0, 9],
                                                                jnp.uint32))
    got = ts.set_slot(_tstate(c), 2, 0.5, 0.9, 3, torch.tensor([0, 9]))
    for f in _FIELDS:
        _same(getattr(got, f), np.asarray(getattr(want, f)).astype(
            np.int64) if f == "key" else getattr(want, f))
    want = js.clear_slot_penalties(jstate(c), jnp.asarray(0))
    got = ts.clear_slot_penalties(_tstate(c), 0)
    for f in _FIELDS:
        _same(getattr(got, f), np.asarray(getattr(want, f)).astype(
            np.int64) if f == "key" else getattr(want, f))


def test_set_slots_without_shaping_writes_only_the_sampling_columns():
    c = _cols(7)
    got = ts.set_slots(_tstate(c), [4], [0.3], [0.5], [2],
                       torch.tensor([[0, 1]]), shaping=False)
    assert got.temperature[4] == np.float32(0.3) and got.top_k[4] == 2
    assert got.key[4].tolist() == [0, 1]
    for f in _FIELDS[4:]:
        _same(getattr(got, f), c[f])


def test_transient_states_bit_exact(ref):
    js, _, _, jnp = ref
    c = _cols(8)
    args = (c["temperature"], c["top_p"], c["top_k"], c["key"])
    extra = (c["bias_ids"], c["bias_vals"], c["suppress_ids"],
             (c["min_until"] > 0).astype(np.int32), c["guide"],
             c["guide_row"])
    want = js.transient_state_batch(*(jnp.asarray(a) for a in args), V,
                                    *(jnp.asarray(a) for a in extra))
    got = ts.transient_state_batch(*(
        torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a)
        for a in args), V, *(torch.from_numpy(a) for a in extra))
    for f in _FIELDS:
        _same(getattr(got, f), np.asarray(getattr(want, f)).astype(
            np.int64) if f == "key" else getattr(want, f))
    want = js.transient_state(*(jnp.asarray(a[1]) for a in args), V)
    got = ts.transient_state(*(
        torch.from_numpy(np.asarray(a[1]).astype(np.int64)
                         if a.dtype == np.uint32 else np.asarray(a[1]))
        for a in args), V)
    for f in _FIELDS:
        _same(getattr(got, f), np.asarray(getattr(want, f)).astype(
            np.int64) if f == "key" else getattr(want, f))


def test_top_logprobs_within_1e5(ref):
    js, _, _, jnp = ref
    c = _cols(9)
    chosen = np.array([1, 250, 3, 0, 99], np.int32)
    want = js.top_logprobs(jnp.asarray(c["logits"]), jnp.asarray(chosen))
    got = ts.top_logprobs(torch.from_numpy(c["logits"]),
                          torch.from_numpy(chosen))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=0, atol=1e-5)
    _same(got[2], want[2])
    assert got[1].shape == (B, ts.TOP_LOGPROBS_MAX)
    assert (np.diff(got[1].numpy(), axis=1) <= 0).all()


def test_host_columns_match(ref):
    js = ref[0]

    class P:
        logit_bias = ((5, 1.0), (-1, 2.0), (300, 3.0), (7, -4.0))

    for a, b in zip(ts.np_bias_cols(P, V), js.np_bias_cols(P, V)):
        _same(a, b)
    _same(ts.np_suppress_col([0, 5, 5, 9]), js.np_suppress_col([0, 5, 5, 9]))
    with pytest.raises(ValueError):
        ts.np_suppress_col(range(ts.SUPPRESS_MAX + 1))
    _same(ts.np_stop_col([3, 3, 8]), js.np_stop_col([3, 3, 8]))
    assert ts.np_stop_col(range(ts.STOP_IDS_MAX + 1)) is None
    assert (ts.TOP_LOGPROBS_MAX, ts.LOGIT_BIAS_MAX, ts.SUPPRESS_MAX,
            ts.STOP_IDS_MAX) == (js.TOP_LOGPROBS_MAX, js.LOGIT_BIAS_MAX,
                                 js.SUPPRESS_MAX, js.STOP_IDS_MAX)


def test_advance_liveness_matches(ref):
    js, _, _, jnp = ref
    rng = np.random.default_rng(10)
    toks = rng.integers(0, 12, (4, B)).astype(np.int32)
    alive = np.array([True, True, False, True, True])
    lengths = np.array([10, 20, 30, 40, 50], np.int32)
    stops = np.full((B, ts.STOP_IDS_MAX), -1, np.int32)
    stops[0, :2] = [3, 11]
    stops[1, 0] = 99
    stops[3, :3] = [0, 1, 2]
    dead = np.array([11, 21, 40, 41, 50], np.int32)
    want = js.advance_liveness(*(jnp.asarray(a) for a in (
        toks, alive, lengths, stops, dead)))
    got = ts.advance_liveness(*(torch.from_numpy(a) for a in (
        toks, alive, lengths, stops, dead)))
    _same(got, want)


def test_filtered_probs_matches(ref):
    js, _, jstate, jnp = ref
    c = _cols(11)
    wp, wi, ws = js.filtered_probs(jnp.asarray(c["logits"]), jstate(c))
    gp, gi, gs = ts.filtered_probs(torch.from_numpy(c["logits"]), _tstate(c))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=0, atol=1e-6)
    keep = ~np.isinf(np.asarray(ws))
    np.testing.assert_array_equal(np.isinf(gs.numpy()), ~keep)
    np.testing.assert_allclose(gs.numpy()[keep], np.asarray(ws)[keep],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [12, 13, 14])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_sample_with_every_pass_bit_exact(ref, seed, with_lengths):
    """Greedy and seeded lanes, an inactive lane, every shaping pass and
    the guide advance: ids, carried keys and guide rows as the
    reference's."""
    js, jtab, jstate, jnp = ref
    gc, tab, starts = _tables()
    c = _with_rows(_cols(seed), gc, starts, steps=seed % 3)
    active = np.array([True, True, False, True, True])
    lengths = c["lengths"] if with_lengths else None
    want, wst = js.sample(jnp.asarray(c["logits"]), jstate(c),
                          jnp.asarray(active),
                          None if lengths is None else jnp.asarray(lengths),
                          guide_tables=jtab)
    got, gst = ts.sample(torch.from_numpy(c["logits"]), _tstate(c),
                         torch.from_numpy(active),
                         None if lengths is None
                         else torch.from_numpy(lengths), tab)
    _same(got, want)
    _same(gst.key, np.asarray(wst.key).astype(np.int64))
    _same(gst.guide_row, wst.guide_row)


def test_host_gates_give_the_device_predicates_result():
    """Gates read on the host (off where no lane asks) sample exactly what
    the device predicates do; the all-off gate is greedy argmax."""
    gc, tab, starts = _tables()
    c = _with_rows(_cols(15), gc, starts)
    for f, val in (("presence", 0.0), ("frequency", 0.0)):
        c[f] = np.full_like(c[f], val)
    c["bias_ids"][:] = -1
    lg = torch.from_numpy(c["logits"])
    host = ts.Gates(sampled=True, penalties=False, bias=False,
                    min_tokens=True, guide=True)
    assert ts.gates_of(_tstate(c), tab) == host
    a, sa = ts.sample(lg, _tstate(c), None, torch.from_numpy(c["lengths"]),
                      tab, host)
    b, sb = ts.sample(lg, _tstate(c), None, torch.from_numpy(c["lengths"]),
                      tab)
    _same(a, b)
    _same(sa.key, sb.key)
    _same(sa.guide_row, sb.guide_row)
    ids, st = ts.sample(lg, _tstate(c), gates=ts.OFF)
    _same(ids, torch.argmax(lg, dim=-1).to(torch.int32))
    _same(st.key, _tstate(c).key)


# ---------------------------------------------------------------------------
# Engine token streams against the JAX engine
# ---------------------------------------------------------------------------

NAME = "tiny"
ENGINE_KW = dict(num_slots=3, max_cache_len=64, steps_per_dispatch=4,
                 prefill_chunk=16, dtype="float32",
                 prefill_buckets=(8, 16, 32))
COLD = ("regex", "[a-f]{3}(x|y)+")
CASES = [
    ("penalties greedy", dict(max_tokens=10, temperature=0.0,
                              presence_penalty=0.8, frequency_penalty=0.5)),
    ("penalties seeded", dict(max_tokens=10, temperature=0.9, top_k=20,
                              seed=4, presence_penalty=1.5,
                              frequency_penalty=0.3)),
    ("bias duplicates", dict(max_tokens=8, temperature=0.0, logit_bias=(
        (7, 2.0), (7, 3.5), (9, -100.0), (300, 1.25)))),
    ("min_tokens with a stop id", dict(
        max_tokens=8, temperature=0.0, logit_bias=((50, 30.0),),
        stop_token_ids=(50,), min_tokens=5)),
    ("logprobs 3 greedy", dict(max_tokens=8, temperature=0.0, logprobs=3)),
    ("logprobs 0 seeded biased", dict(max_tokens=8, temperature=0.8, seed=9,
                                      logprobs=0, logit_bias=((11, 3.0),))),
    ("json greedy", dict(max_tokens=14, temperature=0.0,
                         guide=("json", ""))),
    ("regex seeded", dict(max_tokens=12, temperature=0.9, seed=2,
                          guide=("regex", "(yes|no)[0-9]{2,4}"))),
    ("json_schema seeded", dict(max_tokens=14, temperature=0.7, seed=5,
                                guide=("json_schema", '{"type": "object", '
                                       '"properties": {"a": {"type": '
                                       '"integer"}}, "required": ["a"]}'))),
    ("choice with logprobs and bias", dict(
        max_tokens=12, temperature=0.0, logprobs=2,
        logit_bias=((100, 100.0),), guide=("choice", '["alpha", "beta"]'))),
    ("cold guide, parked", dict(max_tokens=10, temperature=0.0, guide=COLD)),
    ("plain seeded", dict(max_tokens=8, temperature=0.8, top_p=0.9,
                          seed=21)),
]
LENS = [5, 20, 40, 9, 33, 12, 7, 18, 26, 11, 14, 3]   # 40, 33: legacy chunks


def _prompts():
    rng = np.random.default_rng(3)
    return [[int(x) for x in rng.integers(2, 258, n)] for n in LENS]


def _collect(outputs):
    ids, lps = [], []
    while True:
        out = outputs.get(timeout=120)
        ids += out.token_ids
        lps += out.logprobs or []
        if out.finished:
            return ids, out.finish_reason, lps


def _drive(engine, busy):
    for _ in range(2000):
        engine.step(block_s=0.005)
        if not busy(engine):
            return
    raise AssertionError("engine did not drain")


@pytest.fixture(scope="module", params=["mixed", "slot"])
def streams(request):
    """(JAX streams, port streams, requests the port parked) for every
    case, on one JAX engine and one port engine of the scheduler."""
    import jax
    import jax.numpy as jnp

    from arks_tpu.engine import EngineConfig as JEC
    from arks_tpu.engine import InferenceEngine as JE
    from arks_tpu.engine import Request as JR
    from arks_tpu.engine import SamplingParams as JSP
    from arks_tpu.engine.tokenizer import ByteTokenizer as JBT
    from arks_tpu.models import get_config as jgc
    from arks_tpu.models import transformer as jtf
    from arks_tpu_torch.engine import EngineConfig, InferenceEngine, \
        Request, SamplingParams
    from arks_tpu_torch.models import get_config
    from arks_tpu_torch.models.weights import params_from_numpy

    mode = request.param
    layout = "paged" if mode == "mixed" else "slot"
    mp = pytest.MonkeyPatch()
    mp.setenv("ARKS_MIXED_STEP", "1" if mode == "mixed" else "0")
    try:
        jp = jtf.init_params(jgc(NAME), jax.random.PRNGKey(5), jnp.float32)
        prompts = _prompts()
        je = JE(jgc(NAME), JEC(model=NAME, kv_layout=layout,
                               prefix_cache_mb=0, **ENGINE_KW), JBT(),
                params=jp)
        for _, kw in CASES:
            if kw.get("guide"):
                je.guides.compile(*kw["guide"])
        jreqs = [JR(f"r{i}", p, JSP(**kw))
                 for i, (p, (_, kw)) in enumerate(zip(prompts, CASES))]
        for r in jreqs:
            je.add_request(r)
        _drive(je, lambda e: e.num_running or not e._queue.empty()
               or e._prefilling)
        want = [_collect(r.outputs) for r in jreqs]

        te = InferenceEngine(get_config(NAME), EngineConfig(
            model=NAME, kv_layout=layout, **ENGINE_KW), ByteTokenizer(),
            params=params_from_numpy(jax.tree.map(np.asarray, jp),
                                     get_config(NAME), "cpu"), device="cpu")
        assert te._mixed == (mode == "mixed")
        for _, kw in CASES:
            if kw.get("guide") and kw["guide"] != COLD:
                te.guides.compile(*kw["guide"])
        # The cold guide's compile waits until its request is parked.
        release = threading.Event()
        build = te.guides._build

        def slow_build(rx):
            release.wait(60)
            return build(rx)

        te.guides._build = slow_build
        parked = []
        gate = te._gate_guide

        def spy(req):
            got = gate(req)
            if got == "park":
                # Publish before the next step: the re-queue step is then
                # the same in every run.
                parked.append(req.request_id)
                release.set()
                assert te._awaiting_guide[-1][1].event.wait(60)
            return got

        te._gate_guide = spy
        treqs = [Request(f"r{i}", p, SamplingParams(**kw))
                 for i, (p, (_, kw)) in enumerate(zip(prompts, CASES))]
        for r in treqs:
            te.add_request(r)
        _drive(te, lambda e: not e.idle)
        got = [_collect(r.outputs) for r in treqs]
        assert not te._guide_pins and te._sampling.guide.eq(-1).all()
        return want, got, parked
    finally:
        mp.undo()


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[name for name, _ in CASES])
def test_engine_streams_identical_to_jax(streams, case):
    want, got, _ = streams
    (w_ids, w_fin, w_lps), (g_ids, g_fin, g_lps) = want[case], got[case]
    assert g_ids == w_ids and g_fin == w_fin
    assert len(g_lps) == len(w_lps) == (
        len(w_ids) if CASES[case][1].get("logprobs") is not None else 0)
    for (gc, gtop), (wc, wtop) in zip(g_lps, w_lps):
        assert abs(gc - wc) <= 1e-5
        assert [t for t, _ in gtop] == [t for t, _ in wtop]
        np.testing.assert_allclose([v for _, v in gtop],
                                   [v for _, v in wtop], rtol=0, atol=1e-5)


def test_engine_features_took_effect(streams):
    """The shaping really shaped: the duplicate bias pinned its id, the
    suppressed stop id ended the stream right after min_tokens, every
    guided output matches its grammar, and the cold guide parked."""
    import re

    _, got, parked = streams
    by = {name: got[i] for i, (name, _) in enumerate(CASES)}
    tok = ByteTokenizer()
    assert set(by["bias duplicates"][0]) == {7}
    ids, fin, _ = by["min_tokens with a stop id"]
    assert fin == "stop" and len(ids) == 5
    assert tok.decode(by["choice with logprobs and bias"][0]) in (
        "alpha", "beta")
    text, fin, _ = by["regex seeded"]
    if fin == "stop":
        assert re.fullmatch("(yes|no)[0-9]{2,4}", tok.decode(text))
    assert parked == [f"r{[n for n, _ in CASES].index('cold guide, parked')}"]
    assert re.fullmatch("[a-f]{3}(x|y)*",
                        tok.decode(by["cold guide, parked"][0]))


# ---------------------------------------------------------------------------
# On the card: CUDA against the CPU, bit for bit
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shaping_count_and_guides_on_cuda_bit_exact(cuda, seed):
    gc, tab, starts = _tables()
    _, tab_d, _ = _tables(cuda)
    c = _with_rows(_cols(seed), gc, starts, steps=seed)
    lengths = torch.from_numpy(c["lengths"])
    active = torch.tensor([True, True, False, True, True])
    tok = torch.tensor([3, 3, 5, 0, 257], dtype=torch.int32)
    lg = torch.from_numpy(c["logits"])
    _same(ts.shaped(lg.to(cuda), _tstate(c, cuda), lengths.to(cuda), tab_d),
          ts.shaped(lg, _tstate(c), lengths, tab).numpy())
    _same(ts.count_tokens(_tstate(c, cuda), tok.to(cuda),
                          active.to(cuda)).counts,
          ts.count_tokens(_tstate(c), tok, active).counts.numpy())
    _same(ts.guide_mask(lg.to(cuda), _tstate(c, cuda), tab_d),
          ts.guide_mask(lg, _tstate(c), tab).numpy())
    ids = torch.tensor([40, 41, 42, 121, 98], dtype=torch.int32)
    _same(ts.guide_advance(_tstate(c, cuda), ids.to(cuda), tab_d,
                           active.to(cuda)).guide_row,
          ts.guide_advance(_tstate(c), ids, tab, active).guide_row.numpy())
    want, wst = ts.sample(lg, _tstate(c), active, lengths, tab)
    got, gst = ts.sample(lg.to(cuda), _tstate(c, cuda), active.to(cuda),
                         lengths.to(cuda), tab_d)
    _same(got, want.numpy())
    _same(gst.key, wst.key.numpy())
    _same(gst.guide_row, wst.guide_row.numpy())
    st = ts.set_slots(_tstate(c, cuda), [1, 4], [0.5, 0.0], [1.0, 0.9],
                      [0, 3], torch.tensor([[0, 1], [0, 2]], device=cuda),
                      [0.2, 0.0], [0.0, 0.1])
    st = ts.clear_slot_penalties(st, 1)
    ref_st = ts.clear_slot_penalties(ts.set_slots(
        _tstate(c), [1, 4], [0.5, 0.0], [1.0, 0.9], [0, 3],
        torch.tensor([[0, 1], [0, 2]]), [0.2, 0.0], [0.0, 0.1]), 1)
    for f in _FIELDS:
        _same(getattr(st, f), getattr(ref_st, f).numpy())


@pytest.mark.cuda
def test_top_logprobs_on_cuda(cuda):
    c = _cols(3)
    lg = torch.from_numpy(c["logits"])
    chosen = torch.tensor([1, 250, 3, 0, 99], dtype=torch.int32)
    want = ts.top_logprobs(lg, chosen)
    got = ts.top_logprobs(lg.to(cuda), chosen.to(cuda))
    _same(got[2], want[2].numpy())
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=0,
                                   atol=1e-5)

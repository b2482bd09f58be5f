"""The port's steady-state engine shape against the reference on the CPU:
pipelined dispatch (``ARKS_PIPELINE_DEPTH``), depth-0 sampler fusion
(``ARKS_SAMPLER_FUSE``), the legacy decode/admission overlap
(``ARKS_OVERLAP_DECODE``) and deferred admissions, on f32 ``tiny`` with
the JAX engine's weights, on a mixed paged engine and a legacy slot-cache
engine.

The JAX engine runs at depth 0 only (its own ``test_pipeline_decode.py``
holds its depth invariance).  Token ids and finish reasons must equal its
streams, and those of every port run the port's classic run; logprob
values are held to 1e-5 (two frameworks' f32 log_softmax, and, between
the port's own paths, batches of another size: the pipe step runs every
lane, live or not, where the classic step runs the live ones, and the
CPU's GEMM gives a row other bits at M = 1 than at M = 2).

On the CPU a dispatch's result is ready as soon as it is issued, so the
pipeline would resolve every dispatch right away.  Runs marked ``busy``
make every in-flight record report "not landed" (a device still
computing), so the pipeline fills to its depth and resolves the oldest
only when full, as it does on the card."""

import re
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arks_tpu.engine import EngineConfig as JaxEngineConfig
from arks_tpu.engine import InferenceEngine as JaxEngine
from arks_tpu.engine import Request as JaxRequest
from arks_tpu.engine import SamplingParams as JaxSamplingParams
from arks_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from arks_tpu.models import get_config as jax_get_config
from arks_tpu.models import transformer as jtf
from arks_tpu_torch.engine import EngineConfig, InferenceEngine, Request, \
    SamplingParams
from arks_tpu_torch.engine import engine as engine_mod
from arks_tpu_torch.engine import sampler as sampler_mod
from arks_tpu_torch.engine.tokenizer import ByteTokenizer
from arks_tpu_torch.models import get_config
from arks_tpu_torch.models import transformer as ttf
from arks_tpu_torch.models.weights import params_from_numpy

torch.set_num_threads(2)

NAME = "tiny"
ENGINE_KW = dict(num_slots=2, max_cache_len=64, prefill_buckets=(8, 16, 32),
                 steps_per_dispatch=4, dtype="float32")
# scheduler -> (ARKS_MIXED_STEP, engine fields)
SCHEDS = {"mixed": ("1", dict(prefill_chunk=16, kv_layout="paged")),
          "slot": ("0", dict(kv_layout="slot"))}
PROMPTS = [[5, 6, 7], list(range(3, 23)), [9] * 5, [4] * 12, [8, 3]]
GUIDE = ("regex", "(yes|no)[0-9]{2,4}")


def _workload(guided=False):
    """The reference's pipeline workload: greedy, seeded sampled and
    logprob requests, more requests than slots (and, ``guided``, one
    guided request)."""
    out = []
    for i, p in enumerate(PROMPTS):
        out.append((f"r{i}", p, dict(
            max_tokens=9, temperature=0.0 if i % 2 == 0 else 0.8, top_p=0.9,
            top_k=40, seed=7 + i, ignore_eos=True,
            logprobs=2 if i == 2 else None)))
    if guided:
        out.append(("g", [7, 7, 7], dict(max_tokens=10, temperature=0.0,
                                          guide=GUIDE)))
    return out


@pytest.fixture(scope="module")
def weights():
    jp = jtf.init_params(jax_get_config(NAME), jax.random.PRNGKey(3),
                         jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                 get_config(NAME), "cpu")


def _collect(outputs, timeout=60):
    ids, lps = [], []
    while True:
        out = outputs.get(timeout=timeout)
        ids += out.token_ids
        lps += out.logprobs or []
        if out.finished:
            return ids, lps, out.finish_reason


def _drive(engine, n_steps=2000):
    for _ in range(n_steps):
        engine.step(block_s=0.005)
        if engine.idle:
            return
    raise AssertionError("engine did not drain")


def _engine(monkeypatch, weights, sched, depth, *, fuse="1", overlap="0",
            busy=False, **kw):
    monkeypatch.setenv("ARKS_MIXED_STEP", SCHEDS[sched][0])
    monkeypatch.setenv("ARKS_PIPELINE_DEPTH", str(depth))
    monkeypatch.setenv("ARKS_SAMPLER_FUSE", fuse)
    monkeypatch.setenv("ARKS_OVERLAP_DECODE", overlap)
    monkeypatch.setattr(InferenceEngine, "_pipe_rec_ready",
                        staticmethod(lambda rec: not busy))
    fields = dict(ENGINE_KW, **SCHEDS[sched][1])
    fields.update(kw)
    eng = InferenceEngine(get_config(NAME), EngineConfig(model=NAME, **fields),
                          ByteTokenizer(), params=weights[1], device="cpu")
    assert eng._mixed == (sched == "mixed")
    return eng


def _run(eng, work):
    if any(kw.get("guide") for _, _, kw in work):
        eng.guides.compile(*GUIDE)
    reqs = [Request(rid, list(p), SamplingParams(**kw)) for rid, p, kw in work]
    for r in reqs:
        eng.add_request(r)
    _drive(eng)
    return [_collect(r.outputs) for r in reqs]


@pytest.fixture(scope="module", params=list(SCHEDS))
def reference(request, weights):
    """(scheduler, the JAX engine's streams at depth 0 on the workload)."""
    sched = request.param
    mp = pytest.MonkeyPatch()
    mp.setenv("ARKS_MIXED_STEP", SCHEDS[sched][0])
    mp.setenv("ARKS_PIPELINE_DEPTH", "0")
    try:
        je = JaxEngine(jax_get_config(NAME), JaxEngineConfig(
            model=NAME, prefix_cache_mb=0, **ENGINE_KW, **SCHEDS[sched][1]),
            JaxByteTokenizer(), params=weights[0])
        reqs = [JaxRequest(rid, list(p), JaxSamplingParams(**kw))
                for rid, p, kw in _workload()]
        for r in reqs:
            je.add_request(r)
        for _ in range(2000):
            je.step(block_s=0.005)
            if not (je.num_running or not je._queue.empty()
                    or je._prefilling):
                break
        return sched, [_collect(r.outputs) for r in reqs]
    finally:
        mp.undo()


def _same(got, want):
    for (g_ids, g_lps, g_fin), (w_ids, w_lps, w_fin) in zip(got, want):
        assert g_ids == w_ids and g_fin == w_fin
        assert len(g_lps) == len(w_lps)
        for (gc, gtop), (wc, wtop) in zip(g_lps, w_lps):
            assert abs(gc - wc) <= 1e-5
            assert [t for t, _ in gtop] == [t for t, _ in wtop]
            np.testing.assert_allclose([v for _, v in gtop],
                                       [v for _, v in wtop], rtol=0,
                                       atol=1e-5)


# ---------------------------------------------------------------------------
# (a) streams at every depth; (f) fusion at depth 0
# ---------------------------------------------------------------------------


def test_streams_at_every_depth_match_jax_engine(reference, weights,
                                                 monkeypatch):
    """Depths 0 (classic), 0 (fused, mixed), 1, 2 and 3 (the device busy)
    and 2 (the device idle): ids and finish reasons equal the JAX
    engine's at depth 0 and the port's classic run's, logprob values
    within 1e-5 of both; the pipelined runs issued pipe dispatches and
    filled the pipeline, the fused run only fused ones."""
    sched, want = reference
    runs = [(0, "0", False), (0, "1", False), (1, "1", True),
            (2, "1", True), (3, "1", True), (2, "1", False)]
    base = None
    for depth, fuse, busy in runs:
        eng = _engine(monkeypatch, weights, sched, depth, fuse=fuse,
                      busy=busy)
        got = _run(eng, _workload())
        _same(got, want)
        base = base or got
        _same(got, base)
        if depth:
            assert eng.pipe_dispatches > 0
            assert eng.pipe_occupancy_max == (depth if busy else 1)
            assert eng.sampler_fused_dispatches == 0
        elif fuse == "1" and sched == "mixed":
            assert eng.sampler_fused_dispatches == eng.pipe_dispatches > 0
        else:
            assert eng.pipe_dispatches == 0
        assert not eng._pipe_inflight and eng._pipe_state is None
        if sched == "mixed":
            assert eng._alloc.free_pages == \
                eng._alloc.num_pages - eng._alloc.retained_pages


def test_fused_and_classic_identical_with_a_guided_request(weights,
                                                           monkeypatch):
    """Depth 0 on a mixed engine, with a guided request among the
    workload: the fused path (its counter > 0) gives the classic path's
    streams; at depth 2 the fused counter stays 0."""
    got = {}
    for fuse in ("0", "1"):
        eng = _engine(monkeypatch, weights, "mixed", 0, fuse=fuse)
        got[fuse] = _run(eng, _workload(guided=True))
        assert (eng.sampler_fused_dispatches > 0) == (fuse == "1")
    _same(got["1"], got["0"])
    ids, _, _ = got["1"][-1]
    assert re.fullmatch("(yes|no)[0-9]{0,4}", ByteTokenizer().decode(ids))
    eng = _engine(monkeypatch, weights, "mixed", 2, busy=True)
    _same(_run(eng, _workload(guided=True)), got["0"])
    assert eng.sampler_fused_dispatches == 0 and eng.pipe_dispatches > 0


# ---------------------------------------------------------------------------
# (b) the pipelined path ran as the reference runs it
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sched", list(SCHEDS))
def test_one_pipe_dispatch_per_iteration_and_depth_bound(sched, weights,
                                                         monkeypatch):
    """At depth 2 with the device busy: at most ONE pipe dispatch per
    scheduler iteration, one in every steady iteration, occupancy never
    above the depth and reaching it, and only the first dispatch of the
    run issued fresh from the host mirrors."""
    depth = 2
    eng = _engine(monkeypatch, weights, sched, depth, busy=True)
    fresh = []
    issue = eng._pipe_issue

    def spy():
        fresh.append(eng._pipe_state is None)
        issue()

    eng._pipe_issue = spy
    r = Request("p0", [5, 6, 7], SamplingParams(max_tokens=40,
                                                temperature=0.0,
                                                ignore_eos=True))
    eng.add_request(r)
    per_step = []
    for _ in range(400):
        before = eng.pipe_dispatches
        eng.step(block_s=0.005)
        per_step.append(eng.pipe_dispatches - before)
        if eng.idle:
            break
    ids, _, fin = _collect(r.outputs)
    assert fin == "length" and len(ids) == 40
    assert max(per_step) == 1
    first = per_step.index(1)
    last = len(per_step) - per_step[::-1].index(1)
    assert all(per_step[first:last]), per_step
    assert set(eng.pipe_occupancy) <= set(range(1, depth + 1))
    assert eng.pipe_occupancy_max == depth
    assert fresh[0] and not any(fresh[1:])
    assert eng.pipe_dispatches == len(fresh) == sum(per_step)


# ---------------------------------------------------------------------------
# (c) aborts, stop overshoot and slot reuse
# ---------------------------------------------------------------------------


def test_midstream_abort_drains_and_frees_the_slot(weights, monkeypatch):
    eng = _engine(monkeypatch, weights, "mixed", 2, busy=True)
    victim = Request("v", [5, 6, 7], SamplingParams(
        max_tokens=10_000, temperature=0.0, ignore_eos=True))
    eng.add_request(victim)
    for _ in range(50):
        eng.step(block_s=0.005)
        if eng.pipe_occupancy_max == 2:
            break
    assert eng._pipe_inflight and eng.pipe_occupancy_max == 2, \
        "pipeline never filled"
    eng.abort("v")
    _drive(eng)
    _, _, fin = _collect(victim.outputs)
    assert fin == "abort"
    assert not eng._pipe_inflight and eng._pipe_state is None
    assert eng._alloc.free_pages == \
        eng._alloc.num_pages - eng._alloc.retained_pages
    nxt = Request("n", [9, 9], SamplingParams(max_tokens=4, temperature=0.0,
                                               ignore_eos=True))
    eng.add_request(nxt)
    _drive(eng)
    ids, _, fin = _collect(nxt.outputs)
    assert fin == "length" and len(ids) == 4


@pytest.mark.parametrize("sched", list(SCHEDS))
def test_stop_overshoot_is_truncated(sched, weights, monkeypatch):
    """A stop token landing with later dispatches in flight: the stream
    ends at the stop as on the sequential path (the stop itself left
    out), the overshoot dropped."""
    probe = _run(_engine(monkeypatch, weights, sched, 0), [(
        "probe", [5, 6, 7], dict(max_tokens=16, temperature=0.0,
                                 ignore_eos=True))])[0][0]
    stop = probe[9]
    work = [("s", [5, 6, 7], dict(max_tokens=64, temperature=0.0,
                                  ignore_eos=True, stop_token_ids=(stop,)))]
    base = _run(_engine(monkeypatch, weights, sched, 0), work)
    for depth in (2, 3):
        eng = _engine(monkeypatch, weights, sched, depth, busy=True)
        assert _run(eng, work) == base
        assert eng.pipe_occupancy_max == depth
    ids, _, fin = base[0]
    assert fin == "stop" and stop not in ids and ids == probe[:len(ids)]


def test_slot_reuse_right_after_overshoot(weights, monkeypatch):
    """One slot, paged: a request stops with dispatches in flight (their
    rows of it parked by the device's liveness), its pages go back, and
    the next request, admitted into the same slot at once, gives a fresh
    engine's stream, at every depth."""
    probe = _run(_engine(monkeypatch, weights, "mixed", 0), [(
        "probe", [5, 6, 7], dict(max_tokens=12, temperature=0.0,
                                 ignore_eos=True))])[0][0]
    a = ("a", [5, 6, 7], dict(max_tokens=64, temperature=0.0,
                              ignore_eos=True, stop_token_ids=(probe[5],)))
    b = ("b", list(range(3, 21)), dict(max_tokens=8, temperature=0.0,
                                       ignore_eos=True))
    fresh = _run(_engine(monkeypatch, weights, "mixed", 2, busy=True,
                         num_slots=1), [b])[0]
    for depth in (0, 1, 2, 3):
        eng = _engine(monkeypatch, weights, "mixed", depth, busy=True,
                      num_slots=1)
        got_a, got_b = _run(eng, [a, b])
        assert got_a[2] == "stop" and got_b == fresh, depth
        assert eng._alloc.free_pages == \
            eng._alloc.num_pages - eng._alloc.retained_pages


# ---------------------------------------------------------------------------
# (d) fallbacks and the knob
# ---------------------------------------------------------------------------


def test_oversized_stop_set_stays_on_the_classic_path(weights, monkeypatch):
    big = tuple(range(100, 100 + sampler_mod.STOP_IDS_MAX + 4))
    work = [("big", [5, 6, 7], dict(max_tokens=8, temperature=0.0,
                                    ignore_eos=True, stop_token_ids=big))]
    base = _run(_engine(monkeypatch, weights, "mixed", 0, fuse="0"), work)
    for depth in (0, 2):
        eng = _engine(monkeypatch, weights, "mixed", depth, busy=True)
        assert _run(eng, work) == base
        assert eng.pipe_dispatches == 0


@pytest.mark.parametrize("raw", ["-1", "bogus"])
def test_pipeline_depth_knob_is_validated(raw, weights, monkeypatch):
    with pytest.raises(ValueError, match="ARKS_PIPELINE_DEPTH"):
        _engine(monkeypatch, weights, "mixed", raw)


# ---------------------------------------------------------------------------
# (e) a parked guide compile does not drain the pipeline
# ---------------------------------------------------------------------------


def test_parked_guide_compile_keeps_the_pipeline(weights, monkeypatch):
    """A request parked on a slow guide compile is host bookkeeping:
    every iteration meanwhile still issues a pipelined dispatch; once the
    guide publishes the request is admitted and its output walks the
    grammar, and the load's stream equals a depth-0 run's."""
    rx = ("regex", "ab+a")
    load = ("load", [5, 6, 7], dict(max_tokens=60, temperature=0.0,
                                    ignore_eos=True))
    want = _run(_engine(monkeypatch, weights, "mixed", 0, max_cache_len=96),
                [load])[0]
    eng = _engine(monkeypatch, weights, "mixed", 2, busy=True,
                  max_cache_len=96)
    lreq = Request(load[0], load[1], SamplingParams(**load[2]))
    eng.add_request(lreq)
    for _ in range(50):
        eng.step(block_s=0.005)
        if eng.pipe_dispatches:
            break
    assert eng.pipe_dispatches, "pipeline never engaged"
    release = threading.Event()
    build = eng.guides._build

    def gated(pattern):
        release.wait(30)
        return build(pattern)

    eng.guides._build = gated
    greq = Request("g", [9, 9], SamplingParams(max_tokens=12,
                                               temperature=0.0, guide=rx))
    eng.add_request(greq)
    for _ in range(20):
        eng.step(block_s=0.005)
        if eng._awaiting_guide:
            break
    assert eng._awaiting_guide, "guided request never parked"
    before = eng.pipe_dispatches
    for _ in range(10):
        eng.step(block_s=0.005)
    assert eng._awaiting_guide and eng.pipe_dispatches - before == 10
    release.set()
    _drive(eng)
    ids, _, fin = _collect(greq.outputs)
    text = ByteTokenizer().decode(ids)
    assert re.fullmatch("ab+a" if fin == "stop" else "ab*", text), (text,
                                                                    fin)
    assert _collect(lreq.outputs) == want


# ---------------------------------------------------------------------------
# (g) the legacy decode/admission overlap; (h) deferred admissions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_legacy_overlap_streams_match_sequential(layout, weights,
                                                 monkeypatch):
    """The legacy scheduler with ARKS_OVERLAP_DECODE=1 (decode issued,
    then admission and a prefill chunk, then its resolve) gives the
    sequential order's streams while requests arrive mid-flight, driven
    step by step from one thread; the overlap really issued before
    admitting."""
    work = _workload() + [("long", list(range(2, 42)), dict(
        max_tokens=6, temperature=0.0))]     # 40 tokens: chunked
    arrive = {0: work[:2], 3: work[2:4], 7: work[4:]}
    got = {}
    for overlap in ("0", "1"):
        eng = _engine(monkeypatch, weights, "slot", 0, overlap=overlap,
                      kv_layout=layout)
        assert eng._overlap == (overlap == "1")
        order = []
        for name in ("_issue_decode", "_admit"):
            fn = getattr(eng, name)

            def spy(*a, _fn=fn, _name=name):
                order.append(_name)
                return _fn(*a)

            setattr(eng, name, spy)
        reqs = []
        for i in range(2000):
            for rid, p, kw in arrive.get(i, ()):
                reqs.append(Request(rid, list(p), SamplingParams(**kw)))
                eng.add_request(reqs[-1])
            order.append("step")
            eng.step(block_s=0.005)
            if i > max(arrive) and eng.idle:
                break
        got[overlap] = [_collect(r.outputs) for r in reqs]
        pairs = set(zip(order, order[1:]))
        assert (("_issue_decode", "_admit") in pairs) == (overlap == "1")
        if layout == "paged":
            assert eng._alloc.free_pages == \
                eng._alloc.num_pages - eng._alloc.retained_pages
    _same(got["1"], got["0"])


def test_deferred_admission_abort_frees_slot_and_pages(weights,
                                                       monkeypatch):
    """With the admission's first tokens not landed, the batch stays
    deferred (counted by num_running, no slot registered); an abort
    raised meanwhile frees its slot and its pages when it resolves, and
    the engine's exit ends any still deferred."""
    monkeypatch.setattr(engine_mod._HostCopy, "ready", lambda self: False)
    eng = _engine(monkeypatch, weights, "slot", 0, kv_layout="paged")
    r = Request("d", [5, 6, 7], SamplingParams(max_tokens=8,
                                               temperature=0.0))
    eng.add_request(r)
    eng.step(block_s=0.005)
    assert eng._pending_n == 1 and eng.num_running == 1 and not eng._slots
    assert eng._alloc.free_pages < eng._alloc.num_pages
    eng.abort("d")
    eng.step(block_s=0.005)
    ids, _, fin = _collect(r.outputs)
    assert fin == "abort" and ids == []
    assert not eng._pending_admits and eng.num_running == 0
    assert sorted(eng._free) == list(range(eng.ecfg.num_slots))
    assert eng._alloc.free_pages == \
        eng._alloc.num_pages - eng._alloc.retained_pages
    q = Request("e", [5, 6, 7], SamplingParams(max_tokens=8,
                                               temperature=0.0))
    eng.add_request(q)
    eng.step(block_s=0.005)
    assert eng._pending_n == 1
    eng._abort_pending_admits()
    assert _collect(q.outputs)[2] == "abort"
    assert eng._alloc.free_pages == \
        eng._alloc.num_pages - eng._alloc.retained_pages


# ---------------------------------------------------------------------------
# (i) decode_state_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_decode_state_step_matches_reference(layout, weights):
    """Three liveness-masked decode steps on f32 ``tiny`` with one dead
    slot: logits of the live slots and the cache after them equal the
    reference's ``decode_state_step`` (within 1e-5 of the largest
    |logit|, the limit of the port's ``decode_step`` tests, same argmax);
    the dead slot writes nothing, bit for bit; and the port's
    ``decode_state_step`` is its ``decode_step`` with the dead slot parked
    at the sentinel, bit for bit."""
    jcfg, tcfg = jax_get_config(NAME), get_config(NAME)
    jp, tp = weights
    rng = np.random.default_rng(4)
    b, page, maxp = 3, 16, 4
    sentinel = maxp * page
    if layout == "slot":
        shape = (jcfg.num_layers, b, jcfg.num_kv_heads, sentinel,
                 jcfg.head_dim)
        tables = None
    else:
        shape = (jcfg.num_layers, b * maxp, jcfg.num_kv_heads, page,
                 jcfg.head_dim)
        tables = rng.permutation(b * maxp).astype(np.int32).reshape(b, maxp)
    leaves = {n: rng.standard_normal(shape).astype(np.float32)
              for n in ("k", "v")}
    jc = (jtf.KVCache if layout == "slot" else jtf.PagedKVCache)(
        **{n: jnp.asarray(x) for n, x in leaves.items()})
    tc = (ttf.KVCache if layout == "slot" else ttf.PagedKVCache)(
        **{n: torch.from_numpy(x.copy()) for n, x in leaves.items()})
    tc2 = (ttf.KVCache if layout == "slot" else ttf.PagedKVCache)(
        **{n: torch.from_numpy(x.copy()) for n, x in leaves.items()})
    tokens = rng.integers(2, jcfg.vocab_size, b).astype(np.int32)
    lengths = np.array([20, 37, 9], np.int32)
    alive = np.array([True, False, True])
    live = [0, 2]
    fn = jax.jit(jtf.decode_state_step, static_argnums=(1, 6))
    jt = {} if tables is None else dict(tables=jnp.asarray(tables))
    tt = None if tables is None else torch.from_numpy(tables)
    for _ in range(3):
        want, jc = fn(jp, jcfg, jc, jnp.asarray(tokens), jnp.asarray(lengths),
                      jnp.asarray(alive), sentinel, **jt)
        got = ttf.decode_state_step(tp, tcfg, tc, torch.from_numpy(tokens),
                                    torch.from_numpy(lengths),
                                    torch.from_numpy(alive), sentinel, tt)
        eff = torch.from_numpy(np.where(alive, lengths, sentinel))
        plain = ttf.decode_step(tp, tcfg, tc2, torch.from_numpy(tokens), eff,
                                tt)
        assert torch.equal(got, plain)
        want = np.asarray(want)
        tol = 1e-5 * np.abs(want[live]).max()
        np.testing.assert_allclose(got.numpy()[live], want[live], atol=tol,
                                   rtol=0)
        np.testing.assert_array_equal(got.numpy()[live].argmax(-1),
                                      want[live].argmax(-1))
        tokens = want.argmax(-1).astype(np.int32)
        lengths = lengths + 1
    for n in ("k", "v"):
        g, w = getattr(tc, n).numpy(), np.asarray(getattr(jc, n))
        assert np.array_equal(g, getattr(tc2, n).numpy())
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
        if layout == "slot":
            assert np.array_equal(g[:, 1], leaves[n][:, 1])
        else:
            assert np.array_equal(g[:, tables[1]], leaves[n][:, tables[1]])


@pytest.mark.parametrize("sched", list(SCHEDS))
def test_cache_cap_retires_as_the_sequential_path(sched, weights,
                                                  monkeypatch):
    """A stream that runs into the cache cap (its max_tokens far past it)
    with dispatches in flight ends where the sequential path ends it,
    with ``length``, and the pipeline never streams the device's zeros of
    the slot it retired."""
    work = [("cap", [5, 6, 7], dict(max_tokens=10_000, temperature=0.0,
                                    ignore_eos=True))]
    base = _run(_engine(monkeypatch, weights, sched, 0, fuse="0"), work)
    ids, _, fin = base[0]
    assert fin == "length" and len(ids) < 64
    for depth in (2, 3):
        eng = _engine(monkeypatch, weights, sched, depth, busy=True)
        assert _run(eng, work) == base
        assert eng.pipe_dispatches > 0

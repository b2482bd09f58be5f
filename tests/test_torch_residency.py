"""Windowed-residency decode in the port (``ARKS_RESIDENCY_WINDOW_PAGES``,
``arks_tpu_torch/engine/residency.py``) against the reference's
``tests/test_residency.py``.

A windowed engine's pool holds ``num_slots * window`` pages; a slot whose
decode-grown context outgrows the window engages the span-streaming path
(cold pages in host memory, rotated through two staging halves while the
resident spans attend through the chained ragged attention).  The control
engine runs the same workload with the whole logical table resident.

- The reference's five cases: the windowed stream equals the big-pool
  control's BIT FOR BIT (token ids, finish reasons and logprob floats) at
  depth 0 greedy with logprobs, and (marked slow, as the reference marks
  them) seeded and at depth 2; a finished windowed slot returns its pages
  (slow); a prompt larger than the window is refused; the window's
  configuration errors; the smaller pool.
- The windowed stream against the JAX windowed engine (interpret-mode
  Pallas) on the same f32 weights: equal token ids, logprobs within 1e-5.
- The plain ``paged_mixed_attention`` span chain (spans of two pages over
  a seven-page context, carrying state) equals the single call bit for
  bit on the CPU, for f32, bf16, int8 and int4 pools: the fold the card's
  check relies on.
"""

import contextlib
import os

import jax
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
from arks_tpu_torch.engine import (EngineConfig, InferenceEngine, Request,
                                   SamplingParams)
from arks_tpu_torch.engine.tokenizer import ByteTokenizer
from arks_tpu_torch.models import get_config
from arks_tpu_torch.models.weights import params_from_numpy
from arks_tpu_torch.ops import paged_attention as pa

torch.set_num_threads(2)

WINDOW = 6  # pages; pool = num_slots * WINDOW
PAGE = 16
# Prompt (40 tokens, chunked) + 70 decoded = a 110-token final context:
# larger than the windowed pool (6 pages x 16 = 96 tokens), inside the
# control's 256-token table.
PROMPT_LEN, GEN = 40, 70
KW = dict(model="tiny", num_slots=1, max_cache_len=256,
          prefill_buckets=(8, 16, 32), steps_per_dispatch=4,
          prefill_chunk=PAGE, kv_layout="paged", prefix_cache_mb=0,
          dtype="float32")
ENV = ("ARKS_MIXED_STEP", "ARKS_PIPELINE_DEPTH", "ARKS_RESIDENCY_WINDOW_PAGES",
       "ARKS_ATTN_IMPL", "ARKS_MIXED_GRID")
LP_TOL = 1e-5   # port vs JAX logprobs, f32


@contextlib.contextmanager
def _env(**kv):
    old = {k: os.environ.get(k) for k in ENV}
    try:
        for k in ENV:
            os.environ.pop(k, None)
        os.environ.update({k: str(v) for k, v in kv.items()})
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(scope="module")
def weights():
    jparams = jtf.init_params(jax_get_config("tiny"), jax.random.PRNGKey(0),
                              jax.numpy.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                get_config("tiny"), "cpu")
    return jparams, tparams


def _engine(params, *, window, depth=0, **kw):
    with _env(ARKS_MIXED_STEP=1, ARKS_PIPELINE_DEPTH=depth,
              ARKS_RESIDENCY_WINDOW_PAGES=window):
        return InferenceEngine(get_config("tiny"),
                               EngineConfig(**dict(KW, **kw)),
                               ByteTokenizer(), params=params, device="cpu")


def _drive(eng, n_steps=3000):
    for _ in range(n_steps):
        eng.step(block_s=0.01)
        if eng.idle:
            return
    raise AssertionError("engine did not drain")


def _collect(req):
    ids, lps, fin = [], [], None
    while True:
        out = req.outputs.get(timeout=300)
        ids.extend(out.token_ids)
        if out.logprobs:
            lps.extend(out.logprobs)
        if out.finished:
            fin = out
            break
    return ids, lps, fin.finish_reason, fin.error


def _sampling(seeded, cls=SamplingParams):
    if seeded:
        return cls(max_tokens=GEN, temperature=0.8, top_p=0.9, top_k=40,
                   seed=17, ignore_eos=True)
    return cls(max_tokens=GEN, temperature=0.0, ignore_eos=True, logprobs=2)


def _prompt(vocab):
    return [int(x) % vocab for x in range(3, 3 + PROMPT_LEN)]


def _run(params, *, window, depth, seeded):
    eng = _engine(params, window=window, depth=depth)
    req = Request("lc", _prompt(eng.cfg.vocab_size), _sampling(seeded))
    eng.add_request(req)
    _drive(eng)
    return _collect(req), eng


@pytest.mark.parametrize("depth,seeded", [
    (0, False),
    pytest.param(0, True, marks=pytest.mark.slow),
    pytest.param(2, False, marks=pytest.mark.slow),
    pytest.param(2, True, marks=pytest.mark.slow),
], ids=["d0-greedy-lp", "d0-seeded", "d2-greedy-lp", "d2-seeded"])
def test_long_context_byte_identity_vs_big_pool_control(weights, depth,
                                                        seeded):
    """A decode-grown context larger than the windowed engine's device pool
    emits a stream (and logprob floats) equal bit for bit to a control
    engine whose pool holds the whole context."""
    got, eng = _run(weights[1], window=WINDOW, depth=depth, seeded=seeded)
    base, _ = _run(weights[1], window=0, depth=depth, seeded=seeded)
    final_len = PROMPT_LEN + len(got[0])
    assert final_len > eng._alloc.num_pages * eng._page
    assert eng.metrics.residency_spans_total.total() > 0
    assert eng.metrics.residency_prefetch_pages_total.total() > 0
    assert got[0] == base[0], "token stream diverged from the control"
    assert got[2] == base[2] == "length"
    assert got[1] == base[1], "logprobs diverged from the control"


def test_windowed_stream_equals_the_jax_windowed_engine(weights):
    """The same request through the JAX windowed engine on the same f32
    weights (depth 0, greedy with logprobs): equal token ids, logprobs
    within LP_TOL."""
    got, _ = _run(weights[1], window=WINDOW, depth=0, seeded=False)
    with _env(ARKS_MIXED_STEP=1, ARKS_PIPELINE_DEPTH=0,
              ARKS_ATTN_IMPL="pallas", ARKS_RESIDENCY_WINDOW_PAGES=WINDOW):
        jeng = JaxEngine(jax_get_config("tiny"), JaxEngineConfig(**KW),
                         JaxByteTokenizer(), params=weights[0])
    jreq = JaxRequest("lc", _prompt(jeng.cfg.vocab_size),
                      _sampling(False, JaxSamplingParams))
    jeng.add_request(jreq)
    _drive(jeng)
    want = _collect(jreq)
    assert jeng.metrics.residency_spans_total.total() > 0
    assert got[0] == want[0] and got[2] == want[2]
    for (c, top), (jc, jtop) in zip(got[1], want[1]):
        assert abs(c - jc) <= LP_TOL
        assert [i for i, _ in top] == [i for i, _ in jtop]
        np.testing.assert_allclose([v for _, v in top],
                                   [v for _, v in jtop], atol=LP_TOL)


@pytest.mark.slow
def test_residency_slot_releases_pages_on_finish(weights):
    """After a windowed stream finishes, its staging and tail pages return
    to the allocator and the manager drops the slot; a fresh request then
    admits and completes on the same engine."""
    _, eng = _run(weights[1], window=WINDOW, depth=0, seeded=False)
    assert not eng._residency.slots
    assert eng._alloc.free_pages == eng._alloc.num_pages
    nxt = Request("post", [5, 6, 7], SamplingParams(
        max_tokens=4, temperature=0.0, ignore_eos=True))
    eng.add_request(nxt)
    _drive(eng)
    ids, _, reason, _ = _collect(nxt)
    assert len(ids) == 4 and reason == "length"


def test_prompt_larger_than_window_is_rejected(weights):
    """Residency streams DECODE-grown context: a prompt that cannot fit the
    window is refused at admission with context_length_exceeded."""
    eng = _engine(weights[1], window=WINDOW)
    req = Request("big", [5] * (WINDOW * PAGE + 1), SamplingParams(
        max_tokens=2, temperature=0.0, ignore_eos=True))
    eng.add_request(req)
    _drive(eng)
    _, _, reason, error = _collect(req)
    assert (reason, error) == ("error", "context_length_exceeded")


def test_residency_config_validation(weights):
    """The window's failure modes are startup errors: below 4 pages (2
    tail pages + 2 staging halves), negative, the dense grid (no carried
    state), a draft model; a window at or past the table width is off."""
    with pytest.raises(ValueError, match=">= 4"):
        _engine(weights[1], window=3)
    with pytest.raises(ValueError, match=">= 0"):
        _engine(weights[1], window=-1)
    with _env(ARKS_MIXED_STEP=1, ARKS_MIXED_GRID="dense",
              ARKS_RESIDENCY_WINDOW_PAGES=WINDOW):
        with pytest.raises(ValueError, match="ragged"):
            InferenceEngine(get_config("tiny"), EngineConfig(**KW),
                            ByteTokenizer(), params=weights[1],
                            device="cpu")
    with pytest.raises(ValueError, match="speculative"):
        _engine(weights[1], window=WINDOW, draft_model="tiny", draft_len=3)
    eng = _engine(weights[1], window=64)
    assert eng._residency is None
    assert eng._alloc.num_pages == eng._max_pages * eng.ecfg.num_slots


def test_window_smaller_pool_is_allocated(weights):
    """The pool shrinks to num_slots * window pages while the logical
    tables keep the full max_cache_len width."""
    eng = _engine(weights[1], window=WINDOW, num_slots=2)
    assert eng._alloc.num_pages == 2 * WINDOW
    assert eng._tables.shape == (2, eng._max_pages)
    assert eng._max_pages == 256 // PAGE


def _pools(kind, gen, layers, n_pages, hkv, d):
    shape = (layers, n_pages, hkv, PAGE, d)
    if kind in ("f32", "bf16"):
        dt = torch.float32 if kind == "f32" else torch.bfloat16
        return (torch.randn(shape, generator=gen).to(dt),
                torch.randn(shape, generator=gen).to(dt), {})
    rows = PAGE // 2 if kind == "int4" else PAGE
    lim = 127
    k = torch.randint(-lim, lim + 1, shape[:3] + (rows, d), generator=gen,
                      dtype=torch.int32).to(torch.int8)
    v = torch.randint(-lim, lim + 1, shape[:3] + (rows, d), generator=gen,
                      dtype=torch.int32).to(torch.int8)
    scales = {name: torch.rand(shape[:4], generator=gen) / 64 + 1e-3
              for name in ("k_scale", "v_scale")}
    return k, v, scales


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8", "int4"])
def test_plain_span_chain_equals_the_single_call(kind):
    """Seven-page lanes cut into spans of two pages ([0, 2), [2, 4),
    [4, 6), [6, end)), each emitting its state into the next: the plain
    version's chained output equals its single call bit for bit."""
    gen = torch.Generator().manual_seed(7)
    hkv, g, d, layers, max_pages = 2, 2, 64, 2, 8
    n_pages = 3 * max_pages
    k_pool, v_pool, scales = _pools(kind, gen, layers, n_pages, hkv, d)
    qdt = torch.bfloat16 if kind == "bf16" else torch.float32
    # Lane 0 decodes one token at position 108 (7 pages), lane 1 a 5-token
    # chunk ending at 100, lane 2 is idle.
    q_len = torch.tensor([1, 5, 0], dtype=torch.int32)
    pos_start = torch.tensor([108, 95, 0], dtype=torch.int32)
    seq_q_start = torch.tensor([0, 1, 0], dtype=torch.int32)
    t = 6
    q = torch.randn((t, hkv * g, d), generator=gen).to(qdt)
    tables = torch.randperm(n_pages, generator=gen)[:3 * max_pages] \
        .reshape(3, max_pages).to(torch.int32)
    lane = (tables, seq_q_start, q_len, pos_start, 1)
    single = pa.paged_mixed_attention(q, k_pool, v_pool, *lane, **scales)
    carry = None
    cuts = [0, 2, 4, 6, max_pages]
    for lo, hi in zip(cuts, cuts[1:]):
        last = hi == max_pages
        carry = pa.paged_mixed_attention(
            q, k_pool, v_pool, *lane, page_lo=torch.full((3,), lo),
            page_hi=torch.full((3,), hi), carry_state=carry,
            emit_state=not last, **scales)
    bits = torch.int16 if qdt == torch.bfloat16 else torch.int32
    assert torch.equal(carry.view(bits), single.view(bits))
    assert single[:6].abs().sum() > 0

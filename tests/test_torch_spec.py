"""Speculative decoding: the port (``sampler.draft_sample`` /
``speculative_accept``, the verify oracles, ``transformer.verify_step``,
the engine's speculative mixed and pipelined steps, the server's draft
flags) against the reference's (``arks_tpu/engine/sampler.py``,
``arks_tpu/ops/attention.py``, ``arks_tpu/models/transformer.py``,
``arks_tpu/engine/engine.py``).

The functions take the same seeded numpy inputs on both sides: tokens,
counts, keys and guide rows must be equal, probabilities within 1e-6,
f32 logits within 1e-5.  The engines serve f32 ``tiny`` with a
``tiny-gqa`` draft (weights carried across from the JAX trees) at
pipeline depths 0 and 2; every stream (ids, finish reasons, logprobs)
equals the JAX engine's, and the acceptance counts are the same.  One JAX
engine serves every scenario of a depth (request ids carry the
scenario).  A ``tiny`` self-draft on shared params accepts every proposal
and streams the target-only engine's greedy tokens; a ``spec`` fault and
a replay-mode preemption leave every stream whole.
"""

import contextlib
import http.client
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from arks_tpu.engine import EngineConfig as JaxEngineConfig
from arks_tpu.engine import InferenceEngine as JaxEngine
from arks_tpu.engine import Request as JaxRequest
from arks_tpu.engine import SamplingParams as JaxSamplingParams
from arks_tpu.engine import sampler as jsampler
from arks_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from arks_tpu.models import get_config as jax_get_config
from arks_tpu.models import transformer as jtf
from arks_tpu.ops import attention as jattn
from arks_tpu.ops.pallas_attention import quantize_kv as jquantize_kv
from arks_tpu_torch.engine import (EngineConfig, InferenceEngine, Request,
                                   SamplingParams)
from arks_tpu_torch.engine import faults, prng
from arks_tpu_torch.engine import sampler as tsampler
from arks_tpu_torch.engine.tokenizer import ByteTokenizer
from arks_tpu_torch.models import get_config
from arks_tpu_torch.models import transformer as tf
from arks_tpu_torch.models import weights as tw
from arks_tpu_torch.ops import attention as tattn
from arks_tpu_torch.server import OpenAIServer
from arks_tpu_torch.server import __main__ as server_main

torch.set_num_threads(2)

TARGET, DRAFT = "tiny", "tiny-gqa"
DK = 4
KW = dict(model=TARGET, num_slots=4, max_cache_len=64,
          prefill_buckets=(16, 32), steps_per_dispatch=4, prefill_chunk=16,
          kv_layout="paged", draft_model=DRAFT, draft_len=DK,
          prefix_cache_mb=0, dtype="float32")
ENV = ("ARKS_PIPELINE_DEPTH", "ARKS_MIXED_STEP", "ARKS_FAULT_INJECT",
       "ARKS_PREEMPT", "ARKS_SLO_TIERS", "ARKS_PREFIX_HOST_MB",
       "ARKS_SAMPLER_FUSE")


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
    """(JAX target, JAX draft, port target, port draft): the draft's tree
    crosses over through the same ``params_from_numpy`` as the target's."""
    jt = jtf.init_params(jax_get_config(TARGET), jax.random.PRNGKey(3),
                         jnp.float32)
    jd = jtf.init_params(jax_get_config(DRAFT), jax.random.PRNGKey(4),
                         jnp.float32)
    tt = tw.params_from_numpy(jax.tree.map(np.asarray, jt),
                              get_config(TARGET), "cpu")
    td = tw.params_from_numpy(jax.tree.map(np.asarray, jd),
                              get_config(DRAFT), "cpu")
    return jt, jd, tt, td


def test_draft_params_cross_over_unchanged(weights):
    """The numpy -> port bridge carries a draft tree leaf for leaf."""
    jd, td = weights[1], weights[3]
    flat = jax.tree_util.tree_flatten_with_path(jd)[0]
    assert flat
    for path, leaf in flat:
        node = td
        for k in path:
            node = node[k.key]
        assert np.array_equal(np.asarray(leaf), node.numpy()), path


# ---------------------------------------------------------------------------
# draft_sample and speculative_accept
# ---------------------------------------------------------------------------

B, V, R, C = 6, 512, 24, 16


def _states(rng):
    """The same sampling rows on both sides: lane 0 greedy (its block
    fully accepted), 1 greedy (rejected at position 0), 2 sampled (fully
    accepted), 3 sampled and guided, 4 disabled with penalties, a bias and
    min_tokens, 5 greedy and guided."""
    js = jsampler.init_sampling_state(B, 5, V)
    temp = np.array([0, 0, 0.8, 0.9, 0.7, 0], np.float32)
    top_p = np.array([1, 1, 0.9, 0.95, 1, 1], np.float32)
    top_k = np.array([0, 0, 20, 0, 30, 0], np.int32)
    guide = np.array([-1, -1, -1, 0, -1, 1], np.int32)
    guide_row = np.array([0, 0, 0, 3, 0, 7], np.int32)
    presence = np.array([0, 0, 0, 0, 0.5, 0], np.float32)
    frequency = np.array([0, 0, 0, 0, 0.25, 0], np.float32)
    counts = np.zeros((B, V), np.int32)
    counts[4] = rng.integers(0, 3, V)
    bias_ids = np.full((B, jsampler.LOGIT_BIAS_MAX), -1, np.int32)
    bias_vals = np.zeros((B, jsampler.LOGIT_BIAS_MAX), np.float32)
    bias_ids[4, :3] = [7, 8, 9]
    bias_vals[4, :3] = [2.0, -1.0, 3.5]
    sup = np.full((B, jsampler.SUPPRESS_MAX), -1, np.int32)
    sup[4, :2] = [1, 2]
    min_until = np.array([0, 0, 0, 0, 40, 0], np.int32)
    cols = dict(temperature=temp, top_p=top_p, top_k=top_k,
                presence=presence, frequency=frequency, counts=counts,
                bias_ids=bias_ids, bias_vals=bias_vals, suppress_ids=sup,
                min_until=min_until, guide=guide, guide_row=guide_row)
    js = js._replace(**{k: jnp.asarray(v) for k, v in cols.items()})
    ts = tsampler.SamplingState(**{
        f: (prng.key_tensor(np.asarray(getattr(js, f))) if f == "key" else
            torch.from_numpy(np.array(getattr(js, f))))
        for f in tsampler.SamplingState._fields})
    return js, ts


def _guide_tables(rng):
    """Random DFA tables: classes [2, V], transitions [R, C] with dead
    (-1) entries."""
    cls = rng.integers(0, C, (2, V)).astype(np.int32)
    trans = rng.integers(0, R, (R, C)).astype(np.int32)
    trans[rng.random((R, C)) < 0.3] = -1
    return cls, trans


def _same_keys(jkeys, tkeys):
    assert np.array_equal(np.asarray(jkeys).astype(np.int64), tkeys.numpy())


def test_draft_sample_and_speculative_accept_equal_reference():
    rng = np.random.default_rng(11)
    js, ts = _states(rng)
    cls, trans = _guide_tables(rng)
    jg = (jnp.asarray(cls), jnp.asarray(trans))
    tg = (torch.from_numpy(cls), torch.from_numpy(trans))
    # The draft's DK - 1 proposals, keys threaded through.
    jkeys, tkeys = js.key, ts.key
    jd, td = [], []
    # Jitted, as the reference engine runs them.
    jdraft = jax.jit(jsampler.draft_sample)
    for _ in range(DK - 1):
        logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
        jout = jdraft(jnp.asarray(logits), js, jkeys)
        tout = tsampler.draft_sample(torch.from_numpy(logits), ts, tkeys)
        assert np.array_equal(np.asarray(jout[0]), tout[0].numpy())
        for i in (1, 2):
            np.testing.assert_allclose(np.asarray(jout[i]), tout[i].numpy(),
                                       atol=1e-6)
        assert np.array_equal(np.asarray(jout[3]), tout[3].numpy())
        _same_keys(jout[4], tout[4])
        jkeys, tkeys = jout[4], tout[4]
        jd.append(jout[:4])
        td.append(tout[:4])
    drafts = np.stack([np.asarray(x[0]) for x in jd], axis=1)
    target = (rng.standard_normal((B, DK, V)) * 3).astype(np.float32)
    for i in range(DK - 1):
        target[0, i, drafts[0, i]] += 50.0      # greedy: all accepted
        target[2, i, drafts[2, i]] += 30.0      # sampled: p ~ 1 >= q
    target[1, 0, drafts[1, 0]] -= 50.0          # greedy: rejected at 0
    enable = np.array([1, 1, 1, 1, 0, 1], bool)
    lengths = np.array([10, 11, 12, 13, 20, 14], np.int32)
    jres = jax.jit(jsampler.speculative_accept)(
        jnp.asarray(drafts), *(jnp.stack([x[i] for x in jd], axis=1)
                               for i in (1, 2, 3)),
        jnp.asarray(target), js, jkeys, enable=jnp.asarray(enable),
        lengths=jnp.asarray(lengths), guide_tables=jg)
    tres = tsampler.speculative_accept(
        torch.from_numpy(drafts), *(torch.stack([x[i] for x in td], dim=1)
                                    for i in (1, 2, 3)),
        torch.from_numpy(target), ts, tkeys, enable=torch.from_numpy(enable),
        lengths=torch.from_numpy(lengths), guide_tables=tg)
    out, counts = np.asarray(jres[0]), np.asarray(jres[1])
    assert np.array_equal(tres[0].numpy(), out)
    assert np.array_equal(tres[1].numpy(), counts)
    _same_keys(jres[2], tres[2])
    assert np.array_equal(tres[3].numpy(), np.asarray(jres[3]))
    # The cases happened: full blocks on lanes 0 and 2, a rejection at 0
    # on lane 1, one token on the disabled lane.
    assert counts[0] == counts[2] == DK and counts[1] == 1 and counts[4] == 1
    # The greedy-only gate: no key moves, no window is built, and the
    # tokens, counts and guide rows are the full path's.
    g = ts._replace(temperature=torch.zeros(B))
    drafts_t = torch.from_numpy(drafts)
    on = tsampler.speculative_accept(
        drafts_t, *(torch.stack([x[i] for x in td], dim=1)
                    for i in (1, 2, 3)), torch.from_numpy(target), g, tkeys,
        enable=torch.from_numpy(enable), lengths=torch.from_numpy(lengths),
        guide_tables=tg)
    off = tsampler.speculative_accept(
        drafts_t, None, None, None, torch.from_numpy(target), g, tkeys,
        enable=torch.from_numpy(enable), lengths=torch.from_numpy(lengths),
        guide_tables=tg, gates=tsampler.Gates(sampled=False))
    assert torch.equal(off[0], on[0]) and torch.equal(off[1], on[1])
    assert torch.equal(off[3], on[3]) and torch.equal(off[2], tkeys)


# ---------------------------------------------------------------------------
# The verify oracles and verify_step
# ---------------------------------------------------------------------------


def _jax_cache(cfg, layout, kv, rng, slots=3, length=48, page=8):
    """A JAX cache of random contents (quantized as the engine stores
    them) and its tables (paged: each slot's pages shuffled)."""
    quantized, bits = kv != "f32", 4 if kv == "int4" else 8
    n_pages = slots * length // page
    shape = (cfg.num_layers, n_pages if layout == "paged" else slots,
             cfg.num_kv_heads, page if layout == "paged" else length,
             cfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32) * 0.5
    v = rng.standard_normal(shape).astype(np.float32) * 0.5
    tables = rng.permutation(n_pages).reshape(slots, -1).astype(np.int32)
    if not quantized:
        cache = (jnp.asarray(k), jnp.asarray(v), None, None)
    else:
        qmax = 7 if bits == 4 else 127
        kq, ks = jquantize_kv(jnp.asarray(k), qmax=qmax)
        vq, vs = jquantize_kv(jnp.asarray(v), qmax=qmax)
        if bits == 4:
            from arks_tpu.ops.paged_attention import pack_int4
            kq, vq = pack_int4(kq, axis=3), pack_int4(vq, axis=3)
        cache = (kq, vq, ks, vs)
    cls = jtf.PagedKVCache if layout == "paged" else jtf.KVCache
    return cls(*cache), tables


def _torch_cache(jcache, layout):
    cls = tf.PagedKVCache if layout == "paged" else tf.KVCache
    return cls(*[None if x is None else torch.from_numpy(np.array(x))
                 for x in jcache])


@pytest.mark.parametrize("layout,kv", [("slot", "f32"), ("slot", "int8"),
                                       ("paged", "f32"), ("paged", "int8"),
                                       ("paged", "int4")])
def test_verify_step_and_oracles_equal_reference(weights, layout, kv):
    """``verify_step`` over 3 slots of 4-token blocks (one slot parked at
    the sentinel on a paged pool, one block crossing a page): logits
    within 1e-5 and the written cache bytes (values, scales) equal; the
    layer op itself against the reference's on the same inputs."""
    rng = np.random.default_rng(7)
    cfg, jcfg = get_config(TARGET), jax_get_config(TARGET)
    jcache, tables = _jax_cache(jcfg, layout, kv, rng)
    tcache = _torch_cache(jcache, layout)
    tokens = rng.integers(0, V, (3, DK)).astype(np.int32)
    park = 48 if layout == "paged" else 30
    lengths = np.array([5, 14, park], np.int32)
    kw = dict(tables=jnp.asarray(tables)) if layout == "paged" else {}
    jl, jc = jtf.verify_step(weights[0], jcfg, jcache, jnp.asarray(tokens),
                             jnp.asarray(lengths), **kw)
    tl = tf.verify_step(weights[2], cfg, tcache, torch.from_numpy(tokens),
                        torch.from_numpy(lengths),
                        torch.from_numpy(tables) if kw else None)
    live = [0, 1] if layout == "paged" else [0, 1, 2]
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               atol=1e-5)
    for got, want in zip(tcache, jc):
        if want is None:
            continue
        want = np.asarray(want)
        if want.dtype == np.int8:
            assert np.array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    # One layer's op, directly.
    h, d = cfg.num_heads, cfg.head_dim
    q = rng.standard_normal((3, DK, h, d)).astype(np.float32)
    kn = rng.standard_normal((3, DK, cfg.num_kv_heads, d)).astype(np.float32)
    vn = rng.standard_normal((3, DK, cfg.num_kv_heads, d)).astype(np.float32)
    pos = lengths[:, None] + np.arange(DK, dtype=np.int32)
    jcache, _ = _jax_cache(jcfg, layout, kv, np.random.default_rng(8))
    tcache = _torch_cache(jcache, layout)
    t_in = [torch.from_numpy(x) for x in (q, kn, vn)]
    if layout == "paged":
        jout = jattn.paged_verify_update_and_attend(
            *map(jnp.asarray, (q, kn, vn)), jcache.k, jcache.v,
            jnp.asarray(tables), jnp.asarray(pos), 1,
            k_scale=jcache.k_scale, v_scale=jcache.v_scale)
        tout = tattn.paged_verify_update_and_attend(
            *t_in, tcache.k, tcache.v, torch.from_numpy(tables),
            torch.from_numpy(pos), 1, k_scale=tcache.k_scale,
            v_scale=tcache.v_scale)
    else:
        jout = jattn.verify_update_and_attend(
            *map(jnp.asarray, (q, kn, vn)), jcache.k, jcache.v,
            jnp.asarray(pos), jnp.asarray(lengths), 1,
            k_scale=jcache.k_scale, v_scale=jcache.v_scale)
        tout = tattn.verify_update_and_attend(
            *t_in, tcache.k, tcache.v, torch.from_numpy(pos), 1,
            k_scale=tcache.k_scale, v_scale=tcache.v_scale)
    np.testing.assert_allclose(tout.numpy()[live], np.asarray(jout[0])[live],
                               atol=1e-5)
    for got, want in zip(tcache, jout[1:]):
        if want is not None:
            assert np.allclose(got.numpy().astype(np.float32),
                               np.asarray(want).astype(np.float32),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------


def port_engine(weights, depth, draft=True, busy=False, **kv):
    with _env(ARKS_PIPELINE_DEPTH=depth, **kv):
        eng = InferenceEngine(
            get_config(TARGET), EngineConfig(**dict(
                KW, draft_model=DRAFT if draft else None)),
            ByteTokenizer(), params=weights[2], device="cpu",
            draft_params=weights[3] if draft else None,
            draft_cfg=get_config(DRAFT) if draft else None)
    if busy:
        # On the CPU a result lands at once; reading none as ready fills
        # the pipeline to its depth, as on the card.
        eng._pipe_rec_ready = lambda rec: False
    return eng


_JAX: dict = {}


def jax_engine(weights, depth):
    """The JAX spec engine of a depth, built once for the module."""
    if depth not in _JAX:
        with _env(ARKS_PIPELINE_DEPTH=depth):
            eng = JaxEngine(jax_get_config(TARGET), JaxEngineConfig(**KW),
                            JaxByteTokenizer(), params=weights[0],
                            draft_params=weights[1],
                            draft_cfg=jax_get_config(DRAFT))
        if depth:
            assert eng._pipe_warm_wait(300) == "ready"
        _JAX[depth] = eng
    return _JAX[depth]


def _busy(eng) -> bool:
    return bool(eng.num_running or not eng._queue.empty() or eng._prefilling
                or eng._awaiting_restore or eng._awaiting_guide
                or eng.state != "serving")


def _drive(eng, n_steps=3000, late=(), after=0):
    """The engine thread's step/recover contract, synchronously; ``late``
    requests arrive after ``after`` steps."""
    late = list(late)
    for i in range(n_steps):
        if late and i == after:
            for r in late:
                eng.add_request(r)
            late = []
        try:
            eng.step(block_s=0.005)
        except Exception as e:  # noqa: BLE001 — routed like the run loop
            eng._recover_from_fault(e)
        if not late and not _busy(eng):
            return
    raise AssertionError("engine did not drain")


def _collect(req):
    ids, lps = [], []
    while True:
        out = req.outputs.get(timeout=60)
        ids.extend(out.token_ids)
        lps.extend(out.logprobs or [])
        if out.finished:
            return ids, out.finish_reason, out.error, lps


LONG = [int(x) for x in np.random.default_rng(2).integers(3, 500, 40)]


def _requests(rq, sp, tag):
    """Greedy and seeded lanes, a penalized lane and a logprobs lane (they
    never speculate), a guided lane, a stop set, and a 40-token prompt
    past the largest bucket (no draft prefill; chunked beside decoding
    lanes): seven requests on four slots, so later prompts chunk while
    earlier ones decode."""
    specs = [
        ([5, 6, 7], dict(max_tokens=14, temperature=0.0)),
        ([9] * 5, dict(max_tokens=14, temperature=0.8, top_p=0.9, top_k=40,
                       seed=21)),
        ([11, 12, 13, 14], dict(max_tokens=10, temperature=0.0,
                                presence_penalty=0.5,
                                frequency_penalty=0.3)),
        ([20, 21], dict(max_tokens=8, temperature=0.0, logprobs=2)),
        ([8, 3, 4], dict(max_tokens=10, temperature=0.9, seed=33,
                         guide=("regex", "[a-f]+"))),
        (LONG, dict(max_tokens=8, temperature=0.7, seed=5)),
        ([30, 31, 32], dict(max_tokens=12, temperature=0.0,
                            stop_token_ids=[311, 97, 402])),
    ]
    return [rq(f"{tag}-{i}", p, sp(ignore_eos=True, **kw))
            for i, (p, kw) in enumerate(specs)]


def _run(eng, rq, sp, tag):
    reqs = _requests(rq, sp, tag)
    before = (eng._spec_proposed, eng._spec_accepted)
    for r in reqs[:4]:
        eng.add_request(r)
    _drive(eng, late=reqs[4:], after=3)
    got = [_collect(r) for r in reqs]
    return got, (eng._spec_proposed - before[0],
                 eng._spec_accepted - before[1])


def _same_streams(got, want, tag):
    for (ids, fin, err, lps), (jids, jfin, jerr, jlps) in zip(got, want):
        assert (ids, fin, err) == (jids, jfin, jerr), tag
        assert len(lps) == len(jlps), tag
        for (c, top), (jc, jtop) in zip(lps, jlps):
            assert abs(c - jc) < 1e-5, tag
            assert [i for i, _ in top] == [i for i, _ in jtop], tag


@pytest.mark.parametrize("depth", [0, 2])
def test_spec_streams_equal_jax_engine(weights, depth):
    """The mixed workload on a ``tiny`` target with a ``tiny-gqa`` draft:
    every stream equals the JAX spec engine's (greedy, seeded, penalized,
    logprobs, guided, the long prompt, the stop set), with the same
    proposals and acceptances; at depth 2 through a full pipeline."""
    je = jax_engine(weights, depth)
    want, jacc = _run(je, JaxRequest, JaxSamplingParams, f"mix{depth}")
    eng = port_engine(weights, depth, busy=bool(depth))
    got, acc = _run(eng, Request, SamplingParams, f"mix{depth}")
    _same_streams(got, want, f"depth {depth}")
    assert acc == jacc and acc[0] > 0
    assert eng.resolved_config["spec_mixed"] == "true"
    assert not eng.sampler_fused_dispatches
    if depth:
        assert eng.pipe_occupancy_max == depth
    # The long prompt never speculated; its lane still decoded whole.
    assert len(got[5][0]) == 8


def _slot_cache(pool, tables):
    """The slot-contiguous cache holding the rows ``tables`` [B, MaxP] map
    in ``pool``: lane b's pages laid end to end."""
    idx = tables.clamp(min=0).long()

    def lay(x):           # [L, N, Hkv, P(, D)] -> [L, B, Hkv, MaxP * P(, D)]
        g = x[:, idx].transpose(2, 3)
        return g.reshape(*g.shape[:3], -1, *g.shape[5:])
    return tf.KVCache(*[None if x is None else lay(x) for x in pool])


@pytest.mark.parametrize("depth,kv", [(0, "auto"), (2, "int8")])
def test_engine_verify_block_equals_verify_step(weights, monkeypatch, depth,
                                                kv):
    """The serving path's verify block against the reference's oracle for
    it: one speculative dispatch of the engine (depth 0 through
    ``_issue_spec_mixed``, depth 2 through ``spec_pipe``; f32 and int8
    pools) gives the verify logits that ``verify_step`` gives for the
    same tokens on the pool as it stood before the dispatch, and on a
    slot cache holding the same rows, within 1e-5."""
    seen = []
    mixed = tf.mixed_step

    def capture(*args, **kw):
        before = [None if x is None else x.clone() for x in args[2]]
        logits = mixed(*args, **kw)
        if "tokens" in kw:                  # a dispatch of spec_verify
            seen.append((tf.PagedKVCache(*before), kw, logits))
        return logits

    monkeypatch.setattr(tf, "mixed_step", capture)
    with _env(ARKS_PIPELINE_DEPTH=depth):
        eng = InferenceEngine(
            get_config(TARGET), EngineConfig(**dict(KW, kv_cache_dtype=kv)),
            ByteTokenizer(), params=weights[2], device="cpu",
            draft_params=weights[3], draft_cfg=get_config(DRAFT))
    reqs = [Request(f"v-{i}", p, SamplingParams(
        max_tokens=14, temperature=t, seed=5, ignore_eos=True))
        for i, (p, t) in enumerate([([5, 6, 7, 8, 9], 0.0),
                                    (list(range(20, 34)), 0.0),
                                    ([40] * 9, 0.9)])]
    for r in reqs:
        eng.add_request(r)
    _drive(eng)
    b, lane = KW["num_slots"], torch.arange(KW["num_slots"])

    def blocks(kw):
        return (kw["seq_q_len"] == DK) & (kw["seq_q_start"] == lane * DK)
    pool, kw, logits = max(
        enumerate(seen), key=lambda c: (int(blocks(c[1][1]).sum()), c[0]))[1]
    lanes = torch.nonzero(blocks(kw))[:, 0]
    assert len(lanes) == 3
    tokens = kw["tokens"][: b * DK].reshape(b, DK)[lanes]
    lengths, tables = kw["seq_pos_start"][lanes], kw["tables"][lanes]
    want = logits[: b * DK].reshape(b, DK, -1)[lanes].numpy()
    slot = _slot_cache(pool, tables)
    cfg = get_config(TARGET)
    got = tf.verify_step(weights[2], cfg, pool, tokens, lengths, tables)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    got = tf.verify_step(weights[2], cfg, slot, tokens, lengths)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_self_draft_accepts_every_proposal(weights):
    """A ``tiny`` self-draft on shared params (depth 2, full pipeline):
    every proposal is accepted, greedy streams equal the target-only
    engine's, and a stop token in the middle of an accepted block ends the
    stream there."""
    base = port_engine(weights, 0, draft=False)
    greedy = SamplingParams(max_tokens=17, temperature=0.0, ignore_eos=True)
    r = Request("t-0", [5, 6, 7], greedy)
    base.add_request(r)
    _drive(base)
    stream = _collect(r)[0]
    # A token first seen at an index that is not a block's last (blocks of
    # DK tokens follow the first token): index i lands in a block at
    # position (i - 1) % DK.
    stop_at = next(i for i in range(2, len(stream))
                   if stream[i] not in stream[:i] and (i - 1) % DK < DK - 1)
    with _env(ARKS_PIPELINE_DEPTH=2):
        eng = InferenceEngine(
            get_config(TARGET), EngineConfig(**dict(KW, draft_model=TARGET)),
            ByteTokenizer(), params=weights[2], device="cpu",
            draft_params=weights[2], draft_cfg=get_config(TARGET))
    eng._pipe_rec_ready = lambda rec: False
    reqs = [Request("s-0", [5, 6, 7], greedy),
            Request("s-1", [9] * 5, SamplingParams(
                max_tokens=17, temperature=0.8, seed=3, ignore_eos=True)),
            Request("s-2", [5, 6, 7], SamplingParams(
                max_tokens=17, temperature=0.0, ignore_eos=True,
                stop_token_ids=[stream[stop_at]]))]
    for q in reqs:
        eng.add_request(q)
    _drive(eng)
    got = [_collect(q) for q in reqs]
    assert got[0][:2] == (stream, "length")
    assert got[2][:2] == (stream[:stop_at], "stop")
    assert len(got[1][0]) == 17
    assert eng._spec_proposed > 0 and \
        eng._spec_accepted == eng._spec_proposed
    assert eng.metrics.spec_decode_acceptance_rate.get() == 1.0


def test_spec_config_validation(weights, monkeypatch):
    """The reference's checks (``tests/test_spec_decode.py``):
    draft_len >= 2, no pipeline or data parallelism, the mixed scheduler
    (paged layout, chunked prefill, ``ARKS_MIXED_STEP`` not 0), a draft
    vocabulary equal to the target's; windowed residency refuses a draft,
    as the reference's does."""
    cfg = get_config(TARGET)

    def build(**kw):
        return InferenceEngine(cfg, EngineConfig(**dict(
            dict(model=TARGET, draft_model=TARGET), **kw)), ByteTokenizer(),
            device="cpu")

    with pytest.raises(ValueError, match="draft_len"):
        build(draft_len=1)
    with pytest.raises(ValueError, match="pipeline_parallel"):
        build(pipeline_parallel=2)
    with pytest.raises(ValueError, match="data_parallel"):
        build(data_parallel=2)
    with pytest.raises(ValueError, match="mixed scheduler"):
        build(kv_layout="slot", prefill_chunk=16)
    # The port chunks on both schedulers: no engine takes prefill_chunk
    # None.
    with pytest.raises(ValueError, match="prefill_chunk"):
        build(prefill_chunk=None, kv_layout="paged")
    with pytest.raises(ValueError, match="draft vocab"):
        build(draft_model="qwen2.5-0.5b")
    monkeypatch.setenv("ARKS_MIXED_STEP", "0")
    with pytest.raises(ValueError, match="mixed scheduler"):
        build(kv_layout="paged", prefill_chunk=16)
    monkeypatch.delenv("ARKS_MIXED_STEP")
    monkeypatch.setenv("ARKS_RESIDENCY_WINDOW_PAGES", "4")
    with pytest.raises(ValueError, match="speculative"):
        build(prefill_chunk=16)     # 64 pages a slot: the window engages


def _fault_requests(tag):
    return [Request(f"{tag}-{i}", p, SamplingParams(
        max_tokens=14, temperature=0.0 if i % 2 == 0 else 0.9, top_p=0.9,
        top_k=40, seed=21 + i, ignore_eos=True))
        for i, p in enumerate([[5, 6, 7], [9] * 5, [1, 2, 3, 4]])]


@pytest.mark.parametrize("depth", [0, 2])
def test_spec_fault_replays_streams_whole(weights, depth):
    """``spec:3:runtime``: the step faults, nothing is quarantined, and
    every replayed stream equals the fault-free run whole."""
    base = port_engine(weights, depth)
    reqs = _fault_requests("base")
    for r in reqs:
        base.add_request(r)
    _drive(base)
    want = [_collect(r)[:3] for r in reqs]
    eng = port_engine(weights, depth, busy=bool(depth))
    eng._faults = faults.FaultInjector("spec:3:runtime")
    reqs = _fault_requests("fault")
    for r in reqs:
        eng.add_request(r)
    _drive(eng)
    assert [_collect(r)[:3] for r in reqs] == want
    m = eng.metrics
    assert m.engine_faults_total.total() == 1
    assert m.requests_quarantined_total.total() == 0
    assert m.requests_recovered_total.total() >= 1
    assert eng.state == "serving"


def test_replay_gate_takes_blocks_past_the_checked_prefix():
    """A replay gate checks the recorded prefix only: a speculative block
    of any length that starts past it passes (the reference's gate slices
    with a negative count there and fails a 3-token block that follows a
    1-token one), and a wrong token inside the prefix still fails."""
    import queue

    from arks_tpu_torch.engine.engine import _ReplayGate
    from arks_tpu_torch.engine.types import RequestOutput

    class _Eng:
        def __init__(self):
            self.aborted = []

        def abort(self, rid):
            self.aborted.append(rid)

    inner, eng = queue.Queue(), _Eng()
    gate = _ReplayGate(inner, eng, "r", [7], 1)
    for toks in ([7], [8], [9, 10, 11], [12, 13]):
        gate.put(RequestOutput("r", toks))
    assert not gate.failed and not eng.aborted
    assert [t for o in list(inner.queue) for t in o.token_ids] == \
        [8, 9, 10, 11, 12, 13]
    bad = _ReplayGate(queue.Queue(), eng, "s", [7, 8], 2)
    bad.put(RequestOutput("s", [7, 9, 10]))
    assert bad.failed and eng.aborted == ["s"]


def _preempt_run(weights, preempt):
    """The reference's ``_run_scenario`` on a one-slot spec engine
    (draft_len 3, the host tier on): a batch-tier victim decodes 14 steps,
    a latency-tier request arrives, drain; once per victim."""
    env = dict(ARKS_PIPELINE_DEPTH=0, ARKS_PREFIX_HOST_MB=64,
               ARKS_PREEMPT=int(preempt),
               ARKS_SLO_TIERS="latency:ttft_ms=300,batch:")
    kw = dict(KW, num_slots=1, draft_len=3, prefill_buckets=(8, 16, 32))
    with _env(**env):
        eng = InferenceEngine(get_config(TARGET), EngineConfig(**kw),
                              ByteTokenizer(), params=weights[2],
                              device="cpu", draft_params=weights[3],
                              draft_cfg=get_config(DRAFT))
    rq, sp = Request, SamplingParams
    victims = [rq("bt-greedy", [5, 6, 7], sp(
                   max_tokens=20, temperature=0.0, ignore_eos=True,
                   priority=1)),
               rq("bt-seeded", [9] * 5, sp(
                   max_tokens=20, temperature=0.9, top_p=0.9, top_k=40,
                   seed=21, ignore_eos=True, priority=1))]
    outs = {}
    for i, victim in enumerate(victims):
        eng.add_request(victim)
        for _ in range(14):
            try:
                eng.step(block_s=0.005)
            except Exception as e:  # noqa: BLE001
                eng._recover_from_fault(e)
        lat = rq(f"lt-{i}", [2, 2, 2, 3 + i], sp(
            max_tokens=4, temperature=0.0, ignore_eos=True, priority=0))
        eng.add_request(lat)
        _drive(eng)
        for r in (victim, lat):
            outs[r.request_id] = _collect(r)[:3]
    return outs, eng


def test_spec_engine_preempts_via_replay(weights):
    """A speculative engine preempts in replay mode even with the host
    tier on, and its streams equal preemption off (the reference's
    ``test_spec_engine_preempts_via_replay``)."""
    base, _ = _preempt_run(weights, False)
    got, eng = _preempt_run(weights, True)
    assert eng.resolved_config["preempt"] == "replay"
    assert eng.metrics.requests_preempted_total.total() >= 2
    assert got == base
    assert len(eng._swap) == 0


def _http(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, body=None if body is None else json.dumps(
        body), headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read().decode()
    conn.close()
    return resp.status, raw


def test_metrics_show_spec_families(weights):
    """``/metrics`` of a serving spec engine: the ``spec_decode_*``
    families count the proposals, and ``engine_config_info`` says
    ``spec_mixed="true"``."""
    eng = port_engine(weights, 0)
    srv = OpenAIServer(eng, TARGET, host="127.0.0.1", port=0)
    srv.start(background=True)
    eng.start()
    try:
        for prompt in ("speculate", "again"):
            st, _ = _http(srv.port, "POST", "/v1/completions", dict(
                prompt=prompt, max_tokens=8, temperature=0, ignore_eos=True))
            assert st == 200
        st, text = _http(srv.port, "GET", "/metrics")
    finally:
        srv.stop()
        eng.stop()
    assert st == 200 and 'spec_mixed="true"' in text
    samples = dict(line.rsplit(" ", 1) for line in text.splitlines()
                   if line.startswith("spec_decode"))
    assert float(samples["spec_decode_proposed_tokens_total"]) == \
        eng._spec_proposed > 0
    assert float(samples["spec_decode_accepted_tokens_total"]) == \
        eng._spec_accepted
    assert "spec_decode_accepted_length_count" in samples


def _hf_tensors(cfg, seed):
    """A random HF checkpoint of ``cfg`` ([out, in] matrices)."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    e, f = cfg.hidden_size, cfg.intermediate_size
    t = {"model.embed_tokens.weight": r(cfg.vocab_size, e),
         "model.norm.weight": r(e), "lm_head.weight": r(cfg.vocab_size, e)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = r(e)
        t[p + "post_attention_layernorm.weight"] = r(e)
        for proj, n in (("q", cfg.q_dim), ("k", cfg.kv_dim),
                        ("v", cfg.kv_dim)):
            t[p + f"self_attn.{proj}_proj.weight"] = r(n, e)
            t[p + f"self_attn.{proj}_proj.bias"] = r(n)
        t[p + "self_attn.o_proj.weight"] = r(e, cfg.q_dim)
        t[p + "mlp.gate_proj.weight"] = r(f, e)
        t[p + "mlp.up_proj.weight"] = r(f, e)
        t[p + "mlp.down_proj.weight"] = r(e, f)
    return t


def test_server_loads_the_draft_checkpoint(tmp_path):
    """``--draft-model tiny-gqa --draft-model-path DIR`` and
    ``--draft-model DIR`` (a directory with config.json) load the draft
    through the checkpoint loader, quantized on load with
    ``--weight-dtype``; the engine serves speculatively on it."""
    dcfg = get_config(DRAFT)
    save_file(_hf_tensors(dcfg, 9), str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps(dict(
        architectures=["Qwen2ForCausalLM"], model_type="qwen2",
        vocab_size=dcfg.vocab_size, hidden_size=dcfg.hidden_size,
        intermediate_size=dcfg.intermediate_size,
        num_hidden_layers=dcfg.num_layers,
        num_attention_heads=dcfg.num_heads,
        num_key_value_heads=dcfg.num_kv_heads, eos_token_id=0)))
    base = ["--model", TARGET, "--device", "cpu", "--num-slots", "2",
            "--max-model-len", "64", "--dtype", "float32", "--draft-len",
            "3"]
    want = tw.load_params(dcfg, str(tmp_path), "float32",
                          weight_dtype="int8", device="cpu")
    for draft in (["--draft-model", DRAFT, "--draft-model-path",
                   str(tmp_path)], ["--draft-model", str(tmp_path)]):
        args = server_main.parse_args(base + draft + ["--weight-dtype",
                                                      "int8"])
        _, eng = server_main.build_engine(args)
        assert eng.ecfg.draft_len == 3
        got = eng._draft_params
        for name in ("wq", "w_down"):
            for part in ("q", "s"):
                assert torch.equal(got["layers"][name][part],
                                   want["layers"][name][part])
        assert torch.equal(got["embed"]["q"], want["embed"]["q"])
    r = Request("ckpt", [5, 6, 7], SamplingParams(
        max_tokens=6, temperature=0.0, ignore_eos=True))
    eng.add_request(r)
    _drive(eng)
    assert len(_collect(r)[0]) == 6 and eng._spec_proposed > 0

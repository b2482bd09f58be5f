"""Prefix reuse in the port against the reference's, on the same inputs:
the page allocator's spill hook, stats and membership mirror, the host stores
(``HostPrefixTier``, ``PrefixKVCache``), the whole-page pool copies of the
host tier (bit for bit on bf16, int8 and int4 pools), and the engines:
mixed and legacy paged schedulers at pipeline depths 0 and 2 with the
device index and the host tier, and the legacy slot cache with its host
prefix cache.  Streams with reuse on must equal the JAX engine's with it
on and the port's with it off; a warm prompt prefills only its tail; a
restore writes back the spilled bytes exactly.  The counterparts of
``tests/test_prefix_cache.py`` and ``tests/test_prefix_tiers.py``."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arks_tpu.engine import EngineConfig as JaxEngineConfig
from arks_tpu.engine import InferenceEngine as JaxEngine
from arks_tpu.engine import Request as JaxRequest
from arks_tpu.engine import SamplingParams as JaxSamplingParams
from arks_tpu.engine import paged as jpaged
from arks_tpu.engine import prefix_cache as jprefix
from arks_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from arks_tpu.models import get_config as jax_get_config
from arks_tpu.models import transformer as jtf
from arks_tpu.ops import paged_attention as jpa
from arks_tpu_torch.engine import EngineConfig, InferenceEngine, Request, \
    SamplingParams
from arks_tpu_torch.engine import paged as tpaged
from arks_tpu_torch.engine import prefix_cache as tprefix
from arks_tpu_torch.engine.tokenizer import ByteTokenizer
from arks_tpu_torch.models import get_config
from arks_tpu_torch.models import transformer as ttf
from arks_tpu_torch.models.weights import params_from_numpy
from arks_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(2)

NAME = "tiny"
CHUNK = 16   # page size of every engine below
ENGINE_KW = dict(model=NAME, num_slots=2, max_cache_len=64,
                 prefill_buckets=(8, 16, 32), steps_per_dispatch=4,
                 prefill_chunk=CHUNK, dtype="float32")


def _raw(x) -> np.ndarray:
    """Bytes of a torch or JAX array as numpy (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == jnp.bfloat16 else x


# ---------------------------------------------------------------------------
# The allocator, the host stores, the pool copies
# ---------------------------------------------------------------------------


def test_allocator_eviction_spill_hook_and_stats_match_the_reference():
    """One seeded sequence of allocations, registrations, matches and
    frees on both allocators: the same pages, the same evictions (with
    their digests, in order, through ``on_evict``), the same free list,
    index and hit rate."""
    evicted = {"j": [], "t": []}
    ja = jpaged.PageAllocator(24, 4, on_evict=lambda d, p: evicted["j"]
                              .append((d, p)))
    ta = tpaged.PageAllocator(24, 4, on_evict=lambda d, p: evicted["t"]
                              .append((d, p)))
    rng = random.Random(5)
    # Prompts cut from a few shared streams, so prefixes repeat.
    streams = [[rng.randint(0, 9) for _ in range(20)] for _ in range(6)]
    held = []
    for _ in range(300):
        op = rng.random()
        if op < 0.45 or not held:
            n = rng.randint(1, 5)
            ids = rng.choice(streams)[:4 * n]
            digs = tpaged.chain_digests(ids, 4, n)
            assert digs == jpaged.chain_digests(ids, 4, n)
            hit_j, hit_t = ja.match(digs), ta.match(digs)
            assert hit_t == hit_j
            ja.record_query(4 * n, 4 * len(hit_j))
            ta.record_query(4 * n, 4 * len(hit_t))
            need = n - len(hit_t)
            try:
                new_j = ja.alloc(need)
            except jpaged.OutOfPagesError:
                with pytest.raises(tpaged.OutOfPagesError):
                    ta.alloc(need)
                ja.decref(hit_j)
                ta.decref(hit_t)
                continue
            new_t = ta.alloc(need)
            assert new_t == new_j
            ja.register(digs, hit_j + new_j)
            ta.register(digs, hit_t + new_t)
            held.append(hit_t + new_t)
        else:
            pages = held.pop(rng.randrange(len(held)))
            ja.decref(pages)
            ta.decref(pages)
        assert ta._free == ja._free and ta._ref == ja._ref
        assert list(ta._index.items()) == list(ja._index.items())
        # The routing sketch's tier-0 mirror: the same membership, in
        # registration order, at the same version.
        assert ta.index_snapshot() == ja.index_snapshot()
    assert evicted["t"] == evicted["j"] and len(evicted["t"]) > 10
    assert (ta.hit_tokens, ta.query_tokens) == (ja.hit_tokens, ja.query_tokens)
    assert ta.hit_rate == ja.hit_rate > 0


def _blk(rng, quant, shape=(2, 3, 8, 4)):
    k = rng.standard_normal(shape).astype(np.float32)
    blk = {"k": k, "v": -k}
    if quant:
        blk.update(k_scale=np.abs(k[..., 0]), v_scale=np.abs(k[..., 1]))
    return blk


def test_host_tier_matches_the_reference():
    """Puts past the byte budget (LRU eviction), consecutive
    ``match_blocks`` from a start, ``peek`` without an LRU touch, and
    ``clear``: the same blocks, order and bytes as the reference's."""
    rng = np.random.default_rng(3)
    blocks = [_blk(rng, i % 2) for i in range(12)]
    cap = 5 * sum(a.nbytes for a in blocks[0].values())
    jt, tt = jprefix.HostPrefixTier(8, cap), tprefix.HostPrefixTier(8, cap)
    digs = [bytes([i]) * 20 for i in range(12)]
    order = [0, 1, 2, 3, 1, 4, 5, 0, 6, 7, 2, 8, 9, 10, 11, 3]
    for i in order:
        got = tt.put(digs[i], {k: torch.from_numpy(v)
                               for k, v in blocks[i].items()})
        assert got == jt.put(digs[i], blocks[i])
        assert tt.bytes_used == jt.bytes_used and \
            tt.num_blocks == jt.num_blocks
        assert list(tt._blocks) == list(jt._blocks)
        for start in (0, 3, 7):
            want = jt.match_blocks(digs, start)
            got = tt.match_blocks(digs, start)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.keys() == w.keys()
                for k in w:
                    np.testing.assert_array_equal(g[k].numpy(), w[k])
        assert list(tt._blocks) == list(jt._blocks)
        d = digs[order[0]]
        assert (tt.peek(d) is None) == (jt.peek(d) is None)
        assert list(tt._blocks) == list(jt._blocks)
    assert tt.spilled_blocks == jt.spilled_blocks
    tt.clear()
    jt.clear()
    assert tt.bytes_used == jt.bytes_used == 0 and not tt.has(digs[11])


def test_prefix_kv_cache_matches_the_reference():
    """The slot cache's host prefix cache: put (shared blocks stored once,
    LRU eviction past the byte budget), match, get and missing_blocks, on
    the same prompts and K/V as the reference's."""
    rng = np.random.default_rng(4)
    block = 4
    kv = (rng.standard_normal((2, 1, 40, 3, 8)).astype(np.float32),)
    kv += (-kv[0],)
    blk_bytes = 2 * kv[0][:, :, :block].nbytes
    jc = jprefix.PrefixKVCache(block, 6 * blk_bytes)
    tc = tprefix.PrefixKVCache(block, 6 * blk_bytes)
    base = [int(x) for x in rng.integers(0, 50, 40)]
    prompts = [base[:13], base[:30], base[:8] + [7] * 10, base[:40],
               [1] * 9, base[:13]]
    for ids in prompts:
        for c in (jc, tc):
            c.record_query(len(ids), c.match(ids))
        assert tc.match(ids) == jc.match(ids)
        assert tc.missing_blocks(ids, len(ids)) == \
            jc.missing_blocks(ids, len(ids))
        jc.put(ids, kv[0], kv[1], len(ids))
        tc.put(ids, torch.from_numpy(kv[0]), torch.from_numpy(kv[1]),
               len(ids))
        assert tc.bytes_used == jc.bytes_used
        assert list(tc._blocks) == list(jc._blocks)
        plen = tc.match(ids)
        assert plen == jc.match(ids)
        if plen:
            for g, w in zip(tc.get(ids, plen), jc.get(ids, plen)):
                np.testing.assert_array_equal(g.numpy(), w)
    assert (tc.hit_tokens, tc.query_tokens, tc.hit_rate) == \
        (jc.hit_tokens, jc.query_tokens, jc.hit_rate)


@pytest.mark.parametrize("kv", ["bf16", "int8", "int4"])
def test_pool_page_copies_bit_exact_against_the_reference(kv):
    """``gather_pool_pages`` (duplicate padding pages included) and
    ``scatter_pool_pages`` of the first n_valid blocks: the staging blocks
    and the pool bytes after the scatter equal the reference's bit for
    bit, and a gather then a scatter into fresh pages round-trips."""
    cfg = get_config(NAME)
    rng = np.random.default_rng(8)
    quant = kv != "bf16"
    pool = ttf.init_paged_cache(cfg, 10, CHUNK, torch.bfloat16, "cpu",
                                quantized=quant,
                                kv_bits=4 if kv == "int4" else 8)
    for x in pool:
        if x is None:
            continue
        if x.dtype == torch.int8:
            x.copy_(torch.from_numpy(rng.integers(-127, 128, x.shape,
                                                  dtype=np.int8)))
        else:
            x.copy_(torch.from_numpy(rng.standard_normal(x.shape)
                                     .astype(np.float32)))
    jpool = jtf.PagedKVCache(*[None if x is None else jnp.asarray(_raw(x))
                              .view(jnp.bfloat16) if x.dtype ==
                              torch.bfloat16 else jnp.asarray(x.numpy())
                              for x in pool])
    pages = [7, 2, 5, 7]                         # a padded group of 4
    got = ttf.gather_pool_pages(pool, torch.tensor(pages))
    want = jtf.gather_pool_pages(jpool, jnp.asarray(pages, jnp.int32))
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(_raw(g), _raw(w))
    dest = [1, 9, 4, 4]
    jout = jtf.scatter_pool_pages(jpool, want[0], want[1],
                                  jnp.asarray(dest, jnp.int32),
                                  jnp.asarray(3, jnp.int32),
                                  k_scale=want[2], v_scale=want[3])
    ttf.scatter_pool_pages(pool, got[0], got[1], torch.tensor(dest), 3,
                           got[2], got[3])
    for t, j in zip(pool, jout):
        if t is not None:
            np.testing.assert_array_equal(_raw(t), _raw(j))
    for t in pool:
        if t is not None:
            for src, dst in zip(pages[:3], dest[:3]):
                assert torch.equal(t[:, src], t[:, dst])
    # The raw ops on a lone array, as the reference's.
    np.testing.assert_array_equal(
        _raw(tpa.paged_pool_gather(pool.k, torch.tensor(pages))),
        _raw(jpa.paged_pool_gather(jout.k, jnp.asarray(pages, jnp.int32))))


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def params():
    jparams = jtf.init_params(jax_get_config(NAME), jax.random.PRNGKey(3),
                              jnp.float32)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      get_config(NAME), "cpu")


def _workload(vocab):
    """The reference's tier workload: a warm prompt (2 pages + a tail),
    churn that evicts it from the device index, then the warm prompt again
    greedy and seeded."""
    warm = [int(x) % vocab for x in range(3, 36)]
    churn = [[(7 + i) % vocab] * 33 for i in range(5)]
    reqs = [("warm1", warm, 0.0, None),
            *[(f"churn{i}", c, 0.0, None) for i, c in enumerate(churn)],
            ("warm2", warm, 0.0, None), ("warm3", warm, 0.9, 21)]
    return [dict(rid=rid, ids=ids, params=dict(
        max_tokens=6, temperature=temp, top_p=0.9, top_k=40, seed=seed,
        ignore_eos=True)) for rid, ids, temp, seed in reqs]


def _set_env(monkeypatch, depth, mixed, host_mb):
    monkeypatch.setenv("ARKS_PIPELINE_DEPTH", str(depth))
    monkeypatch.setenv("ARKS_MIXED_STEP", mixed)
    monkeypatch.setenv("ARKS_PREFIX_HOST_MB", str(host_mb))


def _run(eng, reqs, make):
    """Each request alone, to the end (sequential: the batches are the
    same on every engine); returns [(ids, finish_reason)]."""
    out = []
    for r in reqs:
        req = make(r["rid"], r["ids"], r["params"])
        eng.add_request(req)
        for _ in range(4000):
            eng.step(block_s=0.01)
            if not (eng.num_running or not eng._queue.empty()
                    or eng._prefilling or eng._awaiting_restore):
                break
        ids = []
        while True:
            o = req.outputs.get(timeout=60)
            ids += o.token_ids
            if o.finished:
                out.append((ids, o.finish_reason))
                break
    return out


def _jax_make(rid, ids, p):
    return JaxRequest(rid, ids, JaxSamplingParams(**p))


def _torch_make(rid, ids, p):
    return Request(rid, ids, SamplingParams(**p))


def _torch_engine(tparams, **kw):
    return InferenceEngine(get_config(NAME), EngineConfig(
        **{**ENGINE_KW, "prefix_cache_mb": 0, "kv_layout": "paged", **kw}),
        ByteTokenizer(), params=tparams, device="cpu")


@pytest.fixture(scope="module")
def jax_tier_runs(params):
    """The JAX engine's streams and tier counters on the workload, per
    scheduler (depth 0; its streams are depth-invariant by contract)."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for mixed in ("0", "auto"):
            _set_env(mp, 0, mixed, 64)
            eng = JaxEngine(jax_get_config(NAME), JaxEngineConfig(
                **{**ENGINE_KW, "prefix_cache_mb": 0, "kv_layout": "paged"}),
                JaxByteTokenizer(), params=params[0])
            streams = _run(eng, _workload(get_config(NAME).vocab_size),
                           _jax_make)
            m = eng.metrics
            out[mixed] = (streams, dict(
                restore=m.prefix_restore_blocks_total.total(),
                spill=m.prefix_spill_blocks_total.total(),
                host=m.prefix_cache_hit_tokens_total.get(tier="host"),
                device=m.prefix_cache_hit_tokens_total.get(tier="device"),
                query=m.prefix_cache_query_tokens_total.total()))
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("mixed", ["0", "auto"],
                         ids=["paged-legacy", "paged-mixed"])
def test_streams_equal_the_jax_engine_and_the_tier_off(
        params, jax_tier_runs, monkeypatch, depth, mixed):
    """Greedy and seeded streams with the host tier on equal the JAX
    engine's with it on, the port's with it off, and the port's with no
    prefix reuse at all (the device index never matching); the tier
    counters (spills, restores, hit tokens by tier, query tokens) equal the
    JAX engine's."""
    want, counts = jax_tier_runs[mixed]
    runs = {}
    for tag, host_mb, no_match in (("on", 64, False), ("host off", 0, False),
                                   ("reuse off", 0, True)):
        _set_env(monkeypatch, depth, mixed, host_mb)
        eng = _torch_engine(params[1])
        if no_match:
            monkeypatch.setattr(eng._alloc, "match", lambda digests: [])
        runs[tag] = _run(eng, _workload(get_config(NAME).vocab_size),
                         _torch_make)
        assert (eng._host is not None) == bool(host_mb)
        if tag == "on":
            assert dict(
                restore=eng.prefix_restore_blocks_total,
                spill=eng.prefix_spill_blocks_total,
                host=eng.prefix_cache_hit_tokens_total["host"],
                device=eng.prefix_cache_hit_tokens_total["device"],
                query=eng.prefix_cache_query_tokens_total) == counts
            assert counts["restore"] > 0 and counts["spill"] > 0
        assert eng._alloc.free_pages + eng._alloc.retained_pages == \
            eng._alloc.num_pages
    assert runs["on"] == want
    assert runs["host off"] == want and runs["reuse off"] == want


def _warm_and_churn(eng):
    vocab = get_config(NAME).vocab_size
    warm = [int(x) % vocab for x in range(3, 36)]          # 33 tokens
    first = _run(eng, [dict(rid="w1", ids=warm, params=dict(
        max_tokens=4, temperature=0.0, ignore_eos=True))], _torch_make)
    _run(eng, [dict(rid=f"c{i}", ids=[(9 + i) % vocab] * 33, params=dict(
        max_tokens=3, temperature=0.0, ignore_eos=True)) for i in range(5)],
        _torch_make)
    return warm, first


def test_evicted_prefix_restores_with_zero_reprefill(params, monkeypatch):
    """After churn evicts the warm prompt's pages from the device index,
    its repeat restores them from the host tier: 32 host-hit tokens, only
    the 1-token tail prefilled, 2 pages restored (latency observed), the
    same stream, and the restored pages back in the device index."""
    _set_env(monkeypatch, 0, "auto", 64)
    eng = _torch_engine(params[1])
    warm, first = _warm_and_churn(eng)
    digs = tpaged.chain_digests(warm, CHUNK, 2)
    assert all(eng._host.has(d) for d in digs), "spill never landed"
    assert eng.prefix_spill_blocks_total >= 2
    p0 = eng.prefill_tokens_total
    h0 = eng.prefix_cache_hit_tokens_total["host"]
    again = _run(eng, [dict(rid="w2", ids=warm, params=dict(
        max_tokens=4, temperature=0.0, ignore_eos=True))], _torch_make)
    assert again == first
    assert eng.prefix_cache_hit_tokens_total["host"] - h0 == 32
    assert eng.prefill_tokens_total - p0 == len(warm) - 32
    assert eng.prefix_restore_blocks_total == 2
    assert len(eng.prefix_restore_seconds) == 1
    probe = eng._alloc.match(digs)
    assert len(probe) == 2
    eng._alloc.decref(probe)


@pytest.mark.parametrize("mixed", ["0", "auto"])
@pytest.mark.parametrize("kv", ["bf16", "int8", "int4"])
def test_spill_restore_bit_exact(params, monkeypatch, mixed, kv):
    """Spilled blocks carry the pool's raw bytes (bf16 rows; int8 and
    packed int4 pages with f32 scales) and a restore writes exactly those
    bytes back into fresh pages, on both paged schedulers."""
    _set_env(monkeypatch, 0, mixed, 64)
    eng = _torch_engine(params[1], kv_cache_dtype=kv)
    warm, first = _warm_and_churn(eng)
    digs = tpaged.chain_digests(warm, CHUNK, 2)
    assert all(eng._host.has(d) for d in digs), "spill never landed"
    host = [{k: v.clone() for k, v in eng._host.peek(d).items()}
            for d in digs]
    blk = host[0]
    assert blk["k"].dtype == (torch.bfloat16 if kv == "bf16" else torch.int8)
    assert ("k_scale" in blk) == (kv != "bf16")
    if kv == "int4":
        assert blk["k"].shape[-2] * 2 == blk["k_scale"].shape[-1]
    again = _run(eng, [dict(rid="w2", ids=warm, params=dict(
        max_tokens=4, temperature=0.0, ignore_eos=True))], _torch_make)
    assert again == first
    pages = eng._alloc.match(digs)
    assert len(pages) == 2
    for pg, b in zip(pages, host):
        for name, arr in zip(("k", "v", "k_scale", "v_scale"), eng.cache):
            if name in b:
                assert torch.equal(arr[:, pg], b[name])
    eng._alloc.decref(pages)


def _park_on_restore(eng, rid):
    """Evict the warm prompt to the host tier, then admit it again: it
    parks on its restore (admitted directly: on the CPU the scatter lands
    at once, and the next step would unpark it)."""
    warm, _ = _warm_and_churn(eng)
    req = Request(rid, warm, SamplingParams(max_tokens=4, temperature=0.0,
                                           ignore_eos=True))
    assert eng._preadmit(req) is None
    return req


def test_abort_while_parked_on_restore(params, monkeypatch):
    """An abort raised while the request is parked on a restore finishes
    it as "abort" and releases every page it held; engine exit ends a
    parked request as "abort" too."""
    _set_env(monkeypatch, 0, "auto", 64)
    eng = _torch_engine(params[1])
    req = _park_on_restore(eng, "victim")
    assert eng._awaiting_restore, "request never parked on the restore"
    assert not eng.idle
    eng.abort("victim")
    for _ in range(10):
        eng.step(block_s=0.001)
    out = req.outputs.get(timeout=10)
    assert out.finished and out.finish_reason == "abort"
    assert not eng._awaiting_restore and eng.idle
    assert eng._alloc.free_pages == \
        eng._alloc.num_pages - eng._alloc.retained_pages
    req = _park_on_restore(eng, "parked")
    assert eng._awaiting_restore
    eng._abort_awaiting_restores()
    out = req.outputs.get(timeout=10)
    assert out.finished and out.finish_reason == "abort"


@pytest.mark.parametrize("mixed", ["0", "auto"])
def test_device_prefix_reuse_equals_the_jax_engine(params, monkeypatch,
                                                   mixed):
    """The device index alone (the retention pages of prefix_cache_mb, no
    host tier): a prompt repeated, then one sharing its two pages with a
    new tail: the same streams and device-hit tokens as the JAX engine,
    and the warm prompts prefill only their tails."""
    vocab = get_config(NAME).vocab_size
    shared = [int(x) % vocab for x in range(7, 39)]        # 32 tokens
    reqs = [dict(rid="p1", ids=shared, params=dict(max_tokens=6,
                                                   temperature=0.0,
                                                   ignore_eos=True)),
            dict(rid="p2", ids=shared, params=dict(max_tokens=6,
                                                   temperature=0.0,
                                                   ignore_eos=True)),
            dict(rid="w", ids=shared + [3, 4, 5, 6, 7, 8, 9, 10],
                 params=dict(max_tokens=5, temperature=0.8, top_k=20,
                             seed=4, ignore_eos=True))]
    _set_env(monkeypatch, 0, mixed, 0)
    jeng = JaxEngine(jax_get_config(NAME), JaxEngineConfig(
        **{**ENGINE_KW, "prefix_cache_mb": 64, "kv_layout": "paged"}),
        JaxByteTokenizer(), params=params[0])
    want = _run(jeng, reqs, _jax_make)
    teng = _torch_engine(params[1], prefix_cache_mb=64)
    assert teng._alloc.num_pages == jeng._alloc.num_pages
    got = _run(teng, reqs[:1], _torch_make)
    p0 = teng.prefill_tokens_total
    got += _run(teng, reqs[1:], _torch_make)
    assert got == want
    # p2 hits one page (32 tokens: one tail token left), w both pages.
    assert teng.prefix_cache_hit_tokens_total["device"] == \
        jeng.metrics.prefix_cache_hit_tokens_total.get(tier="device") == 48
    assert teng.prefill_tokens_total - p0 == (32 - 16) + (40 - 32)
    assert teng._alloc.hit_rate == jeng._alloc.hit_rate


def test_slot_cache_prefix_reuse_equals_the_jax_engine(params, monkeypatch):
    """The slot cache's host prefix cache: a one-shot prompt harvested and
    repeated, a shared prefix with a divergent tail, and a chunk-prefilled
    prompt harvested through ``extract``: the same streams and host-hit
    tokens as the JAX engine's slot layout, equal to a cold engine's, and
    the tails alone prefilled."""
    vocab = get_config(NAME).vocab_size
    shared = [int(x) % vocab for x in range(7, 39)]        # 32: one-shot
    long = [int(x) % vocab for x in range(3, 51)]          # 48: chunked
    greedy = dict(max_tokens=5, temperature=0.0, ignore_eos=True)
    reqs = [dict(rid="p1", ids=shared, params=greedy),
            dict(rid="p2", ids=shared, params=greedy),
            dict(rid="w", ids=shared + [3, 4, 5, 6, 7, 8, 9, 10],
                 params=greedy),
            dict(rid="h1", ids=long, params=greedy),
            dict(rid="h2", ids=long, params=dict(greedy, temperature=0.7,
                                                 seed=9))]
    _set_env(monkeypatch, 0, "0", 0)
    kw = {**ENGINE_KW, "kv_layout": "slot"}
    jeng = JaxEngine(jax_get_config(NAME), JaxEngineConfig(
        **kw, prefix_cache_mb=64), JaxByteTokenizer(), params=params[0])
    want = _run(jeng, reqs, _jax_make)
    teng = InferenceEngine(get_config(NAME), EngineConfig(
        **kw, prefix_cache_mb=64), ByteTokenizer(), params=params[1],
        device="cpu")
    cold = InferenceEngine(get_config(NAME), EngineConfig(
        **kw, prefix_cache_mb=0), ByteTokenizer(), params=params[1],
        device="cpu")
    assert teng._prefix is not None and cold._prefix is None
    got = _run(teng, reqs, _torch_make)
    assert got == want == _run(cold, reqs, _torch_make)
    assert teng._prefix.hit_tokens == jeng._prefix.hit_tokens == 16 + 32 + 32
    assert teng.prefix_cache_hit_tokens_total["host"] == 80
    assert teng._prefix.match(long) == jeng._prefix.match(long) == 48
    assert teng.prefill_tokens_total == cold.prefill_tokens_total - 80


def test_prefix_knobs_build_their_tiers_and_bad_budgets_raise(
        monkeypatch, tmp_path):
    """The disk tier and peer fetch are served: each knob builds its tier
    (the disk tier behind the host tier, the fetch worker, the peer list);
    preemptive swap is served (``test_torch_preempt.py``); a negative
    budget raises."""
    for name, value, built in (
            ("ARKS_PREFIX_DISK_MB", "64",
             lambda e: e._disk is not None and e._disk.capacity == 64 << 20),
            ("ARKS_PEER_FETCH", "1",
             lambda e: e._peer_fetch and e._fetch_queue is not None),
            ("ARKS_PEER_ADDRS", "http://localhost:1",
             lambda e: e._peer_addrs == ["http://localhost:1"])):
        with monkeypatch.context() as m:
            m.setenv(name, value)
            m.setenv("ARKS_PREFIX_DISK_DIR", str(tmp_path))
            eng = _torch_engine(None)
            assert built(eng), name
            eng.stop()
    with monkeypatch.context() as m:
        m.setenv("ARKS_PREEMPT", "1")
        assert _torch_engine(None).resolved_config["preempt"] != "off"
    monkeypatch.setenv("ARKS_PREFIX_HOST_MB", "-1")
    with pytest.raises(ValueError):
        _torch_engine(None)
    with pytest.raises(ValueError):
        EngineConfig(prefix_cache_mb=-1).validate()


@pytest.mark.parametrize("layout", ["paged", "slot"])
def test_engine_with_tiers_is_freed_without_a_gc_pass(monkeypatch, layout):
    """The host tier's spill hook holds no reference to the engine: an
    engine dropped by ``del`` frees its pool at once (a cycle would keep
    it, and a 50 GB model's weights, alive until a GC pass)."""
    import gc
    import weakref
    _set_env(monkeypatch, 0, "auto", 64)
    gc.disable()
    try:
        eng = _torch_engine(None, kv_layout=layout, prefix_cache_mb=64)
        assert (eng._host is not None) == (layout == "paged")
        ref = weakref.ref(eng)
        del eng
        assert ref() is None
    finally:
        gc.enable()

"""The port's engine against the JAX engine on the same weights: identical
greedy token streams on the f32 ``tiny`` and ``tiny-gqa`` configs (pools
of the engine dtype, bf16 under the f32 engine, int8 and int4), and
identical seeded sampled streams, with more requests than slots and
prompts spanning several chunks."""

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
from arks_tpu_torch.engine.tokenizer import ByteTokenizer
from arks_tpu_torch.models import get_config
from arks_tpu_torch.models.weights import params_from_numpy

torch.set_num_threads(2)

ENGINE_KW = dict(num_slots=2, max_cache_len=64, steps_per_dispatch=4,
                 prefill_chunk=16, dtype="float32")


def _prompts(vocab):
    rng = np.random.default_rng(7)
    lens = [3, 20, 48, 10, 33]     # 48 and 33 span 3 chunks of 16
    return [[int(x) for x in rng.integers(2, vocab, n)] for n in lens]


def _collect(outputs, timeout=120):
    ids, fin = [], None
    while True:
        out = outputs.get(timeout=timeout)
        ids.extend(out.token_ids)
        if out.finished:
            return ids, out


def _drive(engine, busy, n_steps=500):
    for _ in range(n_steps):
        engine.step(block_s=0.01)
        if not busy(engine):
            return
    raise AssertionError("engine did not drain")


def _sampling(i, max_tokens, seed):
    """Request i's sampling fields: greedy, or seeded top-k/top-p draws
    at temperature 0.8 with seed ``seed + i``."""
    if seed is None:
        return dict(max_tokens=max_tokens, temperature=0.0, ignore_eos=True)
    return dict(max_tokens=max_tokens, temperature=0.8, top_k=20, top_p=0.9,
                seed=seed + i, ignore_eos=True)


def _jax_streams(name, params, prompts, max_tokens, monkeypatch, *,
                 kv="auto", seed=None):
    monkeypatch.setenv("ARKS_MIXED_STEP", "1")
    ecfg = JaxEngineConfig(model=name, prefill_buckets=(8, 16, 32),
                           kv_layout="paged", kv_cache_dtype=kv, **ENGINE_KW)
    eng = JaxEngine(jax_get_config(name), ecfg, JaxByteTokenizer(),
                    params=params)
    assert eng._mixed and eng._paged
    reqs = [JaxRequest(f"r{i}", p, JaxSamplingParams(
        **_sampling(i, max_tokens, seed))) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    _drive(eng, lambda e: e.num_running or not e._queue.empty()
           or e._prefilling)
    return [_collect(r.outputs) for r in reqs]


def _torch_streams(name, params, prompts, max_tokens, *, kv="auto",
                   seed=None):
    eng = InferenceEngine(get_config(name), EngineConfig(
        model=name, kv_cache_dtype=kv, **ENGINE_KW), ByteTokenizer(),
        params=params, device="cpu")
    reqs = [Request(f"r{i}", p, SamplingParams(
        **_sampling(i, max_tokens, seed))) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    _drive(eng, lambda e: not e.idle)
    return [_collect(r.outputs) for r in reqs], eng


def _params(name, key):
    jparams = jtf.init_params(jax_get_config(name), jax.random.PRNGKey(key),
                              jnp.float32)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      get_config(name), "cpu")


@pytest.mark.parametrize("name", ["tiny", "tiny-gqa"])
def test_greedy_streams_match_jax_engine(name, monkeypatch):
    jparams, tparams = _params(name, 3)
    prompts = _prompts(jax_get_config(name).vocab_size)
    want = _jax_streams(name, jparams, prompts, 7, monkeypatch)
    got, eng = _torch_streams(name, tparams, prompts, 7)
    _same_streams(want, got)
    assert eng._alloc.free_pages == \
        eng._alloc.num_pages - eng._alloc.retained_pages   # all pages back


@pytest.mark.parametrize("kv", ["int8", "int4"])
@pytest.mark.parametrize("name", ["tiny", "tiny-gqa"])
def test_quantized_pool_greedy_streams_match_jax_engine(name, kv,
                                                        monkeypatch):
    """int8/int4 KV pools: the JAX engine runs its XLA oracle path, the
    port the plain versions of its kernels; the greedy streams agree."""
    jparams, tparams = _params(name, 3)
    prompts = _prompts(jax_get_config(name).vocab_size)
    want = _jax_streams(name, jparams, prompts, 7, monkeypatch, kv=kv)
    got, eng = _torch_streams(name, tparams, prompts, 7, kv=kv)
    assert eng.kv_quantized and eng.kv_bits == (8 if kv == "int8" else 4)
    assert eng.cache.k.dtype == torch.int8 and eng.cache.k_scale is not None
    _same_streams(want, got)


@pytest.mark.parametrize("name", ["tiny", "tiny-gqa"])
def test_f32_engine_bf16_cache_greedy_streams_match_jax_engine(
        name, monkeypatch):
    """An f32 engine over a bf16 pool (the reference's _cache_dtype stores
    bf16 whatever the engine dtype): the port stores bf16 rows (rounded
    to nearest even) and reads them widened to f32, as the reference's
    Pallas kernels do (``astype(q.dtype)``), so the JAX engine runs those
    kernels here (``ARKS_ATTN_IMPL=pallas``, interpreted).  Its XLA
    oracle instead rounds the normalized probabilities to the cache's
    bf16, and on ``tiny``'s second prompt a near-tie of two logits falls
    the other way between the reference's own two paths.  The greedy
    streams are the JAX engine's."""
    monkeypatch.setenv("ARKS_ATTN_IMPL", "pallas")
    jparams, tparams = _params(name, 3)
    prompts = _prompts(jax_get_config(name).vocab_size)
    want = _jax_streams(name, jparams, prompts, 7, monkeypatch, kv="bf16")
    got, eng = _torch_streams(name, tparams, prompts, 7, kv="bf16")
    assert eng.cache.k.dtype == torch.bfloat16 and not eng.kv_quantized
    assert eng.params["layers"]["attn_norm"].dtype == torch.float32
    _same_streams(want, got)
    assert eng._alloc.free_pages == \
        eng._alloc.num_pages - eng._alloc.retained_pages


def test_f32_engine_bf16_cache_known_stream(monkeypatch):
    """The reference's PRNGKey(3) weights of ``tiny``, prompt [5..10]: both
    engines give [422, 505, 428, 390, 413] over a bf16 pool."""
    jparams, tparams = _params("tiny", 3)
    prompt = [list(range(5, 11))]
    want = _jax_streams("tiny", jparams, prompt, 5, monkeypatch, kv="bf16")
    got, _ = _torch_streams("tiny", tparams, prompt, 5, kv="bf16")
    assert want[0][0] == got[0][0] == [422, 505, 428, 390, 413]


@pytest.mark.parametrize("seed", [5, 2**33 + 7])
def test_seeded_streams_match_jax_engine(seed, monkeypatch):
    """Seeded draws at temperature 0.8 with top-k and top-p: the port's
    threefry keys give the JAX engine's token streams (the second seed is
    masked to 32 bits on both sides)."""
    name = "tiny-gqa"
    jparams, tparams = _params(name, 5)
    prompts = _prompts(jax_get_config(name).vocab_size)
    want = _jax_streams(name, jparams, prompts, 9, monkeypatch, seed=seed)
    got, _ = _torch_streams(name, tparams, prompts, 9, seed=seed)
    _same_streams(want, got)
    assert len({tuple(ids) for ids, _ in got}) == len(prompts)


def _same_streams(want, got):
    for (w_ids, w_fin), (g_ids, g_fin) in zip(want, got, strict=True):
        assert g_ids == w_ids
        assert (g_fin.finish_reason, g_fin.num_prompt_tokens,
                g_fin.num_generated_tokens) == (
            w_fin.finish_reason, w_fin.num_prompt_tokens,
            w_fin.num_generated_tokens)


def test_mixed_token_budget_matches_jax_engine(monkeypatch):
    """``ARKS_MIXED_CHUNK_TOKENS`` below the chunk, read by both engines:
    the same greedy streams, and the port's fill never puts more than the
    budget of prefill tokens in a dispatch, filling it whenever enough
    prompt is left and sharing it between prefilling sequences."""
    budget = 10
    monkeypatch.setenv("ARKS_MIXED_CHUNK_TOKENS", str(budget))
    name = "tiny-gqa"
    jparams = jtf.init_params(jax_get_config(name), jax.random.PRNGKey(4),
                              jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                get_config(name), "cpu")
    prompts = _prompts(get_config(name).vocab_size)
    fills = []
    fill = InferenceEngine._fill_chunk_lanes

    def spy(self, a, t):
        out = fill(self, a, t)
        left = sum(len(st.ids) - st.pos for st in self._prefilling.values())
        fills.append((left, [take for _, take in out[1]]))
        return out

    monkeypatch.setattr(InferenceEngine, "_fill_chunk_lanes", spy)
    want = _jax_streams(name, jparams, prompts, 5, monkeypatch)
    got, eng = _torch_streams(name, tparams, prompts, 5)
    assert eng._mixed_budget == budget
    assert [ids for ids, _ in got] == [ids for ids, _ in want]
    assert all(sum(takes) == min(left, budget) for left, takes in fills)
    assert any(len(takes) == 2 for _, takes in fills)
    assert sum(sum(takes) for _, takes in fills) == sum(map(len, prompts))

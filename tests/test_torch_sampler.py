"""The port's sampler against the reference's: greedy ties, the filtered
top-k/top-p window, threefry draws and key carries identical to
``jax.random`` on the same keys, and seeded requests whose tokens depend
on their seed alone."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arks_tpu.engine import sampler as jsampler
from arks_tpu_torch.engine import EngineConfig, InferenceEngine, Request, \
    SamplingParams
from arks_tpu_torch.engine import prng
from arks_tpu_torch.engine import sampler as tsampler
from arks_tpu_torch.engine.tokenizer import ByteTokenizer
from arks_tpu_torch.models import get_config

torch.set_num_threads(2)


def _case(seed, b=6, v=300):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, v)).astype(np.float32) * 3
    temp = np.array([0.0, 0.7, 1.0, 1.3, 0.5, 2.0][:b], np.float32)
    top_p = np.array([1.0, 0.9, 0.5, 1.0, 0.95, 0.3][:b], np.float32)
    top_k = np.array([0, 40, 0, 5, 64, 1][:b], np.int32)
    return logits, temp, top_p, top_k


def test_greedy_first_index_wins_ties():
    logits = np.zeros((3, 50), np.float32)
    logits[0, [7, 3, 40]] = 2.0
    logits[1, [49, 0]] = 1.0
    want = np.asarray(jnp.argmax(jnp.asarray(logits), axis=-1))
    state = tsampler.init_sampling_state(3, vocab_size=50)
    got, after = tsampler.sample(torch.from_numpy(logits), state,
                                 gates=tsampler.OFF)
    assert got.dtype == torch.int32 and after.key is state.key
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filtered_window_matches_jax(seed):
    logits, temp, top_p, top_k = _case(seed)
    state = SimpleNamespace(temperature=jnp.asarray(temp),
                            top_p=jnp.asarray(top_p),
                            top_k=jnp.asarray(top_k))
    w_scaled, w_idx = jsampler._filtered_scaled(jnp.asarray(logits), state)
    g_scaled, g_idx = tsampler._filtered_scaled(
        torch.from_numpy(logits), SimpleNamespace(
            temperature=torch.from_numpy(temp), top_p=torch.from_numpy(top_p),
            top_k=torch.from_numpy(top_k)))
    np.testing.assert_array_equal(g_idx.numpy(), np.asarray(w_idx))
    w_scaled = np.asarray(w_scaled)
    np.testing.assert_array_equal(np.isinf(g_scaled.numpy()),
                                  np.isinf(w_scaled))
    keep = ~np.isinf(w_scaled)
    np.testing.assert_allclose(g_scaled.numpy()[keep], w_scaled[keep],
                               atol=1e-6, rtol=1e-6)


def _keys(seeds):
    return np.stack([jsampler.np_prng_key(s) for s in seeds])


@pytest.mark.parametrize("seed", [3, 4])
def test_gumbel_max_draw_with_given_noise(seed):
    """The draw with lane keys is the reference's ``sample``: argmax of
    the filtered window plus the Gumbel noise of each lane's step key;
    greedy lanes take the argmax; active lanes carry the split key on and
    inactive lanes keep theirs."""
    logits, temp, top_p, top_k = _case(seed)
    keys = _keys(range(seed * 10, seed * 10 + len(temp)))
    active = np.array([True, True, False, True, True, False])
    state = jsampler.init_sampling_state(
        len(temp), vocab_size=logits.shape[1])._replace(
        temperature=jnp.asarray(temp), top_p=jnp.asarray(top_p),
        top_k=jnp.asarray(top_k), key=jnp.asarray(keys))
    want, wstate = jsampler.sample(jnp.asarray(logits), state,
                                   jnp.asarray(active))
    tstate = tsampler.init_sampling_state(
        len(temp), vocab_size=logits.shape[1])._replace(
        temperature=torch.from_numpy(temp), top_p=torch.from_numpy(top_p),
        top_k=torch.from_numpy(top_k), key=prng.key_tensor(keys))
    got, after = tsampler.sample(torch.from_numpy(logits), tstate,
                                 torch.from_numpy(active))
    carry = after.key
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(carry.numpy(),
                                  np.asarray(wstate.key).astype(np.int64))
    np.testing.assert_array_equal(carry.numpy()[~active], keys[~active])


def test_gumbel_noise_reproducible_per_generator():
    """Each lane's noise comes from its own key alone: the same key gives
    the same row whatever the other lanes hold, and finite values."""
    a = prng.gumbel(prng.key_tensor(_keys([1, 7, 2])), 64)
    b = prng.gumbel(prng.key_tensor(_keys([1, 8, 3])), 64)
    assert torch.equal(a[0], b[0]) and not torch.equal(a[2], b[2])
    assert torch.isfinite(a).all() and a.dtype == torch.float32


def _sampled_run(seed, prompts):
    eng = InferenceEngine(get_config("tiny-gqa"), EngineConfig(
        model="tiny-gqa", num_slots=2, max_cache_len=64, prefill_chunk=16,
        dtype="float32", seed=3), ByteTokenizer(), device="cpu")
    reqs = [Request(f"r{i}", p, SamplingParams(
        max_tokens=8, temperature=0.9, top_p=0.95, top_k=20, seed=seed + i,
        ignore_eos=True)) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    for _ in range(300):
        eng.step(block_s=0.01)
        if eng.idle:
            break
    out = []
    for r in reqs:
        ids = []
        while True:
            o = r.outputs.get(timeout=30)
            ids += o.token_ids
            if o.finished:
                break
        out.append(ids)
    return out


def test_seeded_sampling_reproduces_across_batches():
    """A seeded request's tokens depend on its seed only, not on which
    other requests share its dispatches."""
    prompts = [[5, 6, 7], list(range(3, 40)), [9] * 10]
    together = _sampled_run(100, prompts)
    alone = _sampled_run(100 + 1, prompts[1:2])
    assert together[1] == alone[0]
    assert together != _sampled_run(200, prompts)

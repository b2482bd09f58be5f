"""``mixed_step`` of the port against the JAX ``mixed_step`` on the same
weights and batches: decode lanes, prefill chunks crossing pages, and lanes
whose prompt completes inside the batch.  Logits within f32 atol 1e-4 (bf16:
atol 5e-2) with the same argmax, and the pool contents after each step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arks_tpu.models import get_config as jax_get_config
from arks_tpu.models import transformer as jtf
from arks_tpu_torch.models import get_config
from arks_tpu_torch.models import transformer as ttf
from arks_tpu_torch.models.weights import params_from_numpy

torch.set_num_threads(2)

PAGE, MAX_PAGES, NUM_PAGES, LANES = 16, 4, 10, 3
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
KV_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _steps(vocab):
    """Two mixed batches over 3 lanes.  Step 1: lane 0 prefills its whole
    20-token prompt (completes, crosses a page), lane 1 the first 12 of 30.
    Step 2: lane 0 decodes, lane 1 finishes its prompt (completes), lane 2
    starts a prompt; then two padding tokens."""
    rng = np.random.default_rng(3)
    p0 = rng.integers(2, vocab, 20)
    p1 = rng.integers(2, vocab, 30)
    p2 = rng.integers(2, vocab, 9)
    sentinel = MAX_PAGES * PAGE
    step1 = [(0, p0, 0, True), (1, p1[:12], 0, False)]
    step2 = [(0, np.array([7]), 20, True), (1, p1[12:], 12, True),
             (2, p2, 0, False)]
    out = []
    for lanes, pad in ((step1, 0), (step2, 2)):
        tokens, slot, pos = [], [], []
        q_start = np.zeros(LANES, np.int32)
        q_len = np.zeros(LANES, np.int32)
        pos_start = np.zeros(LANES, np.int32)
        sample_src = np.zeros(LANES, np.int32)
        for lane, ids, p_start, samples in lanes:
            q_start[lane] = len(tokens)
            q_len[lane] = len(ids)
            pos_start[lane] = p_start
            tokens += [int(x) for x in ids]
            slot += [lane] * len(ids)
            pos += list(range(p_start, p_start + len(ids)))
            if samples:
                sample_src[lane] = len(tokens) - 1
        tokens += [0] * pad
        slot += [-1] * pad
        pos += [sentinel] * pad
        out.append(dict(tokens=np.array(tokens, np.int32),
                        token_slot=np.array(slot, np.int32),
                        token_pos=np.array(pos, np.int32),
                        sample_src=sample_src, seq_q_start=q_start,
                        seq_q_len=q_len, seq_pos_start=pos_start))
    return out


_KEYS = ("tokens", "token_slot", "token_pos", "sample_src", "seq_q_start",
         "seq_q_len", "seq_pos_start")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["tiny", "tiny-gqa"])
def test_mixed_step_matches_jax(name, dtype):
    jcfg, tcfg = jax_get_config(name), get_config(name)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(1), jnp.dtype(dtype))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    jcache = jtf.init_paged_cache(jcfg, NUM_PAGES, PAGE, jnp.dtype(dtype))
    tcache = ttf.init_paged_cache(tcfg, NUM_PAGES, PAGE, dtype, "cpu")
    tables = np.stack([np.random.default_rng(9).permutation(NUM_PAGES)
                       [i * 3:(i + 1) * 3].tolist() + [0]
                       for i in range(LANES)]).astype(np.int32)
    tol = TOL[dtype]
    for batch in _steps(jcfg.vocab_size):
        want, jcache = jtf.mixed_step(
            jparams, jcfg, jcache, jnp.asarray(tables),
            *(jnp.asarray(batch[k]) for k in _KEYS))
        got = ttf.mixed_step(tparams, tcfg, tcache, torch.from_numpy(tables),
                             *(torch.from_numpy(batch[k]) for k in _KEYS))
        want = np.asarray(want)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)
        np.testing.assert_array_equal(got.numpy().argmax(-1),
                                      want.argmax(-1))
        for t_pool, j_pool in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
            np.testing.assert_allclose(_f32(t_pool), _f32(j_pool),
                                       atol=KV_TOL[dtype], rtol=0)

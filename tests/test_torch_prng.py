"""The port's threefry (``arks_tpu_torch/engine/prng.py``) against
``jax.random`` in the mode the reference runs in (partitionable threefry,
"low" Gumbel): the key words of ``split`` and ``fold_in``, the bits of
``random_bits``, the floats of ``uniform`` and the draws of
``categorical``, bit for bit, over 64 seeds.  Keys come from
``np_prng_key``, including seeds past 2**32 and negative seeds, which
both sides mask to 32 bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arks_tpu.engine import sampler as jsampler
from arks_tpu_torch.engine import prng

torch.set_num_threads(2)

SEEDS = list(range(56)) + [2**32, 2**32 + 1, 2**35 + 7, 2**63 - 1, -1, -2,
                           -12345, -(2**40)]
assert len(SEEDS) == 64


def _keys():
    jk = np.stack([jsampler.np_prng_key(s) for s in SEEDS])
    tk = np.stack([prng.np_prng_key(s) for s in SEEDS])
    np.testing.assert_array_equal(tk, jk)
    return jk, prng.key_tensor(tk)


def _u64(x):
    return np.asarray(x).astype(np.int64)


def test_np_prng_key_masks_seeds():
    for s in SEEDS:
        k = prng.np_prng_key(s)
        assert k.dtype == np.uint32 and k[0] == 0 and k[1] == s % 2**32


@pytest.mark.parametrize("num", [2, 3])
def test_split_bit_exact(num):
    jk, tk = _keys()
    want = np.stack([_u64(jax.random.split(k, num)) for k in jk])
    got = prng.split(tk, num)
    assert got.shape == (len(SEEDS), num, 2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("data", [0, 1, 7, 2**32 - 1])
def test_fold_in_bit_exact(data):
    jk, tk = _keys()
    want = np.stack([_u64(jax.random.fold_in(k, np.uint32(data)))
                     for k in jk])
    np.testing.assert_array_equal(prng.fold_in(tk, data).numpy(), want)


def test_random_bits_bit_exact():
    jk, tk = _keys()
    want = np.stack([_u64(jax.random.bits(k, (100,), jnp.uint32))
                     for k in jk])
    np.testing.assert_array_equal(prng.random_bits(tk, 100).numpy(), want)


def test_uniform_bit_exact():
    jk, tk = _keys()
    tiny = float(np.finfo(np.float32).tiny)
    for lo, hi in ((0.0, 1.0), (tiny, 1.0)):
        want = np.stack([np.asarray(jax.random.uniform(
            k, (64,), minval=lo, maxval=hi)) for k in jk])
        got = prng.uniform(tk, 64, lo, hi).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def test_gumbel_matches_jax():
    """The noise goes through two logs, whose last bit may differ between
    XLA's CPU log and torch's: within 4 float32 ulps of 1."""
    jk, tk = _keys()
    want = np.stack([np.asarray(jax.random.gumbel(k, (64,))) for k in jk])
    got = prng.gumbel(tk, 64).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=4.8e-7)


@pytest.mark.parametrize("width", [64, 50])
def test_categorical_bit_exact(width):
    """The draws, with filtered (-inf) entries as the sampler makes them."""
    jk, tk = _keys()
    rng = np.random.default_rng(width)
    logits = (rng.standard_normal((len(SEEDS), width)) * 2).astype(
        np.float32)
    logits[rng.random(logits.shape) < 0.3] = -np.inf
    logits[:, 0] = 1.0
    want = np.asarray(jax.vmap(jax.random.categorical)(
        jnp.asarray(jk), jnp.asarray(logits)))
    got = prng.categorical(tk, torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(got.tolist())) > 8           # the draws do vary

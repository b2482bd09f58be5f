"""The legacy scheduler's model functions of the port against the JAX
reference on the same weights (``params_from_numpy``) and inputs:
``prefill``, ``prefill_chunk``, ``insert_batch``, ``insert_pages_batch``,
``prefill_chunk_paged`` and ``decode_step`` on the slot cache and on the
paged pool, with f32, bf16 and int8 caches, over ``tiny`` and
``tiny-gqa``.

Tolerances: f32 logits within 1e-5 of the largest |logit| (bf16: 5e-2
absolute, the slice-1 limit: the two frameworks round bf16 at other
places) with the same argmax; caches on the rows the reference wrote
within 1e-5 in f32.  An int8 cache is held to its scales within 1e-5
relative and its values within one quantization step (a row that differs
by f32 rounding may land on the other side of a rounding edge); the
inserts quantize identical rows and are held bit for bit."""

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

NAMES = ["tiny", "tiny-gqa"]


def _params(name, dtype="float32", seed=1):
    jcfg, tcfg = jax_get_config(name), get_config(name)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(seed),
                              jnp.dtype(dtype))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    return jcfg, tcfg, jparams, tparams


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _assert_logits(got, want, dtype="float32"):
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape
    tol = 1e-5 * np.abs(want).max() if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))


def _assert_cache(got, want, quantized, sl=(slice(None),)):
    """Every K/V leaf of two caches on the index ``sl``: f32 within 1e-5,
    int8 values within one step and scales within 1e-5 relative."""
    names = ("k", "v", "k_scale", "v_scale") if quantized else ("k", "v")
    for name in names:
        g = _f32(getattr(got, name))[sl]
        w = _f32(getattr(want, name))[sl]
        if name.endswith("scale"):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0)
        elif quantized:
            assert np.abs(g - w).max() <= 1
        else:
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_prefill_matches_jax(name, dtype):
    """Two padded prompts (16 and 9 tokens in a bucket of 16): last-token
    logits and the per-layer K/V that the insert takes."""
    jcfg, tcfg, jparams, tparams = _params(name, dtype)
    rng = np.random.default_rng(2)
    tokens = rng.integers(2, jcfg.vocab_size, (2, 16)).astype(np.int32)
    tokens[1, 9:] = 0
    lengths = np.array([16, 9], np.int32)
    want, wk, wv = jax.jit(jtf.prefill, static_argnums=1)(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(lengths))
    got, gk, gv = ttf.prefill(tparams, tcfg, torch.from_numpy(tokens),
                              torch.from_numpy(lengths))
    _assert_logits(got, want, dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for g, w in ((gk, wk), (gv, wv)):
        assert g.shape == w.shape
        np.testing.assert_allclose(_f32(g), _f32(w), atol=tol, rtol=0)


def _jcache(jcfg, slots, max_len, quantized):
    return jtf.init_cache(jcfg, slots, max_len, jnp.float32,
                          quantized=quantized)


def _tcache(tcfg, slots, max_len, quantized):
    return ttf.init_cache(tcfg, slots, max_len, torch.float32, "cpu",
                          quantized=quantized)


@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("name", NAMES)
def test_prefill_chunk_matches_jax(name, kv):
    """A 37-token prompt in chunks of 16 into slot 1 of a 64-row cache:
    each chunk's logits (meaningful on the last) and the whole cache after
    each chunk, padding rows of the last chunk included."""
    jcfg, tcfg, jparams, tparams = _params(name)
    quant = kv == "int8"
    jcache = _jcache(jcfg, 2, 64, quant)
    tcache = _tcache(tcfg, 2, 64, quant)
    ids = np.random.default_rng(3).integers(2, jcfg.vocab_size, 37)
    fn = jax.jit(jtf.prefill_chunk, static_argnums=1)
    for start in range(0, 37, 16):
        chunk = np.zeros(16, np.int32)
        valid = min(16, 37 - start)
        chunk[:valid] = ids[start:start + valid]
        want, jcache = fn(jparams, jcfg, jcache, jnp.int32(1),
                          jnp.asarray(chunk), jnp.int32(start),
                          jnp.int32(valid))
        got = ttf.prefill_chunk(tparams, tcfg, tcache, 1,
                                torch.from_numpy(chunk), start, valid)
        _assert_logits(got, want)
        _assert_cache(tcache, jcache, quant)


def _prefill_kv(jcfg, m, t, seed):
    """Time-major prefill K/V [L, M, T, Hkv, D] f32 from numpy."""
    rng = np.random.default_rng(seed)
    shape = (jcfg.num_layers, m, t, jcfg.num_kv_heads, jcfg.head_dim)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _assert_bits(got, want, quantized):
    names = ("k", "v", "k_scale", "v_scale") if quantized else ("k", "v")
    for name in names:
        np.testing.assert_array_equal(_bits(getattr(got, name).numpy()),
                                      _bits(getattr(want, name)))


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_insert_batch_bit_exact(kv):
    """Two prompts' K/V (bucket 16) into slots 2 and 0 of three: values
    (int8: quantized values and scales) bit for bit; slot 1 untouched."""
    jcfg, tcfg = jax_get_config("tiny-gqa"), get_config("tiny-gqa")
    quant = kv == "int8"
    k, v = _prefill_kv(jcfg, 2, 16, 4)
    slots = np.array([2, 0], np.int32)
    want = jax.jit(jtf.insert_batch)(_jcache(jcfg, 3, 32, quant),
                                     jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(slots))
    got = _tcache(tcfg, 3, 32, quant)
    ttf.insert_batch(got, torch.from_numpy(k), torch.from_numpy(v), slots)
    _assert_bits(got, want, quant)
    assert not got.k[:, 1].any() and got.k[:, 2].any()
    one = _tcache(tcfg, 3, 32, quant)
    ttf.insert(one, torch.from_numpy(k[:, :1]), torch.from_numpy(v[:, :1]), 2)
    np.testing.assert_array_equal(one.k[:, 2].numpy(), got.k[:, 2].numpy())


@pytest.mark.parametrize("kv", ["float32", "int8", "int4"])
def test_insert_pages_batch_bit_exact(kv):
    """Two prompts of 20 and 9 tokens (bucket 32, page 16) into 2 and 1
    shuffled pool pages: pool bytes and scales bit for bit (int4: nibble
    pairs packed along the page axis)."""
    jcfg, tcfg = jax_get_config("tiny-gqa"), get_config("tiny-gqa")
    quant = kv != "float32"
    bits = 4 if kv == "int4" else 8
    k, v = _prefill_kv(jcfg, 2, 32, 5)
    pages = np.array([[7, 2], [4, 0]], np.int32)
    n_pages = np.array([2, 1], np.int32)
    jc = jtf.init_paged_cache(jcfg, 8, 16, jnp.float32, quantized=quant,
                              kv_bits=bits)
    want = jax.jit(jtf.insert_pages_batch)(jc, jnp.asarray(k), jnp.asarray(v),
                                           jnp.asarray(pages),
                                           jnp.asarray(n_pages))
    got = ttf.init_paged_cache(tcfg, 8, 16, torch.float32, "cpu",
                               quantized=quant, kv_bits=bits)
    ttf.insert_pages_batch(got, torch.from_numpy(k), torch.from_numpy(v),
                           pages, n_pages)
    _assert_bits(got, want, quant)
    one = ttf.init_paged_cache(tcfg, 8, 16, torch.float32, "cpu",
                               quantized=quant, kv_bits=bits)
    ttf.insert_pages(one, torch.from_numpy(k[:, :1]),
                     torch.from_numpy(v[:, :1]), pages[0], 2)
    np.testing.assert_array_equal(one.k[:, 7].numpy(), got.k[:, 7].numpy())


@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("name", NAMES)
def test_prefill_chunk_paged_matches_jax(name, kv):
    """A 37-token prompt in page-sized chunks (16) through a shuffled table
    row: logits per chunk and the pool after each chunk."""
    jcfg, tcfg, jparams, tparams = _params(name)
    quant = kv == "int8"
    jcache = jtf.init_paged_cache(jcfg, 8, 16, jnp.float32, quantized=quant)
    tcache = ttf.init_paged_cache(tcfg, 8, 16, torch.float32, "cpu",
                                  quantized=quant)
    row = np.array([5, 1, 6, 0], np.int32)
    ids = np.random.default_rng(6).integers(2, jcfg.vocab_size, 37)
    fn = jax.jit(jtf.prefill_chunk_paged, static_argnums=1)
    for start in range(0, 37, 16):
        chunk = np.zeros(16, np.int32)
        valid = min(16, 37 - start)
        chunk[:valid] = ids[start:start + valid]
        want, jcache = fn(jparams, jcfg, jcache, jnp.asarray(row),
                          jnp.asarray(chunk), jnp.int32(start),
                          jnp.int32(valid))
        got = ttf.prefill_chunk_paged(tparams, tcfg, tcache,
                                      torch.from_numpy(row),
                                      torch.from_numpy(chunk), start, valid)
        _assert_logits(got, want)
        _assert_cache(tcache, jcache, quant)


def _filled(shape, quant, rng, dtype):
    """Cache leaves already holding a prefix: random rows (int8 values
    with scales), as numpy."""
    if quant:
        return dict(k=rng.integers(-127, 128, shape).astype(np.int8),
                    v=rng.integers(-127, 128, shape).astype(np.int8),
                    k_scale=rng.uniform(0.002, 0.02, shape[:-1]).astype(
                        np.float32),
                    v_scale=rng.uniform(0.002, 0.02, shape[:-1]).astype(
                        np.float32))
    leaves = dict(k=rng.standard_normal(shape).astype(np.float32),
                  v=rng.standard_normal(shape).astype(np.float32))
    if dtype == "bfloat16":   # values a bf16 cache can hold exactly
        leaves = {n: np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
                  for n, x in leaves.items()}
    return leaves


def _caches(layout, quant, dtype, leaves):
    """The same filled cache as a JAX and a torch cache."""
    rows = {n for n, x in leaves.items()
            if x.dtype == np.float32 and not n.endswith("scale")}
    jl = {n: jnp.asarray(x, jnp.dtype(dtype) if n in rows else None)
          for n, x in leaves.items()}
    tl = {n: torch.from_numpy(x.copy()).to(getattr(torch, dtype))
          if n in rows else torch.from_numpy(x.copy())
          for n, x in leaves.items()}
    if layout == "slot":
        return jtf.KVCache(**jl), ttf.KVCache(**tl)
    return jtf.PagedKVCache(**jl), ttf.PagedKVCache(**tl)


@pytest.mark.parametrize("impl", [None, "plain"])
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("layout", ["slot", "paged"])
@pytest.mark.parametrize("name", NAMES)
def test_decode_step_matches_jax(name, layout, kv, impl):
    """Three decode steps over four slots of a filled cache — lengths 20,
    9 and 31 (slot: 63, the cache's last row, then it is retired; paged:
    across a page edge) and a parked slot (slot cache: length S, its write
    dropped and the whole stripe read; paged: the coverage sentinel) — on
    both of the port's paths (None: the kernel wrappers' plain versions;
    "plain": the reference's oracle) against the reference's XLA path.
    Logits of the active slots (the slot cache's parked slot too) and the
    cache rows written."""
    dtype = "bfloat16" if kv == "bfloat16" else "float32"
    quant = kv == "int8"
    jcfg, tcfg, jparams, tparams = _params(name, dtype, seed=7)
    rng = np.random.default_rng(8)
    page, maxp, n_pages = 16, 4, 20
    if layout == "slot":
        s = 64
        shape = (jcfg.num_layers, 4, jcfg.num_kv_heads, s, jcfg.head_dim)
        lengths = np.array([20, 9, 61, s], np.int32)
        tables = None
        live = [0, 1, 2, 3]
    else:
        shape = (jcfg.num_layers, n_pages, jcfg.num_kv_heads, page,
                 jcfg.head_dim)
        lengths = np.array([20, 9, 31, maxp * page], np.int32)
        tables = np.stack([rng.permutation(n_pages)[:maxp]
                           for _ in range(4)]).astype(np.int32)
        live = [0, 1, 2]
    jcache, tcache = _caches(layout, quant, dtype,
                             _filled(shape, quant, rng, dtype))
    tokens = rng.integers(2, jcfg.vocab_size, 4).astype(np.int32)
    fn = jax.jit(jtf.decode_step, static_argnums=1)
    jt = {} if tables is None else dict(tables=jnp.asarray(tables))
    tt = {} if tables is None else dict(tables=torch.from_numpy(tables))
    for _ in range(3):
        want, jcache = fn(jparams, jcfg, jcache, jnp.asarray(tokens),
                          jnp.asarray(lengths), **jt)
        got = ttf.decode_step(tparams, tcfg, tcache,
                              torch.from_numpy(tokens),
                              torch.from_numpy(lengths), impl=impl, **tt)
        want = np.asarray(want)
        _assert_logits(got[live], want[live], dtype)
        tokens = want.argmax(-1).astype(np.int32)
        lengths = lengths + np.array([1, 1, 1, 0], np.int32)
    if dtype == "float32":
        _assert_cache(tcache, jcache, quant)
    else:
        for g, w in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
            np.testing.assert_allclose(_f32(g), _f32(w), atol=2e-2, rtol=0)

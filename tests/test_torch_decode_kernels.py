"""The legacy scheduler's decode kernels against the JAX reference on the
same numpy inputs: the plain versions of ``kv_cache_update`` and
``kv_cache_update_quant`` bit for bit against the reference's Pallas
kernels (interpret mode, under ``jax.jit``); the plain versions of
``ragged_decode_attention`` and ``paged_decode_attention`` against the
Pallas kernels in interpret mode (f32, atol 1e-5) on the slots of length
>= 1 — lengths across block and page edges, a parked slot (write index S,
so length S + 1), an empty slot and shuffled page tables; and
``decode_update_and_attend`` / ``paged_decode_update_and_attend`` on both
of their paths against the reference's, an int4 pool included (its decode
rides the mixed attention); and ``decode_attention_split_plain``, the
kernels' split-KV form, against the Pallas kernels.

A slot of length 0 is garbage in the reference (every score masked, so
p = 1 everywhere) and exactly zero in the port, which these tests pin."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arks_tpu.ops import attention as jattn
from arks_tpu.ops import paged_attention as jpa
from arks_tpu.ops import pallas_attention as jpl
from arks_tpu_torch.ops import attention as tattn
from arks_tpu_torch.ops import paged_attention as tpa
from arks_tpu_torch.ops import pallas_attention as tpl

torch.set_num_threads(2)


def _bits(x):
    x = np.asarray(x)
    if x.dtype == np.float32:
        return x.view(np.int32)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _t(x, dtype=None):
    """numpy -> torch, a copy (bfloat16 through f32, exact)."""
    t = torch.from_numpy(np.array(x, np.float32 if dtype == "bfloat16"
                                  else None))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _j(x, dtype=None):
    return jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else None)


def _tbits(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else _bits(t.numpy())


# Slot cache: S = 256 over blocks of 128; lengths cross a block edge, one
# slot is empty and one parked (write index S).
S = 256
SLOT_LENS = [1, 127, 128, 129, 0, S + 1, 200]


def _slot_case(seed, *, quant, hkv=2, g=3, d=16, layers=2):
    rng = np.random.default_rng(seed)
    b = len(SLOT_LENS)
    shape = (layers, b, hkv, S, d)
    if quant:
        pools = [rng.integers(-127, 128, shape).astype(np.int8)
                 for _ in range(2)]
        scales = [rng.uniform(0.002, 0.03, shape[:-1]).astype(np.float32)
                  for _ in range(2)]
    else:
        pools = [rng.standard_normal(shape).astype(np.float32)
                 for _ in range(2)]
        scales = [None, None]
    return dict(q=rng.standard_normal((b, hkv, g, d)).astype(np.float32),
                k_new=rng.standard_normal((b, hkv, d)).astype(np.float32) * 3,
                v_new=rng.standard_normal((b, hkv, d)).astype(np.float32),
                k=pools[0], v=pools[1], ks=scales[0], vs=scales[1],
                lengths=np.array(SLOT_LENS, np.int32), layer=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_cache_update_bit_exact(dtype):
    """Rows land at the write index of the layer; indices >= S (a parked
    slot) drop; the cache bytes equal the Pallas kernel's."""
    c = _slot_case(1, quant=False)
    widx = np.array([0, 15, 16, 31, S, S - 1, 100], np.int32)
    fn = jax.jit(jpl.kv_cache_update, static_argnames=("layer", "interpret"))
    wk, wv = fn(_j(c["k"], dtype), _j(c["v"], dtype), _j(c["k_new"], dtype),
                _j(c["v_new"], dtype), jnp.asarray(widx), layer=c["layer"],
                interpret=True)
    kc, vc = _t(c["k"], dtype), _t(c["v"], dtype)
    before = tpl.kv_cache_update.launches
    tpl.kv_cache_update(kc, vc, _t(c["k_new"], dtype), _t(c["v_new"], dtype),
                        torch.from_numpy(widx), c["layer"])
    assert tpl.kv_cache_update.launches == before      # CPU: plain version
    np.testing.assert_array_equal(_tbits(kc), _bits(wk))
    np.testing.assert_array_equal(_tbits(vc), _bits(wv))
    assert not np.array_equal(_tbits(kc), _tbits(_t(c["k"], dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_cache_update_quant_bit_exact(dtype):
    """int8 values and f32 scales bit for bit against the Pallas
    ``kv_cache_update_quant`` (with its ``quantize_kv``) under jit; an
    all-zero row gets scale 1e-8; the parked slot writes nothing."""
    c = _slot_case(2, quant=True)
    c["k_new"][3] = 0.0
    widx = np.array([0, 127, 128, 31, S, 255, 7], np.int32)
    fn = jax.jit(jpl.kv_cache_update_quant,
                 static_argnames=("layer", "interpret"))
    want = fn(*(jnp.asarray(c[k]) for k in ("k", "v", "ks", "vs")),
              _j(c["k_new"], dtype), _j(c["v_new"], dtype),
              jnp.asarray(widx), layer=c["layer"], interpret=True)
    got = [torch.from_numpy(c[k].copy()) for k in ("k", "v", "ks", "vs")]
    tpl.kv_cache_update_quant(*got, _t(c["k_new"], dtype),
                              _t(c["v_new"], dtype), torch.from_numpy(widx),
                              c["layer"])
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
    assert got[2][c["layer"], 3, :, 31].eq(np.float32(1e-8)).all()
    np.testing.assert_array_equal(got[0][:, 4].numpy(), c["k"][:, 4])


def _valid(lengths):
    return [b for b, n in enumerate(lengths) if n >= 1]


@pytest.mark.parametrize("quant", [False, True])
def test_ragged_decode_attention_plain_vs_pallas(quant):
    """The slot cache's attention: f32 within 1e-5 of the Pallas kernel
    (blocks of 128) on every slot of length >= 1, the parked slot reading
    all of S; the empty slot exactly zero."""
    c = _slot_case(3, quant=quant)
    sc = dict(k_scale=jnp.asarray(c["ks"]), v_scale=jnp.asarray(c["vs"])) \
        if quant else {}
    want = np.asarray(jpl.ragged_decode_attention(
        jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(c["v"]),
        jnp.asarray(c["lengths"]), c["layer"], block_s=128, block_b=2,
        interpret=True, **sc))
    tsc = dict(k_scale=torch.from_numpy(c["ks"]),
               v_scale=torch.from_numpy(c["vs"])) if quant else {}
    got = tpl.ragged_decode_attention(
        torch.from_numpy(c["q"]), torch.from_numpy(c["k"]),
        torch.from_numpy(c["v"]), torch.from_numpy(c["lengths"]), c["layer"],
        **tsc).numpy()
    ok = _valid(SLOT_LENS)
    np.testing.assert_allclose(got[ok], want[ok], atol=1e-5, rtol=0)
    assert not got[SLOT_LENS.index(0)].any()


# Paged pool: page 16 (128 where the reference's quantized update needs
# its scale tile), 4 table entries per slot, shuffled pages.
PAGE, MAXP, NPAGES = 16, 4, 32
PAGED_LENS = [1, 16, 17, 48, 0, 64, 33]


def _paged_case(seed, *, quant, hkv=2, g=4, d=16, layers=2, page=PAGE):
    rng = np.random.default_rng(seed)
    b = len(PAGED_LENS)
    shape = (layers, NPAGES, hkv, page, d)
    if quant:
        pools = [rng.integers(-127, 128, shape).astype(np.int8)
                 for _ in range(2)]
        scales = [rng.uniform(0.002, 0.03, shape[:-1]).astype(np.float32)
                  for _ in range(2)]
    else:
        pools = [rng.standard_normal(shape).astype(np.float32)
                 for _ in range(2)]
        scales = [None, None]
    tables = rng.permutation(NPAGES)[: b * MAXP].reshape(b, MAXP)
    return dict(q=rng.standard_normal((b, hkv, g, d)).astype(np.float32),
                k_new=rng.standard_normal((b, hkv, d)).astype(np.float32) * 3,
                v_new=rng.standard_normal((b, hkv, d)).astype(np.float32),
                k=pools[0], v=pools[1], ks=scales[0], vs=scales[1],
                tables=tables.astype(np.int32), page=page,
                lengths=np.array(PAGED_LENS, np.int32) * page // PAGE,
                layer=1)


@pytest.mark.parametrize("quant", [False, True])
def test_paged_decode_attention_plain_vs_pallas(quant):
    """Paged decode attention through shuffled tables, lengths on and
    across page edges: f32 within 1e-5 of the Pallas kernel on every slot
    of length >= 1; the empty slot exactly zero."""
    c = _paged_case(4, quant=quant)
    sc = dict(k_scale=jnp.asarray(c["ks"]), v_scale=jnp.asarray(c["vs"])) \
        if quant else {}
    want = np.asarray(jpa.paged_decode_attention(
        jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(c["v"]),
        jnp.asarray(c["tables"]), jnp.asarray(c["lengths"]), c["layer"],
        block_b=1, interpret=True, **sc))
    tsc = dict(k_scale=torch.from_numpy(c["ks"]),
               v_scale=torch.from_numpy(c["vs"])) if quant else {}
    before = tpa.paged_decode_attention.launches
    got = tpa.paged_decode_attention(
        torch.from_numpy(c["q"]), torch.from_numpy(c["k"]),
        torch.from_numpy(c["v"]), torch.from_numpy(c["tables"]),
        torch.from_numpy(c["lengths"]), c["layer"], **tsc).numpy()
    assert tpa.paged_decode_attention.launches == before
    ok = _valid(PAGED_LENS)
    np.testing.assert_allclose(got[ok], want[ok], atol=1e-5, rtol=0)
    assert not got[PAGED_LENS.index(0)].any()


def test_decode_attention_plain_ignores_nan_past_length():
    """Rows past a slot's length never reach p.V: NaN there leaves the
    output finite (an uninitialised pool can hold NaN bits)."""
    c = _paged_case(5, quant=False)
    v = c["v"].copy()
    for b, n in enumerate(PAGED_LENS):
        for pos in range(n, MAXP * PAGE):
            v[c["layer"], c["tables"][b, pos // PAGE], :, pos % PAGE] = np.nan
    got = tpa.paged_decode_attention(
        torch.from_numpy(c["q"]), torch.from_numpy(c["k"]),
        torch.from_numpy(v), torch.from_numpy(c["tables"]),
        torch.from_numpy(c["lengths"]), c["layer"])
    assert torch.isfinite(got).all()


def test_paged_decode_attention_rejects_int4():
    c = _paged_case(6, quant=True)
    kp = tpa.pack_int4(torch.from_numpy(c["k"]).clamp(-7, 7), 3)
    with pytest.raises(ValueError, match="int4"):
        tpa.paged_decode_attention(
            torch.from_numpy(c["q"]), kp, kp, torch.from_numpy(c["tables"]),
            torch.from_numpy(c["lengths"]), 0,
            k_scale=torch.from_numpy(c["ks"]),
            v_scale=torch.from_numpy(c["vs"]))


def _slot_op(c, impl, quant, lib):
    """``decode_update_and_attend`` on the slot case, write index
    lengths - 1 (the parked slot's is S); (out, caches)."""
    widx = np.maximum(c["lengths"] - 1, 0).astype(np.int32)
    b, hkv, g, d = c["q"].shape
    q = c["q"].reshape(b, hkv * g, d)
    names = ("k", "v", "ks", "vs") if quant else ("k", "v")
    if lib == "jax":
        fn = jax.jit(jattn.decode_update_and_attend,
                     static_argnames=("layer", "impl"))
        sc = dict(k_scale=jnp.asarray(c["ks"]),
                  v_scale=jnp.asarray(c["vs"])) if quant else {}
        out, *caches = fn(jnp.asarray(q), jnp.asarray(c["k_new"]),
                          jnp.asarray(c["v_new"]), jnp.asarray(c["k"]),
                          jnp.asarray(c["v"]), jnp.asarray(widx),
                          layer=c["layer"], impl=impl, **sc)
        return np.asarray(out), [np.asarray(x) for x in caches[:len(names)]]
    caches = [torch.from_numpy(c[k].copy()) for k in names]
    sc = dict(k_scale=caches[2], v_scale=caches[3]) if quant else {}
    out = tattn.decode_update_and_attend(
        torch.from_numpy(q), torch.from_numpy(c["k_new"]),
        torch.from_numpy(c["v_new"]), caches[0], caches[1],
        torch.from_numpy(widx), c["layer"], impl=impl, **sc)
    return out.numpy(), [x.numpy() for x in caches]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_decode_update_and_attend_vs_jax(impl, quant, monkeypatch):
    """``impl="plain"`` against the reference's XLA path, the kernel path
    (its plain versions on the CPU) against the reference's Pallas path in
    interpret mode: caches bit-exact, outputs within 1e-5 on every slot
    that attends something (the empty slot's write index 0 makes it
    length 1 here)."""
    if impl == "kernel":
        monkeypatch.setenv("ARKS_ATTN_IMPL", "pallas")
        monkeypatch.setenv("ARKS_ATTN_BLOCK_S", "128")
    c = _slot_case(7, quant=quant)
    want, wcaches = _slot_op(c, "xla" if impl == "plain" else "pallas",
                             quant, "jax")
    got, gcaches = _slot_op(c, impl, quant, "torch")
    for g, w in zip(gcaches, wcaches, strict=True):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _paged_op(c, impl, quant, lib):
    """``paged_decode_update_and_attend`` on the paged case, write index
    lengths - 1, the empty slot parked at the coverage sentinel."""
    widx = np.where(c["lengths"] > 0, c["lengths"] - 1,
                    MAXP * c["page"]).astype(np.int32)
    b, hkv, g, d = c["q"].shape
    q = c["q"].reshape(b, hkv * g, d)
    names = ("k", "v", "ks", "vs") if quant else ("k", "v")
    if lib == "jax":
        fn = jax.jit(jattn.paged_decode_update_and_attend,
                     static_argnames=("layer", "impl"))
        sc = dict(k_scale=jnp.asarray(c["ks"]),
                  v_scale=jnp.asarray(c["vs"])) if quant else {}
        out, *pools = fn(jnp.asarray(q), jnp.asarray(c["k_new"]),
                         jnp.asarray(c["v_new"]), jnp.asarray(c["k"]),
                         jnp.asarray(c["v"]), jnp.asarray(c["tables"]),
                         jnp.asarray(widx), layer=c["layer"], impl=impl,
                         **sc)
        return np.asarray(out), [np.asarray(x) for x in pools[:len(names)]]
    pools = [torch.from_numpy(c[k].copy()) for k in names]
    sc = dict(k_scale=pools[2], v_scale=pools[3]) if quant else {}
    out = tattn.paged_decode_update_and_attend(
        torch.from_numpy(q), torch.from_numpy(c["k_new"]),
        torch.from_numpy(c["v_new"]), pools[0], pools[1],
        torch.from_numpy(c["tables"]), torch.from_numpy(widx), c["layer"],
        impl=impl, **sc)
    return out.numpy(), [x.numpy() for x in pools]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_paged_decode_update_and_attend_vs_jax(impl, quant, monkeypatch):
    """As above for the paged pool: the inactive slot's write drops and it
    attends nothing (zeros in the port's kernel path); pools bit-exact,
    outputs of the active slots within 1e-5."""
    if impl == "kernel":
        monkeypatch.setenv("ARKS_ATTN_IMPL", "pallas")
    c = _paged_case(8, quant=quant,
                    page=128 if quant and impl == "kernel" else PAGE)
    want, wpools = _paged_op(c, "xla" if impl == "plain" else "pallas",
                             quant, "jax")
    got, gpools = _paged_op(c, impl, quant, "torch")
    for g, w in zip(gpools, wpools, strict=True):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    ok = _valid(PAGED_LENS)
    np.testing.assert_allclose(got[ok], want[ok], atol=1e-5, rtol=0)
    if impl == "kernel":
        assert not got[PAGED_LENS.index(0)].any()


def test_paged_decode_op_int4_kernel_path_raises():
    """Once a refusal, now the int4 repair: on an int4 pool the kernel path
    of ``paged_decode_update_and_attend`` quantizes and writes with
    ``paged_kv_update_quant`` and attends through ``paged_mixed_attention``
    over one query per slot (plain versions on the CPU).  Against the
    reference's op (which sends int4 to its XLA oracle): packed pools and
    scales bit for bit, outputs of the active slots within 1e-5 in f32,
    the inactive slot exactly zero."""
    c = _paged_case(9, quant=True)
    for k in ("k", "v"):
        c[k] = tpa.pack_int4(torch.from_numpy(c[k]).clamp(-7, 7),
                             3).numpy()
    widx = np.where(c["lengths"] > 0, c["lengths"] - 1,
                    MAXP * c["page"]).astype(np.int32)
    b, hkv, g, d = c["q"].shape
    q = c["q"].reshape(b, hkv * g, d)
    names = ("k", "v", "ks", "vs")
    fn = jax.jit(jattn.paged_decode_update_and_attend,
                 static_argnames=("layer",))
    want, *wpools = fn(jnp.asarray(q), jnp.asarray(c["k_new"]),
                       jnp.asarray(c["v_new"]), jnp.asarray(c["k"]),
                       jnp.asarray(c["v"]), jnp.asarray(c["tables"]),
                       jnp.asarray(widx), layer=c["layer"],
                       k_scale=jnp.asarray(c["ks"]),
                       v_scale=jnp.asarray(c["vs"]))
    pools = [torch.from_numpy(c[k].copy()) for k in names]
    before = (tpa.paged_kv_update_quant.launches,
              tpa.paged_mixed_attention.launches)
    got = tattn.paged_decode_update_and_attend(
        torch.from_numpy(q), torch.from_numpy(c["k_new"]),
        torch.from_numpy(c["v_new"]), pools[0], pools[1],
        torch.from_numpy(c["tables"]), torch.from_numpy(widx), c["layer"],
        k_scale=pools[2], v_scale=pools[3]).numpy()
    assert (tpa.paged_kv_update_quant.launches,
            tpa.paged_mixed_attention.launches) == before   # CPU: plain
    for gp, wp in zip(pools, wpools[:4], strict=True):
        np.testing.assert_array_equal(_bits(gp.numpy()), _bits(wp))
    assert not np.array_equal(pools[0].numpy(), c["k"])
    ok = _valid(PAGED_LENS)
    np.testing.assert_allclose(got[ok], np.asarray(want)[ok], atol=1e-5,
                               rtol=0)
    assert not got[PAGED_LENS.index(0)].any()


# Split-KV: the kernels' form of the decode attention, pieces of 256
# positions over a context of 512 (two pieces, and past them).
SPLIT_S = 512
SPLIT_LENS = [0, 1, 255, 256, 257, SPLIT_S, SPLIT_S + 1, 300]


def _split_case(seed, *, quant, paged, hkv=2, g=3, d=16):
    rng = np.random.default_rng(seed)
    b = len(SPLIT_LENS)
    page = 128 if paged else SPLIT_S
    n = b * SPLIT_S // page
    shape = (2, n, hkv, page, d)
    if quant:
        pools = [rng.integers(-127, 128, shape).astype(np.int8)
                 for _ in range(2)]
        scales = [rng.uniform(0.002, 0.03, shape[:-1]).astype(np.float32)
                  for _ in range(2)]
    else:
        pools = [rng.standard_normal(shape).astype(np.float32) * 2
                 for _ in range(2)]
        scales = [None, None]
    lens = np.array(SPLIT_LENS, np.int32)
    if paged:                      # the table's coverage bounds a length
        lens = np.minimum(lens, SPLIT_S)
    return dict(q=rng.standard_normal((b, hkv, g, d)).astype(np.float32),
                k=pools[0], v=pools[1], ks=scales[0], vs=scales[1],
                tables=rng.permutation(n).reshape(b, -1).astype(np.int32),
                lengths=lens, layer=1)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("paged", [False, True])
def test_decode_attention_split_plain_vs_pallas(paged, quant):
    """``decode_attention_split_plain`` (pieces of 256 positions, partials
    combined by exp(m_i - M)) against the reference's Pallas kernel in
    interpret mode — ``paged_decode_attention`` through shuffled tables,
    or ``ragged_decode_attention`` over the slot cache — in f32 within
    1e-5 on every slot of length >= 1, at lengths 0, 1, 255, 256, 257,
    S and S + 1 (clamped to S); the empty slot exactly zero."""
    c = _split_case(10, quant=quant, paged=paged)
    layer = c["layer"]
    jsc = dict(k_scale=jnp.asarray(c["ks"]), v_scale=jnp.asarray(c["vs"])) \
        if quant else {}
    args = [jnp.asarray(c[k]) for k in ("q", "k", "v")]
    if paged:
        want = jpa.paged_decode_attention(
            *args, jnp.asarray(c["tables"]), jnp.asarray(c["lengths"]),
            layer, block_b=1, interpret=True, **jsc)
        view = lambda x: tpa.paged_gather_kv(   # noqa
            torch.from_numpy(x), torch.from_numpy(c["tables"]), layer)
    else:
        want = jpl.ragged_decode_attention(
            *args, jnp.asarray(c["lengths"]), layer, block_s=128, block_b=2,
            interpret=True, **jsc)
        view = lambda x: torch.from_numpy(x)[layer]   # noqa
    tsc = dict(k_scale=view(c["ks"]), v_scale=view(c["vs"])) if quant else {}
    got = tpa.decode_attention_split_plain(
        torch.from_numpy(c["q"]), view(c["k"]), view(c["v"]),
        torch.from_numpy(c["lengths"]), **tsc).numpy()
    ok = _valid(SPLIT_LENS)
    np.testing.assert_allclose(got[ok], np.asarray(want)[ok], atol=1e-5,
                               rtol=0)
    assert not got[SPLIT_LENS.index(0)].any()
    assert tpa.decode_splits(SPLIT_S) == 2

"""The port's int8/int4 paged KV pools against the JAX reference on the same
numpy inputs: ``quantize_kv`` and the nibble packing bit for bit; the
oracle scatter (``paged_update_xla``) and the update kernel's plain
version bit for bit against the reference's oracle AND its Pallas
``paged_kv_update_quant`` run in interpret mode (page 128, the Pallas
kernel's tile); the attention kernel's plain version against the Pallas
``paged_mixed_attention`` in interpret mode; and
``paged_mixed_update_and_attend`` on both of its paths (f32, atol 1e-5).
The reference's functions run under ``jax.jit``, as the reference always
runs them: XLA's arithmetic there (a multiplication by the reciprocal of
qmax in ``quantize_kv``) is what the port reproduces.

The mixed batch puts pair-mates of an int4 byte in one dispatch: a chunk
of odd length from an odd position (its first token's mate is not in the
dispatch and keeps the pool's nibble) and one from position 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arks_tpu.ops import attention as jattn
from arks_tpu.ops import paged_attention as jpa
from arks_tpu.ops.pallas_attention import quantize_kv as jquantize_kv
from arks_tpu_torch.ops import attention as tattn
from arks_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(2)

PAGE = 128


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("qmax", [127, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_exact(dtype, qmax):
    """Values and scales, including all-zero rows (scale 1e-8) and rows
    whose |x| spans six decades."""
    rng = np.random.default_rng(qmax)
    x = rng.standard_normal((64, 4, 128)).astype(np.float32)
    x *= 10.0 ** rng.uniform(-3, 3, (64, 4, 1))
    x[3] = 0.0
    x[5, 2] = 0.0
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    wq, ws = jax.jit(jquantize_kv, static_argnames="qmax")(jx, qmax=qmax)
    gq, gs = tpa.quantize_kv(tx, qmax=qmax)
    assert gq.dtype == torch.int8 and gs.dtype == torch.float32
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(_bits(gs.numpy()), _bits(ws))
    assert (gs[3] == np.float32(1e-8)).all() and not gq[3].any()


def test_int4_pack_unpack_bit_exact():
    rng = np.random.default_rng(1)
    vals = rng.integers(-7, 8, (4, 6, 2, 16, 8)).astype(np.int8)
    raw = rng.integers(-128, 128, (2, 3, 2, 8, 8)).astype(np.int8)
    for axis in (3, -2, 0):
        want = np.asarray(jpa.pack_int4(jnp.asarray(vals), axis))
        got = tpa.pack_int4(torch.from_numpy(vals), axis)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            tpa.unpack_int4(got, axis).numpy(), vals)
    for axis in (3, 1):        # every byte, nibbles 8..15 included
        want = np.asarray(jpa.unpack_int4(jnp.asarray(raw), axis))
        got = tpa.unpack_int4(torch.from_numpy(raw), axis)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tpa.unpack_int4_pool(torch.from_numpy(raw)).numpy(),
        np.asarray(jpa.unpack_int4_pool(jnp.asarray(raw))))


def _case(kv, seed, *, hkv=2, g=3, d=16, layers=2, n=7, maxp=3):
    """Random quantized pools that already hold data, their scales, and a
    flat mixed batch over 6 lanes at page 128: decode at 13, a 37-token
    chunk from 121 (odd start, odd length, crosses a page), an inactive
    lane, a 6-token chunk from 0, decode at 255 (last row of page 1), a
    9-token chunk from 300; then 3 padding tokens."""
    rng = np.random.default_rng(seed)
    rows = PAGE // 2 if kv == "int4" else PAGE
    lanes = {0: (13, 1), 1: (121, 37), 3: (0, 6), 4: (2 * PAGE - 1, 1),
             5: (300, 9)}
    s = 6
    qs, ql, ps = (np.zeros(s, np.int32) for _ in range(3))
    slot, pos = [], []
    for lane, (p0, m) in lanes.items():
        qs[lane], ql[lane], ps[lane] = len(slot), m, p0
        slot += [lane] * m
        pos += range(p0, p0 + m)
    slot += [-1] * 3
    pos += [maxp * PAGE] * 3
    t = len(slot)
    tables = np.stack([rng.permutation(n)[:maxp] for _ in range(s)]) \
        .astype(np.int32)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa
    pool = lambda: rng.integers(-128, 128, (layers, n, hkv, rows, d)) \
        .astype(np.int8)  # noqa
    scale = lambda: rng.uniform(0.002, 0.03, (layers, n, hkv, PAGE)) \
        .astype(np.float32)  # noqa
    if kv == "int8":
        pool = lambda: rng.integers(-127, 128, (layers, n, hkv, rows, d)) \
            .astype(np.int8)  # noqa
    return dict(q=f(t, hkv * g, d), k_new=f(t, hkv, d) * 3,
                v_new=f(t, hkv, d), k_pool=pool(), v_pool=pool(),
                k_scale=scale(), v_scale=scale(), layer=1, tables=tables,
                token_slot=np.array(slot, np.int32),
                token_pos=np.array(pos, np.int32), seq_q_start=qs,
                seq_q_len=ql, seq_pos_start=ps)


_POOL_KEYS = ("k_pool", "v_pool", "k_scale", "v_scale")
_BATCH_KEYS = ("tables", "token_slot", "token_pos", "seq_q_start",
               "seq_q_len", "seq_pos_start")


def _write_view(c):
    cover = c["tables"].shape[1] * PAGE
    tables_tok = c["tables"][np.maximum(c["token_slot"], 0)]
    write_idx = np.where(c["token_slot"] < 0, cover, c["token_pos"]) \
        .astype(np.int32)
    return tables_tok, write_idx


def _torch_pools(c):
    return [torch.from_numpy(c[k].copy()) for k in _POOL_KEYS]


def _assert_pools_equal(got, want):
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_paged_update_quant_bit_exact(kv):
    """Pool bytes and scales after the scatter: the port's oracle and the
    update kernel's plain version against the reference's oracle and its
    Pallas kernel in interpret mode, all four identical.  Rows at the
    coverage sentinel are dropped; pair-mates of one dispatch keep each
    other's nibble."""
    c = _case(kv, seed=21)
    tables_tok, widx = _write_view(c)
    jpools = [jnp.asarray(c[k]) for k in _POOL_KEYS]
    jargs = (jnp.asarray(c["k_new"]), jnp.asarray(c["v_new"]),
             jnp.asarray(widx), jnp.asarray(tables_tok), c["layer"])
    want = jax.jit(jpa.paged_update_xla, static_argnums=8)(*jpools, *jargs)
    pallas = jpa.paged_kv_update_quant(*jpools, *jargs, interpret=True)
    _assert_pools_equal([torch.from_numpy(np.array(x)) for x in pallas],
                        [np.asarray(x) for x in want])
    targs = (torch.from_numpy(c["k_new"]), torch.from_numpy(c["v_new"]),
             torch.from_numpy(widx), torch.from_numpy(tables_tok),
             c["layer"])
    oracle = _torch_pools(c)
    tpa.paged_update_xla(*oracle, *targs)
    _assert_pools_equal(oracle, [np.asarray(x) for x in want])
    plain = _torch_pools(c)
    before = tpa.paged_kv_update_quant.launches
    tpa.paged_kv_update_quant(*plain, *targs)        # CPU: the plain version
    assert tpa.paged_kv_update_quant.launches == before
    _assert_pools_equal(plain, [np.asarray(x) for x in want])
    # The scatter wrote something, and left the dropped rows' pages alone.
    assert not np.array_equal(oracle[0].numpy(), c["k_pool"])
    if kv == "int4":
        # Position 121's byte row 60 of its page: the low nibble (token
        # 120, not in the dispatch) is the pool's old one.
        pg = c["tables"][1, 0]
        old = c["k_pool"][1, pg, :, 60] & 15
        np.testing.assert_array_equal(oracle[0].numpy()[1, pg, :, 60] & 15,
                                      old)


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_paged_mixed_attention_plain_vs_pallas(kv):
    """The attention kernel's plain version with quantized pools against
    the reference's ragged Pallas kernel (interpret mode) on its per-lane
    layout, f32 within 1e-5; the reference's rows of inactive lanes and
    the port's padding rows are exactly 0."""
    c = _case(kv, seed=22)
    hkv, d = c["k_pool"].shape[2], c["q"].shape[-1]
    g = c["q"].shape[1] // hkv
    s = c["seq_q_len"].shape[0]
    qmax = int(c["seq_q_len"].max())
    span = c["seq_q_start"][:, None] + np.arange(qmax)
    qs = c["q"][np.minimum(span, len(c["q"]) - 1)]
    qs = qs.reshape(s, qmax, hkv, g, d).transpose(0, 2, 3, 1, 4)
    want = np.asarray(jpa.paged_mixed_attention(
        jnp.asarray(qs), *(jnp.asarray(c[k]) for k in ("k_pool", "v_pool",
                                                      "tables",
                                                      "seq_pos_start",
                                                      "seq_q_len")),
        c["layer"], k_scale=jnp.asarray(c["k_scale"]),
        v_scale=jnp.asarray(c["v_scale"]), interpret=True))
    kp, vp, ks, vs = _torch_pools(c)
    got = tpa.paged_mixed_attention_plain(
        torch.from_numpy(c["q"]), kp, vp, torch.from_numpy(c["tables"]),
        torch.from_numpy(c["seq_q_start"]), torch.from_numpy(c["seq_q_len"]),
        torch.from_numpy(c["seq_pos_start"]), c["layer"], k_scale=ks,
        v_scale=vs).numpy()
    for lane in range(s):
        for i in range(int(c["seq_q_len"][lane])):
            t = c["seq_q_start"][lane] + i
            np.testing.assert_allclose(got[t].reshape(hkv, g, d),
                                       want[lane, :, :, i], atol=1e-5,
                                       rtol=0)
    assert not want[c["seq_q_len"] == 0].any()
    assert not got[c["token_slot"] < 0].any()


def _jax_attend(c, impl):
    fn = jax.jit(jattn.paged_mixed_update_and_attend,
                 static_argnames=("layer", "impl"))
    out, *pools = fn(
        jnp.asarray(c["q"]), jnp.asarray(c["k_new"]), jnp.asarray(c["v_new"]),
        jnp.asarray(c["k_pool"]), jnp.asarray(c["v_pool"]),
        *(jnp.asarray(c[k]) for k in _BATCH_KEYS), layer=c["layer"],
        impl=impl, k_scale=jnp.asarray(c["k_scale"]),
        v_scale=jnp.asarray(c["v_scale"]))
    return np.asarray(out), [np.asarray(x) for x in pools]


def _torch_attend(c, impl):
    kp, vp, ks, vs = pools = _torch_pools(c)
    out = tattn.paged_mixed_update_and_attend(
        torch.from_numpy(c["q"]), torch.from_numpy(c["k_new"]),
        torch.from_numpy(c["v_new"]), kp, vp,
        *(torch.from_numpy(c[k]) for k in _BATCH_KEYS), c["layer"],
        impl=impl, k_scale=ks, v_scale=vs)
    return out.numpy(), pools


@pytest.mark.parametrize("kv", ["int8", "int4"])
@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_mixed_update_and_attend_quant_vs_jax(impl, kv, monkeypatch):
    """``impl="plain"`` against the reference's XLA oracle path on every
    row; the kernel path (its plain versions on the CPU) against the
    reference's Pallas path in interpret mode on every row, padding rows
    exactly 0.  Pools and scales bit-exact on both."""
    if impl == "kernel":
        monkeypatch.setenv("ARKS_ATTN_IMPL", "pallas")
    c = _case(kv, seed=23 if impl == "plain" else 24)
    want, wpools = _jax_attend(c, "xla" if impl == "plain" else "pallas")
    got, gpools = _torch_attend(c, impl)
    _assert_pools_equal(gpools, wpools)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if impl == "kernel":
        assert not got[c["token_slot"] < 0].any()

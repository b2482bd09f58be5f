"""The port's weight quantization (``arks_tpu_torch/models/quant.py``)
against the reference's ``arks_tpu/models/quant.py`` on the same numpy
inputs: ``quantize_tensor`` and ``quantize_tensor_int4`` bit for bit
(values and scales; the reference run eagerly, as its ``quantize_params``
runs them), the int4 nibble packing, the quantized ``qeinsum``,
``embed_lookup`` and ``unembed_logits`` (f32, 1e-5 relative), and
``params_from_numpy`` on int8 and int4 trees.  The port's quantized random
init equals quantizing its unquantized init of the same seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arks_tpu.models import get_config as jax_get_config
from arks_tpu.models import quant as jquant
from arks_tpu.models import transformer as jtf
from arks_tpu_torch.models import get_config
from arks_tpu_torch.models import quant as tquant
from arks_tpu_torch.models import transformer as ttf
from arks_tpu_torch.models.weights import params_from_numpy
from arks_tpu_torch.ops.paged_attention import pack_int4, unpack_int4

torch.set_num_threads(2)

RTOL = 1e-5


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _weights(shape, seed=0, dtype=np.float32):
    """Normal weights whose columns span six decades, with an all-zero
    column (scale 1e-8)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    w *= 10.0 ** rng.uniform(-3, 3, shape[:-2] + (1, shape[-1]))
    w[..., 3] = 0.0
    return w.astype(dtype)


def _pair(w, dtype):
    return (jnp.asarray(w, getattr(jnp, dtype)),
            torch.from_numpy(w).to(getattr(torch, dtype)))


def test_key_sets_and_weight_bits_match_the_reference():
    assert tquant.MATMUL_KEYS == jquant.MATMUL_KEYS
    assert tquant.SKIP_KEYS == jquant.SKIP_KEYS
    for name in ("bf16", "int8", "int4"):
        assert tquant.weight_bits(name) == jquant.weight_bits(name)
    with pytest.raises(ValueError):
        tquant.weight_bits("fp8")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis,shape", [(-2, (3, 96, 40)), (-1, (50, 64))])
def test_quantize_tensor_bit_exact(dtype, axis, shape):
    """int8 per output channel (axis -2) and per embedding row (axis -1)."""
    w = _weights(shape, seed=abs(axis))
    jw, tw = _pair(w, dtype)
    want = jquant.quantize_tensor(jw, axis=axis)
    got = tquant.quantize_tensor(tw, axis=axis)
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    assert tuple(got["s"].shape) == want["s"].shape
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(_bits(got["s"].numpy()), _bits(want["s"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,group", [(128, 32), (96, None), (96, 64),
                                     (256, None)])
def test_quantize_tensor_int4_bit_exact(dtype, k, group):
    """Groupwise int4: several groups (group 32 over K 128), the default
    128 clamped to K 96, 64 clamped down to a divisor of 96 (48), and two
    groups of 128."""
    w = _weights((2, k, 48), seed=k)
    jw, tw = _pair(w, dtype)
    want = jquant.quantize_tensor_int4(jw, group)
    got = tquant.quantize_tensor_int4(tw, group)
    assert got["q"].shape == (2, k // 2, 48) and got["q"].dtype == torch.int8
    assert tuple(got["gs"].shape) == want["gs"].shape
    np.testing.assert_array_equal(tquant.int4_values(got).numpy(),
                                  np.asarray(want["q"]).astype(np.int8))
    np.testing.assert_array_equal(_bits(got["gs"].numpy()), _bits(want["gs"]))


def test_int4_group_env_knob(monkeypatch):
    monkeypatch.setenv("ARKS_INT4_GROUP", "32")
    assert tquant.int4_group_for(128) == 32
    assert tquant.int4_group_for(128, 64) == 64       # explicit arg wins
    w = _weights((128, 16))
    want = jquant.quantize_tensor_int4(jnp.asarray(w))
    got = tquant.quantize_tensor_int4(torch.from_numpy(w))
    assert got["gs"].shape == (4, 16) == want["gs"].shape
    monkeypatch.setenv("ARKS_INT4_GROUP", "x")
    with pytest.raises(ValueError):
        tquant.int4_group_for(128)


def test_int4_pack_unpack_round_trip():
    """Every value pair of [-7, 7] packs to lo | hi << 4 along K and comes
    back exactly."""
    vals = np.arange(-7, 8, dtype=np.int8)
    lo, hi = np.meshgrid(vals, vals, indexing="ij")
    q = np.stack([lo.ravel(), hi.ravel()], axis=0)[None]     # [1, 2, 225]
    packed = pack_int4(torch.from_numpy(q), axis=-2)
    assert packed.shape == (1, 1, 225)
    want = ((lo.ravel() & 15) | (hi.ravel() << 4)).astype(np.int8)
    np.testing.assert_array_equal(packed[0, 0].numpy(), want)
    np.testing.assert_array_equal(unpack_int4(packed, axis=-2).numpy(), q)
    rng = np.random.default_rng(4)
    big = rng.integers(-7, 8, (3, 64, 40)).astype(np.int8)
    t = torch.from_numpy(big)
    assert torch.equal(unpack_int4(pack_int4(t, axis=-2), axis=-2), t)


def _quantize_both(w, bits, axis=-2, group=None):
    jw = jnp.asarray(w)
    if bits == 4:
        jq = jquant.quantize_tensor_int4(jw, group)
        tq = tquant.quantize_tensor_int4(torch.from_numpy(w), group)
    else:
        jq = jquant.quantize_tensor(jw, axis=axis)
        tq = tquant.quantize_tensor(torch.from_numpy(w), axis=axis)
    return jq, tq


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("eq,xshape,wshape", [
    ("...e,ef->...f", (5, 64), (64, 96)),
    ("...e,xef->...xf", (7, 64), (4, 64, 96)),
    ("...xf,xfe->...xe", (7, 4, 96), (4, 96, 64)),
])
def test_qeinsum_matches_jax(bits, eq, xshape, wshape):
    rng = np.random.default_rng(len(xshape) + bits)
    x = rng.standard_normal(xshape).astype(np.float32)
    w = (rng.standard_normal(wshape) * 0.02).astype(np.float32)
    jq, tq = _quantize_both(w, bits, group=32)
    want = jquant.qeinsum(eq, jnp.asarray(x), jq)
    _close(tquant.qeinsum(eq, torch.from_numpy(x), tq), want)
    _close(tquant.dequantize(tq, torch.float32),
           jquant.dequantize(jq, jnp.float32))


# qeinsum's route on the card, the grouped matmul kernel, driven here
# through its plain version (grouped_matmul_plain): one group over the T
# rows (projections), every expert over the same rows and expert x over
# its own (the dense MoE route); T across a 128-row tile, lead dims.
GROUPED_FORMS = [
    ("...e,ef->...f", (5, 64), (64, 96)),
    ("...e,ef->...f", (2, 70, 64), (64, 96)),
    ("...e,xef->...xf", (7, 64), (4, 64, 96)),
    ("...e,xef->...xf", (130, 64), (4, 64, 96)),
    ("...xf,xfe->...xe", (7, 4, 96), (4, 96, 64)),
    ("...xf,xfe->...xe", (2, 65, 4, 96), (4, 96, 64)),
]
# chip_smoke's GM_TOL: the kernel scales int8 in f32 before its one
# rounding, the plain form scales the rounded product.
GM_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("eq,xshape,wshape", GROUPED_FORMS)
def test_qeinsum_grouped_layout_matches_plain_and_jax(bits, dtype, eq,
                                                       xshape, wshape):
    rng = np.random.default_rng(len(xshape) + bits + xshape[0])
    x = rng.standard_normal(xshape).astype(np.float32)
    w = (rng.standard_normal(wshape) * 0.02).astype(np.float32)
    jq, tq = _quantize_both(w, bits, group=32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    if dtype == "bfloat16":
        tq = tquant.quantize_tensor_int4(torch.from_numpy(w).bfloat16(), 32) \
            if bits == 4 else tquant.quantize_tensor(
                torch.from_numpy(w).bfloat16())
    got = tquant.qeinsum_grouped(eq, tx, tq)
    plain = tquant.qeinsum_plain(eq, tx, tq)
    assert got.shape == plain.shape and got.dtype == plain.dtype
    top = plain.float().abs().max().item()
    torch.testing.assert_close(got.float(), plain.float(), rtol=0,
                               atol=GM_TOL[dtype] * top)
    if dtype == "float32":
        _close(got, jquant.qeinsum(eq, jnp.asarray(x), jq))


def test_qeinsum_on_the_cpu_is_its_plain_form():
    """A CPU tensor keeps the plain form, bit for bit, on every form."""
    rng = np.random.default_rng(1)
    for eq, xshape, wshape in GROUPED_FORMS:
        x = torch.from_numpy(rng.standard_normal(xshape).astype(np.float32))
        w = (rng.standard_normal(wshape) * 0.02).astype(np.float32)
        for bits in (8, 4):
            tq = _quantize_both(w, bits, group=32)[1]
            assert torch.equal(tquant.qeinsum(eq, x, tq),
                               tquant.qeinsum_plain(eq, x, tq))


def test_grouped_forms_and_tile_maps():
    """Every quantized product of the models maps to a grouped layout (any
    other raises); the tile maps name each group's expert and its real
    rows."""
    for eq in ("...e,eq->...q", "...q,qe->...e", "...f,fe->...e"):
        assert tquant.grouped_form(eq) == "proj"
    assert tquant.grouped_form("...e,xef->...xf") == "experts"
    assert tquant.grouped_form("...xf,xfe->...xe") == "experts_out"
    assert tquant.grouped_form("be,ev->bv") is None
    tq = _quantize_both(np.ones((8, 16), np.float32), 8)[1]
    with pytest.raises(ValueError, match="no grouped-matmul layout"):
        tquant.qeinsum_grouped("be,ev->bv", torch.ones(2, 8), tq)
    bexp, rows = tquant.grouped_tiles(300, 3, torch.device("cpu"))
    assert bexp.tolist() == [0, 0, 0, 1, 1, 1, 2, 2, 2]
    assert rows.tolist() == [128, 128, 44] * 3
    assert tquant.grouped_tiles(300, 3, torch.device("cpu"))[0] is bexp


def test_embed_lookup_matches_jax():
    rng = np.random.default_rng(2)
    table = (rng.standard_normal((300, 64)) * 0.02).astype(np.float32)
    tokens = rng.integers(0, 300, (4, 9)).astype(np.int32)
    jq, tq = _quantize_both(table, 8, axis=-1)
    want = jquant.embed_lookup(jq, jnp.asarray(tokens), jnp.float32)
    got = tquant.embed_lookup(tq, torch.from_numpy(tokens), torch.float32)
    _close(got, want)


@pytest.mark.parametrize("tied,bits", [(True, 8), (False, 8), (False, 4)])
def test_unembed_logits_matches_jax(tied, bits):
    """Tied (the int8 embedding [V, E], scales [V, 1]) and untied lm_head
    [E, V] in int8 or int4."""
    rng = np.random.default_rng(3)
    h = rng.standard_normal((5, 64)).astype(np.float32)
    shape = (300, 64) if tied else (64, 300)
    table = (rng.standard_normal(shape) * 0.02).astype(np.float32)
    jq, tq = _quantize_both(table, bits, axis=-1 if tied else -2)
    want = jquant.unembed_logits(jnp.asarray(h), jq, tied)
    got = tquant.unembed_logits(torch.from_numpy(h), tq, tied)
    assert got.dtype == torch.float32
    _close(got, want)


def _flat(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", value


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("name", ["tiny", "tiny-moe", "tiny-mixtral"])
def test_params_from_numpy_quantized_trees(name, bits):
    """A reference tree quantized by its ``quantize_params`` bridges to the
    port bit for bit: the port's ``quantize_params`` of the bridged
    unquantized tree gives the same q (int4 packed) and scales."""
    jcfg, tcfg = jax_get_config(name), get_config(name)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(2), jnp.float32)
    jq = jquant.quantize_params(jparams, bits=bits)
    bridged = params_from_numpy(jax.tree.map(np.asarray, jq), tcfg, "cpu")
    ours = tquant.quantize_params(
        params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu"),
        bits=bits)
    got, want = dict(_flat(bridged)), dict(_flat(ours))
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key
    assert tquant.is_quantized(bridged["embed"]) and "s" in bridged["embed"]
    leaf = bridged["layers"]["w_gate"]
    assert ("gs" if bits == 4 else "s") in leaf
    if bits == 4:
        assert leaf["q"].shape[-2] * 2 == jq["layers"]["w_gate"]["q"].shape[-2]
    assert not tquant.is_quantized(bridged["layers"]["attn_norm"])
    if tcfg.num_experts:
        assert not tquant.is_quantized(bridged["layers"]["router"])


def test_params_from_numpy_rejects_misshaped_quantized_leaf():
    cfg = get_config("tiny")
    jparams = jquant.quantize_params(
        jtf.init_params(jax_get_config("tiny"), jax.random.PRNGKey(0),
                        jnp.float32))
    tree = jax.tree.map(np.asarray, jparams)
    tree["layers"]["wq"]["s"] = tree["layers"]["wq"]["s"][:, :, :-1]
    with pytest.raises(ValueError, match="wq"):
        params_from_numpy(tree, cfg, "cpu")


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("name", ["tiny-gqa", "tiny-moe"])
def test_quantized_init_equals_quantizing_the_init(name, bits):
    """``init_params(bits=...)`` draws the same slices as the unquantized
    init and quantizes each as drawn."""
    cfg = get_config(name)
    plain = ttf.init_params(cfg, 4, "float32", "cpu")
    want = dict(_flat(tquant.quantize_params(plain, bits=bits)))
    got = dict(_flat(tquant.init_params_quantized(cfg, 4, "float32", bits,
                                                  "cpu")))
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips when no CUDA device is present (the check
runs inside the fixture, never at import).  These tests import no JAX, so
they run on a GPU machine without it:
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.
``chip_smoke.py`` holds the same kernels at the served path's shapes."""

import numpy as np
import pytest
import torch

from arks_tpu_torch.models.config import ModelConfig
from arks_tpu_torch.models import transformer as tf
from arks_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _batch(dev, dtype, *, hkv, g, d, page, lanes, layers=2, n_pad=3,
           seed=0):
    """Flat mixed batch over ``lanes`` [(pos_start, q_len)], q_len 0 =
    inactive, then padding tokens; random pools and tables."""
    rng = np.random.default_rng(seed)
    s = len(lanes)
    max_pages = max(-(-(p + n) // page) for p, n in lanes) + 1
    slot, pos = [], []
    qs, ql, ps = (np.zeros(s, np.int32) for _ in range(3))
    for lane, (p0, n) in enumerate(lanes):
        qs[lane], ql[lane], ps[lane] = len(slot), n, p0
        slot += [lane] * n
        pos += range(p0, p0 + n)
    slot += [-1] * n_pad
    pos += [max_pages * page] * n_pad
    n_pages = s * max_pages
    tables = rng.permutation(n_pages).reshape(s, max_pages)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t = len(slot)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)  # noqa
    b = dict(q=randn(t, hkv * g, d), k_new=randn(t, hkv, d),
             v_new=randn(t, hkv, d), k_pool=randn(layers, n_pages, hkv, page, d),
             v_pool=randn(layers, n_pages, hkv, page, d), layer=layers - 1,
             tables=i32(tables), token_slot=i32(slot), token_pos=i32(pos),
             seq_q_start=i32(qs), seq_q_len=i32(ql), seq_pos_start=i32(ps))
    b["tables_tok"] = b["tables"][b["token_slot"].clamp(min=0).long()]
    b["write_idx"] = torch.where(b["token_slot"] < 0,
                                 torch.full_like(b["token_pos"],
                                                 max_pages * page),
                                 b["token_pos"])
    return b


LANES = [(0, 1), (15, 1), (16, 1), (40, 1), (8, 20), (3, 9), (0, 0), (30, 0)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [8, 64, 128])
def test_paged_kv_update_bit_exact(dev, dtype, d):
    b = _batch(dev, dtype, hkv=4, g=1, d=d, page=16, lanes=LANES)
    args = (b["k_new"], b["v_new"], b["write_idx"], b["tables_tok"],
            b["layer"])
    kk, vk = b["k_pool"].clone(), b["v_pool"].clone()
    kp, vp = b["k_pool"].clone(), b["v_pool"].clone()
    before = pa.paged_kv_update.launches
    pa.paged_kv_update(kk, vk, *args)
    pa.paged_kv_update(kp, vp, *args, impl="plain")
    torch.cuda.synchronize()
    assert pa.paged_kv_update.launches == before + 1
    assert torch.equal(kk, kp) and torch.equal(vk, vp)
    assert not torch.equal(kk, b["k_pool"])       # rows were written


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("hkv,g,d,page", [(4, 7, 128, 256), (2, 4, 64, 16),
                                          (1, 8, 128, 32), (3, 1, 64, 64)])
def test_paged_mixed_attention_vs_plain(dev, dtype, tol, hkv, g, d, page):
    lanes = [(p * page // 16, n) for p, n in LANES] + [(page - 1, 2 * page)]
    b = _batch(dev, dtype, hkv=hkv, g=g, d=d, page=page, lanes=lanes)
    args = (b["tables"], b["seq_q_start"], b["seq_q_len"],
            b["seq_pos_start"], b["layer"])
    before = pa.paged_mixed_attention.launches
    got = pa.paged_mixed_attention(b["q"], b["k_pool"], b["v_pool"], *args)
    want = pa.paged_mixed_attention(b["q"], b["k_pool"], b["v_pool"], *args,
                                    impl="plain")
    torch.cuda.synchronize()
    assert pa.paged_mixed_attention.launches == before + 1
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    assert not got[b["token_slot"] < 0].any()


def _quant_pools(b, kv):
    """Replace the batch's pools with the same data quantized per token:
    int8 (or int4, packed along the page axis) values and f32 scales."""
    for name in ("k", "v"):
        vals, scale = pa.quantize_kv(b[f"{name}_pool"],
                                     qmax=7 if kv == "int4" else 127)
        b[f"{name}_pool"] = pa.pack_int4(vals, 3) if kv == "int4" else vals
        b[f"{name}_scale"] = scale
    return b


# Lanes with int4 pair-mates in one dispatch: chunks from odd and even
# positions, of odd and even length.
QUANT_LANES = [(0, 1), (15, 1), (16, 1), (40, 1), (9, 21), (3, 9), (0, 0),
               (30, 0), (22, 6)]


@pytest.mark.parametrize("kv", ["int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128])
def test_paged_kv_update_quant_bit_exact(dev, dtype, d, kv):
    """Values and scales bit-identical to the plain version (quantize_kv
    + the two-parity scatter), pair-mates of one dispatch included."""
    b = _quant_pools(_batch(dev, dtype, hkv=4, g=1, d=d, page=16,
                            lanes=QUANT_LANES), kv)
    args = (b["k_new"] * 3, b["v_new"], b["write_idx"], b["tables_tok"],
            b["layer"])
    names = ("k_pool", "v_pool", "k_scale", "v_scale")
    kern = [b[k].clone() for k in names]
    plain = [b[k].clone() for k in names]
    before = pa.paged_kv_update_quant.launches
    pa.paged_kv_update_quant(*kern, *args)
    pa.paged_kv_update_quant(*plain, *args, impl="plain")
    torch.cuda.synchronize()
    assert pa.paged_kv_update_quant.launches == before + 1
    for g, w in zip(kern, plain):
        assert torch.equal(g.view(torch.int8), w.view(torch.int8))
    assert not torch.equal(kern[0], b["k_pool"])


@pytest.mark.parametrize("kv", ["int8", "int4"])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("hkv,g,d,page", [(4, 7, 128, 256), (2, 4, 64, 16),
                                          (3, 1, 64, 64)])
def test_paged_mixed_attention_quant_vs_plain(dev, dtype, tol, hkv, g, d,
                                              page, kv):
    lanes = [(p * page // 16, n) for p, n in LANES] + [(page - 1, 2 * page)]
    b = _quant_pools(_batch(dev, dtype, hkv=hkv, g=g, d=d, page=page,
                            lanes=lanes), kv)
    args = (b["tables"], b["seq_q_start"], b["seq_q_len"],
            b["seq_pos_start"], b["layer"])
    scales = dict(k_scale=b["k_scale"], v_scale=b["v_scale"])
    before = pa.paged_mixed_attention.launches
    got = pa.paged_mixed_attention(b["q"], b["k_pool"], b["v_pool"], *args,
                                   **scales)
    want = pa.paged_mixed_attention(b["q"], b["k_pool"], b["v_pool"], *args,
                                    impl="plain", **scales)
    torch.cuda.synchronize()
    assert pa.paged_mixed_attention.launches == before + 1
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    assert not got[b["token_slot"] < 0].any()


def test_kernels_raise_on_unsupported(dev):
    b = _batch(dev, torch.float16, hkv=2, g=2, d=64, page=16, lanes=LANES)
    with pytest.raises(TypeError):
        pa.paged_mixed_attention(b["q"], b["k_pool"], b["v_pool"],
                                 b["tables"], b["seq_q_start"],
                                 b["seq_q_len"], b["seq_pos_start"], 0)
    b = _batch(dev, torch.bfloat16, hkv=1, g=9, d=64, page=16, lanes=LANES)
    with pytest.raises(ValueError):
        pa.paged_mixed_attention(b["q"], b["k_pool"], b["v_pool"],
                                 b["tables"], b["seq_q_start"],
                                 b["seq_q_len"], b["seq_pos_start"], 0)


@pytest.mark.parametrize("kv", [None, "int8", "int4"])
def test_mixed_step_kernels_vs_plain(dev, kv):
    """Two mixed steps through the kernels and through their plain
    versions (``impl="plain"`` is the reference's oracle, which folds the
    v scale after normalising: 1e-4 covers that in f32)."""
    cfg = ModelConfig(name="test-d64", vocab_size=512, hidden_size=256,
                      intermediate_size=512, num_layers=2, num_heads=8,
                      num_kv_heads=2, head_dim=64, qkv_bias=True,
                      dtype="float32")
    params = tf.init_params(cfg, 0, torch.float32, dev)
    tables = torch.arange(6, dtype=torch.int32, device=dev).reshape(2, 3)
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)  # noqa
    # lane 0 prefills 40 tokens (crosses a 16-token page), lane 1 decodes
    # at position 5 over a pool the first step wrote; 2 padding tokens.
    steps = [
        (list(range(2, 42)) + [7] * 6, [0] * 40 + [1] * 6,
         list(range(40)) + list(range(6)), [39, 45], [0, 40], [40, 6],
         [0, 0]),
        ([9, 11, 0, 0], [0, 1, -1, -1], [40, 6, 48, 48], [0, 1], [0, 1],
         [1, 1], [40, 6]),
    ]
    caches = {i: tf.init_paged_cache(cfg, 6, 16, torch.float32, dev,
                                     quantized=kv is not None,
                                     kv_bits=4 if kv == "int4" else 8)
              for i in ("kernel", "plain")}
    for step in steps:
        out = {i: tf.mixed_step(params, cfg, caches[i], tables,
                                *(i32(a) for a in step), impl=i)
               for i in ("kernel", "plain")}
        torch.testing.assert_close(out["kernel"], out["plain"], atol=1e-4,
                                   rtol=0)
        if kv is None:
            torch.testing.assert_close(caches["kernel"].k,
                                       caches["plain"].k, atol=1e-5, rtol=0)
        else:   # the K/V rows of both paths agree to 1e-5 in f32, so
            # their quantized bytes may differ by one step at most
            assert (caches["kernel"].k_scale - caches["plain"].k_scale
                    ).abs().max() <= 1e-6


# ---------------------------------------------------------------------------
# The legacy scheduler's kernels: slot-cache writes, decode attention over
# the slot cache and over the paged pool
# ---------------------------------------------------------------------------


def _slot_cache(dev, dtype, *, b, hkv, d, s, layers=2, quant=None, seed=0):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    shape = (layers, b, hkv, s, d)
    kv = [torch.randn(shape, generator=gen, device=dev).to(dtype)
          for _ in range(2)]
    if quant:
        return _as_int8(kv)
    return kv


def _as_int8(pools):
    """Pools quantized per token (values, then f32 scales)."""
    vals, scales = zip(*(pa.quantize_kv(p) for p in pools))
    return list(vals) + list(scales)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [8, 64, 128])
def test_kv_cache_update_bit_exact(dev, dtype, d):
    from arks_tpu_torch.ops import pallas_attention as pl
    s = 48
    k, v = _slot_cache(dev, dtype, b=6, hkv=4, d=d, s=s)
    widx = torch.tensor([0, 15, 16, s - 1, s, 30], dtype=torch.int32,
                        device=dev)
    new = [torch.randn(6, 4, d, device=dev).to(dtype) for _ in range(2)]
    kern = [k.clone(), v.clone()]
    plain = [k.clone(), v.clone()]
    before = pl.kv_cache_update.launches
    pl.kv_cache_update(*kern, *new, widx, 1)
    pl.kv_cache_update(*plain, *new, widx, 1, impl="plain")
    torch.cuda.synchronize()
    assert pl.kv_cache_update.launches == before + 1
    for g, w in zip(kern, plain):
        assert torch.equal(g, w)
    assert not torch.equal(kern[0], k)
    assert torch.equal(kern[0][:, 4], k[:, 4])      # the parked slot


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128])
def test_kv_cache_update_quant_bit_exact(dev, dtype, d):
    from arks_tpu_torch.ops import pallas_attention as pl
    s = 128
    caches = _slot_cache(dev, dtype, b=6, hkv=4, d=d, s=s, quant=True)
    widx = torch.tensor([0, 127, 64, s, 5, 100], dtype=torch.int32,
                        device=dev)
    new = [torch.randn(6, 4, d, device=dev).to(dtype) * 3 for _ in range(2)]
    new[0][4] = 0.0
    kern = [x.clone() for x in caches]
    plain = [x.clone() for x in caches]
    before = pl.kv_cache_update_quant.launches
    pl.kv_cache_update_quant(*kern, *new, widx, 1)
    pl.kv_cache_update_quant(*plain, *new, widx, 1, impl="plain")
    torch.cuda.synchronize()
    assert pl.kv_cache_update_quant.launches == before + 1
    for g, w in zip(kern, plain):
        assert torch.equal(g.view(torch.int8), w.view(torch.int8))
    assert not torch.equal(kern[0], caches[0])
    assert torch.equal(kern[0][:, 3], caches[0][:, 3])   # the parked slot


def _slot_lengths(s, dev):
    # Across 64-token tiles, an empty slot, a parked slot (S + 1), full.
    return torch.tensor([1, 63, 64, 65, 0, s + 1, s, 200], dtype=torch.int32,
                        device=dev)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("hkv,g,d,s", [(4, 7, 128, 256), (2, 4, 64, 320),
                                       (1, 8, 128, 512), (3, 1, 64, 256)])
def test_ragged_decode_attention_vs_plain(dev, dtype, tol, hkv, g, d, s,
                                          quant):
    from arks_tpu_torch.ops import pallas_attention as pl
    lengths = _slot_lengths(s, dev)
    b = lengths.shape[0]
    caches = _slot_cache(dev, dtype, b=b, hkv=hkv, d=d, s=s, quant=quant)
    q = torch.randn(b, hkv, g, d, device=dev).to(dtype)
    sc = dict(k_scale=caches[2], v_scale=caches[3]) if quant else {}
    before = pl.ragged_decode_attention.launches
    got = pl.ragged_decode_attention(q, caches[0], caches[1], lengths, 1,
                                     **sc)
    want = pl.ragged_decode_attention(q, caches[0], caches[1], lengths, 1,
                                      impl="plain", **sc)
    torch.cuda.synchronize()
    assert pl.ragged_decode_attention.launches == before + 1
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    assert not got[4].any()                           # the empty slot


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-5)])
def test_decode_attention_split_vs_split_plain(dev, dtype, tol, quant):
    """The split-KV pieces (256 positions) and their combine against
    ``decode_attention_split_plain`` on the same cache: lengths on and
    across piece edges, a parked slot (S + 1) and an empty one."""
    from arks_tpu_torch.ops import pallas_attention as pl
    s = 1024
    lengths = torch.tensor([1, 255, 256, 257, 0, s + 1, 700, s],
                           dtype=torch.int32, device=dev)
    caches = _slot_cache(dev, dtype, b=8, hkv=2, d=128, s=s, quant=quant)
    q = torch.randn(8, 2, 7, 128, device=dev).to(dtype)
    sc = dict(k_scale=caches[2], v_scale=caches[3]) if quant else {}
    got = pl.ragged_decode_attention(q, caches[0], caches[1], lengths, 1,
                                     **sc)
    sc1 = {k: v[1] for k, v in sc.items()}
    want = pa.decode_attention_split_plain(q, caches[0][1], caches[1][1],
                                           lengths, **sc1)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    assert not got[4].any()


def _paged_decode_case(dev, dtype, *, hkv, g, d, page, quant, seed=0):
    lengths = [1, page - 1, page, page + 1, 0, 3 * page + 5, 4 * page, 2]
    b, maxp = len(lengths), 5
    rng = np.random.default_rng(seed)
    n_pages = b * maxp + 3
    tables = torch.as_tensor(rng.permutation(n_pages)[: b * maxp]
                             .reshape(b, maxp).astype(np.int32), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pools = [torch.randn((2, n_pages, hkv, page, d), generator=gen,
                         device=dev).to(dtype) for _ in range(2)]
    if quant:
        pools = _as_int8(pools)
    q = torch.randn(b, hkv, g, d, device=dev).to(dtype)
    return q, pools, tables, torch.tensor(lengths, dtype=torch.int32,
                                          device=dev)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("hkv,g,d,page", [(4, 7, 128, 256), (2, 4, 64, 16),
                                          (1, 8, 128, 32), (3, 1, 64, 64)])
def test_paged_decode_attention_vs_plain(dev, dtype, tol, hkv, g, d, page,
                                         quant):
    q, pools, tables, lengths = _paged_decode_case(
        dev, dtype, hkv=hkv, g=g, d=d, page=page, quant=quant)
    sc = dict(k_scale=pools[2], v_scale=pools[3]) if quant else {}
    before = pa.paged_decode_attention.launches
    got = pa.paged_decode_attention(q, pools[0], pools[1], tables, lengths,
                                    1, **sc)
    want = pa.paged_decode_attention(q, pools[0], pools[1], tables, lengths,
                                     1, impl="plain", **sc)
    torch.cuda.synchronize()
    assert pa.paged_decode_attention.launches == before + 1
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    assert not got[4].any()


def test_paged_decode_attention_skips_rows_past_the_length(dev):
    """NaN in every pool row past a slot's length (pages past it and the
    tail of its last page) leaves the output finite."""
    q, pools, tables, lengths = _paged_decode_case(
        dev, torch.bfloat16, hkv=2, g=4, d=64, page=16, quant=False)
    v = pools[1].clone()
    for b, n in enumerate(lengths.tolist()):
        for pos in range(n, tables.shape[1] * 16):
            v[1, tables[b, pos // 16], :, pos % 16] = float("nan")
    got = pa.paged_decode_attention(q, pools[0], v, tables, lengths, 1)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()


def test_decode_kernels_raise_on_unsupported(dev):
    from arks_tpu_torch.ops import pallas_attention as pl
    q, pools, tables, lengths = _paged_decode_case(
        dev, torch.float16, hkv=2, g=4, d=64, page=16, quant=False)
    with pytest.raises(TypeError):
        pa.paged_decode_attention(q, pools[0], pools[1], tables, lengths, 0)
    q, pools, tables, lengths = _paged_decode_case(
        dev, torch.bfloat16, hkv=2, g=4, d=64, page=16, quant=True)
    i4 = pa.pack_int4(pools[0].clamp(-7, 7), 3)
    with pytest.raises(ValueError, match="int4"):
        pa.paged_decode_attention(q, i4, i4, tables, lengths, 0,
                                  k_scale=pools[2], v_scale=pools[3])
    k, v = _slot_cache(dev, torch.bfloat16, b=2, hkv=1, d=64, s=32)
    with pytest.raises(ValueError):
        pl.ragged_decode_attention(torch.zeros(2, 1, 9, 64, device=dev,
                                               dtype=torch.bfloat16), k, v,
                                   torch.ones(2, dtype=torch.int32,
                                              device=dev), 0)


@pytest.mark.parametrize("layout,kv", [("slot", None), ("slot", "int8"),
                                       ("paged", None), ("paged", "int8"),
                                       ("paged", "int4")])
def test_decode_step_kernels_vs_plain(dev, layout, kv):
    """Three decode steps through the kernels and through the reference's
    oracle path (impl="plain") from a prompt inserted by ``prefill``, one
    slot parked: logits within 1e-4 in f32 (the oracle folds the v scale
    after normalising), caches within 1e-5 (int8 scales within 1e-6).  An
    int4 pool's decode rides the mixed kernel, one query per slot."""
    cfg = ModelConfig(name="test-d64", vocab_size=512, hidden_size=256,
                      intermediate_size=512, num_layers=2, num_heads=8,
                      num_kv_heads=2, head_dim=64, qkv_bias=True,
                      dtype="float32")
    params = tf.init_params(cfg, 0, torch.float32, dev)
    tokens = torch.as_tensor(np.arange(2, 42, dtype=np.int32).reshape(2, 20),
                             device=dev)
    lens = torch.tensor([20, 13], dtype=torch.int32, device=dev)
    _, ks, vs = tf.prefill(params, cfg, tokens, lens)
    caches, tables = {}, None
    for impl in ("kernel", "plain"):
        if layout == "slot":
            c = tf.init_cache(cfg, 3, 64, torch.float32, dev,
                              quantized=kv is not None)
            tf.insert_batch(c, ks, vs, [0, 1])
        else:
            c = tf.init_paged_cache(cfg, 12, 16, torch.float32, dev,
                                    quantized=kv is not None,
                                    kv_bits=4 if kv == "int4" else 8)
            tables = torch.tensor([[3, 7, 1, 0], [5, 2, 9, 0], [0, 0, 0, 0]],
                                  dtype=torch.int32, device=dev)
            tf.insert_pages_batch(c, ks, vs, tables[:2, :2], [2, 1])
        caches[impl] = c
    sentinel = 64
    lengths = torch.tensor([20, 13, sentinel], dtype=torch.int32, device=dev)
    toks = torch.tensor([5, 9, 0], dtype=torch.int32, device=dev)
    for _ in range(3):
        out = {impl: tf.decode_step(params, cfg, caches[impl], toks, lengths,
                                    tables, impl=impl)
               for impl in ("kernel", "plain")}
        torch.testing.assert_close(out["kernel"][:2], out["plain"][:2],
                                   atol=1e-4, rtol=0)
        toks = out["plain"].argmax(-1).to(torch.int32)
        lengths = lengths + torch.tensor([1, 1, 0], dtype=torch.int32,
                                         device=dev)
    if kv is None:
        torch.testing.assert_close(caches["kernel"].k, caches["plain"].k,
                                   atol=1e-5, rtol=0)
    else:
        assert (caches["kernel"].k_scale - caches["plain"].k_scale
                ).abs().max() <= 1e-6


# ---------------------------------------------------------------------------
# The dense launch of the mixed-attention kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv", [None, "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_mixed_attention_dense_bit_identical_to_ragged(dev, dtype, kv):
    """The dense launch writes every valid row bit for bit as the ragged
    one does (same per-item page walk), and zeros elsewhere."""
    page = 16
    lanes = [(p * page // 16, n) for p, n in LANES] + [(page - 1, 2 * page)]
    b = _batch(dev, dtype, hkv=2, g=4, d=64, page=page, lanes=lanes)
    scales = {}
    if kv is not None:
        b = _quant_pools(b, kv)
        scales = dict(k_scale=b["k_scale"], v_scale=b["v_scale"])
    args = (b["tables"], b["seq_q_start"], b["seq_q_len"],
            b["seq_pos_start"], b["layer"])
    dense0 = pa.paged_mixed_attention_dense.launches
    ragged0 = pa.paged_mixed_attention.launches
    ragged = pa.paged_mixed_attention(b["q"], b["k_pool"], b["v_pool"], *args,
                                      grid="ragged", **scales)
    dense = pa.paged_mixed_attention(b["q"], b["k_pool"], b["v_pool"], *args,
                                     grid="dense", **scales)
    torch.cuda.synchronize()
    assert pa.paged_mixed_attention_dense.launches == dense0 + 1
    assert pa.paged_mixed_attention.launches == ragged0 + 1
    assert torch.equal(dense.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32),
                       ragged.view(torch.int16 if dtype == torch.bfloat16
                                   else torch.int32))


# ---------------------------------------------------------------------------
# The grouped matmul (MoE experts)
# ---------------------------------------------------------------------------


def _grouped_case(dev, dtype, mode, *, sizes, k, n, group=64, seed=0):
    """Expert-sorted rows of ``sizes`` padded by pad_groups (block_t 128),
    and a weight in ``mode`` (raw of ``dtype``, int8, packed int4)."""
    from arks_tpu_torch.models import quant
    from arks_tpu_torch.ops import moe_kernel as mk
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    nx = len(sizes)
    t = sum(sizes)
    se = torch.repeat_interleave(torch.arange(nx, device=dev),
                                 torch.as_tensor(sizes, device=dev))
    xs = torch.randn((t, k), generator=gen, device=dev).to(dtype)
    gs = torch.as_tensor(sizes, device=dev)
    xs_p, dest, bexp = mk.pad_groups(xs, se, gs)
    w = torch.randn((nx, k, n), generator=gen, device=dev) * 0.05
    kw = {}
    if mode == "raw":
        w = w.to(dtype)
    elif mode == "int8":
        qd = quant.quantize_tensor(w)
        w, kw = qd["q"], {"w_scale": qd["s"][:, 0, :].contiguous()}
    else:
        qd = quant.quantize_tensor_int4(w, group)
        w, kw = qd["q"], {"w_group_scale": qd["gs"]}
    return xs_p, w, bexp, kw, mk.rows_used(gs), mk.tile_rows(
        gs, xs_p.shape[0] // mk.BLOCK_T)


# An empty expert, a group of exactly 128 rows, groups of 1 row, a long
# one, 64- and 65-row groups (one M block of the bf16 kernel, and across).
GROUP_SIZES = [5, 0, 128, 1, 300, 1, 64, 65]


@pytest.mark.parametrize("mode", ["raw", "int8", "int4"])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("n", [256, 208, 784])
def test_grouped_matmul_vs_plain(dev, dtype, tol, mode, n):
    """bf16 within 1e-2 of the largest |out| (one bf16 rounding of the
    output and another summation order), f32 within 1e-5; zero rows give
    exact zeros; N = 208 and 784 mask a partial column tile.  Skipping
    tiles past the groups (rows_used) and multiplying only a tile's real
    64-row block (tile_rows) give the same bytes as the full product."""
    from arks_tpu_torch.ops import moe_kernel as mk
    xs_p, w, bexp, kw, used, rows = _grouped_case(
        dev, dtype, mode, sizes=GROUP_SIZES, k=256, n=n)
    before = mk.grouped_matmul.launches
    got = mk.grouped_matmul(xs_p, w, bexp, rows_used=used, **kw)
    full = mk.grouped_matmul(xs_p, w, bexp, **kw)      # no tile skipping
    real = mk.grouped_matmul(xs_p, w, bexp, rows_used=used, tile_rows=rows,
                             **kw)
    want = mk.grouped_matmul(xs_p, w, bexp, impl="plain", **kw)
    torch.cuda.synchronize()
    assert mk.grouped_matmul.launches == before + 3
    assert got.dtype == dtype and got.shape == (xs_p.shape[0], n)
    scale = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=tol * scale)
    assert torch.equal(got, full) and torch.equal(real, full)
    zero_rows = (xs_p == 0).all(dim=1)
    assert not got[zero_rows].any() and not real[zero_rows].any()


def test_grouped_matmul_raises_on_unsupported(dev):
    from arks_tpu_torch.ops import moe_kernel as mk
    xs_p, w, bexp, kw, _, _ = _grouped_case(dev, torch.bfloat16, "int8",
                                            sizes=[3, 4], k=64, n=64)
    with pytest.raises(ValueError):          # N not a multiple of 16
        mk.grouped_matmul(xs_p, w[..., :40], bexp,
                          w_scale=kw["w_scale"][:, :40])
    with pytest.raises(TypeError):           # f32 xs over an int8 weight
        mk.grouped_matmul(xs_p.float(), w.float(), bexp, **kw)
    xs4, w4, b4, kw4, _, _ = _grouped_case(dev, torch.bfloat16, "int4",
                                           sizes=[3, 4], k=160, n=64, group=40)
    with pytest.raises(ValueError):          # bf16: a K stage spans 3 groups
        mk.grouped_matmul(xs4, w4, b4, **kw4)
    with pytest.raises(ValueError):          # bf16: K not a multiple of 8
        mk.grouped_matmul(xs_p[:, :36], w[:, :36], bexp, **kw)


# K past the last 64-wide stage (96 = Mixtral-shaped test models' down
# projection), K below one stage, and int4 groups of 32 (two per stage).
@pytest.mark.parametrize("mode,k,group", [("raw", 96, 64), ("int8", 96, 64),
                                          ("int4", 96, 32), ("int4", 32, 32),
                                          ("int4", 256, 32),
                                          ("int4", 192, 96), ("raw", 40, 64)])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2),
                                       (torch.float32, 1e-5)])
def test_grouped_matmul_k_tail_and_small_groups(dev, dtype, tol, mode, k,
                                                group):
    """Any K and int4 groups below 64 against the plain version, within
    GM_TOL of the largest |out| (chip_smoke's limits); zero rows exact."""
    from arks_tpu_torch.ops import moe_kernel as mk
    xs_p, w, bexp, kw, used, rows = _grouped_case(
        dev, dtype, mode, sizes=GROUP_SIZES, k=k, n=208, group=group)
    before = mk.grouped_matmul.launches
    got = mk.grouped_matmul(xs_p, w, bexp, rows_used=used, tile_rows=rows,
                            **kw)
    want = mk.grouped_matmul(xs_p, w, bexp, impl="plain", **kw)
    torch.cuda.synchronize()
    assert mk.grouped_matmul.launches == before + 1
    scale = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=tol * scale)
    assert not got[(xs_p == 0).all(dim=1)].any()


# ---------------------------------------------------------------------------
# The split-KV mixed attention: block_q 1, 8 and 32, every pool stream,
# page spans with carried and emitted state
# ---------------------------------------------------------------------------


# Lanes per block_q (the widest lane sets it): decode lanes only, chunks of
# at most 8 tokens, chunks up to 40 (block_q 32, two q-blocks).  Positions
# cross pages of 16; inactive lanes in each.
BLOCK_Q_LANES = {
    1: [(0, 1), (15, 1), (16, 1), (40, 1), (0, 0), (77, 1), (30, 0),
        (120, 1)],
    8: [(0, 1), (15, 8), (16, 3), (40, 1), (0, 0), (60, 8), (9, 7)],
    32: [(0, 1), (15, 1), (8, 20), (3, 9), (0, 0), (30, 40), (100, 32)],
}
POOL_STREAMS = [(torch.bfloat16, None), (torch.float32, None),
                (torch.bfloat16, "int8"), (torch.bfloat16, "int4"),
                (torch.float32, "bf16")]


def _stream_batch(dev, dtype, kv, lanes, *, hkv=2, g=7, d=128, page=16):
    """A batch whose pools are ``kv`` (None: q's dtype; "bf16": bf16 under
    f32 q; "int8"/"int4": quantized) and the scale kwargs."""
    b = _batch(dev, torch.bfloat16 if kv == "bf16" else dtype, hkv=hkv, g=g,
               d=d, page=page, lanes=lanes)
    scales = {}
    if kv in ("int8", "int4"):
        b = _quant_pools(b, kv)
        scales = dict(k_scale=b["k_scale"], v_scale=b["v_scale"])
    if kv == "bf16":
        b["q"] = b["q"].float()
    return b, scales


@pytest.mark.parametrize("dtype,kv", POOL_STREAMS)
@pytest.mark.parametrize("block_q", [1, 8, 32])
def test_paged_mixed_attention_split_kv_vs_plain(dev, dtype, kv, block_q):
    """The split-KV kernel at each block_q (from the widest lane) against
    the plain version: bf16 q within 2e-2, f32 q within 1e-5 (an f32
    engine's bf16 pool widened exactly); the plan's block_q is the
    reference's min(qmax, 32); rows no lane owns are zero."""
    lanes = BLOCK_Q_LANES[block_q]
    b, scales = _stream_batch(dev, dtype, kv, lanes)
    qmax = max(n for _, n in lanes)
    assert pa.mixed_grid_plan(qmax)["block_q"] == block_q
    args = (b["tables"], b["seq_q_start"], b["seq_q_len"],
            b["seq_pos_start"], b["layer"])
    before = pa.paged_mixed_attention.launches
    got = pa.paged_mixed_attention(b["q"], b["k_pool"], b["v_pool"], *args,
                                   qmax=qmax, **scales)
    want = pa.paged_mixed_attention(b["q"], b["k_pool"], b["v_pool"], *args,
                                    qmax=qmax, impl="plain", **scales)
    split = pa.paged_mixed_attention_plain(
        b["q"], b["k_pool"], b["v_pool"], *args, qmax=qmax, split=True,
        **scales)
    torch.cuda.synchronize()
    assert pa.paged_mixed_attention.launches == before + 1
    tol = 1e-5 if b["q"].dtype == torch.float32 else 2e-2
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    torch.testing.assert_close(got.float(), split.float(), atol=tol, rtol=0)
    assert not got[b["token_slot"] < 0].any()


def _bits(x):
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("dtype,kv", POOL_STREAMS)
def test_paged_mixed_attention_span_chain_bit_exact(dev, dtype, kv):
    """[0, k) emitting state, then [k, end) carrying it, gives the single
    call's output bit for bit (the pieces are pages and the fold is a left
    fold in page order); the emitted state agrees with the plain version's
    within 2e-5 (m, l) and 2e-5 of the largest |acc|; rows no lane owns are
    zero in the state too.  The dense grid refuses spans and state."""
    lanes = [(3 * 16 + 5, 1), (2 * 16, 1), (16 + 1, 4), (3, 1), (0, 0),
             (40, 20)]
    b, scales = _stream_batch(dev, dtype, kv, lanes)
    args = (b["tables"], b["seq_q_start"], b["seq_q_len"],
            b["seq_pos_start"], b["layer"])
    q, kp, vp = b["q"], b["k_pool"], b["v_pool"]
    whole = pa.paged_mixed_attention(q, kp, vp, *args, **scales)
    for k in (1, 2):
        split = torch.full_like(b["seq_q_len"], k)
        state = pa.paged_mixed_attention(q, kp, vp, *args, page_hi=split,
                                         emit_state=True, **scales)
        chained = pa.paged_mixed_attention(q, kp, vp, *args, page_lo=split,
                                           carry_state=state, **scales)
        torch.cuda.synchronize()
        assert all(x.dtype == torch.float32 for x in state)
        assert torch.equal(_bits(chained), _bits(whole))
        want = pa.paged_mixed_attention(q, kp, vp, *args, page_hi=split,
                                        emit_state=True, impl="plain",
                                        **scales)
        pad = b["token_slot"] < 0
        for got_x, want_x in zip(state, want):
            assert not got_x[pad].any()
            atol = 2e-5 * max(1.0, want_x.abs().max().item())
            if q.dtype == torch.bfloat16:
                atol *= 500          # p rounded to bf16 before p.V
            torch.testing.assert_close(got_x, want_x, atol=atol, rtol=0)
    with pytest.raises(ValueError):
        pa.paged_mixed_attention(q, kp, vp, *args, grid="dense",
                                 page_hi=torch.ones_like(b["seq_q_len"]),
                                 **scales)
    with pytest.raises(ValueError):
        pa.paged_mixed_attention(q, kp, vp, *args, grid="dense",
                                 emit_state=True, **scales)


# ---------------------------------------------------------------------------
# An f32 engine over a bf16 cache: the write kernels round f32 rows to
# bf16, the attention kernels read bf16 widened to f32
# ---------------------------------------------------------------------------


def test_paged_kv_update_f32_rows_into_bf16_pool_bit_exact(dev):
    b = _batch(dev, torch.bfloat16, hkv=4, g=1, d=128, page=16, lanes=LANES)
    args = (b["k_new"].float() * 1.001, b["v_new"].float() / 3,
            b["write_idx"], b["tables_tok"], b["layer"])
    kk, vk = b["k_pool"].clone(), b["v_pool"].clone()
    kp, vp = b["k_pool"].clone(), b["v_pool"].clone()
    before = pa.paged_kv_update.launches
    pa.paged_kv_update(kk, vk, *args)
    pa.paged_kv_update(kp, vp, *args, impl="plain")
    torch.cuda.synchronize()
    assert pa.paged_kv_update.launches == before + 1
    assert torch.equal(_bits(kk), _bits(kp)) and torch.equal(_bits(vk),
                                                             _bits(vp))
    assert not torch.equal(kk, b["k_pool"])


def test_kv_cache_update_f32_rows_into_bf16_cache_bit_exact(dev):
    from arks_tpu_torch.ops import pallas_attention as pl
    s = 48
    k, v = _slot_cache(dev, torch.bfloat16, b=6, hkv=4, d=128, s=s)
    widx = torch.tensor([0, 15, 16, s - 1, s, 30], dtype=torch.int32,
                        device=dev)
    new = [torch.randn(6, 4, 128, device=dev) / 3 for _ in range(2)]
    kern, plain = [k.clone(), v.clone()], [k.clone(), v.clone()]
    before = pl.kv_cache_update.launches
    pl.kv_cache_update(*kern, *new, widx, 1)
    pl.kv_cache_update(*plain, *new, widx, 1, impl="plain")
    torch.cuda.synchronize()
    assert pl.kv_cache_update.launches == before + 1
    for g_, w_ in zip(kern, plain):
        assert torch.equal(_bits(g_), _bits(w_))
    assert torch.equal(kern[0][:, 4], k[:, 4])      # the parked slot


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_decode_attention_f32_over_bf16_cache_vs_plain(dev, layout):
    """f32 q over a bf16 cache (widened on the copy, p kept f32) within
    1e-5 of the plain version; the empty slot is zero."""
    from arks_tpu_torch.ops import pallas_attention as pl
    if layout == "slot":
        s = 320
        lengths = _slot_lengths(s, dev)
        k, v = _slot_cache(dev, torch.bfloat16, b=8, hkv=2, d=128, s=s)
        q = torch.randn(8, 2, 4, 128, device=dev)
        before = pl.ragged_decode_attention.launches
        got = pl.ragged_decode_attention(q, k, v, lengths, 1)
        want = pl.ragged_decode_attention(q, k, v, lengths, 1, impl="plain")
        assert pl.ragged_decode_attention.launches == before + 1
    else:
        q, pools, tables, lengths = _paged_decode_case(
            dev, torch.bfloat16, hkv=2, g=4, d=128, page=16, quant=False)
        q = q.float()
        before = pa.paged_decode_attention.launches
        got = pa.paged_decode_attention(q, pools[0], pools[1], tables,
                                        lengths, 1)
        want = pa.paged_decode_attention(q, pools[0], pools[1], tables,
                                         lengths, 1, impl="plain")
        assert pa.paged_decode_attention.launches == before + 1
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert not got[4].any()


# ---------------------------------------------------------------------------
# The paged row writes with the step's destinations (paged_write_rows)
# ---------------------------------------------------------------------------


def _with_dst(b):
    """The batch's destinations, resolved once as a step resolves them."""
    page = b["k_scale"].shape[3] if "k_scale" in b else b["k_pool"].shape[3]
    b["dst"] = pa.paged_write_rows(b["write_idx"], b["tables_tok"], page,
                                   b["k_pool"].shape[1])
    return b


def test_paged_write_rows_on_the_card_equals_the_cpu(dev):
    b = _with_dst(_batch(dev, torch.bfloat16, hkv=2, g=1, d=64, page=16,
                         lanes=LANES))
    want = pa.paged_write_rows(b["write_idx"].cpu(), b["tables_tok"].cpu(),
                               16, b["k_pool"].shape[1])
    assert b["dst"].is_cuda and torch.equal(b["dst"].cpu(), want)
    assert (want == -1).sum() == 3                  # the padding tokens


@pytest.mark.parametrize("dtype,d,hkv", [
    (torch.bfloat16, 8, 4), (torch.bfloat16, 64, 4), (torch.bfloat16, 128, 4),
    (torch.float32, 8, 4), (torch.float32, 128, 4),
    (torch.float32, 128, 20)])     # 20 x 2 x 32 vectors: past 1024 threads
def test_paged_kv_update_dst_bit_exact(dev, dtype, d, hkv):
    """Through dst and through write_idx / tables: both pools bit-identical
    to the plain scatter."""
    b = _with_dst(_batch(dev, dtype, hkv=hkv, g=1, d=d, page=16,
                         lanes=LANES))
    rows = (b["k_new"], b["v_new"])
    plain = [b["k_pool"].clone(), b["v_pool"].clone()]
    pa.paged_kv_update(*plain, *rows, b["write_idx"], b["tables_tok"],
                       b["layer"], impl="plain")
    before = pa.paged_kv_update.launches
    for args, kw in (((None, None), dict(dst=b["dst"])),
                     ((b["write_idx"], b["tables_tok"]), {})):
        kern = [b["k_pool"].clone(), b["v_pool"].clone()]
        pa.paged_kv_update(*kern, *rows, *args, b["layer"], **kw)
        torch.cuda.synchronize()
        assert torch.equal(_bits(kern[0]), _bits(plain[0]))
        assert torch.equal(_bits(kern[1]), _bits(plain[1]))
    assert pa.paged_kv_update.launches == before + 2
    assert not torch.equal(plain[0], b["k_pool"])


def test_paged_kv_update_dst_f32_rows_into_bf16_pool_bit_exact(dev):
    b = _with_dst(_batch(dev, torch.bfloat16, hkv=4, g=1, d=128, page=16,
                         lanes=LANES))
    rows = (b["k_new"].float() * 1.001, b["v_new"].float() / 3)
    kern = [b["k_pool"].clone(), b["v_pool"].clone()]
    plain = [b["k_pool"].clone(), b["v_pool"].clone()]
    pa.paged_kv_update(*kern, *rows, None, None, b["layer"], dst=b["dst"])
    pa.paged_kv_update(*plain, *rows, b["write_idx"], b["tables_tok"],
                       b["layer"], impl="plain")
    torch.cuda.synchronize()
    for g_, w_ in zip(kern, plain):
        assert torch.equal(_bits(g_), _bits(w_))
    assert not torch.equal(kern[0], b["k_pool"])


@pytest.mark.parametrize("kv", ["int8", "int4"])
@pytest.mark.parametrize("dtype,d,hkv", [
    (torch.bfloat16, 64, 4), (torch.bfloat16, 128, 4),
    (torch.float32, 128, 4), (torch.bfloat16, 512, 2),   # 4 words a lane
    (torch.bfloat16, 128, 20)])    # 40 rows: past 32 warps
def test_paged_kv_update_quant_dst_bit_exact(dev, dtype, d, hkv, kv):
    """Through dst and through write_idx / tables: values and scales
    bit-identical to the plain version, int4 pair-mates of one dispatch
    and lone mates included."""
    b = _with_dst(_quant_pools(_batch(dev, dtype, hkv=hkv, g=1, d=d,
                                      page=16, lanes=QUANT_LANES), kv))
    rows = (b["k_new"] * 3, b["v_new"])
    names = ("k_pool", "v_pool", "k_scale", "v_scale")
    plain = [b[k].clone() for k in names]
    pa.paged_kv_update_quant(*plain, *rows, b["write_idx"], b["tables_tok"],
                             b["layer"], impl="plain")
    before = pa.paged_kv_update_quant.launches
    for args, kw in (((None, None), dict(dst=b["dst"])),
                     ((b["write_idx"], b["tables_tok"]), {})):
        kern = [b[k].clone() for k in names]
        pa.paged_kv_update_quant(*kern, *rows, *args, b["layer"], **kw)
        torch.cuda.synchronize()
        for g_, w_ in zip(kern, plain):
            assert torch.equal(g_.view(torch.int8), w_.view(torch.int8))
    assert pa.paged_kv_update_quant.launches == before + 2
    assert not torch.equal(plain[0], b["k_pool"])


def test_update_kernels_raise_on_a_bad_dst(dev):
    b = _with_dst(_batch(dev, torch.bfloat16, hkv=2, g=1, d=64, page=16,
                         lanes=LANES))
    pools = (b["k_pool"], b["v_pool"])
    rows = (b["k_new"], b["v_new"])
    for bad in (b["dst"].long(), b["dst"][:-1], b["dst"].cpu()):
        with pytest.raises(ValueError):
            pa.paged_kv_update(*pools, *rows, None, None, 0, dst=bad)
    with pytest.raises(ValueError):                  # no index at all
        pa.paged_kv_update(*pools, *rows, None, None, 0)
    q = _quant_pools(_batch(dev, torch.bfloat16, hkv=2, g=1, d=64, page=16,
                            lanes=LANES), "int8")
    qp = [q[k] for k in ("k_pool", "v_pool", "k_scale", "v_scale")]
    with pytest.raises(ValueError):
        pa.paged_kv_update_quant(*qp, q["k_new"], q["v_new"], None, None, 0,
                                 dst=b["dst"].long())
    wide = _quant_pools(_batch(dev, torch.bfloat16, hkv=1, g=1, d=640,
                               page=16, lanes=LANES), "int8")
    wp = [wide[k] for k in ("k_pool", "v_pool", "k_scale", "v_scale")]
    with pytest.raises(ValueError):                  # D > 512
        pa.paged_kv_update_quant(*wp, wide["k_new"], wide["v_new"],
                                 wide["write_idx"], wide["tables_tok"], 0)


def test_kernel_launches_read_the_current_stream(dev):
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert pa._stream(dev.index) == side.cuda_stream
        assert pa._stream() == side.cuda_stream
    assert pa._stream(dev.index) == torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# The slot-cache writes: a block per slot over every head's K and V rows
# ---------------------------------------------------------------------------

# Cache kind -> (cache dtype, or None for int8; new-row dtype).
SLOT_WRITE_KINDS = {"bf16": (torch.bfloat16, torch.bfloat16),
                    "f32": (torch.float32, torch.float32),
                    "f32 rows into bf16": (torch.bfloat16, torch.float32),
                    "int8, bf16 rows": (None, torch.bfloat16),
                    "int8, f32 rows": (None, torch.float32)}


def _slot_write_case(dev, kind, hkv, d, batch, seed=0):
    """(caches, new rows, write index) of one slot-write batch: slots at a
    stripe's first and last rows and across a 16-row edge, one parked at
    S and one negative; every index at or past S or negative; or 300
    slots at random indices in [-2, S + 2) (an int64 index, cast by the
    wrapper).  The first row of slot 4 is all zero."""
    cache_dt, row_dt = SLOT_WRITE_KINDS[kind]
    quant = cache_dt is None
    s = 128 if quant else 48
    if batch == "many slots":
        rng = np.random.default_rng(seed)
        widx = torch.as_tensor(rng.integers(-2, s + 2, 300), device=dev)
    else:
        idx = ([s, s + 3, -1, -7, s, 2 ** 31 - 1]
               if batch == "every write drops" else [0, s - 1, s, -1, 16, 15])
        widx = torch.tensor(idx, dtype=torch.int32, device=dev)
    b = widx.shape[0]
    caches = _slot_cache(dev, cache_dt or torch.bfloat16, b=b, hkv=hkv, d=d,
                         s=s, quant=quant, seed=seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    new = [torch.randn(b, hkv, d, generator=gen, device=dev).to(row_dt) * 3
           for _ in range(2)]
    new[0][4] = 0.0
    return caches, new, widx


def _same(x, y):
    if x.dtype in (torch.bfloat16, torch.float32):
        return torch.equal(_bits(x), _bits(y))
    return torch.equal(x, y)


@pytest.mark.parametrize("batch", ["parked, negative and edges",
                                   "every write drops", "many slots"])
@pytest.mark.parametrize("hkv,d", [(2, 64), (2, 128), (8, 64), (8, 128),
                                   (20, 128)])  # 20: past 1024 threads
@pytest.mark.parametrize("kind", list(SLOT_WRITE_KINDS))   # and 32 warps
def test_slot_writes_bit_exact(dev, kind, hkv, d, batch):
    """kv_cache_update (kv_cache_update_quant for an int8 cache) leaves
    every cache byte and scale equal to its plain version's, launching
    once; a batch whose every write drops changes nothing."""
    from arks_tpu_torch.ops import pallas_attention as pl
    caches, new, widx = _slot_write_case(dev, kind, hkv, d, batch)
    fn = pl.kv_cache_update if len(caches) == 2 else pl.kv_cache_update_quant
    kern = [x.clone() for x in caches]
    plain = [x.clone() for x in caches]
    before = fn.launches
    fn(*kern, *new, widx, 1)
    fn(*plain, *new, widx, 1, impl="plain")
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    for g_, w_ in zip(kern, plain):
        assert _same(g_, w_)
    assert _same(kern[0], caches[0]) == (batch == "every write drops")
    if len(caches) == 4 and batch == "parked, negative and edges":
        assert kern[2][1, 4, :, 16].eq(1e-8).all()   # the all-zero row


def test_slot_writes_raise_on_unsupported(dev):
    from arks_tpu_torch.ops import pallas_attention as pl
    caches, new, widx = _slot_write_case(dev, "bf16", 2, 64, "many slots")
    for bad in (widx.cpu(), widx[:-1]):
        with pytest.raises(ValueError):
            pl.kv_cache_update(*caches, *new, bad, 1)
    with pytest.raises(ValueError):                  # layer out of range
        pl.kv_cache_update(*caches, *new, widx, 2)
    with pytest.raises(TypeError):
        pl.kv_cache_update(*(x.half() for x in caches), *new, widx, 1)
    wide = _slot_write_case(dev, "int8, bf16 rows", 1, 640, "many slots")
    with pytest.raises(ValueError):                  # D > 512
        pl.kv_cache_update_quant(*wide[0], *wide[1], wide[2], 1)
    q, qnew, qidx = _slot_write_case(dev, "int8, f32 rows", 2, 64,
                                     "many slots")
    with pytest.raises(ValueError):                  # rows on the CPU
        pl.kv_cache_update_quant(*q, *(x.cpu() for x in qnew), qidx, 1)
    with pytest.raises(TypeError):
        pl.kv_cache_update_quant(*q, *(x.half() for x in qnew), qidx, 1)


# ---------------------------------------------------------------------------
# qeinsum's grouped routes: projections (one group) and the dense MoE route
# (every expert over the same rows) through grouped_matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("eq,xshape,wshape", [
    ("...e,ef->...f", (8, 256), (256, 208)),
    ("...e,ef->...f", (2, 131, 256), (256, 1024)),
    ("...e,xef->...xf", (8, 256), (4, 256, 208)),
    ("...e,xef->...xf", (70, 256), (4, 256, 208)),
    ("...xf,xfe->...xe", (8, 4, 192), (4, 192, 256)),
])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2),
                                       (torch.float32, 1e-5)])
def test_qeinsum_grouped_route_vs_plain(dev, dtype, tol, bits, eq, xshape,
                                        wshape):
    """A quantized ``qeinsum`` on the card is one grouped_matmul launch that
    reads the raw int8/int4 weight, within GM_TOL of the largest |out| of
    ``qeinsum_plain`` (the convert, matmul and scale form)."""
    from arks_tpu_torch.models import quant
    from arks_tpu_torch.ops import moe_kernel as mk
    gen = torch.Generator(device=dev)
    gen.manual_seed(len(xshape) + bits)
    x = torch.randn(xshape, generator=gen, device=dev).to(dtype)
    w = (torch.randn(wshape, generator=gen, device=dev) * 0.02).to(dtype)
    leaf = quant.quantize_tensor_int4(w, 64) if bits == 4 else \
        quant.quantize_tensor(w)
    before = mk.grouped_matmul.launches
    got = quant.qeinsum(eq, x, leaf)
    assert mk.grouped_matmul.launches == before + 1
    want = quant.qeinsum(eq, x, leaf, impl="plain")
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == dtype
    scale = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=tol * scale)


def test_qeinsum_grouped_route_raises_on_unsupported(dev):
    """Shapes the kernel refuses raise on the card; nothing falls back to
    the convert form."""
    from arks_tpu_torch.models import quant
    x = torch.randn(8, 64, device=dev, dtype=torch.bfloat16)
    w = torch.randn(64, 40, device=dev, dtype=torch.bfloat16) * 0.02
    with pytest.raises(ValueError):          # N not a multiple of 16
        quant.qeinsum("...e,ef->...f", x, quant.quantize_tensor(w))
    with pytest.raises(ValueError):          # bf16: K not a multiple of 8
        quant.qeinsum("...e,ef->...f", x[:, :36],
                      quant.quantize_tensor(w[:36].repeat(1, 4)[:, :64]))
    with pytest.raises(ValueError):          # no grouped layout
        quant.qeinsum("be,ev->bv", x, quant.quantize_tensor(w[:, :32]))

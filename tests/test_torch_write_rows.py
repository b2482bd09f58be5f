"""Destinations resolved once per step (``paged_write_rows``) and the update
kernels' plain versions that take them, against the JAX reference on the
same numpy inputs.

Each batch goes through the reference's oracle scatter (``paged_update_xla``
under ``jax.jit``, as the reference runs it) and its Pallas
``paged_kv_update`` / ``paged_kv_update_quant`` in interpret mode, as the
JAX package's own tests run them; the port resolves each token's pool row
with ``paged_write_rows`` and writes through the plain version with
``dst``.  Pools and scales must come out bit-identical, for bf16 and f32
pools, f32 rows into a bf16 pool, and int8 and int4 pools.  A table entry
outside the pool is held against the oracle alone: the Pallas kernel
leaves that bounds check to the TPU's DMA engine, and its interpret mode
clamps the page instead.

Then ``mixed_step`` and the paged ``decode_step`` with and without the
step's destinations give identical logits and pools on ``tiny``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arks_tpu.ops import paged_attention as jpa
from arks_tpu_torch.models import get_config
from arks_tpu_torch.models import transformer as ttf
from arks_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(2)

PAGE, MAX_PAGES, N_PAGES, LAYERS, HKV, D = 128, 3, 20, 2, 2, 16
COVER = MAX_PAGES * PAGE

# Pool kind -> (pool dtype, new-row dtype, quantized bits or None).
KINDS = {"bf16": ("bfloat16", "bfloat16", None),
         "f32": ("float32", "float32", None),
         "f32 rows into bf16": ("bfloat16", "float32", None),
         "int8": (None, "float32", 8),
         "int4": (None, "bfloat16", 4)}

# Batch -> lanes [(first position, tokens)], then padding tokens.  Lane i
# owns pages 3i..3i+2 of one permutation of the pool, so no two lanes
# write one row.
BATCHES = {
    # one token per lane: a page's first and last rows, the coverage's
    # last row, and an inactive lane at the sentinel
    "decode-only": ([(0, 1), (127, 1), (128, 1), (300, 1), (COVER - 1, 1),
                     (COVER, 1)], 0),
    # a 20-token chunk across the page edge at 128, beside two decode lanes
    "chunk across a page edge": ([(118, 20), (5, 1), (256, 1)], 0),
    # a 9-token chunk and 4 padding tokens routed to the sentinel
    "padding tokens": ([(250, 9), (77, 1)], 4),
    # lane 1's table maps its second page outside the pool
    "table entry outside the pool": ([(120, 16), (130, 3), (7, 1)], 0),
    # int4 pair-mates in one dispatch (10-11 .. 14-15, 34-35, 36-37) and
    # lone mates (33, whose mate 32 is not written; 64; 200)
    "int4 pair-mates and lone mates": ([(10, 6), (33, 5), (64, 1),
                                        (200, 1)], 0),
}
OUTSIDE = "table entry outside the pool"


def _batch(name, seed):
    """Per-token write view (tables_tok [T, MaxP], write_idx [T]) of one
    batch over random lane tables."""
    lanes, n_pad = BATCHES[name]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(N_PAGES)
    tables = np.stack([perm[3 * i:3 * i + 3] for i in range(len(lanes))]) \
        .astype(np.int32)
    if name == OUTSIDE:
        tables[1, 1] = N_PAGES + 2
    rows, widx = [], []
    for lane, (p0, n) in enumerate(lanes):
        rows += [lane] * n
        widx += range(p0, p0 + n)
    rows += [0] * n_pad
    widx += [COVER] * n_pad
    return tables[rows], np.array(widx, np.int32)


def _case(kind, name, seed=0):
    pool_dt, row_dt, bits = KINDS[kind]
    rng = np.random.default_rng(seed + 100)
    tables_tok, widx = _batch(name, seed)
    t = widx.shape[0]
    c = dict(tables_tok=tables_tok, write_idx=widx, layer=1, bits=bits,
             row_dt=row_dt,
             k_new=rng.standard_normal((t, HKV, D)).astype(np.float32) * 3,
             v_new=rng.standard_normal((t, HKV, D)).astype(np.float32))
    if bits is None:
        shape = (LAYERS, N_PAGES, HKV, PAGE, D)
        c["pools"] = [rng.standard_normal(shape).astype(np.float32)
                      for _ in range(2)]
        c["pool_dt"] = pool_dt
        return c
    rows = PAGE // 2 if bits == 4 else PAGE
    lo = -128 if bits == 4 else -127
    c["pools"] = [rng.integers(lo, 128, (LAYERS, N_PAGES, HKV, rows, D))
                  .astype(np.int8) for _ in range(2)] + \
        [rng.uniform(0.002, 0.03, (LAYERS, N_PAGES, HKV, PAGE))
         .astype(np.float32) for _ in range(2)]
    return c


def _jax_pools(c):
    dt = c.get("pool_dt")
    return [jnp.asarray(x, dt) if dt else jnp.asarray(x) for x in c["pools"]]


def _torch_pools(c):
    dt = c.get("pool_dt")
    return [torch.from_numpy(x.copy()).to(getattr(torch, dt)) if dt
            else torch.from_numpy(x.copy()) for x in c["pools"]]


def _bits(x):
    """Pool bytes as integers: bf16 and f32 through their bit patterns."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.view(np.int16)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _reference(c, pallas: bool):
    """The reference's pools after the write: its jitted oracle, or its
    Pallas kernel in interpret mode."""
    pools = _jax_pools(c)
    kn = jnp.asarray(c["k_new"], c["row_dt"])
    vn = jnp.asarray(c["v_new"], c["row_dt"])
    args = (kn, vn, jnp.asarray(c["write_idx"]),
            jnp.asarray(c["tables_tok"]), c["layer"])
    if c["bits"] is None:
        if pallas:
            return jpa.paged_kv_update(*pools, *args, interpret=True)
        return jax.jit(jpa.paged_update_xla, static_argnums=8)(
            *pools, None, None, *args)[:2]
    if pallas:
        return jpa.paged_kv_update_quant(*pools, *args, interpret=True)
    return jax.jit(jpa.paged_update_xla, static_argnums=8)(*pools, *args)


@pytest.mark.parametrize("name", list(BATCHES))
@pytest.mark.parametrize("kind", list(KINDS))
def test_write_rows_and_plain_dst_write_bit_exact(kind, name):
    """paged_write_rows + the plain write with dst: every pool byte and
    scale equal to the reference's oracle and (table entries inside the
    pool) to its Pallas kernel in interpret mode; the CPU wrapper takes
    the plain version and counts no launch."""
    c = _case(kind, name)
    t = c["write_idx"].shape[0]
    tw = torch.from_numpy(c["write_idx"])
    tt = torch.from_numpy(c["tables_tok"])
    dst = tpa.paged_write_rows(tw, tt, PAGE, N_PAGES)
    assert dst.dtype == torch.int32 and dst.shape == (t,)
    # Each kept token's row is its table entry * P + offset; the sentinel,
    # padding and the entry outside the pool are -1.
    widx = c["write_idx"]
    pg = c["tables_tok"][np.arange(t), np.minimum(widx, COVER - 1) // PAGE]
    want = np.where((widx < COVER) & (pg < N_PAGES),
                    pg * PAGE + widx % PAGE, -1)
    np.testing.assert_array_equal(dst.numpy(), want)

    pools = _torch_pools(c)
    rows = (torch.from_numpy(c["k_new"]).to(getattr(torch, c["row_dt"])),
            torch.from_numpy(c["v_new"]).to(getattr(torch, c["row_dt"])))
    if c["bits"] is None:
        fn = tpa.paged_kv_update
    else:
        fn = tpa.paged_kv_update_quant
    before = fn.launches
    fn(*pools, *rows, None, None, c["layer"], dst=dst)
    assert fn.launches == before
    refs = [_reference(c, pallas=False)]
    if name != OUTSIDE:
        refs.append(_reference(c, pallas=True))
    for ref in refs:
        assert len(ref) == len(pools)
        for got, w in zip(pools, ref):
            np.testing.assert_array_equal(_bits(got), _bits(w))
    # The batch wrote something, and the plain write without dst agrees.
    assert not np.array_equal(_bits(pools[0]), _bits(c["pools"][0]))
    again = _torch_pools(c)
    fn(*again, *rows, tw, tt, c["layer"])
    for got, w in zip(again, pools):
        np.testing.assert_array_equal(_bits(got), _bits(w))


def test_write_rows_drop_negative_indices_and_rows_past_the_pool():
    """A negative write index is dropped, by paged_write_rows and by the
    plain write through write_idx / tables alike; a ``dst`` row past the
    pool is dropped by the plain write, as by the kernel."""
    tables = torch.tensor([[2, 0, 1], [1, 2, 0], [0, 1, 2]], dtype=torch.int32)
    widx = torch.tensor([-1, 17, 40], dtype=torch.int32)
    dst = tpa.paged_write_rows(widx, tables, 16, 3)
    assert dst.tolist() == [-1, 2 * 16 + 1, 2 * 16 + 8]
    new = torch.ones(3, 1, 8)
    pools = [[torch.zeros(1, 3, 1, 16, 8) for _ in range(2)]
             for _ in range(3)]
    tpa.paged_kv_update(*pools[0], new, new, widx, tables, 0)
    tpa.paged_kv_update(*pools[1], new, new, None, None, 0, dst=dst)
    assert torch.equal(pools[0][0], pools[1][0]) and pools[0][0].sum() == 16
    # -1 and 48 (3 pages of 16: one row past the pool) write nothing.
    tpa.paged_kv_update(*pools[2], new, new, None, None, 0,
                        dst=torch.tensor([-1, 48, 5], dtype=torch.int32))
    k = pools[2][0]
    assert k.sum() == 8 and k[0, 0, 0, 5].eq(1).all()


# ---------------------------------------------------------------------------
# The model step with and without the step's destinations
# ---------------------------------------------------------------------------


def _tiny(kv):
    cfg = get_config("tiny")
    params = ttf.init_params(cfg, 0, torch.float32, "cpu")
    cache = lambda: ttf.init_paged_cache(  # noqa: E731
        cfg, 8, 16, torch.float32, "cpu", quantized=kv is not None,
        kv_bits=4 if kv == "int4" else 8)
    return cfg, params, cache


def _same_caches(a, b):
    for x, y in zip(a, b):
        if x is not None:
            assert torch.equal(x, y)


@pytest.mark.parametrize("kv", [None, "int8", "int4"])
def test_mixed_step_with_and_without_dst_identical(kv, monkeypatch):
    """Two mixed steps on tiny: the updates through ``prepare_mixed``'s
    ``dst`` and through write_idx / tables give identical logits and
    pools (f32, int8 and int4 pools)."""
    cfg, params, cache = _tiny(kv)
    tables = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32)  # noqa: E731
    # lane 0 prefills 21 tokens across a 16-token page, lane 1 decodes at
    # 6 over a pool the first step wrote; two padding tokens.
    steps = [
        (list(range(2, 23)) + [7] * 7, [0] * 21 + [1] * 7,
         list(range(21)) + list(range(7)), [20, 27], [0, 21], [21, 7],
         [0, 0]),
        ([9, 11, 0, 0], [0, 1, -1, -1], [21, 7, 64, 64], [0, 1], [0, 1],
         [1, 1], [21, 7]),
    ]
    real = ttf.prepare_mixed
    caches = {"dst": cache(), "no dst": cache()}
    for step in steps:
        out = {}
        for how, c in caches.items():
            if how == "no dst":
                monkeypatch.setattr(ttf, "prepare_mixed",
                                    lambda *a, **k: real(*a, **k)._replace(
                                        dst=None))
            else:
                monkeypatch.setattr(ttf, "prepare_mixed", real)
            out[how] = ttf.mixed_step(params, cfg, c, tables,
                                      *(i32(a) for a in step))
        assert torch.equal(out["dst"], out["no dst"])
        _same_caches(caches["dst"], caches["no dst"])
    assert caches["dst"].k.any()


@pytest.mark.parametrize("kv", [None, "int8", "int4"])
def test_decode_step_with_and_without_dst_identical(kv, monkeypatch):
    """Three paged decode steps on tiny, slots across a page edge, one
    inactive (its length at the coverage sentinel): the step's resolved
    ``dst`` and write_idx / tables give identical logits and pools."""
    cfg, params, cache = _tiny(kv)
    tables = torch.tensor([[3, 1, 0, 2], [4, 5, 6, 7], [0, 0, 0, 0]],
                          dtype=torch.int32)
    real = ttf.paged_write_rows
    caches = {"dst": cache(), "no dst": cache()}
    for step in range(3):
        tokens = torch.tensor([5 + step, 9, 2], dtype=torch.int32)
        lengths = torch.tensor([15 + step, 40 + step, 64], dtype=torch.int32)
        out = {}
        for how, c in caches.items():
            monkeypatch.setattr(ttf, "paged_write_rows",
                                real if how == "dst"
                                else lambda *a, **k: None)
            out[how] = ttf.decode_step(params, cfg, c, tokens, lengths,
                                       tables)
        assert torch.equal(out["dst"], out["no dst"])
        _same_caches(caches["dst"], caches["no dst"])
    assert caches["dst"].k.any()

"""The port's ops against the JAX reference on the same numpy inputs:
norms and rope (f32, atol 1e-6), the ragged work list and the pool
scatter (bit-exact), and ``paged_mixed_update_and_attend`` against both the
reference's XLA oracle and its Pallas kernel run in interpret mode
(f32, atol 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arks_tpu.ops import attention as jattn
from arks_tpu.ops import norms as jnorms
from arks_tpu.ops import paged_attention as jpa
from arks_tpu.ops import rope as jrope
from arks_tpu_torch.ops import attention as tattn
from arks_tpu_torch.ops import norms as tnorms
from arks_tpu_torch.ops import paged_attention as tpa
from arks_tpu_torch.ops import rope as trope

torch.set_num_threads(2)


def _np(x):
    """torch -> numpy, bfloat16 through its bit pattern."""
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy()
    return x.numpy()


def _jnp_bits(x):
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal((64,)).astype(np.float32)
    want = np.asarray(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    got = tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape,theta", [((7, 4, 16), 10000.0),
                                         ((2, 9, 8, 8), 1e6)])
def test_apply_rope_matches_jax(shape, theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    pos = rng.integers(0, 4000, shape[:-2]).astype(np.int32)
    want = np.asarray(jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                       theta))
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("qmax,hkv", [(1, 4), (7, 4), (257, 4), (33, 2),
                                       (16, 8)])
def test_mixed_grid_plan_matches_jax(qmax, hkv):
    """The port's fixed plan is the reference's at block_q = MAX_BLOCK_Q
    and head_group = 1."""
    want = jpa.mixed_grid_plan(qmax, hkv=hkv, g=7, d=128, page=256,
                               kv="bfloat16", block_q=tpa.MAX_BLOCK_Q,
                               grid="ragged", dma_depth=2, head_group=1)
    assert want["head_group"] == 1
    got = tpa.mixed_grid_plan(qmax)
    assert got == {k: want[k] for k in ("block_q", "qpad", "num_qb")}


@pytest.mark.parametrize("seed,s,block_q,num_qb,head_groups,page,max_pages", [
    (0, 4, 8, 3, 1, 16, 4),
    (1, 8, 8, 33, 4, 256, 16),     # qwen2.5-7b engine shape, 4 KV heads
    (2, 5, 4, 5, 2, 8, 3),
    (3, 3, 2, 4, 1, 4, 2),         # causal ends clamp at the table width
    (4, 6, 8, 2, 4, 16, 4),        # every lane inactive but one
])
def test_build_mixed_work_list_bit_exact(seed, s, block_q, num_qb,
                                         head_groups, page, max_pages):
    rng = np.random.default_rng(seed)
    q_len = rng.integers(0, block_q * num_qb + 1, s).astype(np.int32)
    q_len[rng.random(s) < 0.3] = 0
    if seed == 4:
        q_len[:] = 0
        q_len[2] = 3
    pos = rng.integers(0, page * max_pages, s).astype(np.int32)
    want = jpa.build_mixed_work_list(
        jnp.asarray(pos), jnp.asarray(q_len), page=page, block_q=block_q,
        num_qb=num_qb, max_pages=max_pages, head_groups=head_groups)
    got = tpa.build_mixed_work_list(
        torch.from_numpy(pos), torch.from_numpy(q_len), page=page,
        block_q=block_q, num_qb=num_qb, max_pages=max_pages,
        head_groups=head_groups)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed,s,block_q,num_qb,head_groups,page,max_pages", [
    (0, 4, 8, 3, 1, 16, 4),
    (1, 8, 32, 9, 4, 256, 16),     # qwen2.5-7b engine shape at block_q 32
    (2, 5, 4, 5, 2, 8, 3),
    (4, 6, 8, 2, 4, 16, 4),
])
def test_build_mixed_work_list_spans_bit_exact(seed, s, block_q, num_qb,
                                               head_groups, page, max_pages):
    """Page spans [page_lo, page_hi) per lane, the windowed-residency hook:
    the port's list is the reference's bit for bit (a span below, across
    and past each lane's pages, and lo above hi)."""
    rng = np.random.default_rng(seed)
    q_len = rng.integers(0, block_q * num_qb + 1, s).astype(np.int32)
    q_len[rng.random(s) < 0.3] = 0
    pos = rng.integers(0, page * max_pages, s).astype(np.int32)
    lo = rng.integers(0, max_pages + 1, s).astype(np.int32)
    hi = rng.integers(0, max_pages + 2, s).astype(np.int32)
    kw = dict(page=page, block_q=block_q, num_qb=num_qb,
              max_pages=max_pages, head_groups=head_groups)
    for spans in (dict(page_lo=lo), dict(page_hi=hi),
                  dict(page_lo=lo, page_hi=hi)):
        want = jpa.build_mixed_work_list(
            jnp.asarray(pos), jnp.asarray(q_len), **kw,
            **{k: jnp.asarray(v) for k, v in spans.items()})
        got = tpa.build_mixed_work_list(
            torch.from_numpy(pos), torch.from_numpy(q_len), **kw,
            **{k: torch.from_numpy(v) for k, v in spans.items()})
        for w, g in zip(want, got):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("grid", ["ragged", "dense"])
@pytest.mark.parametrize("page", [16, 512])
def test_mixed_pieces_layout(grid, page):
    """The split-KV layout of a step's items: each real item has
    (pages - plo) x pieces_per_page pieces (a page past 256 positions is cut
    into pieces of 256), padding and idle items none; pcum is their running
    sum, pbase the running sum of count x rows before each item, and pitem
    names each piece's item over the grid's static bound."""
    rng = np.random.default_rng(3)
    s, hkv, maxp = 6, 2, 4
    q_len = torch.tensor([1, 0, 9, 17, 3, 0], dtype=torch.int32)
    pos = torch.from_numpy(rng.integers(0, page * 2, s).astype(np.int32))
    tables = torch.zeros((s, maxp), dtype=torch.int32)
    q_start = torch.cumsum(q_len, 0).to(torch.int32) - q_len
    work = tpa.mixed_work(tables, q_start, q_len, pos, page=page, hkv=hkv,
                          qmax=17, grid=grid)
    pcum, pbase, pitem = (x.tolist() for x in work.pieces)
    if grid == "ragged":
        seq, _, qb, plo, pages = (x.tolist() for x in work.items)
    else:
        seq, qb, plo, pages = (x.tolist() for x in tpa.dense_items(
            pos, q_len, page=page, block_q=work.block_q,
            num_qb=work.num_qb, hkv=hkv, max_pages=maxp))
        assert len(seq) == s * hkv * work.num_qb
    ppp = max(1, page // 256)
    total = used = 0
    for i in range(len(seq)):
        rows = max(0, min(work.block_q, int(q_len[seq[i]]) - qb[i]
                          * work.block_q))
        count = max(0, pages[i] - plo[i]) * ppp if rows else 0
        assert pbase[i] == used
        total += count
        used += count * rows
        assert pcum[i] == total
        assert pitem[total - count:total] == [i] * count
    assert total > 0
    assert len(pitem) == len(seq) * maxp * ppp


def _pool(rng, shape, jdt=jnp.float32, tdt=torch.float32):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_update_bit_exact(dtype):
    """Pool bytes after the scatter are identical to the reference's
    (oracle scatter AND the Pallas update kernel in interpret mode); rows
    at the coverage sentinel are dropped."""
    jdt, tdt = _DT[dtype]
    rng = np.random.default_rng(5)
    l, n, hkv, p, d, maxp, t = 2, 6, 2, 16, 8, 3, 9
    jk, tk = _pool(rng, (l, n, hkv, p, d), jdt, tdt)
    jv, tv = _pool(rng, (l, n, hkv, p, d), jdt, tdt)
    kn = rng.standard_normal((t, hkv, d)).astype(np.float32)
    vn = rng.standard_normal((t, hkv, d)).astype(np.float32)
    tables = np.stack([rng.permutation(n)[:maxp] for _ in range(t)]) \
        .astype(np.int32)
    widx = rng.permutation(maxp * p)[:t].astype(np.int32)
    widx[[2, 6]] = maxp * p                       # dropped rows
    layer = 1
    want_k, want_v, _, _ = jpa.paged_update_xla(
        jk, jv, None, None, jnp.asarray(kn, jdt), jnp.asarray(vn, jdt),
        jnp.asarray(widx), jnp.asarray(tables), layer)
    pal_k, pal_v = jpa.paged_kv_update(
        jk, jv, jnp.asarray(kn, jdt), jnp.asarray(vn, jdt),
        jnp.asarray(widx), jnp.asarray(tables), layer, interpret=True)
    args = (torch.from_numpy(kn).to(tdt), torch.from_numpy(vn).to(tdt),
            torch.from_numpy(widx), torch.from_numpy(tables), layer)
    k0, v0 = tk.clone(), tv.clone()
    tpa.paged_update_xla(tk, tv, None, None, *args)
    for ref in (want_k, pal_k):
        np.testing.assert_array_equal(_np(tk), _jnp_bits(ref))
    for ref in (want_v, pal_v):
        np.testing.assert_array_equal(_np(tv), _jnp_bits(ref))
    # The kernel wrapper on CPU tensors runs the same plain scatter.
    tpa.paged_kv_update(k0, v0, *args)
    np.testing.assert_array_equal(_np(k0), _np(tk))
    np.testing.assert_array_equal(_np(v0), _np(tv))


def test_paged_gather_kv_bit_exact():
    rng = np.random.default_rng(6)
    jk, tk = _pool(rng, (2, 5, 2, 4, 8))
    tables = rng.integers(0, 5, (3, 3)).astype(np.int32)
    want = jpa.paged_gather_kv(jk, jnp.asarray(tables), 1)
    got = tpa.paged_gather_kv(tk, torch.from_numpy(tables), 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _mixed_batch(rng, *, n, maxp, p):
    """Flat mixed batch over 5 lanes: two decode lanes (one at a page
    boundary), a chunk lane crossing pages mid-page, an inactive lane, a
    chunk lane from position 0, then padding tokens."""
    lanes = {0: (13, 1), 1: (p - 6, 10), 3: (0, 6), 4: (2 * p - 1, 1)}
    s = 5
    q_start = np.zeros(s, np.int32)
    q_len = np.zeros(s, np.int32)
    pos_start = np.zeros(s, np.int32)
    slot, pos = [], []
    for lane, (p0, ql) in lanes.items():
        q_start[lane] = len(slot)
        q_len[lane] = ql
        pos_start[lane] = p0
        slot += [lane] * ql
        pos += list(range(p0, p0 + ql))
    slot += [-1, -1, -1]                        # padding tokens
    pos += [maxp * p] * 3
    tables = np.stack([rng.permutation(n)[:maxp] for _ in range(s)]) \
        .astype(np.int32)
    return dict(tables=tables, token_slot=np.array(slot, np.int32),
                token_pos=np.array(pos, np.int32), seq_q_start=q_start,
                seq_q_len=q_len, seq_pos_start=pos_start)


def _attend_case(seed=11):
    rng = np.random.default_rng(seed)
    l, n, hkv, g, p, d, maxp = 2, 12, 2, 3, 16, 16, 3
    b = _mixed_batch(rng, n=n, maxp=maxp, p=p)
    t = b["token_slot"].shape[0]
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa
    return dict(q=f(t, hkv * g, d), k_new=f(t, hkv, d), v_new=f(t, hkv, d),
                k_pool=f(l, n, hkv, p, d), v_pool=f(l, n, hkv, p, d),
                layer=1, **b)


_BATCH_KEYS = ("tables", "token_slot", "token_pos", "seq_q_start",
               "seq_q_len", "seq_pos_start")


def _jax_attend(c, impl):
    out, kp, vp, _, _ = jattn.paged_mixed_update_and_attend(
        jnp.asarray(c["q"]), jnp.asarray(c["k_new"]), jnp.asarray(c["v_new"]),
        jnp.asarray(c["k_pool"]), jnp.asarray(c["v_pool"]),
        *(jnp.asarray(c[k]) for k in _BATCH_KEYS), c["layer"], impl=impl)
    return np.asarray(out), np.asarray(kp), np.asarray(vp)


def _torch_attend(c, impl):
    kp = torch.from_numpy(c["k_pool"].copy())
    vp = torch.from_numpy(c["v_pool"].copy())
    out = tattn.paged_mixed_update_and_attend(
        torch.from_numpy(c["q"]), torch.from_numpy(c["k_new"]),
        torch.from_numpy(c["v_new"]), kp, vp,
        *(torch.from_numpy(c[k]) for k in _BATCH_KEYS), c["layer"],
        impl=impl)
    return out.numpy(), kp.numpy(), vp.numpy()


def _valid_rows(c):
    return c["token_slot"] >= 0


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_mixed_update_and_attend_vs_jax_oracle(impl):
    """Port vs the reference's XLA oracle (its CPU default).  The plain
    path reproduces the oracle on every row; the kernel path (its plain
    versions on CPU) on every valid row, with padding rows zero."""
    c = _attend_case()
    want, wk, wv = _jax_attend(c, "xla")
    got, gk, gv = _torch_attend(c, impl)
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gv, wv)
    rows = slice(None) if impl == "plain" else _valid_rows(c)
    np.testing.assert_allclose(got[rows], want[rows], atol=1e-5, rtol=0)
    if impl == "kernel":
        assert not got[~_valid_rows(c)].any()


def test_mixed_update_and_attend_vs_pallas_interpret(monkeypatch):
    """Port kernel path vs the reference's ragged Pallas kernel, run
    interpreted on the CPU: every row, padding rows exactly zero."""
    monkeypatch.setenv("ARKS_ATTN_IMPL", "pallas")
    c = _attend_case(seed=12)
    want, wk, wv = _jax_attend(c, "pallas")
    got, gk, gv = _torch_attend(c, "kernel")
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert not got[~_valid_rows(c)].any() and not want[~_valid_rows(c)].any()


def test_paged_mixed_attention_plain_vs_pallas_per_lane():
    """The plain version of the attention kernel against the reference's
    ``paged_mixed_attention`` on its own per-lane layout [S, Hkv, G, Q, D]
    (the gather the port's kernel does not need is done here)."""
    c = _attend_case(seed=13)
    hkv, d = c["k_pool"].shape[2], c["q"].shape[-1]
    g = c["q"].shape[1] // hkv
    s = c["seq_q_len"].shape[0]
    qmax = int(c["seq_q_len"].max())
    span = c["seq_q_start"][:, None] + np.arange(qmax)
    qs = c["q"][np.minimum(span, len(c["q"]) - 1)]       # [S, Q, H, D]
    qs = qs.reshape(s, qmax, hkv, g, d).transpose(0, 2, 3, 1, 4)
    want = np.asarray(jpa.paged_mixed_attention(
        jnp.asarray(qs), jnp.asarray(c["k_pool"]), jnp.asarray(c["v_pool"]),
        jnp.asarray(c["tables"]), jnp.asarray(c["seq_pos_start"]),
        jnp.asarray(c["seq_q_len"]), c["layer"], interpret=True))
    got = tpa.paged_mixed_attention_plain(
        torch.from_numpy(c["q"]), torch.from_numpy(c["k_pool"]),
        torch.from_numpy(c["v_pool"]), torch.from_numpy(c["tables"]),
        torch.from_numpy(c["seq_q_start"]), torch.from_numpy(c["seq_q_len"]),
        torch.from_numpy(c["seq_pos_start"]), c["layer"], qmax=qmax).numpy()
    for lane in range(s):
        for i in range(int(c["seq_q_len"][lane])):
            t = c["seq_q_start"][lane] + i
            np.testing.assert_allclose(
                got[t].reshape(hkv, g, d), want[lane, :, :, i], atol=1e-5,
                rtol=0)
    assert not want[c["seq_q_len"] == 0].any()


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_paged_mixed_attention_plain_vs_pallas_dense_grid(kv):
    """The reference's dense-grid kernel (``grid="dense"``, its
    ``_paged_mixed_kernel``) in interpret mode against the port's plain
    version, which both of the port's launches (ragged and dense) are held
    to on the card."""
    c = _attend_case(seed=14)
    hkv, d = c["k_pool"].shape[2], c["q"].shape[-1]
    g = c["q"].shape[1] // hkv
    s = c["seq_q_len"].shape[0]
    qmax = int(c["seq_q_len"].max())
    span = c["seq_q_start"][:, None] + np.arange(qmax)
    qs = c["q"][np.minimum(span, len(c["q"]) - 1)]
    qs = qs.reshape(s, qmax, hkv, g, d).transpose(0, 2, 3, 1, 4)
    pools = (c["k_pool"], c["v_pool"])
    jsc, tsc = {}, {}
    if kv == "int8":
        qk, ks = tpa.quantize_kv(torch.from_numpy(c["k_pool"]))
        qv, vs = tpa.quantize_kv(torch.from_numpy(c["v_pool"]))
        pools = (qk.numpy(), qv.numpy())
        jsc = dict(k_scale=jnp.asarray(ks.numpy()),
                   v_scale=jnp.asarray(vs.numpy()))
        tsc = dict(k_scale=ks, v_scale=vs)
    want = np.asarray(jpa.paged_mixed_attention(
        jnp.asarray(qs), jnp.asarray(pools[0]), jnp.asarray(pools[1]),
        jnp.asarray(c["tables"]), jnp.asarray(c["seq_pos_start"]),
        jnp.asarray(c["seq_q_len"]), c["layer"], interpret=True,
        grid="dense", **jsc))
    got = tpa.paged_mixed_attention(
        torch.from_numpy(c["q"]), torch.from_numpy(pools[0]),
        torch.from_numpy(pools[1]), torch.from_numpy(c["tables"]),
        torch.from_numpy(c["seq_q_start"]), torch.from_numpy(c["seq_q_len"]),
        torch.from_numpy(c["seq_pos_start"]), c["layer"], qmax=qmax,
        grid="dense", **tsc).numpy()
    for lane in range(s):
        for i in range(int(c["seq_q_len"][lane])):
            t = c["seq_q_start"][lane] + i
            np.testing.assert_allclose(
                got[t].reshape(hkv, g, d), want[lane, :, :, i], atol=1e-5,
                rtol=0)
    assert not want[c["seq_q_len"] == 0].any()
    assert not got[c["token_slot"] < 0].any()


def test_mixed_grid_mode_matches_reference(monkeypatch):
    monkeypatch.delenv("ARKS_MIXED_GRID", raising=False)
    assert tpa.mixed_grid_mode() == jpa.mixed_grid_mode() == "ragged"
    for value in ("ragged", "dense", "DENSE"):
        monkeypatch.setenv("ARKS_MIXED_GRID", value)
        assert tpa.mixed_grid_mode() == jpa.mixed_grid_mode()
    monkeypatch.setenv("ARKS_MIXED_GRID", "sparse")
    with pytest.raises(ValueError):
        tpa.mixed_grid_mode()
    with pytest.raises(ValueError):
        jpa.mixed_grid_mode()


def test_mixed_work_per_grid(monkeypatch):
    """The ragged grid's work builds its list; the dense grid's needs none
    (its CTAs find their items).  The step's grid is resolved once, from
    ``ARKS_MIXED_GRID``, when ``prepare_mixed`` builds the work."""
    c = _attend_case()
    lane = [torch.from_numpy(c[k]) for k in ("tables", "seq_q_start",
                                             "seq_q_len", "seq_pos_start")]
    ragged = tpa.mixed_work(*lane, page=c["k_pool"].shape[3], hkv=2,
                            qmax=5, grid="ragged")
    dense = tpa.mixed_work(*lane, page=c["k_pool"].shape[3], hkv=2, qmax=5,
                           grid="dense")
    assert ragged.grid == "ragged" and len(ragged.items) == 5
    assert dense.grid == "dense" and dense.items is None
    assert (dense.block_q, dense.num_qb) == (ragged.block_q, ragged.num_qb)
    monkeypatch.setenv("ARKS_MIXED_GRID", "dense")
    assert tpa.mixed_work(*lane, page=c["k_pool"].shape[3], hkv=2,
                          qmax=5).grid == "dense"
    with pytest.raises(ValueError):
        tpa.paged_mixed_attention_dense(
            torch.from_numpy(c["q"]), torch.from_numpy(c["k_pool"]),
            torch.from_numpy(c["v_pool"]), dense, c["layer"])


def test_kernel_wrappers_reject_bad_impl():
    c = _attend_case()
    with pytest.raises(ValueError):
        _torch_attend(c, "fast")


# ---------------------------------------------------------------------------
# The reference kernel's span and state arguments
# ---------------------------------------------------------------------------


def _span_case(kv, seed=15):
    """_attend_case's batch with f32, int8 or int4 (packed) pools: the
    port's flat inputs and the reference's per-lane queries."""
    c = _attend_case(seed)
    hkv, d = c["k_pool"].shape[2], c["q"].shape[-1]
    g = c["q"].shape[1] // hkv
    s = c["seq_q_len"].shape[0]
    qmax = int(c["seq_q_len"].max())
    span = c["seq_q_start"][:, None] + np.arange(qmax)
    qs = c["q"][np.minimum(span, len(c["q"]) - 1)]
    qs = qs.reshape(s, qmax, hkv, g, d).transpose(0, 2, 3, 1, 4)
    pools = [torch.from_numpy(c["k_pool"]), torch.from_numpy(c["v_pool"])]
    tsc = {}
    if kv != "f32":
        qmax_v = 7 if kv == "int4" else 127
        vals = [tpa.quantize_kv(p, qmax=qmax_v) for p in pools]
        pools = [tpa.pack_int4(v, 3) if kv == "int4" else v for v, _ in vals]
        tsc = dict(k_scale=vals[0][1], v_scale=vals[1][1])
    jsc = {k: jnp.asarray(v.numpy()) for k, v in tsc.items()}
    return c, qs, qmax, pools, tsc, jsc


def _ref_state_flat(state, c, qmax):
    """The reference's state (m, l [S, Hkv, G, qpad, 128]; acc [S, Hkv, G,
    qpad, D]) in the port's flat layout: m, l [T, H], acc [T, H, D]."""
    m, l, acc = (np.asarray(x) for x in state)
    s, hkv, g = m.shape[:3]
    t = c["q"].shape[0]
    out = [np.zeros((t, hkv * g), np.float32),
           np.zeros((t, hkv * g), np.float32),
           np.zeros((t, hkv * g, acc.shape[-1]), np.float32)]
    for lane in range(s):
        for i in range(int(c["seq_q_len"][lane])):
            tok = c["seq_q_start"][lane] + i
            out[0][tok] = m[lane, :, :, i, 0].reshape(-1)
            out[1][tok] = l[lane, :, :, i, 0].reshape(-1)
            out[2][tok] = acc[lane, :, :, i].reshape(hkv * g, -1)
    return out


@pytest.mark.parametrize("kv", ["f32", "int8", "int4"])
def test_paged_mixed_attention_plain_span_state_vs_pallas(kv):
    """The plain version with page_lo/page_hi/carry_state/emit_state
    against the reference's ragged Pallas kernel in interpret mode: the
    emitted state of [0, 1) within 2e-5 after the layout conversion (rows
    no lane owns zero in both), the chained output [1, end) within 1e-5 of
    the reference's chained output, and the plain chained output equal to
    the plain single call (the split-and-fold form bit for bit, the
    one-pass form within 1e-6)."""
    c, qs, qmax, pools, tsc, jsc = _span_case(kv)
    split = np.ones_like(c["seq_q_len"])
    plan = tpa.mixed_grid_plan(qmax)
    jkw = dict(block_q=plan["block_q"], head_group=1, interpret=True,
               grid="ragged", **jsc)
    jargs = (jnp.asarray(qs), jnp.asarray(pools[0].numpy()),
             jnp.asarray(pools[1].numpy()), jnp.asarray(c["tables"]),
             jnp.asarray(c["seq_pos_start"]), jnp.asarray(c["seq_q_len"]),
             c["layer"])
    jstate = jpa.paged_mixed_attention(*jargs, page_hi=jnp.asarray(split),
                                       emit_state=True, **jkw)
    jout = np.asarray(jpa.paged_mixed_attention(
        *jargs, page_lo=jnp.asarray(split), carry_state=jstate, **jkw))
    targs = (torch.from_numpy(c["q"]), *pools, torch.from_numpy(c["tables"]),
             torch.from_numpy(c["seq_q_start"]),
             torch.from_numpy(c["seq_q_len"]),
             torch.from_numpy(c["seq_pos_start"]), c["layer"])
    tsplit = torch.from_numpy(split)
    for form in (False, True):
        kw = dict(qmax=qmax, split=form, **tsc)
        state = tpa.paged_mixed_attention_plain(*targs, page_hi=tsplit,
                                                emit_state=True, **kw)
        for got, want in zip(state, _ref_state_flat(jstate, c, qmax)):
            np.testing.assert_allclose(got.numpy(), want, atol=2e-5,
                                       rtol=2e-5)
        chained = tpa.paged_mixed_attention_plain(
            *targs, page_lo=tsplit, carry_state=state, **kw)
        single = tpa.paged_mixed_attention_plain(*targs, **kw)
        if form:
            assert torch.equal(chained, single)
        else:
            torch.testing.assert_close(chained, single, atol=1e-6, rtol=0)
        for lane in range(c["seq_q_len"].shape[0]):
            for i in range(int(c["seq_q_len"][lane])):
                t = c["seq_q_start"][lane] + i
                np.testing.assert_allclose(
                    chained[t].reshape(jout.shape[1:3] + (-1,)).numpy(),
                    jout[lane, :, :, i], atol=1e-5, rtol=0)
        assert not chained[~_valid_rows(c)].any()
        assert not state[2][~_valid_rows(c)].any()


@pytest.mark.parametrize("kv", ["f32", "int8", "int4"])
def test_paged_mixed_attention_split_plain_vs_unsplit(kv):
    """The kernel's split-KV form (pieces of one page, each from
    (-1e30, 0, 0), folded left in page order) against the one-pass plain
    version within 1e-5 in f32, and the CPU wrapper is the one-pass
    form."""
    c, _, qmax, pools, tsc, _ = _span_case(kv, seed=16)
    targs = (torch.from_numpy(c["q"]), *pools, torch.from_numpy(c["tables"]),
             torch.from_numpy(c["seq_q_start"]),
             torch.from_numpy(c["seq_q_len"]),
             torch.from_numpy(c["seq_pos_start"]), c["layer"])
    one = tpa.paged_mixed_attention_plain(*targs, qmax=qmax, **tsc)
    split = tpa.paged_mixed_attention_plain(*targs, qmax=qmax, split=True,
                                            **tsc)
    torch.testing.assert_close(split, one, atol=1e-5, rtol=0)
    assert torch.equal(tpa.paged_mixed_attention(*targs, qmax=qmax, **tsc),
                       one)

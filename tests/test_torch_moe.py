"""The port's MoE block (``models/moe.py``, ``ops/moe_kernel.py``) against
the reference's on the same numpy inputs: the model configs field for
field; ``router_topk`` / ``router_weights``; ``pad_groups`` bit for bit
and ``tile_rows`` exact against its layout;
the grouped matmul's plain version against the Pallas ``_gm_kernel`` run
in interpret mode (f32, int8, int4; 1e-5 relative); ``moe_ffn`` dense and
grouped on both ``ARKS_MOE_KERNEL`` routes (f32, 1e-5 relative); and the
grouped-or-dense choice of each model entry point against the
reference's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arks_tpu.models import get_config as jax_get_config
from arks_tpu.models import moe as jmoe
from arks_tpu.models import quant as jquant
from arks_tpu.models import transformer as jtf
from arks_tpu.ops import moe_kernel as jmk
from arks_tpu_torch.models import get_config
from arks_tpu_torch.models import moe as tmoe
from arks_tpu_torch.models import quant as tquant
from arks_tpu_torch.models import transformer as ttf
from arks_tpu_torch.models.weights import params_from_numpy
from arks_tpu_torch.ops import moe_kernel as tmk

torch.set_num_threads(2)

RTOL = 1e-5
MOE_CONFIGS = ["tiny-moe", "tiny-mixtral", "mixtral-8x7b", "qwen2-57b-a14b"]


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("name", MOE_CONFIGS)
def test_moe_configs_match_the_reference(name):
    assert dataclasses.asdict(get_config(name)) == \
        dataclasses.asdict(jax_get_config(name))


@pytest.mark.parametrize("name", ["tiny-moe", "tiny-mixtral"])
def test_router_matches_jax(name):
    """Random logits, and rows with tied probabilities (ties go to the
    lower expert index, as lax.top_k)."""
    cfg, jcfg = get_config(name), jax_get_config(name)
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((40, cfg.num_experts)).astype(np.float32)
    logits[0] = 0.5                       # every expert tied
    logits[1, 1::2] = 2.0                 # ties among the top ones
    jv, ji = jmoe.router_topk(jnp.asarray(logits), jcfg)
    tv, ti = tmoe.router_topk(torch.from_numpy(logits), cfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tv, jv)
    _close(tmoe.router_weights(torch.from_numpy(logits), cfg),
           jmoe.router_weights(jnp.asarray(logits), jcfg))


def _groups(sizes, k=24, seed=0):
    """Expert-sorted rows for group ``sizes`` (zeros = empty experts)."""
    rng = np.random.default_rng(seed)
    sorted_expert = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
    xs = rng.standard_normal((len(sorted_expert), k)).astype(np.float32)
    return xs, sorted_expert, np.asarray(sizes, np.int32)


# Group sizes: an empty expert, exact multiples of block_t, a 1-row group.
GROUPS = [[5, 0, 16, 1, 8], [8, 8, 0, 0], [0, 3, 0, 29], [1, 1, 1, 1, 1, 1]]


@pytest.mark.parametrize("sizes", GROUPS)
def test_pad_groups_bit_exact(sizes):
    xs, se, gs = _groups(sizes)
    want = jmk.pad_groups(jnp.asarray(xs), jnp.asarray(se), jnp.asarray(gs), 8)
    got = tmk.pad_groups(torch.from_numpy(xs), torch.from_numpy(se),
                         torch.from_numpy(gs), 8)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    used = int(tmk.rows_used(torch.from_numpy(gs), 8))
    assert used == sum(-(-n // 8) * 8 for n in sizes)
    assert not got[0][used:].any()            # tiles past the groups: zeros


# Group sizes at block_t 128: empty, 1-row, 64-row (one M block of the
# kernel), 65-row (crosses it), 128-row and 129-row groups.
TILE_GROUPS = [[0, 1, 64, 65, 128, 0, 129], [3, 1, 2, 4, 0, 2, 2, 2],
               [128, 0, 1, 97, 88, 70, 80, 64], [0, 0, 0], [65]]


@pytest.mark.parametrize("sizes", TILE_GROUPS)
def test_tile_rows_matches_reference_pad_groups(sizes):
    """Each tile's real rows, exact, against the rows the reference's
    ``pad_groups`` places in it (its ``dest`` map), tiles past the groups
    0; a tile's real rows are its first ones (the rest are zero)."""
    bt = 128
    xs, se, gs = _groups(sizes, k=4)
    xs += 1.0                                   # no routed row is all zero
    xs_p, dest, _ = jmk.pad_groups(jnp.asarray(xs), jnp.asarray(se),
                                   jnp.asarray(gs), bt)
    n_tiles = xs_p.shape[0] // bt
    want = np.bincount(np.asarray(dest) // bt, minlength=n_tiles)
    got = tmk.tile_rows(torch.from_numpy(gs), n_tiles, bt)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    nonzero = np.asarray(xs_p).any(axis=1).reshape(n_tiles, bt)
    for i, n in enumerate(want):
        assert nonzero[i, :n].all() and not nonzero[i, n:].any()


def _weights(mode, nx, k, n, seed=3):
    """((jax weight, jax scale kwargs), (torch weight, torch scale kwargs))
    of a grouped_matmul weight in ``mode``."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((nx, k, n)) * 0.05).astype(np.float32)
    if mode == "f32":
        return (jnp.asarray(w), {}), (torch.from_numpy(w), {})
    if mode == "int8":
        jq = jquant.quantize_tensor(jnp.asarray(w))
        tq = tquant.quantize_tensor(torch.from_numpy(w))
        return ((jq["q"], {"w_scale": jq["s"][:, 0, :]}),
                (tq["q"], {"w_scale": tq["s"][:, 0, :]}))
    jq = jquant.quantize_tensor_int4(jnp.asarray(w), group=8)
    tq = tquant.quantize_tensor_int4(torch.from_numpy(w), group=8)
    return ((jq["q"], {"w_group_scale": jq["gs"]}),
            (tq["q"], {"w_group_scale": tq["gs"]}))


@pytest.mark.parametrize("mode", ["f32", "int8", "int4"])
@pytest.mark.parametrize("sizes", GROUPS[:3])
def test_grouped_matmul_plain_matches_pallas_interpret(mode, sizes):
    xs, se, gs = _groups(sizes, k=32)
    nx = len(sizes)
    xs_p, _, bexp = jmk.pad_groups(jnp.asarray(xs), jnp.asarray(se),
                                   jnp.asarray(gs), 8)
    (jw, jkw), (tw, tkw) = _weights(mode, nx, 32, 48)
    want = jmk.grouped_matmul(xs_p, jw, bexp, block_t=8, block_n=16,
                              interpret=True, **jkw)
    got = tmk.grouped_matmul(torch.from_numpy(np.array(xs_p)), tw,
                             torch.from_numpy(np.array(bexp)), block_t=8,
                             **tkw)
    assert got.dtype == torch.float32
    _close(got, want)


def test_moe_impl_knob(monkeypatch):
    monkeypatch.delenv("ARKS_MOE_KERNEL", raising=False)
    assert tmk.moe_impl() == jmk.moe_impl() == "xla"
    for value in ("auto", "xla", "pallas"):
        monkeypatch.setenv("ARKS_MOE_KERNEL", value)
        assert tmk.moe_impl() == jmk.moe_impl()
    monkeypatch.setenv("ARKS_MOE_KERNEL", "triton")
    with pytest.raises(ValueError):
        tmk.moe_impl()


def _layer_params(name, bits, seed=0):
    jcfg, tcfg = jax_get_config(name), get_config(name)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    if bits:
        jparams = jquant.quantize_params(jparams, bits=bits)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    jl = jax.tree.map(lambda a: a[0], jparams["layers"])
    return jcfg, tcfg, jl, ttf._layer(tparams, 0)


@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("route", ["xla", "pallas", "dense"])
@pytest.mark.parametrize("name", ["tiny-moe", "tiny-mixtral"])
def test_moe_ffn_matches_jax(name, route, bits, monkeypatch):
    """[2, 40, E] activations (80 tokens, grouped by the reference's own
    rule) through the grouped path on each route, or forced dense."""
    jcfg, tcfg, jl, tl = _layer_params(name, bits)
    x = np.random.default_rng(5).standard_normal(
        (2, 40, tcfg.hidden_size)).astype(np.float32)
    if route == "dense":
        want = jmoe.moe_ffn(jnp.asarray(x), jl, jcfg, grouped=False)
        got = tmoe.moe_ffn(torch.from_numpy(x), tl, tcfg, grouped=False)
    else:
        monkeypatch.setenv("ARKS_MOE_KERNEL", route)
        want = jmoe.moe_ffn(jnp.asarray(x), jl, jcfg)
        got = tmoe.moe_ffn(torch.from_numpy(x), tl, tcfg, grouped=True)
    assert got.shape == x.shape
    _close(got, want)


def test_grouped_combine_is_deterministic_and_exact():
    """Each token's k outputs are added in expert order onto zeros: the
    grouped path equals the dense one on unquantized weights within f32
    rounding, and two runs are bitwise equal."""
    _, tcfg, _, tl = _layer_params("tiny-moe", 0)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (70, tcfg.hidden_size)).astype(np.float32))
    a = tmoe.moe_ffn(x, tl, tcfg, grouped=True)
    b = tmoe.moe_ffn(x, tl, tcfg, grouped=True)
    assert torch.equal(a, b)
    _close(a, tmoe.moe_ffn(x, tl, tcfg, grouped=False).numpy(), rtol=1e-4)


# ---------------------------------------------------------------------------
# The grouped-or-dense choice of each entry point, against the reference
# ---------------------------------------------------------------------------


def _spy(monkeypatch, module, calls, tag):
    real = module.moe_ffn_grouped

    def spy(*args, **kwargs):
        calls.append(tag)
        return real(*args, **kwargs)
    monkeypatch.setattr(module, "moe_ffn_grouped", spy)


def _reference_choice(monkeypatch, run):
    calls = []
    _spy(monkeypatch, jmoe, calls, "jax")
    run()
    return bool(calls)


def _port_choice(monkeypatch, run):
    calls = []
    _spy(monkeypatch, tmoe, calls, "torch")
    run()
    return bool(calls)


def _paged_batch(t_flat, page=16, lanes=2):
    """One lane prefilling t_flat - 1 tokens from 0, one decoding at 5."""
    n = t_flat - 1
    tokens = np.arange(2, 2 + t_flat).astype(np.int32) % 500 + 2
    slot = np.array([0] * n + [1], np.int32)
    pos = np.array(list(range(n)) + [5], np.int32)
    return dict(tokens=tokens, token_slot=slot, token_pos=pos,
                sample_src=np.array([n - 1, n], np.int32),
                seq_q_start=np.array([0, n], np.int32),
                seq_q_len=np.array([n, 1], np.int32),
                seq_pos_start=np.array([0, 5], np.int32))


_KEYS = ("tokens", "token_slot", "token_pos", "sample_src", "seq_q_start",
         "seq_q_len", "seq_pos_start")


@pytest.mark.parametrize("t_flat", [63, 64])
def test_mixed_step_dispatch_choice_matches_reference(t_flat, monkeypatch):
    name = "tiny-mixtral"
    jcfg, tcfg = jax_get_config(name), get_config(name)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    page, maxp = 16, 5
    tables = np.arange(2 * maxp, dtype=np.int32).reshape(2, maxp)
    b = _paged_batch(t_flat, page)

    def jrun():
        cache = jtf.init_paged_cache(jcfg, 2 * maxp, page, jnp.float32)
        jtf.mixed_step(jparams, jcfg, cache, jnp.asarray(tables),
                       *(jnp.asarray(b[k]) for k in _KEYS))

    def trun():
        cache = ttf.init_paged_cache(tcfg, 2 * maxp, page, "float32", "cpu")
        ttf.mixed_step(tparams, tcfg, cache, torch.from_numpy(tables),
                       *(torch.from_numpy(b[k]) for k in _KEYS))
    want = _reference_choice(monkeypatch, jrun)
    assert want == (t_flat >= 64)
    assert _port_choice(monkeypatch, trun) == want


@pytest.mark.parametrize("b,t", [(1, 63), (1, 64), (2, 32), (3, 16)])
def test_prefill_and_chunk_dispatch_choice_matches_reference(b, t,
                                                             monkeypatch):
    """One-shot prefill [B, T] groups iff B*T >= 64; a prefill chunk of C
    tokens (the reference's [1, C]) iff C >= 64; decode never."""
    name = "tiny-mixtral"
    jcfg, tcfg = jax_get_config(name), get_config(name)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    tokens = (np.arange(b * t).reshape(b, t) % 400 + 2).astype(np.int32)
    lengths = np.full((b,), t, np.int32)

    def jrun():
        jtf.prefill(jparams, jcfg, jnp.asarray(tokens), jnp.asarray(lengths))

    def trun():
        ttf.prefill(tparams, tcfg, torch.from_numpy(tokens),
                    torch.from_numpy(lengths))
    want = _reference_choice(monkeypatch, jrun)
    assert want == (b * t >= 64)
    assert _port_choice(monkeypatch, trun) == want

    if b == 1:
        def jchunk():
            cache = jtf.init_cache(jcfg, 1, 128, jnp.float32)
            jtf.prefill_chunk(jparams, jcfg, cache, jnp.asarray(0),
                              jnp.asarray(tokens[0]), jnp.asarray(0),
                              jnp.asarray(t))

        def tchunk():
            cache = ttf.init_cache(tcfg, 1, 128, "float32", "cpu")
            ttf.prefill_chunk(tparams, tcfg, cache, 0,
                              torch.from_numpy(tokens[0]), 0, t)
        want = _reference_choice(monkeypatch, jchunk)
        assert want == (t >= 64)
        assert _port_choice(monkeypatch, tchunk) == want

    def jdecode():
        cache = jtf.init_cache(jcfg, b * 32, 32, jnp.float32)
        jtf.decode_step(jparams, jcfg, cache,
                        jnp.zeros((b * 32,), jnp.int32),
                        jnp.zeros((b * 32,), jnp.int32))

    def tdecode():
        cache = ttf.init_cache(tcfg, b * 32, 32, "float32", "cpu")
        ttf.decode_step(tparams, tcfg, cache,
                        torch.zeros((b * 32,), dtype=torch.int32),
                        torch.zeros((b * 32,), dtype=torch.int32))
    assert not _reference_choice(monkeypatch, jdecode)
    assert not _port_choice(monkeypatch, tdecode)


def test_engine_decides_on_its_padded_batch(monkeypatch):
    """The reference's engine runs every mixed step at num_slots + budget
    tokens; the port's engine runs each row block at rows of its own and
    takes each block's MoE dispatch by the reference's rule on them,
    recorded at every MoE FFN call of ``_issue_mixed``'s steps: a step
    that carries chunks runs the decode block (num_slots rows, the pipe
    step's) then the chunk block (the budget's rows) in every layer, with
    or without a decode lane; a decode-only step the decode block alone.
    Each block on both sides of the 64-row threshold."""
    from arks_tpu_torch.engine import (EngineConfig, InferenceEngine,
                                       Request, SamplingParams)
    from arks_tpu_torch.engine.tokenizer import ByteTokenizer
    monkeypatch.setenv("ARKS_PIPELINE_DEPTH", "0")
    seen = []
    real = tmoe.moe_ffn

    def spy(x, *args, grouped, **kw):
        seen.append((x.numel() // x.shape[-1], grouped))
        return real(x, *args, grouped=grouped, **kw)

    monkeypatch.setattr(tmoe, "moe_ffn", spy)
    cfg = get_config("tiny-mixtral")

    def step(eng):
        seen.clear()
        eng._resolve_mixed(eng._issue_mixed())
        return list(seen)

    def greedy(rid, ids):
        return Request(rid, ids, SamplingParams(
            max_tokens=8, temperature=0.0, ignore_eos=True))

    for slots, chunk in ((2, 64), (2, 63), (64, 16)):
        eng = InferenceEngine(cfg, EngineConfig(
            model="tiny-mixtral", num_slots=slots, max_cache_len=chunk * 4,
            prefill_chunk=chunk, kv_layout="paged", dtype="float32"),
            ByteTokenizer(), device="cpu")
        assert eng._mixed_budget == chunk
        dec = (slots, slots >= 64)
        blk = (chunk, chunk >= 64)
        eng.add_request(greedy("a", [5, 6, 7]))
        eng._admit()
        assert step(eng) == [dec, blk] * cfg.num_layers, (slots, chunk)
        assert step(eng) == [dec] * cfg.num_layers, (slots, chunk)
        eng.add_request(greedy("b", [9] * (chunk * 2 + 1)))
        eng._admit()
        assert step(eng) == [dec, blk] * cfg.num_layers, (slots, chunk)

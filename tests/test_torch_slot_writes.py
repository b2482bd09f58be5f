"""The slot-cache row writes (``kv_cache_update`` and ``kv_cache_update_quant``)
against the JAX reference on the same numpy inputs, and the legacy decode
step's per-step values.

Each batch goes through the reference's Pallas ``kv_cache_update`` /
``kv_cache_update_quant`` (the latter with the ``quantize_kv`` it runs
first) in interpret mode under ``jax.jit``, as the reference runs them, and
through the port's wrappers on CPU tensors, which take the plain versions.
Caches and scales must come out bit-identical for bf16 and f32 caches, f32
rows into a bf16 cache, and bf16 and f32 rows into an int8 cache, at 2 and
8 KV heads of 64 and 128: a parked slot at S writes nothing, an all-zero
row gets scale 1e-8, and a batch whose every write drops leaves the cache
as it was.  S stays at the reference's multiples (16 rows for the plain
write, 128 scales for the quantized one).  A negative index, which the
Pallas kernels leave unguarded, is held against the port's own rule: it
drops.  Then ``decode_step`` on the slot cache makes its int32 write index
and attend lengths once per step, not once per layer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arks_tpu.ops import pallas_attention as jpl
from arks_tpu_torch.models import get_config
from arks_tpu_torch.models import transformer as ttf
from arks_tpu_torch.ops import pallas_attention as tpl

torch.set_num_threads(2)

LAYERS, B, LAYER = 2, 5, 1
S_PLAIN, S_QUANT = 32, 128

# Cache kind -> (cache dtype or None for int8, new-row dtype).
KINDS = {"bf16": ("bfloat16", "bfloat16"),
         "f32": ("float32", "float32"),
         "f32 rows into bf16": ("bfloat16", "float32"),
         "int8, bf16 rows": (None, "bfloat16"),
         "int8, f32 rows": (None, "float32")}
SHAPES = [(2, 64), (2, 128), (8, 64), (8, 128)]   # (Hkv, D)


def _write_idx(s, batch):
    """Slot 2 parked at S, the others across a 16-row chunk edge and the
    stripe's last row; or every slot at or past S."""
    if batch == "every write drops":
        return np.array([s, s, s + 5, s, s + 1], np.int32)
    return np.array([0, s - 1, s, 15, 16], np.int32)


def _case(kind, hkv, d, batch="parked slot at S", seed=0):
    cache_dt, row_dt = KINDS[kind]
    quant = cache_dt is None
    s = S_QUANT if quant else S_PLAIN
    rng = np.random.default_rng(seed)
    shape = (LAYERS, B, hkv, s, d)
    c = dict(kind=kind, quant=quant, cache_dt=cache_dt, row_dt=row_dt,
             write_idx=_write_idx(s, batch),
             k_new=rng.standard_normal((B, hkv, d)).astype(np.float32) * 3,
             v_new=rng.standard_normal((B, hkv, d)).astype(np.float32))
    c["k_new"][3] = 0.0                        # an all-zero K row per head
    if quant:
        c["caches"] = [rng.integers(-127, 128, shape).astype(np.int8)
                       for _ in range(2)] + \
            [rng.uniform(0.002, 0.03, shape[:-1]).astype(np.float32)
             for _ in range(2)]
    else:
        c["caches"] = [rng.standard_normal(shape).astype(np.float32)
                       for _ in range(2)]
    return c


def _bits(x):
    """Cache bytes as integers: bf16 and f32 through their bit patterns."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.view(np.int16)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _reference(c):
    """The reference's caches (and scales) after its Pallas write in
    interpret mode, under jit."""
    dt = c["cache_dt"]
    caches = [jnp.asarray(x, dt) if dt else jnp.asarray(x)
              for x in c["caches"]]
    rows = (jnp.asarray(c["k_new"], c["row_dt"]),
            jnp.asarray(c["v_new"], c["row_dt"]), jnp.asarray(c["write_idx"]))
    fn = jpl.kv_cache_update_quant if c["quant"] else jpl.kv_cache_update
    return jax.jit(fn, static_argnames=("layer", "interpret"))(
        *caches, *rows, layer=LAYER, interpret=True)


def _port(c, write_idx=None):
    """The port's caches after its wrapper on CPU tensors (the plain
    version); asserts the wrapper counted no launch."""
    dt = c["cache_dt"]
    caches = [torch.from_numpy(x.copy()).to(getattr(torch, dt)) if dt
              else torch.from_numpy(x.copy()) for x in c["caches"]]
    rdt = getattr(torch, c["row_dt"])
    widx = c["write_idx"] if write_idx is None else write_idx
    rows = (torch.from_numpy(c["k_new"]).to(rdt),
            torch.from_numpy(c["v_new"]).to(rdt), torch.from_numpy(widx))
    fn = tpl.kv_cache_update_quant if c["quant"] else tpl.kv_cache_update
    before = fn.launches
    fn(*caches, *rows, LAYER)
    assert fn.launches == before                  # CPU: the plain version
    return caches


@pytest.mark.parametrize("hkv,d", SHAPES)
@pytest.mark.parametrize("kind", list(KINDS))
def test_slot_write_plain_bit_exact_vs_pallas(kind, hkv, d):
    """Every cache byte and scale equal to the reference's Pallas kernel;
    the parked slot's stripes untouched; the all-zero K row quantized to
    zeros at scale 1e-8."""
    c = _case(kind, hkv, d)
    got, want = _port(c), _reference(c)
    assert len(want) == len(got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    k0 = _bits(torch.from_numpy(c["caches"][0]).to(
        getattr(torch, c["cache_dt"])) if c["cache_dt"] else c["caches"][0])
    assert not np.array_equal(_bits(got[0]), k0)
    np.testing.assert_array_equal(_bits(got[0])[:, 2], k0[:, 2])  # parked
    if c["quant"]:
        idx = c["write_idx"][3]
        assert (got[2][LAYER, 3, :, idx] == np.float32(1e-8)).all()
        assert (got[0][LAYER, 3, :, idx] == 0).all()


@pytest.mark.parametrize("kind", list(KINDS))
def test_slot_write_every_write_drops(kind):
    """A batch whose every index is at or past S: the reference and the
    port both leave every cache byte and scale as it was."""
    c = _case(kind, 2, 64, batch="every write drops", seed=1)
    got, want = _port(c), _reference(c)
    for g, w, x in zip(got, want, c["caches"]):
        np.testing.assert_array_equal(_bits(g), _bits(w))
        if c["cache_dt"] == "float32" or c["quant"]:
            np.testing.assert_array_equal(_bits(g), _bits(x))


@pytest.mark.parametrize("kind", ["bf16", "int8, f32 rows"])
def test_slot_write_negative_index_drops(kind):
    """A negative write index writes nothing (the kernels' rule, which the
    plain versions share); the other slots write as with that slot parked."""
    c = _case(kind, 2, 64, seed=2)
    s = S_QUANT if c["quant"] else S_PLAIN
    neg = c["write_idx"].copy()
    neg[2] = -1
    got, parked = _port(c, neg), _port(c)
    assert c["write_idx"][2] == s
    for g, w in zip(got, parked):
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_decode_step_makes_write_index_and_lengths_once_per_step(kv,
                                                                 monkeypatch):
    """Every layer of a slot-cache decode step gets the same int32 write
    index and the same attend lengths (write_idx + 1) tensors, made once;
    the logits equal those of a step whose layers make the lengths
    themselves."""
    cfg = get_config("tiny-gqa")
    params = ttf.init_params(cfg, 0, torch.float32, "cpu")
    quant = kv == "int8"
    seen = []
    real = ttf.decode_update_and_attend

    def spy(*args, **kw):
        seen.append((args[5], kw["lengths"]))
        return real(*args, **kw)

    def no_lengths(*args, **kw):
        kw["lengths"] = None
        return real(*args, **kw)

    toks = torch.tensor([3, 7, 11], dtype=torch.int32)
    lengths = torch.tensor([0, 5, 8], dtype=torch.int64)   # 8 = S: parked
    logits = {}
    for name, fn in (("once", spy), ("per layer", no_lengths)):
        cache = ttf.init_cache(cfg, 3, 8, torch.float32, "cpu",
                               quantized=quant)
        monkeypatch.setattr(ttf, "decode_update_and_attend", fn)
        logits[name] = ttf.decode_step(params, cfg, cache, toks, lengths)
    assert len(seen) == cfg.num_layers
    widx, lens = seen[0]
    assert widx.dtype == torch.int32 and lens.dtype == torch.int32
    assert torch.equal(lens, widx + 1) and torch.equal(widx, lengths.int())
    assert all(w is widx and n is lens for w, n in seen)
    assert torch.equal(logits["once"], logits["per layer"])

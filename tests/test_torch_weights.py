"""Weights from a local HuggingFace checkpoint: the port's safetensors
reader against the ``safetensors`` package, the port's ``params_from_hf``
against the reference's bit for bit (dense, Mixtral and Qwen2-MoE
checkpoints; f32 and bf16 engines; bf16, int8 and int4 weights, values
and scales), layer-wise quantize-on-load against the whole-leaf quantize,
``load_params``'s order, and a greedy stream of the port's engine on
loaded weights against the JAX engine's on its own load."""

import logging
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import save_file

from arks_tpu.engine import EngineConfig as JaxEngineConfig
from arks_tpu.engine import InferenceEngine as JaxEngine
from arks_tpu.engine import Request as JaxRequest
from arks_tpu.engine import SamplingParams as JaxSamplingParams
from arks_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from arks_tpu.models import get_config as jax_get_config
from arks_tpu.models import weights as ref_weights
from arks_tpu_torch.engine import EngineConfig, InferenceEngine, Request, \
    SamplingParams
from arks_tpu_torch.engine.tokenizer import ByteTokenizer
from arks_tpu_torch.models import get_config, quant
from arks_tpu_torch.models import weights as tw

torch.set_num_threads(2)


def hf_tensors(cfg, seed: int, dtype=np.float32) -> dict:
    """A random checkpoint in HF names and layouts ([out, in] matrices)."""
    rng = np.random.default_rng(seed)
    e, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    qd, kvd = cfg.q_dim, cfg.kv_dim

    def r(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32) \
            .astype(dtype)

    t = {"model.embed_tokens.weight": r(v, e), "model.norm.weight": r(e)}
    if not cfg.tie_word_embeddings:
        t["lm_head.weight"] = r(v, e)
    mixtral = "mixtral" in cfg.name
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = r(e)
        t[p + "post_attention_layernorm.weight"] = r(e)
        for proj, n in (("q", qd), ("k", kvd), ("v", kvd)):
            t[p + f"self_attn.{proj}_proj.weight"] = r(n, e)
            if cfg.qkv_bias:
                t[p + f"self_attn.{proj}_proj.bias"] = r(n)
        t[p + "self_attn.o_proj.weight"] = r(e, qd)
        if not cfg.num_experts:
            t[p + "mlp.gate_proj.weight"] = r(f, e)
            t[p + "mlp.up_proj.weight"] = r(f, e)
            t[p + "mlp.down_proj.weight"] = r(e, f)
            continue
        fm = cfg.moe_intermediate_size
        base = p + ("block_sparse_moe." if mixtral else "mlp.")
        names = ("w1", "w3", "w2") if mixtral else \
            ("gate_proj", "up_proj", "down_proj")
        t[base + "gate.weight"] = r(cfg.num_experts, e)
        for x in range(cfg.num_experts):
            t[base + f"experts.{x}.{names[0]}.weight"] = r(fm, e)
            t[base + f"experts.{x}.{names[1]}.weight"] = r(fm, e)
            t[base + f"experts.{x}.{names[2]}.weight"] = r(e, fm)
        if cfg.shared_expert_intermediate_size:
            fs = cfg.shared_expert_intermediate_size
            t[p + "mlp.shared_expert.gate_proj.weight"] = r(fs, e)
            t[p + "mlp.shared_expert.up_proj.weight"] = r(fs, e)
            t[p + "mlp.shared_expert.down_proj.weight"] = r(e, fs)
            t[p + "mlp.shared_expert_gate.weight"] = r(1, e)
    return t


def write_checkpoint(path, tensors: dict, shards: int = 1) -> None:
    """``tensors`` in ``shards`` files (split by sorted name)."""
    os.makedirs(path, exist_ok=True)
    names = sorted(tensors)
    for i in range(shards):
        part = {n: tensors[n] for n in names[i::shards]}
        save_file(part, os.path.join(
            path, f"model-{i + 1:05d}-of-{shards:05d}.safetensors"))


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """name -> (f32 checkpoint dir, bf16 checkpoint dir); Mixtral's f32
    one split over two shards."""
    out = {}
    for i, name in enumerate(("tiny", "tiny-moe", "tiny-mixtral")):
        cfg = get_config(name)
        root = tmp_path_factory.mktemp(name)
        f32, b16 = str(root / "f32"), str(root / "bf16")
        write_checkpoint(f32, hf_tensors(cfg, i),
                         shards=2 if name == "tiny-mixtral" else 1)
        write_checkpoint(b16, hf_tensors(cfg, 10 + i, jnp.bfloat16))
        out[name] = (f32, b16)
    return out


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _assert_same_tree(got: dict, want: dict) -> None:
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for k in want:
        a, b = got[k], want[k]
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype,
                                                           b.dtype)
        assert torch.equal(a, b), k


@pytest.mark.parametrize("which", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["tiny-moe", "tiny-mixtral"])
def test_reader_equals_safe_open(ckpts, name, which):
    """Every tensor of every shard, read by the port's own reader, equals
    the ``safetensors`` package's (bf16 compared as its bits)."""
    path = ckpts[name][0 if which == "f32" else 1]
    got = tw.HFTensors(path)
    seen = set()
    for fname in sorted(os.listdir(path)):
        with safe_open(os.path.join(path, fname), framework="pt") as f:
            for key in f.keys():
                want = f.get_tensor(key)
                assert got[key].dtype == want.dtype
                assert torch.equal(got[key].view(torch.int16)
                                   if want.dtype == torch.bfloat16
                                   else got[key],
                                   want.view(torch.int16)
                                   if want.dtype == torch.bfloat16 else want)
                seen.add(key)
    assert seen == set(got) and len(got.files) == (
        2 if name == "tiny-mixtral" and which == "f32" else 1)


CASES = ([(n, "f32", "float32", w) for n in ("tiny", "tiny-moe",
                                             "tiny-mixtral")
          for w in ("bf16", "int8", "int4")]
         + [(n, "bf16", "bfloat16", w) for n in ("tiny", "tiny-moe",
                                                 "tiny-mixtral")
            for w in ("bf16", "int8")])


@pytest.mark.parametrize("name,ckpt,dtype,wd", CASES)
def test_params_from_hf_equals_reference(ckpts, name, ckpt, dtype, wd):
    """The port's load equals the reference's ``params_from_hf`` bridged
    to the port's layout, bit for bit: float leaves, int8 values and
    scales, int4 values (packed) and group scales."""
    path = ckpts[name][0 if ckpt == "f32" else 1]
    ref = ref_weights.params_from_hf(jax_get_config(name), path,
                                     jnp.dtype(dtype), wd)
    want = tw.params_from_numpy(jax.tree.map(np.asarray, ref),
                                get_config(name), "cpu")
    got = tw.params_from_hf(get_config(name), path, dtype, wd, "cpu")
    _assert_same_tree(got, want)


@pytest.mark.parametrize("wd", ["int8", "int4"])
def test_layerwise_quantize_equals_whole_leaf(ckpts, wd, monkeypatch):
    """Quantizing slice by slice in narrow column blocks (row blocks for
    the embedding) equals quantizing each whole stacked leaf at once."""
    cfg = get_config("tiny-moe")
    path = ckpts["tiny-moe"][0]
    full = tw.params_from_hf(cfg, path, "float32", "bf16", "cpu")
    monkeypatch.setattr(tw, "_QBLOCK", 96)      # several blocks a slice
    got = tw.params_from_hf(cfg, path, "float32", wd, "cpu")
    bits = quant.weight_bits(wd)
    want = {"layers": {}}
    for name, leaf in _leaves(full):
        key = name.split("/")[-1]
        dst = want["layers"] if name.startswith("layers/") else want
        if key == "embed":
            dst[key] = quant.quantize_tensor(leaf, axis=-1, recip=True)
        elif key in quant.MATMUL_KEYS:
            dst[key] = (quant.quantize_tensor_int4(leaf, recip=True)
                        if bits == 4 else
                        quant.quantize_tensor(leaf, axis=-2, recip=True))
        else:
            dst[key] = leaf
    _assert_same_tree(got, want)


def test_load_params_order(ckpts, tmp_path, caplog):
    """safetensors load; an Orbax directory raises (it is never silently
    random); an empty directory warns and takes the seeded random init."""
    cfg = get_config("tiny")
    loaded = tw.load_params(cfg, ckpts["tiny"][0], "float32", "int8",
                            "cpu")
    assert quant.is_quantized(loaded["layers"]["wq"])
    assert tw.weights_kind(ckpts["tiny"][0]) == "safetensors"
    assert tw.has_real_weights(ckpts["tiny"][0])
    orbax = tmp_path / "orbax"
    (orbax / tw.ORBAX_SUBDIR).mkdir(parents=True)
    write_checkpoint(str(orbax), hf_tensors(cfg, 0))
    with pytest.raises(NotImplementedError, match="orbax"):
        tw.load_params(cfg, str(orbax), device="cpu")
    empty = tmp_path / "empty"
    empty.mkdir()
    assert not tw.has_real_weights(str(empty))
    with caplog.at_level(logging.WARNING, "arks_tpu_torch.weights"):
        rnd = tw.load_params(cfg, str(empty), "float32", device="cpu",
                             seed=5)
    assert "no weights found" in caplog.text
    want = tw.init_params(cfg, 5, "float32", "cpu")
    _assert_same_tree(rnd, want)


def test_unreadable_checkpoints_raise(ckpts, tmp_path):
    """No fallback: a truncated shard, a tensor of an unsupported dtype, a
    missing tensor and a directory without shards all raise."""
    cfg = get_config("tiny")
    src = os.path.join(ckpts["tiny"][0], "model-00001-of-00001.safetensors")
    blob = open(src, "rb").read()
    cut = tmp_path / "cut"
    cut.mkdir()
    (cut / "model.safetensors").write_bytes(blob[:len(blob) // 2])
    with pytest.raises(ValueError, match="overruns"):
        tw.params_from_hf(cfg, str(cut), device="cpu")
    head = tmp_path / "head"
    head.mkdir()
    (head / "model.safetensors").write_bytes(struct.pack("<Q", 1 << 40))
    with pytest.raises(ValueError, match="header"):
        tw.HFTensors(str(head))
    ints = tmp_path / "ints"
    t = hf_tensors(cfg, 0)
    t["model.norm.weight"] = t["model.norm.weight"].astype(np.int32)
    write_checkpoint(str(ints), t)
    with pytest.raises(ValueError, match="model.norm.weight.*I32"):
        tw.params_from_hf(cfg, str(ints), device="cpu")
    missing = tmp_path / "missing"
    del t["model.norm.weight"]
    write_checkpoint(str(missing), t)
    with pytest.raises(KeyError, match="model.norm.weight"):
        tw.params_from_hf(cfg, str(missing), device="cpu")
    with pytest.raises(FileNotFoundError):
        tw.params_from_hf(cfg, str(tmp_path), device="cpu")


def _drive(engine, busy, n_steps=500):
    for _ in range(n_steps):
        engine.step(block_s=0.01)
        if not busy(engine):
            return
    raise AssertionError("engine did not drain")


def _collect(outputs):
    ids = []
    while True:
        out = outputs.get(timeout=120)
        ids.extend(out.token_ids)
        if out.finished:
            return ids, out.finish_reason


def test_greedy_stream_on_loaded_weights_equals_jax_engine(ckpts,
                                                           monkeypatch):
    """f32 ``tiny`` from its checkpoint: the port's engine on its own load
    streams the JAX engine's greedy tokens on the reference's load."""
    path = ckpts["tiny"][0]
    kw = dict(num_slots=2, max_cache_len=64, steps_per_dispatch=4,
              prefill_chunk=16, dtype="float32")
    rng = np.random.default_rng(3)
    prompts = [[int(x) for x in rng.integers(2, 512, n)] for n in (5, 21)]
    sp = dict(max_tokens=8, temperature=0.0, ignore_eos=True)
    monkeypatch.setenv("ARKS_MIXED_STEP", "1")
    jeng = JaxEngine(jax_get_config("tiny"), JaxEngineConfig(
        model="tiny", prefill_buckets=(8, 16, 32), kv_layout="paged", **kw),
        JaxByteTokenizer(), params=ref_weights.load_params(
            jax_get_config("tiny"), path, dtype=jnp.float32))
    jreqs = [JaxRequest(f"r{i}", p, JaxSamplingParams(**sp))
             for i, p in enumerate(prompts)]
    for r in jreqs:
        jeng.add_request(r)
    _drive(jeng, lambda e: e.num_running or not e._queue.empty()
           or e._prefilling)
    teng = InferenceEngine(get_config("tiny"), EngineConfig(model="tiny",
                                                            **kw),
                           ByteTokenizer(), device="cpu",
                           params=tw.load_params(get_config("tiny"), path,
                                                 "float32", device="cpu"))
    treqs = [Request(f"r{i}", p, SamplingParams(**sp))
             for i, p in enumerate(prompts)]
    for r in treqs:
        teng.add_request(r)
    _drive(teng, lambda e: not e.idle)
    want = [_collect(r.outputs) for r in jreqs]
    got = [_collect(r.outputs) for r in treqs]
    assert got == want and all(len(ids) == 8 for ids, _ in got)

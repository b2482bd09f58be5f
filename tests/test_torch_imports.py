"""The port stands alone: importing every ``arks_tpu_torch`` module pulls in
neither ``jax`` nor anything of ``arks_tpu``, nor ``safetensors`` (the
port reads checkpoints with its own reader and needs no such package);
no source file of the port (or ``chip_smoke.py``) imports them; and entry
points refuse to carry on on the CPU when no GPU is present and the caller
did not ask for the CPU."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import arks_tpu_torch
from arks_tpu_torch import device as device_mod
from arks_tpu_torch.engine import EngineConfig, InferenceEngine
from arks_tpu_torch.engine.tokenizer import ByteTokenizer
from arks_tpu_torch.models import get_config

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
PKG = Path(arks_tpu_torch.__file__).resolve().parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import arks_tpu_torch
names = [m.name for m in pkgutil.walk_packages(arks_tpu_torch.__path__,
                                               "arks_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "arks_tpu", "safetensors"))
print(len(names), bad, ",".join(names))
"""


def test_importing_every_module_loads_no_jax_and_no_arks_tpu():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    assert int(out[0]) >= 20          # every module was imported
    assert out[1] == "[]"
    imported = set(out[2].split(","))
    assert {"arks_tpu_torch.models.moe", "arks_tpu_torch.models.quant",
            "arks_tpu_torch.ops.moe_kernel",
            "arks_tpu_torch.engine.prefix_cache",
            "arks_tpu_torch.models.weights", "arks_tpu_torch.knobs",
            "arks_tpu_torch.slo", "arks_tpu_torch.tenancy",
            "arks_tpu_torch.engine.fairqueue",
            "arks_tpu_torch.engine.metrics",
            "arks_tpu_torch.utils.metrics",
            "arks_tpu_torch.engine.faults", "arks_tpu_torch.utils.swallow",
            "arks_tpu_torch.engine.model_pool",
            "arks_tpu_torch.engine.residency",
            "arks_tpu_torch.obs.trace", "arks_tpu_torch.obs.logctx",
            "arks_tpu_torch.obs.perfetto",
            "arks_tpu_torch.obs.profiler"} <= imported


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_imports_jax_or_the_jax_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "arks_tpu", "safetensors"), \
            (path, mod)


def test_engine_without_cuda_raises_unless_cpu_requested(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("tiny")
    ecfg = EngineConfig(model="tiny", num_slots=1, max_cache_len=32,
                        prefill_chunk=16, dtype="float32")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(cfg, ecfg, ByteTokenizer())
    with pytest.raises(RuntimeError):
        InferenceEngine(cfg, ecfg, ByteTokenizer(), device="cuda")
    eng = InferenceEngine(cfg, ecfg, ByteTokenizer(), device="cpu")
    assert eng.device.type == "cpu" and eng.cache.k.device.type == "cpu"


def test_resolve_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert device_mod.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        device_mod.resolve_device(None)
    with pytest.raises(ValueError):
        device_mod.resolve_device("meta")


def test_model_builders_without_cuda_raise_unless_cpu_requested(monkeypatch):
    """init_params, init_paged_cache and params_from_numpy default to the
    card too: without CUDA they raise rather than build on the CPU."""
    from arks_tpu_torch.models import transformer as tf
    from arks_tpu_torch.models.weights import params_from_numpy
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("tiny")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.init_params(cfg, 0, torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.init_paged_cache(cfg, 2, 16, torch.float32)
    params = tf.init_params(cfg, 0, torch.float32, "cpu")
    tree = {k: ({n: w.numpy() for n, w in v.items()} if isinstance(v, dict)
                else v.numpy()) for k, v in params.items()}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy(tree, cfg)
    back = params_from_numpy(tree, cfg, "cpu")
    assert torch.equal(back["layers"]["wq"], params["layers"]["wq"])
    assert tf.init_paged_cache(cfg, 2, 16, torch.float32, "cpu").k.is_cpu


def test_server_cli_without_cuda_raises(monkeypatch):
    from arks_tpu_torch.server.__main__ import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        main(["--model", "tiny", "--max-model-len", "32", "--port", "0"])


@pytest.mark.parametrize("field,value", [
    ("context_parallel", 2),
    ("draft_model", "tiny"), ("tensor_parallel", 2),
    ("data_parallel", 2), ("pipeline_parallel", 2),
])
def test_engine_config_outside_the_slice_raises(field, value):
    # A draft model is served since speculative decoding landed; with
    # parallelism it is not yet.
    extra = {"tensor_parallel": 2} if field == "draft_model" else {}
    ecfg = EngineConfig(model="tiny", max_cache_len=32, prefill_chunk=16,
                        **{field: value}, **extra)
    with pytest.raises(NotImplementedError):
        InferenceEngine(get_config("tiny"), ecfg, ByteTokenizer(),
                        device="cpu")


@pytest.mark.parametrize("weight_dtype", ["int8", "int4"])
@pytest.mark.parametrize("name", ["tiny", "tiny-moe"])
def test_engine_config_quantized_weights_build(name, weight_dtype):
    """int8/int4 weights and MoE models are inside the slice: the engine
    draws quantized weights (int4 packed two a byte along K; the embedding
    int8 in both modes); an unknown weight dtype raises."""
    ecfg = EngineConfig(model=name, max_cache_len=32, prefill_chunk=16,
                        weight_dtype=weight_dtype)
    eng = InferenceEngine(get_config(name), ecfg, ByteTokenizer(),
                          device="cpu")
    wq = eng.params["layers"]["wq"]
    assert wq["q"].dtype == torch.int8
    assert ("gs" in wq) == (weight_dtype == "int4")
    assert "s" in eng.params["embed"]
    with pytest.raises(ValueError):
        EngineConfig(model=name, weight_dtype="fp8").validate()


@pytest.mark.parametrize("kv,bits", [("int8", 8), ("int4", 4)])
def test_engine_config_quantized_pools_build(kv, bits):
    """int8/int4 KV pools are inside the slice: the engine builds an int8
    pool (int4: packed along the page axis) with f32 scales."""
    ecfg = EngineConfig(model="tiny", max_cache_len=32, prefill_chunk=16,
                        kv_cache_dtype=kv)
    eng = InferenceEngine(get_config("tiny"), ecfg, ByteTokenizer(),
                          device="cpu")
    assert ecfg.kv_quantized and eng.kv_quantized and eng.kv_bits == bits
    assert eng.cache.k.dtype == torch.int8
    assert eng.cache.k.shape[3] == 16 * bits // 8 and eng.cache.page == 16
    assert eng.cache.k_scale.shape == eng.cache.k.shape[:3] + (16,)


def test_model_kv_preference_applies_under_auto():
    cfg = dataclasses.replace(get_config("tiny"), kv_cache_dtype="int4")
    auto = EngineConfig(model="tiny", max_cache_len=32, prefill_chunk=16)
    assert InferenceEngine(cfg, auto, ByteTokenizer(),
                           device="cpu").kv_bits == 4
    assert auto.kv_cache_dtype == "auto"          # the caller's config
    explicit = dataclasses.replace(auto, kv_cache_dtype="int8")
    assert InferenceEngine(cfg, explicit, ByteTokenizer(),
                           device="cpu").kv_bits == 8

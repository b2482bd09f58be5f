"""Model architecture configs for the PyTorch port.

A copy of ``arks_tpu/models/config.py`` (the port imports nothing from the
JAX package): the same ``ModelConfig`` fields, ``from_hf_config`` and preset
registry, so a config name means the same model in both packages.  Presets
cover Qwen2.5 at 0.5B/1.5B/7B/72B, Llama-3, Mixtral/Qwen2-MoE, plus the
``tiny``/``tiny-gqa`` configs the CPU parity tests use.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = False
    qkv_bias: bool = False  # Qwen2-family uses bias on q/k/v projections.
    max_position_embeddings: int = 32768
    dtype: str = "bfloat16"
    eos_token_ids: tuple[int, ...] = ()
    # Mixture-of-Experts (0 experts = dense FFN).  norm_topk_prob=True is
    # Mixtral semantics (softmax over the selected experts); False is
    # Qwen2-MoE (global softmax, selected probs used as-is).
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    shared_expert_intermediate_size: int = 0
    norm_topk_prob: bool = True
    # Per-model KV-cache dtype preference ("auto"|"bf16"|"int8"|"int4"):
    # consulted when EngineConfig.kv_cache_dtype is left at "auto" — a
    # checkpoint known to tolerate int4 KV can ship that fact with its
    # config instead of every deployment flagging it.  "auto" = no
    # preference (the engine's backend default applies).
    kv_cache_dtype: str = "auto"

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def num_params(self) -> int:
        """Approximate parameter count (embeddings + blocks + head)."""
        e, f, v = self.hidden_size, self.intermediate_size, self.vocab_size
        attn = e * self.q_dim + 2 * e * self.kv_dim + self.q_dim * e
        if self.qkv_bias:
            attn += self.q_dim + 2 * self.kv_dim
        if self.num_experts:
            mlp = self.num_experts * 3 * e * self.moe_intermediate_size \
                + e * self.num_experts
            if self.shared_expert_intermediate_size:
                mlp += 3 * e * self.shared_expert_intermediate_size + e
        else:
            mlp = 3 * e * f
        norms = 2 * e
        blocks = self.num_layers * (attn + mlp + norms)
        head = 0 if self.tie_word_embeddings else e * v
        return v * e + blocks + e + head

    @staticmethod
    def from_hf_config(path_or_dict: str | dict[str, Any], name: str = "") -> "ModelConfig":
        """Build a config from a HuggingFace ``config.json`` (Qwen2/Llama style)."""
        if isinstance(path_or_dict, str):
            p = path_or_dict
            if os.path.isdir(p):
                p = os.path.join(p, "config.json")
            with open(p) as f:
                d = json.load(f)
        else:
            d = dict(path_or_dict)
        arch = (d.get("architectures") or [""])[0].lower()
        model_type = d.get("model_type", "")
        qkv_bias = "qwen2" in arch or model_type in ("qwen2", "qwen2_moe")
        heads = d["num_attention_heads"]
        eos = d.get("eos_token_id")
        if eos is None:
            eos = ()
        elif isinstance(eos, int):
            eos = (eos,)
        # MoE: HF calls the expert count num_local_experts (Mixtral) or
        # num_experts (Qwen2-MoE).
        num_experts = int(d.get("num_local_experts", d.get("num_experts", 0)) or 0)
        is_mixtral = "mixtral" in arch or model_type == "mixtral"
        return ModelConfig(
            name=name or model_type or "hf-model",
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_layers=d["num_hidden_layers"],
            num_heads=heads,
            num_kv_heads=d.get("num_key_value_heads", heads),
            head_dim=d.get("head_dim", d["hidden_size"] // heads),
            rope_theta=float(d.get("rope_theta", 10000.0)),
            rms_norm_eps=float(d.get("rms_norm_eps", 1e-6)),
            tie_word_embeddings=bool(d.get("tie_word_embeddings", False)),
            qkv_bias=qkv_bias,
            max_position_embeddings=int(d.get("max_position_embeddings", 32768)),
            eos_token_ids=tuple(eos),
            num_experts=num_experts,
            num_experts_per_tok=int(d.get("num_experts_per_tok", 0) or 0),
            moe_intermediate_size=int(
                d.get("moe_intermediate_size",
                      d["intermediate_size"] if num_experts else 0) or 0),
            shared_expert_intermediate_size=int(
                d.get("shared_expert_intermediate_size", 0) or 0),
            norm_topk_prob=bool(d.get("norm_topk_prob", is_mixtral)),
            kv_cache_dtype=str(d.get("kv_cache_dtype", "auto")),
        )


_REGISTRY: dict[str, ModelConfig] = {}


def register_config(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name.lower()] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    key = name.lower()
    if key in _REGISTRY:
        return _REGISTRY[key]
    raise KeyError(f"unknown model config {name!r}; known: {sorted(_REGISTRY)}")


# Tiny config for CPU-mesh tests: dims divisible by 8 so every mesh shape works.
register_config(ModelConfig(
    name="tiny", vocab_size=512, hidden_size=64, intermediate_size=128,
    num_layers=2, num_heads=8, num_kv_heads=8, head_dim=8,
    qkv_bias=True, eos_token_ids=(0,),
))
register_config(ModelConfig(
    name="tiny-gqa", vocab_size=512, hidden_size=64, intermediate_size=128,
    num_layers=2, num_heads=8, num_kv_heads=4, head_dim=8,
    qkv_bias=True, eos_token_ids=(0,),
))

# Qwen2.5 family (HF: Qwen/Qwen2.5-*-Instruct).
register_config(ModelConfig(
    name="qwen2.5-0.5b", vocab_size=151936, hidden_size=896,
    intermediate_size=4864, num_layers=24, num_heads=14, num_kv_heads=2,
    head_dim=64, rope_theta=1000000.0, tie_word_embeddings=True,
    qkv_bias=True, eos_token_ids=(151645, 151643),
))
register_config(ModelConfig(
    name="qwen2.5-1.5b", vocab_size=151936, hidden_size=1536,
    intermediate_size=8960, num_layers=28, num_heads=12, num_kv_heads=2,
    head_dim=128, rope_theta=1000000.0, tie_word_embeddings=True,
    qkv_bias=True, eos_token_ids=(151645, 151643),
))
register_config(ModelConfig(
    name="qwen2.5-7b", vocab_size=152064, hidden_size=3584,
    intermediate_size=18944, num_layers=28, num_heads=28, num_kv_heads=4,
    head_dim=128, rope_theta=1000000.0, qkv_bias=True,
    eos_token_ids=(151645, 151643),
))
register_config(ModelConfig(
    name="qwen2.5-72b", vocab_size=152064, hidden_size=8192,
    intermediate_size=29568, num_layers=80, num_heads=64, num_kv_heads=8,
    head_dim=128, rope_theta=1000000.0, qkv_bias=True,
    eos_token_ids=(151645, 151643),
))

# MoE tiny configs for CPU-mesh tests (dims divisible by 8).
register_config(ModelConfig(
    name="tiny-moe", vocab_size=512, hidden_size=64, intermediate_size=128,
    num_layers=2, num_heads=8, num_kv_heads=4, head_dim=8, qkv_bias=True,
    num_experts=8, num_experts_per_tok=2, moe_intermediate_size=96,
    shared_expert_intermediate_size=64, norm_topk_prob=False,
    eos_token_ids=(0,),
))
register_config(ModelConfig(
    name="tiny-mixtral", vocab_size=512, hidden_size=64, intermediate_size=128,
    num_layers=2, num_heads=8, num_kv_heads=4, head_dim=8,
    num_experts=4, num_experts_per_tok=2, moe_intermediate_size=96,
    norm_topk_prob=True, eos_token_ids=(0,),
))

# MoE families (HF: mistralai/Mixtral-8x7B-Instruct-v0.1, Qwen/Qwen2-57B-A14B).
register_config(ModelConfig(
    name="mixtral-8x7b", vocab_size=32000, hidden_size=4096,
    intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
    head_dim=128, rope_theta=1000000.0, rms_norm_eps=1e-5,
    num_experts=8, num_experts_per_tok=2, moe_intermediate_size=14336,
    norm_topk_prob=True, eos_token_ids=(2,),
))
register_config(ModelConfig(
    name="qwen2-57b-a14b", vocab_size=151936, hidden_size=3584,
    intermediate_size=18944, num_layers=28, num_heads=28, num_kv_heads=4,
    head_dim=128, rope_theta=1000000.0, qkv_bias=True,
    num_experts=64, num_experts_per_tok=8, moe_intermediate_size=2560,
    shared_expert_intermediate_size=20480, norm_topk_prob=False,
    eos_token_ids=(151645, 151643),
))

# Llama-3 family.
register_config(ModelConfig(
    name="llama3-8b", vocab_size=128256, hidden_size=4096,
    intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
    head_dim=128, rope_theta=500000.0, rms_norm_eps=1e-5,
    eos_token_ids=(128001, 128009),
))
register_config(ModelConfig(
    name="llama3-70b", vocab_size=128256, hidden_size=8192,
    intermediate_size=28672, num_layers=80, num_heads=64, num_kv_heads=8,
    head_dim=128, rope_theta=500000.0, rms_norm_eps=1e-5,
    eos_token_ids=(128001, 128009),
))

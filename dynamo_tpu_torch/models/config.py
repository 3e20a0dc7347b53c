"""Model architecture configs for the native PyTorch engine.

The reference ships no model code of its own — architecture is whatever the
wrapped engine (vLLM/sglang) loads from HF config.json; its
``ModelDeploymentCard`` (lib/llm/src/model_card/model.rs:15-201) carries only
serving metadata.  This package executes models natively, so the architecture
config lives here, convertible from a HF ``config.json``.

Dense Llama-family (Llama 2/3, DeepSeek-R1-Distill-Llama) plus Mixtral-style
MoE fields (models/moe.py runs the experts).  head_dim is 128 where the
checkpoints allow, bfloat16 activations by default.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int
    rope_theta: float = 500000.0
    rope_scaling: Optional[Dict[str, Any]] = None
    rms_norm_eps: float = 1e-5
    max_position: int = 131072
    tie_word_embeddings: bool = False
    dtype: str = "bfloat16"  # activation/weight dtype (string: framework-free config)
    # MoE (Mixtral / DeepSeek-V2-style shared+routed experts; 0 experts = dense)
    num_experts: int = 0
    num_experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_intermediate_size: int = 0
    eos_token_ids: tuple = ()
    # Qwen2-style attention: q/k/v projections carry biases.
    qkv_bias: bool = False

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    def with_overrides(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    @classmethod
    def from_hf_config(cls, cfg: Dict[str, Any], name: str = "") -> "ModelConfig":
        """Convert a HuggingFace ``config.json`` dict (llama/mixtral style)."""
        num_heads = cfg["num_attention_heads"]
        head_dim = cfg.get("head_dim") or cfg["hidden_size"] // num_heads
        # Qwen2 checkpoints carry q/k/v biases but don't always write an
        # explicit attention_bias flag.
        qkv_bias = bool(
            cfg.get("attention_bias", cfg.get("model_type") == "qwen2")
        )
        eos = cfg.get("eos_token_id", ())
        if isinstance(eos, int):
            eos = (eos,)
        return cls(
            name=name or cfg.get("_name_or_path", "hf-model"),
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            num_layers=cfg["num_hidden_layers"],
            num_heads=num_heads,
            num_kv_heads=cfg.get("num_key_value_heads", num_heads),
            head_dim=head_dim,
            intermediate_size=cfg["intermediate_size"],
            rope_theta=cfg.get("rope_theta", 10000.0),
            rope_scaling=cfg.get("rope_scaling"),
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
            max_position=cfg.get("max_position_embeddings", 8192),
            tie_word_embeddings=cfg.get("tie_word_embeddings", False),
            num_experts=cfg.get("num_local_experts", 0),
            num_experts_per_token=cfg.get("num_experts_per_tok", 0),
            moe_intermediate_size=cfg.get("intermediate_size", 0)
            if cfg.get("num_local_experts")
            else 0,
            eos_token_ids=tuple(eos),
            qkv_bias=qkv_bias,
        )

    @classmethod
    def from_local_path(cls, path: str, name: str = "") -> "ModelConfig":
        with open(os.path.join(path, "config.json")) as f:
            return cls.from_hf_config(json.load(f), name=name or os.path.basename(path))


_REGISTRY: Dict[str, ModelConfig] = {}


def register_config(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name in _REGISTRY:
        return _REGISTRY[name]
    if os.path.isdir(name):
        return ModelConfig.from_local_path(name)
    raise KeyError(f"unknown model config: {name!r}; known: {sorted(_REGISTRY)}")


# ---------------------------------------------------------------------------
# Presets.  llama-3.1-8b matches DeepSeek-R1-Distill-Llama-8B (the north-star
# model, BASELINE.md): same architecture, distilled weights.
# ---------------------------------------------------------------------------

register_config(
    ModelConfig(
        name="llama-3.1-8b",
        vocab_size=128256,
        hidden_size=4096,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        intermediate_size=14336,
        rope_theta=500000.0,
        eos_token_ids=(128001, 128008, 128009),
    )
)

register_config(
    ModelConfig(
        name="llama-3.1-70b",
        vocab_size=128256,
        hidden_size=8192,
        num_layers=80,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        intermediate_size=28672,
        rope_theta=500000.0,
        eos_token_ids=(128001, 128008, 128009),
    )
)

register_config(
    ModelConfig(
        name="mixtral-8x7b",
        vocab_size=32000,
        hidden_size=4096,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        intermediate_size=14336,
        rope_theta=1e6,
        num_experts=8,
        num_experts_per_token=2,
        moe_intermediate_size=14336,
        eos_token_ids=(2,),
    )
)

register_config(
    ModelConfig(
        name="qwen2.5-7b",
        vocab_size=152064,
        hidden_size=3584,
        num_layers=28,
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        intermediate_size=18944,
        rope_theta=1e6,
        tie_word_embeddings=False,
        qkv_bias=True,
        eos_token_ids=(151643, 151645),
    )
)

# Tiny configs for CPU tests / CI.
register_config(
    ModelConfig(
        name="debug-tiny",
        vocab_size=256,
        hidden_size=64,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        intermediate_size=128,
        rope_theta=10000.0,
        max_position=2048,
        eos_token_ids=(0,),
    )
)

register_config(
    ModelConfig(
        name="debug-tiny-moe",
        vocab_size=256,
        hidden_size=64,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        intermediate_size=128,
        rope_theta=10000.0,
        max_position=2048,
        num_experts=4,
        num_experts_per_token=2,
        moe_intermediate_size=128,
        eos_token_ids=(0,),
    )
)

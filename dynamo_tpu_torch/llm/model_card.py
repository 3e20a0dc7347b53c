"""ModelDeploymentCard: serving metadata published on the control plane.

A copy of the JAX package's ``llm/model_card.py`` (the LoRA adapter card
comes with multi-LoRA serving, ROADMAP queue 1).

Reference semantics: lib/llm/src/model_card/model.rs:15-201 + create.rs —
a card describes everything a frontend needs to serve a model (display
name, tokenizer, prompt format, context length) without touching weights;
cards live in shared storage under a TTL and are refreshed by the owning
worker (NATS object store bucket ``mdc`` there; hub KV under the worker's
lease here — same liveness semantics, one less storage system).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ..runtime.transports.shard import hub_key

MDC_PREFIX = "mdc/"


def mdc_key(name: str) -> str:
    """Deployment-card key for one model name (shard-map routed)."""
    return hub_key("mdc", name)


@dataclass
class ModelDeploymentCard:
    name: str
    model_type: str = "chat"  # chat | completion | both
    context_length: int = 8192
    kv_block_size: int = 16
    tokenizer: Dict[str, Any] = field(default_factory=lambda: {"kind": "byte"})
    prompt_template: Optional[str] = None  # chat template (jinja text)
    architecture: Optional[str] = None  # config name (models/config.py)
    revision: int = 0
    extra: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "model_type": self.model_type,
            "context_length": self.context_length,
            "kv_block_size": self.kv_block_size,
            "tokenizer": self.tokenizer,
            "prompt_template": self.prompt_template,
            "architecture": self.architecture,
            "revision": self.revision,
            "extra": self.extra,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelDeploymentCard":
        return cls(**{k: d.get(k, getattr(cls, k, None)) for k in (
            "name", "model_type", "context_length", "kv_block_size",
            "tokenizer", "prompt_template", "architecture", "revision",
        )}, extra=d.get("extra") or {})

    @classmethod
    def from_local_path(cls, path: str, name: Optional[str] = None) -> "ModelDeploymentCard":
        """Build a card from a HF model directory (config.json + tokenizer)."""
        card = cls(name=name or os.path.basename(path.rstrip("/")))
        cfg_path = os.path.join(path, "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as fh:
                cfg = json.load(fh)
            card.context_length = cfg.get("max_position_embeddings", card.context_length)
            card.architecture = path
        tok = os.path.join(path, "tokenizer.json")
        if os.path.exists(tok):
            card.tokenizer = {"kind": "hf", "file": tok}
        tpl = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(tpl):
            with open(tpl) as fh:
                tc = json.load(fh)
            if tc.get("chat_template"):
                card.prompt_template = tc["chat_template"]
        return card

    # ------------------------------------------------------------- publishing
    def key(self) -> str:
        return mdc_key(self.name)

    async def publish(self, runtime) -> None:
        """Register under the worker's primary lease (auto-refresh + removal
        on worker death via the runtime's lease monitor)."""
        await runtime.register_key(self.key(), self.to_dict())

    @classmethod
    async def load(cls, runtime, name: str) -> Optional["ModelDeploymentCard"]:
        data = await runtime.hub.kv_get(mdc_key(name))
        return cls.from_dict(data) if data else None

    @classmethod
    async def list_all(cls, runtime) -> Dict[str, "ModelDeploymentCard"]:
        kvs = await runtime.hub.kv_get_prefix(MDC_PREFIX)
        return {
            key[len(MDC_PREFIX):]: cls.from_dict(value)
            for key, value in kvs.items()
        }

"""Checkpoint resolution: model name → local directory, the local half.

Port of the JAX package's ``models/hub.py`` without its download: an
existing local directory or ``.gguf`` file is used as is, and a copy
pre-staged under ``DYN_MODEL_CACHE`` (a known alias or ``org/name`` repo id
as ``org--name``) is found there.  A remote repo id raises the JAX
package's ``FileNotFoundError``: the port has no ``huggingface_hub`` and
never downloads.  Adapters resolve by the same rule (``resolve_adapter``).
"""

from __future__ import annotations

import os
from typing import Optional

# North-star + convenience aliases → HF repo ids (the JAX package's).
ALIASES = {
    "deepseek-r1-distill-llama-8b": "deepseek-ai/DeepSeek-R1-Distill-Llama-8B",
    "deepseek-r1-distill-llama-70b": "deepseek-ai/DeepSeek-R1-Distill-Llama-70B",
    "llama-3.1-8b-instruct": "meta-llama/Llama-3.1-8B-Instruct",
    "llama-3.1-70b-instruct": "meta-llama/Llama-3.1-70B-Instruct",
    "mixtral-8x7b-instruct": "mistralai/Mixtral-8x7B-Instruct-v0.1",
    "qwen2.5-7b-instruct": "Qwen/Qwen2.5-7B-Instruct",
}

# The artifacts serving needs: weights, tokenizer, configs.
_PATTERNS = [
    "*.safetensors",
    "*.safetensors.index.json",
    "config.json",
    "generation_config.json",
    "tokenizer.json",
    "tokenizer.model",
    "tokenizer_config.json",
    "special_tokens_map.json",
]

# A LoRA adapter directory's serving artifacts (PEFT layout).
_ADAPTER_PATTERNS = [
    "adapter_model.safetensors",
    "adapter_config.json",
]

_NO_DOWNLOAD = "this package does not download (no huggingface_hub)"


def cache_dir() -> str:
    return os.environ.get(
        "DYN_MODEL_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "dynamo_tpu", "models"),
    )


def resolve_model(spec: str, revision: Optional[str] = None) -> str:
    """Resolve a model spec to a local checkpoint directory (or ``.gguf``
    file).  Raises FileNotFoundError naming the directory to pre-stage
    when the spec is remote."""
    if os.path.isdir(spec) or spec.endswith(".gguf"):
        return spec
    repo = ALIASES.get(spec.lower(), spec)
    staged = os.path.join(cache_dir(), repo.replace("/", "--"))
    if os.path.isdir(staged) and os.path.exists(os.path.join(staged, "config.json")):
        return staged
    if "/" not in repo:
        raise FileNotFoundError(
            f"model {spec!r} is neither a local directory, a known alias, "
            f"nor a HF repo id (org/name); known aliases: {sorted(ALIASES)}"
        )
    raise FileNotFoundError(
        f"model {spec!r} is a remote repo id and {_NO_DOWNLOAD}; pre-stage "
        f"the serving artifacts ({', '.join(_PATTERNS)}) at {staged}"
        + (f" (revision {revision})" if revision else "")
    )


def resolve_adapter(spec: str) -> str:
    """Resolve a LoRA adapter spec to a local PEFT directory, by
    ``resolve_model``'s rule."""
    if os.path.isdir(spec):
        return spec
    staged = os.path.join(cache_dir(), spec.replace("/", "--"))
    if os.path.isdir(staged) and os.path.exists(
        os.path.join(staged, "adapter_model.safetensors")
    ):
        return staged
    if "/" not in spec:
        raise FileNotFoundError(
            f"adapter {spec!r} is neither a local directory nor a HF repo "
            f"id (org/name); pre-stage PEFT artifacts "
            f"({', '.join(_ADAPTER_PATTERNS)}) at {staged}"
        )
    raise FileNotFoundError(
        f"adapter {spec!r} is a remote repo id and {_NO_DOWNLOAD}; pre-stage "
        f"the PEFT artifacts ({', '.join(_ADAPTER_PATTERNS)}) at {staged}"
    )


def tokenizer_spec(path: str) -> Optional[dict]:
    """Tokenizer spec dict (llm/discovery.make_tokenizer input) for a
    resolved checkpoint directory, or None if it ships no tokenizer."""
    if path.endswith(".gguf"):
        return {"kind": "gguf", "file": path}
    if os.path.exists(os.path.join(path, "tokenizer.json")):
        return {"kind": "hf", "dir": path}
    if os.path.exists(os.path.join(path, "tokenizer.model")):
        return {"kind": "sp", "file": os.path.join(path, "tokenizer.model")}
    return None

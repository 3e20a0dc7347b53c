"""Multi-tenant serving on one resident engine: batched multi-LoRA
(``lora.py``; S-LoRA, arXiv:2311.03285), hot-swappable per-request adapters
applied merge-free through fixed-shape device banks, with tenant-salted KV
hashing for cache isolation.  Structured output (the JAX package's
``grammar.py``) is ROADMAP queue 1 item 6.5."""

from .lora import (  # noqa: F401
    LORA_TARGETS,
    AdapterCapacityError,
    AdapterError,
    AdapterRegistry,
    LoraAdapter,
    kv_salt_for_adapter,
    load_lora_adapter,
    save_lora_adapter,
    target_dims,
)

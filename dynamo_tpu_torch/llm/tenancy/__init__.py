"""Multi-tenant serving on one resident engine:

- ``grammar.py`` — structured output: JSON-schema/regex constraints compiled
  to token-mask automata (Outlines, arXiv:2307.09702), applied as per-row
  logit masks inside the existing unified ragged program.
- ``lora.py`` — batched multi-LoRA: hot-swappable per-request adapters
  (S-LoRA, arXiv:2311.03285) applied merge-free through fixed-shape device
  banks, with tenant-salted KV hashing for cache isolation.
"""

from .grammar import (  # noqa: F401
    GrammarCompiler,
    GrammarError,
    TokenMaskAutomaton,
    build_regex_from_schema,
    compile_token_automaton,
    constraint_spec,
)

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

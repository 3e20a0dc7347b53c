"""TorchEngine and its host-side scheduler / KV manager."""

# Options of the JAX package's ``run`` command that this engine does not
# have yet: (args attribute, its default, flag, where it waits in ROADMAP).
# Setting one fails; it is never dropped.  None are left.
UNSUPPORTED_OPTIONS: tuple = ()


def refuse_unsupported(args) -> None:
    """Exit naming the ROADMAP item when ``args`` sets an option of
    ``UNSUPPORTED_OPTIONS`` away from its default."""
    for attr, default, flag, waits in UNSUPPORTED_OPTIONS:
        if getattr(args, attr, default) != default:
            raise SystemExit(f"{flag} is not supported by out=torch yet (ROADMAP {waits})")


def build_torch_engine(args):
    """CLI factory for ``run out=torch``, the counterpart of the JAX
    package's ``build_tpu_engine`` for the settings this engine has.  Runs
    on CUDA unless ``args.device`` says otherwise (device.py); at more than
    one rank on this process's rank of the group ``run`` joined
    (parallel/distributed.py).  Imports torch lazily."""
    refuse_unsupported(args)
    from .config import EngineConfig
    from .engine import TorchEngine

    arch = _resolve_arch(args)
    lora_section, lora_adapters = _lora_section(args)
    cfg = EngineConfig(
        model=arch or "debug-tiny",
        block_size=getattr(args, "block_size", 16),
        num_blocks=getattr(args, "num_blocks", 256),
        max_batch=getattr(args, "max_batch", 8),
        max_model_len=getattr(args, "max_model_len", 1024),
        prefill_chunk=getattr(args, "prefill_chunk", 512),
        dp=getattr(args, "dp", 1),
        tp=getattr(args, "tp", 1),
        ep=getattr(args, "ep", 1),
        sp=getattr(args, "sp", 1),
        sp_prefill_min=getattr(args, "sp_prefill_min", 1024),
        dtype=getattr(args, "dtype", "bfloat16"),
        decode_steps=getattr(args, "decode_steps", 4),
        pipeline_depth=getattr(args, "pipeline_depth", 2),
        cache_dtype=getattr(args, "cache_dtype", None),
        kv_scale=getattr(args, "kv_scale", 1.0),
        seed=getattr(args, "seed", 0),
        qos=_qos_sched_section(),
        spec_decode=_spec_decode_section(args),
        host_cache_bytes=(getattr(args, "host_cache_mb", 0) or 0) << 20,
        disk_cache_bytes=(getattr(args, "disk_cache_mb", 0) or 0) << 20,
        disk_cache_dir=getattr(args, "disk_cache_dir", None),
        object_store_bytes=(getattr(args, "object_store_mb", 0) or 0) << 20,
        object_store_dir=getattr(args, "object_store_dir", None),
        checkpoint_path=getattr(args, "checkpoint", None),
        lora=lora_section,
    )
    if getattr(args, "kv_pull_mb", None) is not None:
        cfg.kv_pull_max_bytes = int(args.kv_pull_mb) << 20
    engine = TorchEngine(cfg, device=getattr(args, "device", None))
    _load_adapters(engine, lora_adapters, getattr(args, "model", None))
    return engine


def _resolve_arch(args):
    """The JAX ``build_tpu_engine``'s architecture resolution: a
    ``--checkpoint`` spec resolves to a local path first (models/hub.py: a
    directory, a ``.gguf`` file or a pre-staged copy; remote ids are
    refused), then the architecture comes from ``--arch``, else the
    checkpoint's ``config.json`` or the GGUF's metadata, else
    ``--model-config``.  Sets ``args.checkpoint`` to the resolved path
    (tokenizer discovery reads it) and ``args.checkpoint_source`` to the
    spec."""
    import json

    from ..models.config import ModelConfig, register_config

    arch = getattr(args, "arch", None)
    checkpoint = getattr(args, "checkpoint", None)
    model_config_path = getattr(args, "model_config", None)
    if checkpoint:
        from ..models.hub import resolve_model

        args.checkpoint_source = checkpoint
        checkpoint = resolve_model(checkpoint)
        args.checkpoint = checkpoint
    if checkpoint and not arch and not checkpoint.endswith(".gguf") and not model_config_path:
        arch = register_config(ModelConfig.from_local_path(checkpoint)).name
    if checkpoint and checkpoint.endswith(".gguf") and not arch:
        from ..models.gguf import GGUFFile

        arch = register_config(GGUFFile(checkpoint).to_model_config()).name
    if model_config_path:
        with open(model_config_path) as f:
            cfg_json = json.load(f)
        arch = register_config(
            ModelConfig.from_hf_config(cfg_json, name=cfg_json.get("_name", "custom"))
        ).name
    return arch


def _lora_section(args):
    """Layered multi-LoRA section: RuntimeConfig ``lora`` (file /
    DYN_LORA__* env) under explicit --lora* CLI flags.  Returns
    ``(LoraConfig-kwargs, {name: spec})``: the adapters map merges the
    config section's ``adapters`` with every repeatable ``--lora NAME=SPEC``
    flag, and any adapter at all implies ``enable``."""
    from ..runtime.config import RuntimeConfig

    section = dict(RuntimeConfig.from_layers().lora)
    adapters = dict(section.pop("adapters", None) or {})
    for spec in getattr(args, "lora", None) or []:
        name, sep, path = spec.partition("=")
        if not sep or not name or not path:
            raise SystemExit(f"--lora expects NAME=PATH, got {spec!r}")
        adapters[name] = path
    if getattr(args, "lora_max_adapters", None) is not None:
        section["max_adapters"] = int(args.lora_max_adapters)
    if getattr(args, "lora_rank", None) is not None:
        section["rank"] = int(args.lora_rank)
    if adapters:
        section["enable"] = True
    return section, adapters


def _load_adapters(engine, adapters: dict, base_model) -> None:
    """Host-register the configured adapters.  ``random[:seed]`` specs
    build synthetic adapters; other specs resolve like checkpoints (a local
    PEFT directory or a pre-staged copy, models/hub.resolve_adapter).  On
    any LoRA-enabled engine the served-model allowlist is pinned to
    base+adapters so unknown names 404 instead of silently running the
    base model — also when no boot adapters exist."""
    if adapters:
        from ..llm.tenancy.lora import LoraAdapter, load_lora_adapter
        from ..models.hub import resolve_adapter

        for name, spec in sorted(adapters.items()):
            if isinstance(spec, str) and spec.startswith("random"):
                _, _, seed = spec.partition(":")
                adapter = LoraAdapter.random(
                    engine.model_config, name, rank=min(4, engine.cfg.lora.rank),
                    seed=int(seed or 0),
                )
            else:
                adapter = load_lora_adapter(resolve_adapter(spec), engine.model_config, name=name)
            engine.register_adapter(adapter)
    if base_model and (adapters or engine.cfg.lora.enable):
        engine.set_served_models([base_model, *adapters])


def _spec_decode_section(args) -> dict:
    """Layered spec_decode section: RuntimeConfig (file/DYN_SPEC_DECODE__*
    env) under explicit --spec-* CLI flags."""
    from ..runtime.config import RuntimeConfig

    section = dict(RuntimeConfig.from_layers().spec_decode)
    if getattr(args, "spec_decode", None) is not None:
        section["enable"] = bool(args.spec_decode)
    if getattr(args, "spec_k", None) is not None:
        section["k"] = int(args.spec_k)
    if getattr(args, "spec_ngram_max", None) is not None:
        section["ngram_max"] = int(args.spec_ngram_max)
    if getattr(args, "spec_ngram_min", None) is not None:
        section["ngram_min"] = int(args.spec_ngram_min)
    return section


def _qos_sched_section() -> dict:
    """Scheduler half of the layered ``qos`` config section (file /
    DYN_QOS__* env): WFQ tenant weights + the batch starvation bound.  The
    edge half (quotas, brownout) is consumed by the CLI's HttpService
    wiring instead."""
    from ..runtime.config import RuntimeConfig

    section = RuntimeConfig.from_layers().qos or {}
    known = ("tenant_weights", "default_weight", "batch_every")
    return {k: section[k] for k in known if k in section}

"""TorchEngine and its host-side scheduler / KV manager."""

# Options of the JAX package's ``run`` command that this engine does not
# have yet: (args attribute, its default, flag, where it waits in ROADMAP).
# Setting one fails; it is never dropped.
UNSUPPORTED_OPTIONS = (
    ("checkpoint", None, "--checkpoint", "queue 1 item 6, loaders"),
    ("tp", 1, "--tp", "queue 1 item 7, tp/sp and multi-host"),
    ("dp", 1, "--dp", "queue 1 item 7, tp/sp and multi-host"),
    ("ep", 1, "--ep", "queue 1 item 7, tp/sp and multi-host"),
    ("sp", 1, "--sp", "queue 1 item 7, tp/sp and multi-host"),
    ("nnodes", 1, "--nnodes", "queue 1 item 7, tp/sp and multi-host"),
    ("lora", None, "--lora", "queue 1 item 6, LoRA"),
    ("lora_max_adapters", None, "--lora-max-adapters", "queue 1 item 6, LoRA"),
    ("lora_rank", None, "--lora-rank", "queue 1 item 6, LoRA"),
)


def build_torch_engine(args):
    """CLI factory for ``run out=torch``, the counterpart of the JAX
    package's ``build_tpu_engine`` for the settings this engine has.  Runs
    on CUDA unless ``args.device`` says otherwise (device.py).  Imports
    torch lazily."""
    for attr, default, flag, waits in UNSUPPORTED_OPTIONS:
        if getattr(args, attr, default) != default:
            raise SystemExit(f"{flag} is not supported by out=torch yet (ROADMAP {waits})")
    from .config import EngineConfig
    from .engine import TorchEngine

    cfg = EngineConfig(
        model=getattr(args, "arch", None) or "debug-tiny",
        block_size=getattr(args, "block_size", 16),
        num_blocks=getattr(args, "num_blocks", 256),
        max_batch=getattr(args, "max_batch", 8),
        max_model_len=getattr(args, "max_model_len", 1024),
        prefill_chunk=getattr(args, "prefill_chunk", 512),
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
    )
    if getattr(args, "kv_pull_mb", None) is not None:
        cfg.kv_pull_max_bytes = int(args.kv_pull_mb) << 20
    return TorchEngine(cfg, device=getattr(args, "device", None))


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

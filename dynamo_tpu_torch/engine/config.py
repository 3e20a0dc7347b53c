"""Engine configuration knobs.

The JAX package's ``EngineConfig`` trimmed to the knobs this engine honours:
a knob it would silently ignore (meshes, LoRA) is absent, so
passing one fails at construction instead of serving something else.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

@dataclass
class QosSchedConfig:
    """Scheduler-side QoS (engine/scheduler.py WfqQueue).  Defaults give
    exact FIFO for single-tenant traffic: equal weights collapse WFQ to
    per-tenant FIFO, and FIFO within one tenant.
    """

    # Tenant → WFQ weight (share of admission work while backlogged).
    tenant_weights: Dict[str, float] = field(default_factory=dict)
    default_weight: float = 1.0
    # Batch-class starvation bound: at most this many consecutive
    # interactive admissions while batch is backlogged before one batch
    # admission is forced.
    batch_every: int = 4

    def __post_init__(self) -> None:
        if self.default_weight <= 0:
            raise ValueError("qos default_weight must be > 0")
        if self.batch_every < 1:
            raise ValueError("qos batch_every must be >= 1")
        for name, w in self.tenant_weights.items():
            if float(w) <= 0:
                raise ValueError(f"qos tenant weight {name!r} must be > 0")

    @classmethod
    def normalize(cls, v: Any) -> "QosSchedConfig":
        """Accept the section as an instance, a dict, or None."""
        if v is None:
            return cls()
        if isinstance(v, cls):
            return v
        if isinstance(v, dict):
            known = set(cls.__dataclass_fields__)
            bad = set(v) - known
            if bad:
                raise ValueError(f"unknown qos keys: {sorted(bad)}")
            return cls(**v)
        raise ValueError(f"bad qos section: {v!r}")


@dataclass
class SpecDecodeConfig:
    """Draft-free speculative decoding (engine/spec.py), copied from the JAX
    package's engine/config.py.

    The proposer is prompt-lookup (Saxena 2023): the last ``ngram_min..
    ngram_max`` tokens of a sequence are matched against its own
    prompt+output history and the continuation of the most recent match is
    proposed as a draft.  Drafts verify through the existing unified step,
    one single-token row per draft position, so per-position logits and the
    per-(seed, step) sampler come for free, and the longest prefix matching
    the seeded sample stream is accepted.  Speculation on/off is
    token-for-token identical at any temperature.
    """

    enable: bool = False
    # Suffix n-gram lengths tried longest-first against the history.
    ngram_min: int = 2
    ngram_max: int = 4
    # Draft-length ceiling per sequence per dispatch (the adaptive
    # controller moves each sequence's k inside [k_min, k]).
    k: int = 8
    k_min: int = 1
    # EWMA smoothing of per-dispatch acceptance (accepted/drafted).
    ewma_alpha: float = 0.3
    # Below this EWMA the sequence's proposer is benched ...
    accept_floor: float = 0.15
    # ... until this many more tokens have been committed, then re-probes
    # at k_min.
    cooldown_tokens: int = 64
    # Proposer matching window: only the last ``lookback`` history tokens
    # are scanned (0 = unlimited).
    lookback: int = 2048
    # Engagement bar vs the fused pipeline (pure-decode plans): speculate
    # when the expected committed tokens per round trip reach
    # ``pipeline_margin * n_decode * decode_steps`` (a verification step
    # streams the weights once for all its rows where a fused chunk streams
    # them decode_steps times).
    pipeline_margin: float = 0.5

    def __post_init__(self) -> None:
        if self.ngram_min < 1 or self.ngram_max < self.ngram_min:
            raise ValueError(
                f"spec_decode ngram range [{self.ngram_min}, {self.ngram_max}]"
                " must satisfy 1 <= ngram_min <= ngram_max"
            )
        if self.k < 1 or self.k_min < 1 or self.k_min > self.k:
            raise ValueError(
                f"spec_decode k range [{self.k_min}, {self.k}] must satisfy"
                " 1 <= k_min <= k"
            )
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError("spec_decode ewma_alpha must be in (0, 1]")
        if self.pipeline_margin <= 0.0:
            raise ValueError("spec_decode pipeline_margin must be > 0")

    @classmethod
    def normalize(cls, v: Any) -> "SpecDecodeConfig":
        """Accept the config section in any layered-config shape: an
        instance, a dict (file/env layers), a bare bool, or None."""
        if v is None:
            return cls()
        if isinstance(v, cls):
            return v
        if isinstance(v, bool):
            return cls(enable=v)
        if isinstance(v, dict):
            known = set(cls.__dataclass_fields__)
            bad = set(v) - known
            if bad:
                raise ValueError(f"unknown spec_decode keys: {sorted(bad)}")
            return cls(**v)
        raise ValueError(f"bad spec_decode section: {v!r}")


@dataclass
class EngineConfig:
    model: str = "debug-tiny"
    block_size: int = 16  # tokens per KV page
    num_blocks: int = 256  # device KV pages
    max_batch: int = 8  # decode slots
    max_model_len: int = 1024  # context limit per sequence
    prefill_chunk: int = 512  # max prompt tokens per device step
    dtype: str = "bfloat16"
    # KV page dtype; defaults to dtype.  Quantized page dtypes ("int8",
    # "float8_e4m3fn") store value / kv_scale; kv_scale is a float, a
    # per-layer sequence, or "auto": per-layer scales calibrated from a
    # probe forward at engine start (engine.py _calibrate_kv_scales).
    # int8 needs a real scale: at 1.0, sub-unit activations round to 0.
    cache_dtype: Any = None
    kv_scale: Any = 1.0
    # Weight quantization: "int8" = W8A8-dynamic (per-output-channel int8
    # weights, per-row dynamic int8 activations, int8 products into int32
    # — models/quant.py, ops/quant_matmul.py).  None = float weights.
    weight_quant: Optional[str] = None
    # Fuse q|k|v and gate|up weights at engine init (7 matmuls per dense
    # layer -> 5; fused products share one activation quantization).
    fuse_projections: bool = True
    seed: int = 0  # random-init weights when no params are given
    enable_prefix_caching: bool = True
    # Decode iterations fused into one dispatch: the sampled token feeds
    # the next iteration on the device, with one host fetch per dispatch.
    decode_steps: int = 4
    # Fused decode dispatches kept in flight before their token fetch is
    # awaited (the sampled-token carry stays on the device between
    # dispatches, so chunk k+1 runs while chunk k's tokens come back).
    # Stop conditions apply with up to pipeline_depth * decode_steps tokens
    # of lag; over-decoded tokens are dropped host-side.
    pipeline_depth: int = 2
    # Host (CPU RAM) KV offload tier: sealed blocks are write-behind copied
    # to host (pinned on CUDA) so device eviction keeps their contents;
    # prompts restore evicted prefixes with one in-place scatter instead of
    # recomputing (engine/host_cache.py, engine/offload.py).  0 disables.
    host_cache_bytes: int = 0
    # Seconds between offload pump cycles (device gather + async D2H).
    host_offload_interval: float = 0.05
    # Disk KV tier (engine/disk_cache.py): host-tier LRU eviction DEMOTES
    # blocks to hash-named files under ``disk_cache_dir`` instead of
    # dropping them; restores promote disk→host→device.  Requires
    # host_cache_bytes > 0 (demotion feeds it).  0 disables.
    disk_cache_bytes: int = 0
    # Directory for the disk tier's block files; None resolves to a
    # per-process dir under the system temp root, removed at close().
    disk_cache_dir: Optional[str] = None
    # fsync the block file before the atomic rename (DYN_DISK_FSYNC=1 also
    # enables).  Off by default: the read-side checksum already turns a
    # torn payload into a recompute, never a wrong scatter.
    disk_fsync: bool = False
    # Object-store KV tier (engine/object_store.py): disk-tier LRU eviction
    # DEMOTES blocks into a durable object layout, and hot chains can be
    # persisted there explicitly (persist_hashes), so a scale-from-zero
    # worker pointed at the same ``object_store_dir`` boots warm.  Requires
    # disk_cache_bytes > 0 and an explicit directory: the store outlives
    # the process, so the operator owns params stability.  0 disables.
    object_store_bytes: int = 0
    object_store_dir: Optional[str] = None
    # fsync each object before the atomic publish (DYN_OBJSTORE_FSYNC=1
    # also enables).
    object_store_fsync: bool = False
    # KV integrity plane (engine/integrity.py): seconds a checksum-failed
    # block hash stays negative-cached (restore and promotion treat it as
    # a miss meanwhile).
    kv_corrupt_ttl_s: float = 30.0
    # Cross-worker prefix pull (llm/kv_router/pull.py): when the router's
    # index says a peer holds a strictly longer prefix than every local
    # tier, the engine pulls the sealed delta blocks over the KV transfer
    # plane instead of recomputing prefill.  Budgets bound the worst case:
    # a pull never moves more than ``kv_pull_max_bytes`` and never waits
    # longer than ``kv_pull_timeout_s`` — past either, local prefill runs
    # (the disagg degraded-mode shape; the request is never lost).
    kv_pull_max_bytes: int = 64 << 20
    kv_pull_timeout_s: float = 5.0
    # Decode-stall watchdog threshold in seconds (engine/pipeline.py
    # _await_device): a token fetch or device dispatch exceeding it logs the
    # recent dispatch trace and bumps dynamo_tpu_engine_stall_total.  None
    # reads the DYN_DECODE_STALL_S environment variable; 0 disables.
    decode_stall_s: Optional[float] = None
    # Mixed-phase cadence: while prompts are prefilling, decode rows sit out
    # the prefill steps and advance via one fused decode_steps burst every
    # this many prefill chunks (engine.py _run_loop).
    prefill_chunks_per_burst: int = 24
    # Scheduler QoS section (QosSchedConfig; accepts dict).
    qos: Any = None
    # Draft-free speculative decoding (SpecDecodeConfig; accepts a dict,
    # a bool or None).
    spec_decode: Any = None

    def __post_init__(self) -> None:
        if self.cache_dtype is None:
            self.cache_dtype = self.dtype
        self.qos = QosSchedConfig.normalize(self.qos)
        self.spec_decode = SpecDecodeConfig.normalize(self.spec_decode)
        if self.weight_quant not in (None, "int8"):
            raise ValueError(f"unknown weight_quant {self.weight_quant!r} (None or 'int8')")
        if isinstance(self.kv_scale, str) and self.kv_scale != "auto":
            raise ValueError(f"unknown kv_scale {self.kv_scale!r} (a float, a sequence or 'auto')")
        if self.decode_steps < 1:
            raise ValueError("decode_steps must be >= 1")
        if self.pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        if self.disk_cache_bytes > 0 and self.host_cache_bytes <= 0:
            raise ValueError(
                "disk_cache_bytes requires host_cache_bytes > 0 (the disk "
                "tier is fed by host-tier demotion)"
            )
        if self.object_store_bytes > 0:
            if self.disk_cache_bytes <= 0:
                raise ValueError(
                    "object_store_bytes requires disk_cache_bytes > 0 (the "
                    "object tier is fed by disk-tier demotion)"
                )
            if self.object_store_dir is None:
                raise ValueError(
                    "object_store_bytes requires an explicit "
                    "object_store_dir: the store outlives the process, so "
                    "the operator must own the directory (and the params "
                    "stability its hashes assume)"
                )

    @property
    def max_blocks_per_seq(self) -> int:
        return (self.max_model_len + self.block_size - 1) // self.block_size

    @property
    def max_step_tokens(self) -> int:
        """Token capacity of one unified (ragged) step: a full prefill
        budget plus a decode token for every batch slot."""
        n = self.prefill_chunk + self.max_batch
        return 1 << (n - 1).bit_length()

    def bucket_tokens(self, n: int) -> int:
        """Power-of-two token-count bucket for the unified ragged step."""
        b = max(16, 1 << (max(1, n) - 1).bit_length())
        return min(b, self.max_step_tokens)

"""TorchEngine: the native PyTorch engine behind the AsyncEngine interface.

Port of the JAX package's ``TpuEngine`` (engine/engine.py) for the dense
serving path, token-level requests in, ``LLMEngineOutput`` items out:

- ONE unified step (``_step``): a flat ragged run of tokens mixing prompt
  chunks and decode tokens (models/llama.py forward_ragged), followed by
  the batched sampler;
- a fused multi-step decode (``_multi``): ``decode_steps`` iterations per
  dispatch, the sampled token, position, rng step and penalty counts
  staying on the device between iterations, and the final carry returned
  so the next dispatch can chain to it on the device;
- each dispatch of either is ONE device program (engine/graphs.py): on
  CUDA a CUDA graph captured once per key (at first use or by
  ``warmup()``) and replayed, the counterpart of the JAX engine's
  ``jax.jit`` executables; on the CPU the same functions eagerly;
- the JAX engine's default serving loop (engine/pipeline.py): the
  continuous fused-decode pipeline with ``pipeline_depth`` dispatches in
  flight, deferred device→host fetches into pinned memory, in-loop
  admission and retirement;
- the same continuous-batching scheduler and paged-KV block manager
  (copies of the JAX package's host modules), KV events and
  ForwardPassMetrics included.

Device work runs in worker threads (``asyncio.to_thread``) so the event
loop keeps serving ingress while the card computes; the paged KV slab is
updated in place.  Attention goes through the hand-written CUDA kernels on
a CUDA device and through their plain versions on the CPU — chosen by the
device, never by a fallback.  W8A8 int8 weights (``weight_quant``), int8 /
fp8 KV pages with calibrated per-layer scales (``kv_scale="auto"``) and
draft-free speculative decoding (engine/spec.py) are the JAX engine's, and
so are its request-tracing spans (``engine.queue_wait``, ``engine.prefill``,
``engine.decode_chunk``, ``engine.kv_restore``; host clocks only, outside
every captured graph), and its local KV memory tiers (engine/offload.py):
a host tier in pinned memory, a disk tier and the durable object store,
each block CRC-32 verified at every tier boundary, restored ahead of
admission by an in-place scatter into the pages the graphs hold, and the
JAX engine's KV block transfer (engine/transfer.py): the checksummed
host-staged export and import of disaggregated prefill, and the
same-process device-to-device path.  The same transfer carries the
cross-worker prefix pull at admission (``set_prefix_puller``, the
``engine.kv_pull`` span) and live migration's copy rounds; the migration
primitives (snapshot, freeze, cutover) are engine/migrate.py's.
Weights come from a local checkpoint (``checkpoint_path``: HF safetensors
or GGUF, models/loader.py) or from a seeded random init.  Batched
multi-LoRA is the JAX engine's (``lora``): fixed-shape adapter banks in
the params the graphs read, per-row slot ids staged with every dispatch,
an ``AdapterRegistry`` promoting adapters by in-place column writes
ordered on the stream the graphs replay on, and the adapter's KV salt
isolating its blocks in every tier.  Grammar-constrained requests
(llm/tenancy/grammar.py) carry a token-mask automaton: a constrained row
samples one token a unified step under its packed mask row, which every
step program reads from one static buffer (``_stage_mask``), and never
rides a fused dispatch.  MoE configs (mixtral-8x7b, debug-tiny-moe) run
models/moe.py in place of the dense FFN, with static shapes, so their
steps are captured like the dense ones.

Tensor, expert, data and sequence parallelism run one engine per rank
(parallel/): every rank builds the same engine from the same config and
seed, holds its slice of the params and pages, and runs the sharded forward
with its collectives.  Global rank 0 serves (scheduler, KV manager, tiers,
the serving loop) and publishes every dispatch to the other ranks before it
enqueues it, under the device lock (``attach_publisher``, the step plane of
engine/multihost.py); the others replay them in order (``mirror_step``), so
every rank reaches every collective in one order.  Long prompts prefill in
one ring-attention pass over ``sp`` (``_sp_prefill``).  On one node the
KV export and the tiers take whole blocks, as the JAX engine does in one
process: the leader gathers every rank's heads (one gather over ``tp``)
and keeps the node's one host tier, with disk and object store beneath,
within ``host_cache_bytes``; a restore publishes each rank its heads.
Across nodes (``nnodes`` > 1) the disk and object tiers are off and the
export refuses (it returns None, the caller prefills locally), as the JAX
package's multi-process branches do; each rank's host tier holds its own
slice.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import os
import shutil
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, AsyncIterator, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import default_device
from ..llm.kv_router.protocols import ForwardPassMetrics, KvCacheEvent
from ..llm.metrics import kv_integrity_metrics, kv_tier_metrics, tenancy_metrics
from ..llm.protocols import FinishReason, ModelNotFoundError, PreprocessedRequest
from ..llm.tenancy.grammar import GrammarCacheMissError, TokenMaskAutomaton
from ..models.config import ModelConfig, get_config
from ..models.llama import PagedKVCache, RaggedBatch, forward_ragged, init_params, torch_dtype
from ..models.quant import fuse_projections, init_params_quantized, quantize_params
from ..ops.decode_attention import install_tuned_hints
from ..ops.ragged_attention import kernel_route, quantize_for_cache
from ..parallel import distributed as pdist
from ..parallel.mesh import MeshConfig, check_tp, make_mesh, param_pspecs, shard_params
from ..ops.sampling import SampleOut, SamplingFlags, SamplingParams, sample_tokens
from ..runtime.engine import AsyncEngine, Context, ResponseStream
from ..runtime.tracing import SeqTrace, parse_trace, span
from ..tokens import hash_token_blocks
from .config import EngineConfig
from .disk_cache import DTYPES, DiskKvStore
from .graphs import DevicePrograms, FetchRing, Layout
from .host_cache import HostKvStore
from .integrity import CorruptionCache
from .kv_manager import KvBlockManager
from .migrate import MigrationMixin
from .object_store import ObjectKvStore
from .offload import HostOffloadMixin
from .pipeline import _FINISHED, DecodePipelineMixin, HostSampling
from .scheduler import Scheduler, SequenceState, StepPlan
from .spec import AcceptanceController, SpecDecodeMixin
from .transfer import KvTransferMixin

logger = logging.getLogger(__name__)


class StreamSpans:
    """Device time of spans of work queued on the current stream, kept
    without a host sync.  On CUDA a span is a pair of events, folded into
    the total once its end event has completed; ``seconds`` waits for the
    rest.  A span runs from the moment the stream reaches its first
    operation to the end of its last, so it includes any time the card
    waited on the host to launch the span's work.  On the CPU, where work
    runs as it is called, a span's host wall is its device time."""

    def __init__(self, device: torch.device):
        self._device = device
        self._cuda = device.type == "cuda"
        self._pending: Deque[Tuple[Any, Any]] = collections.deque()
        self._total_s = 0.0
        self.count = 0

    def start(self) -> Any:
        if not self._cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self._device))
        return ev

    def stop(self, start: Any) -> None:
        self.count += 1
        if not self._cuda:
            self._total_s += time.perf_counter() - start
            return
        end = torch.cuda.Event(enable_timing=True)
        end.record(torch.cuda.current_stream(self._device))
        self._pending.append((start, end))
        self._fold(wait=False)

    def _fold(self, wait: bool) -> None:
        while self._pending and (wait or self._pending[0][1].query()):
            start, end = self._pending.popleft()
            end.synchronize()
            self._total_s += start.elapsed_time(end) / 1e3

    @property
    def seconds(self) -> float:
        self._fold(wait=True)
        return self._total_s


class TorchEngine(KvTransferMixin, HostOffloadMixin, SpecDecodeMixin, DecodePipelineMixin,
                  MigrationMixin, AsyncEngine):
    """Token-in/token-out engine on one device."""

    def __init__(
        self,
        cfg: EngineConfig,
        params: Optional[Dict[str, Any]] = None,
        device: Optional[torch.device] = None,
        event_callback: Optional[Callable[[KvCacheEvent], None]] = None,
        shard: Optional["pdist.ParallelState"] = None,
    ):
        self.cfg = cfg
        self.model_config: ModelConfig = get_config(cfg.model).with_overrides(dtype=cfg.dtype)
        mc = self.model_config
        check_tp(mc.num_kv_heads, cfg.tp)
        # This rank's place in the mesh (parallel/): given, or the state
        # init_multihost set up in this process.  None = one rank.
        mesh_cfg = MeshConfig(dp=cfg.dp, tp=cfg.tp, ep=cfg.ep, sp=cfg.sp)
        self.shard: Optional[pdist.ParallelState] = None
        if mesh_cfg.num_devices > 1:
            shard = shard if shard is not None else pdist.current()
            if shard is None:
                make_mesh(mesh_cfg, [default_device(device)])  # raises: too few devices
            if shard.mesh.config != mesh_cfg:
                raise ValueError(f"the process group's mesh {shard.mesh.config} is not the "
                                 f"engine's {mesh_cfg}")
            self.shard = shard
            if device is None:
                device = shard.device
        self.device = default_device(device)
        # The step plane (engine/multihost.py): the leader's publisher.
        self._publisher = None
        self._export_refusal_logged = False
        # Whole blocks (every rank's heads) in the export and the tiers:
        # one rank, or one node's ranks gathering to the leader.  Across
        # nodes the export refuses and each rank's tier keeps its slice, as
        # the JAX multi-process branches do.
        self._whole_blocks = self.shard is None or self.shard.nnodes == 1
        self.kv = KvBlockManager(
            cfg.num_blocks,
            cfg.block_size,
            event_callback=event_callback,
            enable_prefix_caching=cfg.enable_prefix_caching,
        )
        self.scheduler = Scheduler(cfg, self.kv)
        self._queues: Dict[str, asyncio.Queue] = {}
        self._contexts: Dict[str, Any] = {}
        self._wake = asyncio.Event()
        self._closed = False
        self._loop_task: Optional[asyncio.Task] = None
        # Cross-worker prefix puller (llm/kv_router/pull.py), set by the
        # serving layer; None = no pull at admission.
        self._prefix_puller = None
        # Serialises device dispatches (each runs in a worker thread).
        self._device_lock = asyncio.Lock()
        # Mixed-phase cadence: prefill chunks run since the last decode burst.
        self._chunks_since_burst = 0
        self._prefill_requeues_seen = 0
        # Per-dispatch trace (kind, wall_s, rows, device_tokens); dispatch
        # and fetch are recorded apart since they overlap.  Bounded.
        self.step_trace: Deque[Tuple[str, float, int, int]] = collections.deque(maxlen=65536)
        # Prefill-chunk accounting: cumulative counters plus a bounded
        # per-chunk wall trace for the latency quantiles on /metrics.
        self.prefill_chunks = 0
        self.prefill_wall_s = 0.0
        self.prefill_tokens = 0
        self._prefill_chunk_trace: Deque[float] = collections.deque(maxlen=4096)
        # Deferred token fetches (FIFO): (kind, task, *meta), applied at
        # harvest points (engine/pipeline.py _harvest_pending).
        self._pending_fetches: List[Tuple] = []
        # Request ids with fused dispatches possibly in flight (a migration
        # freeze polls it for quiescence, engine/migrate.py).
        self._pipeline_members: set = set()
        # Continuous-batching pipeline health, on /metrics as
        # dynamo_tpu_engine_dispatch_* (llm/metrics.py).
        self.pipeline_sessions = 0  # _decode_pipeline runs begun
        self.pipeline_rebuilds = 0  # sessions drained by a rebuild event
        self.continuous_admissions = 0  # sequences admitted in-loop
        self.continuous_retired = 0  # rows retired in-loop (no drain)
        self.pipeline_wall_s = 0.0  # cumulative fused-session wall
        # Device-busy wall inside fused sessions (dispatch, wait and the
        # interleaved admission prefill): host_gap_frac's numerator.
        self.decode_busy_s = 0.0
        # Decode-stall watchdog (pipeline._await_device): threshold from
        # the config, else DYN_DECODE_STALL_S; 0 = off.
        self._stall_threshold_s = float(
            cfg.decode_stall_s
            if cfg.decode_stall_s is not None
            else os.environ.get("DYN_DECODE_STALL_S", "0") or 0
        )
        self.decode_stalls = 0
        self.last_stall: Optional[Dict[str, Any]] = None
        # Awaited before every device op, outside the device lock, when set
        # (tests throttle decode with it).
        self.pace_hook: Optional[Callable[[], Any]] = None
        # Multi-tenancy (llm/tenancy): the LoRA adapter registry (None =
        # LoRA disabled) and the optional served-model allowlist (unknown
        # names → ModelNotFoundError → 404 at the edge).
        self._lora_registry = None
        self._served_models: Optional[set] = None
        # The deserialized grammar-automaton LRU (requests ship automata by
        # content hash; llm/tenancy/grammar.py).
        self._grammar_lru: "collections.OrderedDict[str, TokenMaskAutomaton]" = (
            collections.OrderedDict())
        # Device time and count of prefill steps and fused decode
        # dispatches, timed on the stream: a dispatch returns once queued,
        # so host walls would misplace its work.
        self.prefill_spans = StreamSpans(self.device)
        self.decode_spans = StreamSpans(self.device)
        self._init_tiers()
        self._init_transfer()
        # The tuned launch shapes for this engine's geometry (the table that
        # ``python -m dynamo_tpu_torch.tools.tune_decode`` writes; built-in
        # defaults when no entry matches), installed before any kernel runs
        # so that every captured graph holds the tuned launch.
        install_tuned_hints(cfg.model, cfg.max_batch, cfg.block_size)

        # --- device state -------------------------------------------------
        dev = self.device
        # No fused projections for MoE trees, as the JAX engine: the
        # unfused q/k/v path serves their attention.
        fuse = cfg.fuse_projections and not self.model_config.is_moe and self.shard is None
        if cfg.lora.enable and self.shard is not None:
            raise ValueError(
                "lora.enable requires a single-shard engine in this build (tp/dp/ep/sp == 1): "
                "the adapter banks have no PartitionSpecs yet")
        if params is None and cfg.checkpoint_path:
            from ..models.loader import load_params

            # Each leaf allocated once on the device, quantized and fused as
            # the tensors arrive: no float transient of the whole tree.
            params = load_params(self.model_config, cfg.checkpoint_path, quant=cfg.weight_quant,
                                 device=dev, fuse=fuse)
        elif params is None:
            if cfg.weight_quant:
                # Int8 drawn directly: full-depth 8B in bf16 would be 16 GB
                # before it could be quantized.
                params = init_params_quantized(self.model_config, cfg.seed, dev)
            else:
                params = init_params(self.model_config, cfg.seed, dev)
        else:
            params = {
                k: ({n: w.to(dev) for n, w in v.items()} if k == "layers" else v.to(dev))
                for k, v in params.items()
            }
            if cfg.weight_quant:
                params = quantize_params(params)  # a no-op on a quantized tree
        if self.shard is not None:
            # Every rank draws (or loads) the same whole tree and keeps its
            # slice, as every JAX process holds the same host values.
            params = shard_params(params, param_pspecs(mc), self.shard.mesh, self.shard.rank)
        self.params = fuse_projections(params) if fuse else params
        self._lora_rank = cfg.lora.rank if cfg.lora.enable else 0
        if cfg.lora.enable:
            # Fixed-shape multi-LoRA device banks (llm/tenancy/lora.py): R
            # resident slots x rank-r A/B factors per attention projection,
            # zero (an all-zero slot is exactly the base model), added after
            # quantize/fuse: adapters are merge-free.  The graphs capture
            # their addresses, so promotions write into them in place.
            from ..llm.tenancy.lora import AdapterRegistry, target_dims

            L, Rr = self.model_config.num_layers, cfg.lora.max_adapters * cfg.lora.rank
            layers = dict(self.params["layers"])
            for tgt, (din, dout) in target_dims(self.model_config).items():
                layers[f"lora_a_{tgt}"] = torch.zeros((L, din, Rr), dtype=torch_dtype(cfg.dtype),
                                                      device=dev)
                layers[f"lora_b_{tgt}"] = torch.zeros((L, Rr, dout), dtype=torch_dtype(cfg.dtype),
                                                      device=dev)
            self.params = dict(self.params, layers=layers)
            self._lora_registry = AdapterRegistry(
                cfg.lora.max_adapters, cfg.lora.rank, self._lora_apply,
                promote_timeout_s=cfg.lora.promote_timeout_s,
            )
        cache_dtype = torch_dtype(cfg.cache_dtype)
        # This rank's heads' pages (tp divides num_kv_heads).
        self._kv_heads = mc.num_kv_heads // cfg.tp
        self._kv_head0 = 0 if self.shard is None else self.shard.tp.index * self._kv_heads
        self.cache = PagedKVCache.create(
            mc.with_overrides(num_kv_heads=self._kv_heads), cfg.num_blocks, cfg.block_size,
            cache_dtype, dev
        )
        # A whole block [L, ps, 2KV, hd] with every rank's heads: what the
        # KV export, the tiers and their files hold, as one JAX process
        # holds it.  On one node the leader assembles it from the ranks'
        # heads (``_node_heads``); across nodes each rank keeps its slice.
        L_, _, ps_, kv2_, hd_ = self.cache.pages.shape
        self.block_shape = (L_, ps_, kv2_ * cfg.tp, hd_)
        self.programs: Optional[DevicePrograms] = None
        self.calibration_s = 0.0
        if cache_dtype.itemsize == 1:
            if isinstance(cfg.kv_scale, str):  # "auto" (EngineConfig checks)
                t0 = time.perf_counter()
                self.kv_scale: Any = self._calibrate_kv_scales()
                self.calibration_s = time.perf_counter() - t0
            elif isinstance(cfg.kv_scale, (list, tuple, np.ndarray)):
                self.kv_scale = np.asarray(cfg.kv_scale, np.float32)
            else:
                self.kv_scale = float(cfg.kv_scale)
        else:
            self.kv_scale = None
        # Speculative decoding's per-sequence draft-length policy (spec.py);
        # None when speculation is off.
        self._spec_ctl = (
            AcceptanceController(cfg.spec_decode) if cfg.spec_decode.enable else None
        )
        S, V = cfg.max_batch, self.model_config.vocab_size
        self._zero_counts = torch.zeros((S, V), dtype=torch.int16, device=dev)
        self._rows = torch.arange(S, device=dev)
        # batch_invariant: every forward's per-token layers at the largest
        # step's row count (0 = the step's own).
        self._pad_rows = cfg.bucket_tokens(cfg.prefill_chunk + S) if cfg.batch_invariant else 0
        self._decode_cu = torch.arange(S + 1, dtype=torch.int32, device=dev)
        self._decode_num = torch.full((1,), S, dtype=torch.int32, device=dev)
        # The fused decode's device carry (token, rng step, penalty counts):
        # every ``multi`` dispatch leaves its final carry here and a chained
        # dispatch starts from it.
        self._carry = (
            torch.zeros((S,), dtype=torch.int64, device=dev),
            torch.zeros((S,), dtype=torch.int64, device=dev),
            torch.zeros((S, V), dtype=torch.int16, device=dev),
        )
        # The device programs (captured graphs on CUDA) and the pinned
        # slots of deferred fetches: pipeline_depth chunks, up to two burst
        # chunks, and one first-token fetch per parked row at most.
        self.programs = DevicePrograms(dev, eager=self.shard is not None and self.shard.eager)
        # The grammar mask every ``step`` program applies: [S, ceil(V/32)]
        # packed admissible-token words (int64 holding uint32), all-ones
        # for unconstrained rows, at a fixed address the graphs read
        # (``_stage_mask`` writes it in place before a constrained step).
        self._mask_layout = Layout({"mask_words": np.zeros((S, (V + 31) // 32), np.int64)})
        self._mask_arena = torch.empty(self._mask_layout.nbytes, dtype=torch.uint8, device=dev)
        self._mask_words = self._mask_layout.views(self._mask_arena)["mask_words"]
        self._mask_words.fill_(0xFFFFFFFF)
        self._mask_dirty = False
        self._fetch_ring = FetchRing(dev, cfg.pipeline_depth + 2 + S)

    def _init_tiers(self) -> None:
        """The KV memory tiers (the JAX engine's tier wiring): host →
        disk → object store, each fed by the demotion of the one above."""
        cfg = self.cfg
        cuda = self.device.type == "cuda"
        self.host_kv: Optional[HostKvStore] = None
        self.disk_kv: Optional[DiskKvStore] = None
        # The durable object-store tier is the only one that OUTLIVES this
        # process — never removed at close().
        self.object_kv: Optional[ObjectKvStore] = None
        self._disk_dir_owned = False
        self._offload_queue: List[Tuple[int, Any]] = []
        self._offload_task: Optional[asyncio.Task] = None
        # KV integrity plane (engine/integrity.py): negative cache of
        # checksum-failed hashes, and the optional self-corruption reporter
        # the serving layer may wire to a health watchdog.
        self.integrity = CorruptionCache(ttl_s=cfg.kv_corrupt_ttl_s)
        self._integrity_reporter: Optional[Callable[[str], None]] = None
        # Device↔host block copies (the tiers' and the KV transfer's): a
        # side stream on CUDA, with their bytes and stream time
        # (copy_summary()).
        self._copy_stream = torch.cuda.Stream(self.device) if cuda else None
        self.h2d_spans = StreamSpans(self.device)
        self.d2h_spans = StreamSpans(self.device)
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self._copy_lock = threading.Lock()
        self._crc_pool: Optional[ThreadPoolExecutor] = None
        if cfg.host_cache_bytes <= 0:
            return
        if self.shard is not None and self._whole_blocks and not self.shard.is_leader:
            # One node: the leader's tiers hold whole blocks within the
            # budget, as one JAX process's do; this rank lends its heads to
            # the leader's gathers and takes its heads of each restore.
            return
        self.host_kv = HostKvStore(cfg.host_cache_bytes)
        # Checksums of whole prefixes, on threads (engine/integrity.py).
        self._crc_pool = ThreadPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1), thread_name_prefix="kv-crc")
        if cfg.disk_cache_bytes > 0 and not self._whole_blocks:
            # Across nodes each rank's host tier holds its own slice of a
            # block; the disk container takes whole blocks (the JAX
            # multi-process branch keeps the same pre-tier drop behaviour).
            logger.warning("disk KV tier disabled: a run over %d nodes keeps per-rank host "
                           "tiers only", self.shard.nnodes)
        elif cfg.disk_cache_bytes > 0:
            # The per-PID default is deliberate: block hashes do not encode
            # the weights' identity, so a stable shared dir could restore a
            # previous (differently seeded) run's KV under valid hashes.
            # Engine-owned dirs are removed at close(); only an explicit
            # disk_cache_dir (the operator owns weight stability) survives
            # restarts and benefits from the re-index.
            self._disk_dir_owned = cfg.disk_cache_dir is None
            d = cfg.disk_cache_dir or os.path.join(
                tempfile.gettempdir(), f"dynamo_tpu_torch_kv_{os.getpid()}"
            )
            fsync = cfg.disk_fsync or os.environ.get("DYN_DISK_FSYNC", "") not in ("", "0", "false")
            self.disk_kv = DiskKvStore(cfg.disk_cache_bytes, d, fsync=fsync, pin_memory=cuda)
            self.host_kv.on_evict = self._demote_to_disk
            if cfg.object_store_bytes > 0:
                ofsync = cfg.object_store_fsync or os.environ.get(
                    "DYN_OBJSTORE_FSYNC", "") not in ("", "0", "false")
                self.object_kv = ObjectKvStore(
                    cfg.object_store_bytes, cfg.object_store_dir, fsync=ofsync, pin_memory=cuda
                )
                self.disk_kv.on_evict = self._demote_to_objstore
        # Device eviction of a block a lower tier retains emits a
        # tier-tagged event instead of Removed (kv_manager).
        self.kv.tier_lookup = self._tier_of

    # ----------------------------------------------------------- device ops
    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _calibrate_kv_scales(self) -> np.ndarray:
        """Per-layer quantization scales from a probe forward (the JAX
        engine's ``_calibrate_kv_scales``): a short deterministic token run
        through the model into a throwaway bf16 cache, each layer's max
        |K/V| mapped to the page dtype's largest value (127 for int8, 448
        for e4m3), floored at 1e-6.  The probe is an ordinary eager forward,
        so on CUDA it runs the hand-written kernels."""
        # The scales reach the kernels as Python floats, which a CUDA graph
        # bakes into its captured launches: they must be final before any
        # program is captured (warmup or first use), never recalibrated
        # after.
        if self.programs is not None and any(self.programs.cache_sizes().values()):
            raise RuntimeError("KV scales must be calibrated before any device program is captured")
        cfg, mc = self.cfg, self.model_config
        # Probe length bounded so nb (+1 slack) fits a single row's table.
        T = min(128, (cfg.max_blocks_per_seq - 1) * cfg.block_size)
        nb = (T + cfg.block_size - 1) // cfg.block_size + 1
        probe = PagedKVCache.create(mc.with_overrides(num_kv_heads=self._kv_heads), nb,
                                    cfg.block_size, torch.bfloat16, self.device)
        S = cfg.max_batch
        toks = (np.arange(T, dtype=np.int64) * 2654435761) % mc.vocab_size
        pos = np.arange(T, dtype=np.int32)
        tables = np.zeros((S, nb), np.int32)
        tables[0] = np.arange(nb)
        cu = np.zeros((S + 1,), np.int32)
        cu[1:] = T
        d = self._to_device
        rb = RaggedBatch(
            token_ids=d(toks), positions=d(pos),
            slot_mapping=d(pos),  # consecutive slots in pages 0..nb
            kv_lens=d(np.asarray([T] + [0] * (S - 1), np.int32)),
            page_indices=d(tables), cu_q_lens=d(cu), num_seqs=d(np.asarray([1], np.int32)),
        )
        with torch.inference_mode():
            forward_ragged(self.params, mc, rb, probe, shard=self.shard)
            maxabs = probe.pages.float().abs().amax(dim=(1, 2, 3, 4))
            if self.shard is not None:
                # Every rank stores the same scale: the max over the heads
                # of the whole tp group.
                maxabs = self.shard.tp.all_reduce(maxabs, "max")
            maxabs = maxabs.cpu().numpy()
        dt = torch_dtype(cfg.cache_dtype)
        qmax = float(torch.finfo(dt).max if dt.is_floating_point else torch.iinfo(dt).max)
        scales = np.maximum(maxabs / qmax, 1e-6).astype(np.float32)
        logger.info("calibrated per-layer kv scales (dtype %s): min %.4g max %.4g",
                    dt, scales.min(), scales.max())
        return scales

    def _step(self, rb: RaggedBatch, samp: SamplingParams) -> SampleOut:
        """One unified ragged step: forward + sample (device, no sync)."""
        logits = forward_ragged(
            self.params, self.model_config, rb, self.cache, kv_scale=self.kv_scale,
            lora_rank=self._lora_rank, shard=self.shard, pad_rows=self._pad_rows,
        )
        return sample_tokens(logits, samp)

    def _multi(
        self,
        tok0: torch.Tensor,  # [S] int64
        steps0: torch.Tensor,  # [S] int64 rng stream positions
        counts0: torch.Tensor,  # [S, V] int16 penalty counts
        pos0: torch.Tensor,  # [S] int32, -1 = padding row
        tables: torch.Tensor,  # [S, PP] int32
        limits: torch.Tensor,  # [S] int32 allocated KV capacity
        samp: SamplingParams,
        adapter_slots: Optional[torch.Tensor] = None,  # [S] int32, -1 = base
    ) -> Tuple[SampleOut, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """``decode_steps`` fused decode iterations in one dispatch: each
        sampled token feeds the next iteration on the device.  Returns the
        stacked ``[decode_steps, S]`` outputs, not yet fetched, and the
        final carry ``(token, steps, counts)`` a chained dispatch starts
        from (the JAX engine's ``_multi`` contract).

        Steps whose position reaches ``limits`` skip the cache write (their
        tokens are discarded host-side).  Padding rows attend over one
        garbage position (kv_len 1, never 0)."""
        bs, PP = self.cfg.block_size, tables.shape[1]
        rows = self._rows
        active = pos0 >= 0
        tok, pos, steps, counts = tok0, pos0, steps0, counts0
        outs: List[SampleOut] = []
        for _ in range(self.cfg.decode_steps):
            posc = pos.clamp(min=0)
            slot = tables[rows, (posc // bs).clamp(max=PP - 1)] * bs + posc % bs
            writable = active & (posc < limits)
            rb = RaggedBatch(
                token_ids=tok,
                positions=posc,
                slot_mapping=torch.where(writable, slot, -1).to(torch.int32),
                kv_lens=torch.where(active, torch.minimum(pos + 1, limits), 1).to(torch.int32),
                page_indices=tables,
                cu_q_lens=self._decode_cu,
                num_seqs=self._decode_num,
                adapter_slots=adapter_slots,
            )
            logits = forward_ragged(
                self.params, self.model_config, rb, self.cache,
                kv_scale=self.kv_scale, decode=True, lora_rank=self._lora_rank,
                shard=self.shard, pad_rows=self._pad_rows,
            )
            out = sample_tokens(logits, samp, steps=steps, counts=counts)
            outs.append(out)
            tok = out.tokens
            if samp.any_penalty:  # one token a row: gather, add, scatter back
                col = tok[:, None]
                counts = counts.scatter(1, col, counts.gather(1, col) + active[:, None].to(counts.dtype))
            pos = torch.where(active, pos + 1, pos)
            steps = torch.where(active, steps + 1, steps)
        return SampleOut(*(torch.stack(f) for f in zip(*outs))), (tok, steps, counts)

    def _samp_params(self, x: Dict[str, torch.Tensor], flags: SamplingFlags) -> SamplingParams:
        return SamplingParams.from_tensors(x, x.get("counts", self._zero_counts), flags)

    def _run_step(self, rb: Dict[str, np.ndarray], samp: HostSampling) -> SampleOut:
        """Dispatch the ``step`` program for host-built ``rb`` (RaggedBatch
        fields) and ``samp``: a graph replay on CUDA, keyed by the token
        bucket and the sampler's flags."""
        host = {**rb, **samp.arrays}
        if samp.counts is not None:
            host["counts"] = samp.counts
        flags = samp.flags
        self._stage_mask(samp.mask_words)

        def fn(x):
            batch = RaggedBatch(*(x.get(f) for f in RaggedBatch._fields))
            sp = self._samp_params(x, flags)._replace(mask_words=self._mask_words, any_mask=True)
            return self._step(batch, sp)

        return self.programs.step((int(rb["token_ids"].shape[0]), *flags), fn, host)

    def _stage_mask(self, mask_words: Optional[np.ndarray]) -> None:
        """Write a step's grammar mask rows into the static ``_mask_words``
        buffer that every ``step`` program reads, in place and ordered on
        the stream the program runs on (one staged copy on CUDA); a step
        with no constrained row needs all-ones words, restored once after
        the last constrained step."""
        if mask_words is None:
            if self._mask_dirty:
                self._mask_words.fill_(0xFFFFFFFF)
                self._mask_dirty = False
            return
        if self.programs.cuda:
            self.programs.staging.copy_in(self._mask_layout, {"mask_words": mask_words},
                                          self._mask_arena)
        else:
            self._mask_words.copy_(torch.from_numpy(mask_words))
        self._mask_dirty = True

    def _run_multi(self, tok0: Optional[np.ndarray], pos0: np.ndarray, tables: np.ndarray,
                   limits: np.ndarray, samp: HostSampling) -> SampleOut:
        """Dispatch the ``multi`` program: seeded from the host (``tok0``
        and ``samp``'s steps and counts) or, with ``tok0`` None, chained to
        the device carry of the previous dispatch.  Keyed by the sampler's
        flags and the carry form.  Leaves the final carry in ``_carry``."""
        flags = samp.flags
        chained = tok0 is None
        host = {"pos0": pos0, "tables": tables, "limits": limits, **samp.arrays}
        if samp.adapter_slots is not None:
            host["adapter_slots"] = samp.adapter_slots
        dev: Dict[str, torch.Tensor] = {}
        if chained:
            dev = {"carry_tok": self._carry[0], "carry_steps": self._carry[1]}
            if flags.any_penalty:
                dev["carry_counts"] = self._carry[2]
        else:
            host["tok0"] = tok0
            if samp.counts is not None:
                host["counts"] = samp.counts

        def fn(x):
            sp = self._samp_params(x, flags)
            if chained:
                carry = (x["carry_tok"], x["carry_steps"], x.get("carry_counts", sp.counts))
            else:
                carry = (x["tok0"], sp.steps, sp.counts)
            return self._multi(*carry, x["pos0"], x["tables"], x["limits"], sp,
                               x.get("adapter_slots"))

        outs, (last, steps_f, counts_f) = self.programs.multi((*flags, chained), fn, host, dev)
        self._carry[0].copy_(last)
        self._carry[1].copy_(steps_f)
        if flags.any_penalty:
            self._carry[2].copy_(counts_f)
        return outs

    # --------------------------------------------------------------- warmup
    def compile_counts(self) -> Dict[str, int]:
        """Programs per entry: graphs captured on CUDA (keys run on the
        CPU).  A serve after ``warmup()`` must not grow them."""
        return self.programs.cache_sizes()

    def reachable_token_buckets(self) -> List[int]:
        """Every token bucket the scheduler can hand _run_unified: up to
        max_batch decode rows ride alongside up to prefill_chunk prompt
        tokens in one step, so totals range 1..prefill_chunk + max_batch."""
        hi = self.cfg.bucket_tokens(self.cfg.prefill_chunk + self.cfg.max_batch)
        buckets, b = [], self.cfg.bucket_tokens(1)
        while b < hi:
            buckets.append(b)
            b *= 2
        buckets.append(hi)
        return buckets

    def warmup(self) -> Dict[str, int]:
        """Capture every program the serving loop dispatches at the greedy
        defaults — one unified step per reachable token bucket (grammar-
        constrained rows ride the same programs: the mask is a static
        buffer), and the fused decode seeded from the host and chained to
        the device carry — so no capture lands inside a request.  Every
        slot is -1 and every fused row inactive, so no cache write lands.
        Sampled, penalised or logprob traffic keys other programs, captured
        at first use.  Returns compile_counts()."""
        cfg = self.cfg
        S, PP = cfg.max_batch, cfg.max_blocks_per_seq
        samp = self._sampling_arrays([])
        with torch.inference_mode():
            for T in self.reachable_token_buckets():
                # One row owns as many tokens as its page table can hold
                # (a bucket may exceed max_model_len); the rest of the
                # bucket is padding and the other rows are empty.  The
                # launches depend on the shapes only, not on these values.
                n = min(T, PP * cfg.block_size)
                cu = np.zeros((S + 1,), np.int32)
                cu[1:] = n
                rb = dict(
                    token_ids=np.zeros((T,), np.int64),
                    positions=np.zeros((T,), np.int32),
                    slot_mapping=np.full((T,), -1, np.int32),  # writes dropped
                    kv_lens=np.asarray([n] + [0] * (S - 1), np.int32),
                    page_indices=np.zeros((S, PP), np.int32),
                    cu_q_lens=cu,
                    num_seqs=np.asarray([1], np.int32),
                )
                if self._lora_registry is not None:
                    rb["adapter_slots"] = np.full((T,), -1, np.int32)
                out = self._run_step(rb, samp)
            if cfg.decode_steps > 1:
                args = (np.full((S,), -1, np.int32), np.zeros((S, PP), np.int32),
                        np.zeros((S,), np.int32))
                self._run_multi(np.zeros((S,), np.int64), *args, samp)
                out = self._run_multi(None, *args, samp)
            # A real fetch: warmup must not return with work still queued.
            self._start_d2h(out, False).result()
            # Every reachable sp-prefill token bucket (sp_prefill_min up to
            # max_model_len), as the JAX engine compiles them: the kernels'
            # and the library's first-use costs never land in a request.
            for Tg in self.sp_buckets():
                self._run_sp(np.zeros((Tg,), np.int64), Tg)
        return self.compile_counts()

    async def run_warmup(self) -> Dict[str, int]:
        """warmup() under the device lock, off the event loop; the other
        ranks warm up in step (serving paths use this)."""
        async with self._device_lock:
            await self._publish("warmup")
            return await asyncio.to_thread(self.warmup)

    # ------------------------------------------------------------ the mesh
    def sp_buckets(self) -> List[int]:
        """The sp-prefill token buckets: powers of two from
        ``sp_prefill_min`` to ``max_model_len``, each a multiple of sp."""
        cfg = self.cfg
        if cfg.sp <= 1:
            return []
        lo = max(cfg.sp, 1 << (max(1, cfg.sp_prefill_min) - 1).bit_length())
        hi = max(lo, 1 << (cfg.max_model_len - 1).bit_length())
        out, t = [], lo
        while True:
            out.append(t + (-t) % cfg.sp)
            if t >= hi:
                return out
            t *= 2

    def _run_sp(self, toks: np.ndarray, valid: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """One sequence-parallel whole-prompt pass (models/llama.py
        forward_sp_prefill) over ``toks`` (a bucket's ids, ``valid`` of
        them real): (logits [V], rows [L, Tg, 2KV, hd] in the page dtype,
        value / scale on quantized pages)."""
        from ..models.llama import forward_sp_prefill

        with torch.inference_mode():
            logits, rows = forward_sp_prefill(self.params, self.model_config,
                                              self._to_device(toks), int(valid), self.shard)
            dt = self.cache.pages.dtype
            if self.kv_scale is not None:
                sc = torch.as_tensor(np.asarray(self.kv_scale, np.float32).reshape(-1, 1, 1, 1),
                                     device=rows.device)
                rows = quantize_for_cache(rows.float() / sc, dt)
            elif rows.dtype != dt:
                rows = rows.to(dt)
            return logits, rows

    def _sp_prefill_seal(self, toks: np.ndarray, valid: int, ids: List[int], first: int) -> None:
        """One sp-prefill pass, then its complete blocks ``first ..``
        scattered into pages ``ids`` in place, on every rank within one
        dispatch (stream order: the rows were computed on this stream)."""
        rows = self._run_sp(toks, valid)[1]
        bs = self.cfg.block_size
        L, _, KV2, hd = rows.shape
        n = len(ids)
        blocks = rows[:, first * bs:(first + n) * bs].reshape(L, n, bs, KV2, hd)
        self._restore_scatter(ids, (blocks.transpose(0, 1), None))

    def attach_publisher(self, publisher) -> None:
        """Leader side: broadcast every device dispatch to the other ranks
        (engine/multihost.py StepPublisher)."""
        self._publisher = publisher

    async def _publish(self, kind: str, payload: Tuple = ()) -> None:
        """Broadcast one dispatch before it is enqueued, under the device
        lock (the publish order is the order every rank reaches the
        dispatch's collectives)."""
        if self._publisher is not None:
            await self._publisher.publish(kind, payload)

    async def mirror_step(self, kind: str, payload: Tuple) -> None:
        """Follower side: replay one leader dispatch with this rank's
        slices (same programs, same host inputs, same order)."""
        async with self._device_lock:
            await asyncio.to_thread(self._mirror, kind, payload)
        if kind in ("offload", "restore_host", "restore_blocks"):
            # Followers record host-tier drops too (no event sink to
            # publish to, but the transition list must not grow).
            self._flush_tier_events()

    def _mirror(self, kind: str, payload: Tuple) -> None:
        with torch.inference_mode():
            if kind == "warmup":
                self.warmup()
            elif kind == "unified":
                rb, samp = payload
                self._run_step(rb, samp)
            elif kind == "multi":
                self._run_multi(*payload)
            elif kind == "inject":
                ids, k, v, name = payload
                self._restore_scatter(ids, self._inject_upload(*self._local_heads(k, v),
                                                               DTYPES[name]))
            elif kind == "export":
                self._export_gather(payload[0], None)  # this rank's heads to the leader
            elif kind == "offload":
                ids, hashes = payload
                staged = self._offload_gather(ids)
                if staged is not None:  # across nodes: this rank's own tier slice
                    self._offload_commit(staged, hashes)
            elif kind == "restore_host":
                ids, hashes = payload
                self._mirror_restore(ids, hashes)
            elif kind == "restore_blocks":
                self._restore_node(payload[0], None)  # this rank's heads from the leader
            elif kind == "sp_prefill":
                self._sp_prefill_seal(*payload)
            else:
                raise ValueError(f"unknown mirror step kind {kind!r}")

    def _node_heads(self, t: torch.Tensor, dim: int) -> Optional[torch.Tensor]:
        """``t``, this rank's combined heads of some pages on axis ``dim``,
        with every rank's heads on the leader (one gather over ``tp``, the
        axis that shards the pages; dp, sp and ep replicate them); None on
        every other rank, whose heads went to the leader.  The leader's
        ``tp`` group takes part; the other replicas have nothing to send."""
        if self.shard is None:
            return t
        group = self.shard.tp
        if group.ranks[0] != 0:
            return None
        out = group.gather(t, dim)
        return out if self.shard.is_leader else None

    def _restore_node(self, ids: List[int], staged: Optional[Tuple[torch.Tensor, Any]]) -> None:
        """A restore on one node: the leader's verified whole blocks
        ``staged`` (``[n, L, ps, 2KV, hd]`` on its device, and the upload's
        event) reach every rank as its heads, one scatter over all ranks
        (dp, sp and ep replicate the pages, so a rank takes its ``tp``
        index's heads); each rank then scatters them into pages ``ids``.
        A follower passes None.  Runs in a worker thread under the device
        lock."""
        L, ps, kv2, hd = self.block_shape
        width = kv2 // self.cfg.tp
        with torch.inference_mode():
            mine = torch.empty((len(ids), L, ps, width, hd), dtype=self.cache.pages.dtype,
                               device=self.device)
            parts = None
            if staged is not None:
                buf, done = staged
                if done is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(done)
                    buf.record_stream(stream)
                tp_of = [self.shard.mesh.coords(r)["tp"] for r in self.shard.world.ranks]
                parts = [buf[:, :, :, t * width:(t + 1) * width] for t in tp_of]
            self.shard.world.scatter(mine, parts)
        self._restore_scatter(ids, (mine, None))

    def _local_heads(self, k: np.ndarray, v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """This rank's KV heads of transfer arrays ``[L, n, ps, KV, hd]``
        that carry every head."""
        if k.shape[3] == self._kv_heads:
            return k, v
        h = slice(self._kv_head0, self._kv_head0 + self._kv_heads)
        return k[:, :, :, h], v[:, :, :, h]

    def _mirror_restore(self, ids: List[int], hashes: List[int]) -> None:
        """A follower's half of a host-tier restore: this rank's slices of
        ``hashes``, verified, scattered into pages ``ids``.  The leader
        chose them from its own tier, which every rank's mirrors block for
        block; a missing or corrupt slice would diverge the ranks, so it
        fails the step."""
        blocks = []
        for h in hashes:
            blk = self.host_kv.peek(h)
            if blk is None:
                raise RuntimeError(f"rank {self.shard.rank}: host tier lacks block {h:#x}")
            blocks.append(blk)
        staged, _ = self._restore_upload(blocks)
        stamps = [self.host_kv.checksum(h) for h in hashes]
        rows = [i for i, st in enumerate(stamps) if st is not None]
        if rows and self._restore_verify(staged, rows) != [stamps[i] for i in rows]:
            raise RuntimeError(f"rank {self.shard.rank}: host tier slice failed its checksum")
        self._restore_scatter(ids, staged)
        for h in hashes:
            self.host_kv.touch(h)

    # ------------------------------------------------------------ public API
    async def generate(self, request: Context) -> ResponseStream:
        if self._closed:
            raise RuntimeError("engine is closed")
        pre = PreprocessedRequest.from_dict(request.data)
        if len(pre.token_ids) > self.cfg.max_model_len:
            raise ValueError(
                f"prompt length {len(pre.token_ids)} exceeds max_model_len "
                f"{self.cfg.max_model_len}"
            )
        V = self.model_config.vocab_size
        bad = next((t for t in pre.token_ids if not 0 <= t < V), None)
        if bad is not None:
            # An id past the embedding would fault the step of every row in
            # the batch (on CUDA, the device context): refuse it here.
            raise ValueError(f"prompt token id {bad} is outside the vocabulary [0, {V})")
        # Multi-tenancy resolution BEFORE admission: the adapter decides the
        # KV salt, which must root the block-hash chain from the first
        # sealed block (and key every tier lookup below).
        adapter = self._resolve_adapter(pre)
        automaton = None
        if pre.grammar:
            automaton = self._grammar_automaton(pre.grammar)
            tenancy_metrics.grammar_requests_total += 1
        if adapter is not None:
            from ..llm.tenancy.lora import kv_salt_for_adapter

            pre.annotations.setdefault("kv_salt", kv_salt_for_adapter(adapter))
        # Request tracing (runtime/tracing.py): the context arrives in
        # annotations.trace (the preprocessor) or on request.ctx.trace;
        # None keeps every instrumentation point a single attr check.
        trace = parse_trace(pre.annotations.get("trace")) or getattr(request.ctx, "trace", None)
        self._ensure_loop()
        salt = pre.annotations.get("kv_salt") or None
        salt = None if salt is None else str(salt)
        if self.host_kv is not None and self._tiers_hold_blocks():
            # Pull any evicted prefix blocks back from the tiers BEFORE
            # admission, so the scheduler sees them as prefix-cache hits.
            # The tiers index blocks by the (salted) hashes they sealed
            # under, so a tenant's restore hits exactly its own blocks.
            t0 = time.perf_counter()
            with span(trace, "engine.kv_restore", "engine") as rs:
                restored = await self._restore_from_host(list(pre.token_ids), salt)
                rs.set(restored_tokens=restored)
            if restored:
                kv_tier_metrics.restore_latency_ms.observe((time.perf_counter() - t0) * 1e3)
                kv_tier_metrics.restore_hits_total += 1
            else:
                kv_tier_metrics.restore_misses_total += 1
        if self._prefix_puller is not None and pre.annotations.get("kv_pull"):
            # Cross-worker prefix pull (llm/kv_router/pull.py): the router
            # stamped a peer that holds a strictly longer prefix than any
            # local tier; pull the sealed delta blocks over the transfer
            # plane instead of recomputing prefill.  Bounded by the
            # configured byte/latency budgets; ANY failure degrades to
            # local prefill (the disagg degraded-mode shape).
            with span(trace, "engine.kv_pull", "engine") as ps:
                pulled = await self._prefix_puller.pull(
                    list(pre.token_ids), salt, pre.annotations["kv_pull"], trace=trace,
                )
                ps.set(pulled_tokens=pulled)
        if (
            self.cfg.sp > 1
            and len(pre.token_ids) >= self.cfg.sp_prefill_min
            and self.shard.nnodes == 1
            and salt is None
        ):
            # A long prompt: one sequence-parallel whole-prompt pass seals
            # its complete blocks ahead of admission (ring attention over
            # sp), on one node's ranks only, as the JAX engine keeps it to
            # one process.
            sp_sealed = await self._sp_prefill(list(pre.token_ids))
        else:
            sp_sealed = 0
        seq = SequenceState.from_request(request.id, pre, self.cfg)
        if sp_sealed:
            # PIN the just-sealed prefix until admission (the scheduler
            # releases it): the blocks sit in the reuse pool, where another
            # request's allocations could evict them first.
            seq.pin_ids = self._pin_prefix(list(pre.token_ids), salt)
        if trace is not None:
            # Anchors the queue-wait (scheduler._record_admission) and
            # prefill (pipeline._trace_first_token) spans.
            seq.trace = SeqTrace(trace)
        if automaton is not None:
            seq.grammar = automaton
            # Resumed sequences (a migration splice, seeded crash recovery)
            # fold already-delivered OUTPUT into the prompt: the automaton
            # state is the start state advanced through those tokens (every
            # delivered token was mask-admissible, so the walk only fails
            # on a corrupt resume — a request error).
            state: Optional[int] = automaton.start
            for t in seq.prompt[seq.orig_prompt_len:]:
                state = automaton.advance(state, int(t))
                if state is None:
                    raise ValueError("resume stream violates its grammar constraint")
            seq.grammar_state = state
        if adapter is not None:
            seq.adapter = adapter
            try:
                # A resident device slot (promotion, LRU eviction of idle
                # residents); the ref pins the slot until _finish, so a
                # running row's slot is never rewritten.
                seq.adapter_slot = await self._lora_registry.acquire(adapter)
            except KeyError:
                tenancy_metrics.adapter_not_found_total += 1
                raise ModelNotFoundError(adapter) from None
            tenancy_metrics.adapter_requests_total += 1
        queue: asyncio.Queue = asyncio.Queue()
        self._queues[request.id] = queue
        self._contexts[request.id] = request.ctx
        self.scheduler.add(seq)
        self._wake.set()
        # Unseeded sampled requests get their engine-assigned seed stamped on
        # the first item, so a client can resume the stream byte-identically.
        samp_opts = pre.sampling_options
        stamp_seed = samp_opts.seed is None and (samp_opts.temperature or 0.0) > 0.0

        async def gen() -> AsyncIterator[Dict[str, Any]]:
            needs_stamp = stamp_seed
            try:
                while True:
                    item = await queue.get()
                    if item is _FINISHED:
                        return
                    if needs_stamp and isinstance(item, dict):
                        item["resolved_seed"] = int(seq.sampling_seed)
                        needs_stamp = False
                    yield item
            finally:
                self._queues.pop(request.id, None)
                self._contexts.pop(request.id, None)

        return ResponseStream(gen(), request.ctx)

    # ----------------------------------------------------------- tenancy API
    def _grammar_automaton(self, g: Dict[str, Any]) -> TokenMaskAutomaton:
        """Deserialize (or LRU-hit) a request's token-mask automaton and fix
        its mask geometry to this engine's vocab/eos.

        Hash-first wire protocol: the preprocessor ships a hash-only stub
        by default; a content-hash LRU hit resolves it with zero table
        bytes on the wire, a miss raises GrammarCacheMissError (prologue
        kind ``grammar_miss``) and the preprocessor re-sends the full edge
        table exactly once."""
        key = g.get("hash")
        automaton = self._grammar_lru.pop(key, None) if key else None
        if automaton is None:
            if g.get("stub") or "edges" not in g:
                tenancy_metrics.grammar_hash_misses_total += 1
                raise GrammarCacheMissError(str(key))
            automaton = TokenMaskAutomaton.from_dict(g)
        elif g.get("stub"):
            tenancy_metrics.grammar_hash_hits_total += 1
        self._grammar_lru[automaton.hash] = automaton  # LRU refresh/insert
        while len(self._grammar_lru) > 32:
            self._grammar_lru.pop(next(iter(self._grammar_lru)))
        automaton.set_mask_context(self.model_config.vocab_size,
                                   self.model_config.eos_token_ids)
        return automaton

    def register_adapter(self, adapter) -> None:
        """Host-register a LoraAdapter (llm/tenancy/lora.py): no restart and
        no new graph; promotion to a device slot happens at first use."""
        if self._lora_registry is None:
            raise RuntimeError("LoRA serving is disabled (EngineConfig.lora.enable)")
        self._lora_registry.register(adapter, self.model_config)
        if self._served_models is not None:
            self._served_models.add(adapter.name)

    def unregister_adapter(self, name: str) -> None:
        if self._lora_registry is not None:
            self._lora_registry.unregister(name)
            # A name left in the allowlist would let requests for the
            # removed adapter silently run the base model.
            if self._served_models is not None:
                self._served_models.discard(name)

    def adapter_names(self) -> List[str]:
        return self._lora_registry.names() if self._lora_registry else []

    def set_served_models(self, names) -> None:
        """Optional allowlist of model names this engine serves (base +
        adapters): a request naming anything else fails with
        ModelNotFoundError (the 404 model_not_found body at the edge)."""
        self._served_models = set(names) if names is not None else None

    def _write_lora_slot(self, slot: int, adapter) -> None:
        """Write one slot's rank-padded factors into the banks IN PLACE (the
        captured graphs hold the banks' addresses).  The copies are queued
        on the current stream, behind every replay already dispatched, from
        pinned host memory: a dispatch still carrying a finished row of the
        slot's previous adapter reads the old factors, and only that row's
        discarded output could see the new ones."""
        from ..llm.tenancy.lora import LORA_TARGETS, padded_factors

        r = self.cfg.lora.rank
        lo, hi = slot * r, (slot + 1) * r
        layers = self.params["layers"]
        pin = self.device.type == "cuda"
        with torch.inference_mode():
            for tgt in LORA_TARGETS:
                a, b = padded_factors(adapter, self.model_config, tgt, r)
                for name, fac, cols in (
                    (f"lora_a_{tgt}", a, (slice(None), slice(None), slice(lo, hi))),
                    (f"lora_b_{tgt}", b, (slice(None), slice(lo, hi), slice(None))),
                ):
                    src = torch.from_numpy(fac).to(layers[name].dtype)
                    if pin:
                        src = src.pin_memory()
                    layers[name][cols].copy_(src, non_blocking=pin)

    async def _lora_apply(self, slot: int, adapter) -> None:
        """Registry promotion hook: the slot's factors into the banks, under
        the device lock (the JAX engine's ``_lora_apply``); the registry
        guarantees the slot has no live rows."""
        async with self._device_lock:
            await asyncio.to_thread(self._write_lora_slot, slot, adapter)

    def _resolve_adapter(self, pre: PreprocessedRequest) -> Optional[str]:
        """Adapter name for this request, or None for the base model.
        Raises ModelNotFoundError for names nobody serves: never a silent
        fall-through to the base model."""
        name = pre.annotations.get("adapter")
        if not isinstance(name, str) or not name:
            name = None
        if name is None and pre.model:
            if self._lora_registry is not None and self._lora_registry.has(pre.model):
                name = pre.model
            elif self._served_models is not None:
                if pre.model not in self._served_models:
                    tenancy_metrics.adapter_not_found_total += 1
                    raise ModelNotFoundError(pre.model)
            elif self._lora_registry is not None and pre.model != self.cfg.model:
                # A LoRA-enabled engine serves many logical models by name:
                # one that is neither the base nor a registered adapter is a
                # routing mistake.  (LoRA-less engines keep the model field
                # advisory.)
                tenancy_metrics.adapter_not_found_total += 1
                raise ModelNotFoundError(pre.model)
        if name is not None and (self._lora_registry is None or not self._lora_registry.has(name)):
            tenancy_metrics.adapter_not_found_total += 1
            raise ModelNotFoundError(name)
        return name

    def set_event_callback(
        self, callback: Optional[Callable[[KvCacheEvent], None]]
    ) -> None:
        """Attach/replace the KV event sink (e.g. a KvEventPublisher) after
        construction — the CLI builds the engine before the runtime exists.

        The sink is called on the running event loop's thread, in emission
        order: an event emitted from a device thread (``asyncio.to_thread``)
        hops over with ``call_soon_threadsafe``, and while such a hop is
        pending, events emitted on the loop queue behind it (``call_soon``
        shares the loop's FIFO ready queue).  None detaches."""
        if callback is None:
            self.kv._event_callback = None
            return
        loop = asyncio.get_running_loop()
        loop_thread = threading.get_ident()
        lock = threading.Lock()
        pending = [0]  # hops scheduled and not yet delivered

        def deliver(event: KvCacheEvent) -> None:
            with lock:
                pending[0] -= 1
            callback(event)

        def emit(event: KvCacheEvent) -> None:
            with lock:
                on_loop = threading.get_ident() == loop_thread
                if on_loop and pending[0] == 0:
                    hop = None
                else:
                    pending[0] += 1
                    hop = loop.call_soon if on_loop else loop.call_soon_threadsafe
            if hop is None:
                callback(event)
            else:
                hop(deliver, event)

        self.kv._event_callback = emit

    def metrics(self) -> ForwardPassMetrics:
        return ForwardPassMetrics(
            request_active_slots=self.scheduler.num_running,
            request_total_slots=self.cfg.max_batch,
            kv_active_blocks=self.kv.active_blocks,
            kv_total_blocks=self.kv.num_blocks,
            num_requests_waiting=self.scheduler.num_waiting,
            gpu_cache_usage_perc=self.kv.usage,
            gpu_prefix_cache_hit_rate=self.kv.hit_rate,
        )

    async def close(self) -> None:
        self._closed = True
        self._wake.set()
        if self._loop_task is not None:
            await self._loop_task
            self._loop_task = None
        if self._publisher is not None:
            await self._publisher.close()
            self._publisher = None
        if self._offload_task is not None:
            self._offload_task.cancel()
            try:
                await self._offload_task
            except asyncio.CancelledError:
                pass
            self._offload_task = None
        if self.disk_kv is not None and self._disk_dir_owned:
            # Engine-owned (defaulted) disk-tier dir: removed, so restarts
            # don't leak a dead budget's worth of block files.
            shutil.rmtree(self.disk_kv.directory, ignore_errors=True)
            self.disk_kv = None
        # The object store is deliberately NOT removed: it is the durable
        # rung — a replacement worker pointed at the same dir boots warm.
        self.object_kv = None
        if self._crc_pool is not None:
            self._crc_pool.shutdown(wait=False)
        self._fail_all()  # no generate() stream is left hanging
        # The graphs bake in the weights' and pages' addresses: drop them
        # with the engine.
        self.programs.close()

    # ------------------------------------------------------------ tiered KV
    def estimate_prefix_hit(self, token_ids: List[int], salt: Optional[str] = None) -> int:
        """Tokens of ``token_ids`` already resident on the device (router
        input)."""
        blocks = hash_token_blocks(token_ids, self.cfg.block_size, salt)
        return len(self.kv.match_prefix(blocks)) * self.cfg.block_size

    def _tier_of(self, seq_hash: int) -> Optional[str]:
        """Cheapest LOWER tier still holding ``seq_hash`` (the device
        excluded — the caller is usually deciding what device eviction
        means)."""
        if self.host_kv is not None and self.host_kv.contains(seq_hash):
            return "host"
        if self.disk_kv is not None and self.disk_kv.contains(seq_hash):
            return "disk"
        if self.object_kv is not None and self.object_kv.contains(seq_hash):
            return "objstore"
        return None

    def _demote_to_disk(self, seq_hash: int, block: torch.Tensor) -> bool:
        """HostKvStore.on_evict hook: push an evicted host-tier block down
        to disk.  Runs inside the host store's eviction loop (often off the
        event loop) — record-only, events flush later.  The offload-time
        checksum is carried into the disk envelope (and verified by the
        put), so a bit that rotted in host RAM is refused here."""
        if self.disk_kv is None:
            return False
        return self.disk_kv.put(seq_hash, block, checksum=self.host_kv.checksum(seq_hash))

    def _demote_to_objstore(self, seq_hash: int, path: str) -> bool:
        """DiskKvStore.on_evict hook: re-wrap an evicted disk envelope as a
        durable object (parsed and its carried CRC re-verified at ingest,
        so disk rot is refused here).  Record-only, events flush later."""
        if self.object_kv is None:
            return False
        return self.object_kv.ingest_kvblk(seq_hash, path)

    def set_integrity_reporter(self, reporter: Optional[Callable[[str], None]]) -> None:
        """Attach ``reporter(plane)``, called on every local-tier corruption
        detection (a health watchdog's feed); None detaches."""
        self._integrity_reporter = reporter

    def _record_corruption(self, plane: str, seq_hash: Optional[int],
                           chain: Optional[List[int]] = None,
                           donor: Optional[int] = None) -> None:
        """Corruption quarantine, one entry point for every plane: count
        it, negative-cache the hash (TTL — restore loops must not thrash on
        it), drop the block and every CHAINED DESCENDANT still held by the
        local tiers (their chain passes through poison), attribute a wire
        ``donor`` to the health ledger, and report local-tier rot.  The
        caller flushes tier events afterwards (this may run in a thread;
        events are emitted on the loop)."""
        kv_integrity_metrics.corrupt_total[plane] += 1
        logger.warning(
            "KV corruption detected on plane %r (block %s): dropped before "
            "scatter; falling back to recompute",
            plane, f"{seq_hash:#x}" if seq_hash is not None else "?",
        )
        if seq_hash is not None:
            self.integrity.ban(seq_hash)
            dropped = 0
            descendants: List[int] = []
            if chain:
                try:
                    descendants = chain[chain.index(seq_hash) + 1:]
                except ValueError:
                    descendants = []
            for d in [seq_hash, *descendants]:
                hit = False
                for tier in (self.host_kv, self.disk_kv, self.object_kv):
                    if tier is not None and tier.drop(d):
                        hit = True
                if hit and d != seq_hash:
                    dropped += 1
            kv_integrity_metrics.descendants_dropped_total += dropped
        if donor is not None:
            from ..runtime.health import kv_corruption

            kv_corruption.record(donor)
        elif plane != "wire" and self._integrity_reporter is not None:
            try:
                self._integrity_reporter(plane)
            except Exception:  # noqa: BLE001 — reporting must never break serving
                logger.warning("integrity reporter failed", exc_info=True)

    def _flush_tier_events(self) -> None:
        """Publish the tier transitions the stores recorded since the last
        flush.  Runs on the event loop; every threaded tier mutation's
        caller flushes after the thread returns.  A hash still sealed on
        the device publishes nothing — the router's view stays 'hbm' until
        device eviction."""
        if self.host_kv is None:
            return
        # Each store's "demote" means "the NEXT tier down took it", so the
        # tier tag depends on which store recorded the transition.
        tagged: List[Tuple[str, str, int]] = [
            ("disk", kind, h) for kind, h in self.host_kv.drain_transitions()
        ]
        if self.disk_kv is not None:
            tagged += [("objstore", kind, h) for kind, h in self.disk_kv.drain_transitions()]
        if self.object_kv is not None:
            tagged += [("", kind, h) for kind, h in self.object_kv.drain_transitions()]
        demoted: Dict[str, List[int]] = {}
        removed: List[int] = []
        for next_tier, kind, h in tagged:
            if h in self.kv._by_hash:
                continue  # the device still holds it: best tier unchanged
            if kind == "demote":
                demoted.setdefault(next_tier, []).append(h)
            elif self._tier_of(h) is not None:
                continue  # another tier still holds it
            else:
                removed.append(h)
        for tier, hashes in demoted.items():
            self.kv.emit_tiered(tier, hashes)
        self.kv.emit_removed(removed)

    def local_prefix_blocks(self, token_ids: List[int], salt: Optional[str] = None,
                            blocks: Optional[List[Any]] = None) -> int:
        """Leading complete blocks restorable from ANY local tier (device,
        host, disk, object store).  ``blocks`` lets a caller that already
        hashed the chain skip a second walk."""
        if blocks is None:
            blocks = hash_token_blocks(token_ids, self.cfg.block_size, salt)
        n = 0
        for tb in blocks:
            h = tb.sequence_hash
            if h in self.kv._by_hash or self._tier_of(h) is not None:
                n += 1
            else:
                break
        return n

    def set_prefix_puller(self, puller) -> None:
        """Attach the cross-worker prefix puller (llm/kv_router/pull.py);
        None detaches.  The serving layer owns peer discovery — the engine
        only calls ``puller.pull(tokens, salt, hint)`` at admission."""
        self._prefix_puller = puller

    def block_nbytes(self) -> int:
        """Bytes of one whole KV block (all layers, every rank's heads) in
        the page dtype, as the JAX engine counts its global pages."""
        return int(self.cache.pages.nbytes // max(1, self.cfg.num_blocks)) * self.cfg.tp

    def kv_tier_summary(self) -> Dict[str, Any]:
        """Per-tier bytes/blocks gauges for /metrics (KvTierMetrics's
        source)."""
        bb = self.block_nbytes()
        out: Dict[str, Any] = {
            "hbm": {"blocks": len(self.kv._by_hash), "bytes": len(self.kv._by_hash) * bb},
            "prefix_hit_rate": self.kv.hit_rate,
        }
        for name, tier in (("host", self.host_kv), ("disk", self.disk_kv),
                           ("objstore", self.object_kv)):
            if tier is not None:
                out[name] = {"blocks": len(tier), "bytes": tier.used_bytes}
        return out

    def copy_summary(self) -> Dict[str, Any]:
        """Device↔host block copies so far: bytes and stream time (on CUDA
        the copy stream's events; waits for the copies in flight)."""
        with self._copy_lock:
            return {
                "h2d_bytes": self.h2d_bytes, "h2d_ms": self.h2d_spans.seconds * 1e3,
                "h2d_copies": self.h2d_spans.count,
                "d2h_bytes": self.d2h_bytes, "d2h_ms": self.d2h_spans.seconds * 1e3,
                "d2h_copies": self.d2h_spans.count,
            }

    # -------------------------------------------------------------- the loop
    def _ensure_loop(self) -> None:
        if self._loop_task is None or self._loop_task.done():
            self._loop_task = asyncio.get_running_loop().create_task(self._run_loop())
        if self.host_kv is not None and (self._offload_task is None or self._offload_task.done()):
            self._offload_task = asyncio.get_running_loop().create_task(self._offload_pump())

    async def _run_loop(self) -> None:
        while not self._closed:
            self._cancel_stopped()
            try:
                while self._pending_fetches and self._pending_fetches[0][1].done():
                    # Completed background fetches apply for free: parked
                    # rows resume without the loop blocking on a copy.
                    await self._harvest_pending()
            except asyncio.CancelledError:
                raise
            except Exception:  # a failed fetch fails every stream
                logger.exception("deferred fetch failed")
                self._fail_all()
                return
            plan = self.scheduler.schedule()
            self._note_prefill_requeues()
            for seq in self.scheduler.take_rejected():
                self._finish(seq, FinishReason.ERROR)
            if plan is None:
                if self._pending_fetches:
                    try:
                        await self._harvest_pending(all_pending=True)
                    except asyncio.CancelledError:
                        raise
                    except Exception:
                        logger.exception("deferred fetch failed")
                        self._fail_all()
                        return
                    continue
                if self.scheduler.num_waiting and not self.scheduler.num_running:
                    # e.g. decode just preempted everyone back to waiting:
                    # retry admission (each pass admits or rejects one).
                    await asyncio.sleep(0)
                    continue
                self._wake.clear()
                await self._wake.wait()
                continue
            try:
                if plan.pure_decode and self.cfg.decode_steps == 1 and self._pending_fetches:
                    # A row whose token is still in flight would miss this
                    # plan and fall out of phase with the rest, the two
                    # groups then taking turns: fold it in first, as the
                    # fused branch below does.
                    await self._harvest_pending(all_pending=True)
                    continue
                did_work = False
                # Speculation first: drafted rows verify several tokens per
                # round trip on the unified step (spec.py); no drafts
                # (proposer misses, benched controllers, or an expected gain
                # below the fused pipeline's) falls through unchanged.
                drafts = self._spec_propose(plan) if self._spec_ctl is not None else {}
                if drafts:
                    await self._run_spec_unified(plan, drafts)
                    did_work = True
                if not did_work and plan.pure_decode and self.cfg.decode_steps > 1:
                    if self._pending_fetches:
                        # Parked rows must not sit out a whole fused
                        # session: fold them in first.
                        await self._harvest_pending(all_pending=True)
                        continue
                    self._chunks_since_burst = 0
                    did_work = await self._decode_pipeline([s for s, _, _ in plan.items])
                if not did_work and self.cfg.decode_steps > 1:
                    # Mixed phase: fetch-free prefill steps at device rate,
                    # and every prefill_chunks_per_burst of them one fused
                    # burst advancing every decode row.
                    decode_items = [it for it in plan.items if it[1] >= len(it[0].prompt)]
                    prefill_items = [it for it in plan.items if it[1] < len(it[0].prompt)]
                    # Grammar-constrained decode rows never burst — their
                    # mask advances host-side per token — so they ride the
                    # prefill steps one token a step, while unconstrained
                    # rows keep the fused-burst cadence.  Without prefill
                    # in the plan, the plain unified step below gives every
                    # row one token a round trip.
                    burstable = [it for it in decode_items if it[0].grammar is None]
                    step_extra = [it for it in decode_items if it[0].grammar is not None]
                    if burstable and prefill_items:
                        await self._run_unified(StepPlan(prefill_items + step_extra))
                        self._chunks_since_burst += 1
                        if self._chunks_since_burst >= self.cfg.prefill_chunks_per_burst:
                            self._chunks_since_burst = 0
                            # Replan against freezes/finishes that landed
                            # during the awaited prefill step.
                            burst_items = [it for it in burstable
                                           if not it[0].finished and not it[0].frozen]
                            if burst_items and not await self._decode_burst(
                                [s for s, _, _ in burst_items]
                            ):
                                # No KV headroom for a whole burst: the
                                # 1-token slots are already allocated.
                                self.step_trace.append(
                                    ("burst_fallback", 0.0, len(burst_items), 0))
                                await self._run_unified(StepPlan(burst_items))
                        did_work = True
                if not did_work:
                    await self._run_unified(plan)
            except asyncio.CancelledError:
                raise
            except Exception:  # engine-fatal: fail all inflight requests
                logger.exception("engine step failed")
                self._fail_all()
                return
            await asyncio.sleep(0)  # let ingress/egress run between steps

    def _stopped(self, seq: SequenceState) -> bool:
        """Whether ``seq``'s caller stopped it or abandoned its stream.
        Closing the stream drops the request's context (generate's
        ``finally``), so a missing context is a stop too: without this, a
        client that disconnected kept its row until max_tokens."""
        ctx = self._contexts.get(seq.request_id)
        return not seq.finished and (ctx is None or ctx.is_stopped)

    def _cancel_stopped(self) -> None:
        for seq in list(self.scheduler.running) + list(self.scheduler.waiting):
            if self._stopped(seq):
                seq.finished = True
                self.scheduler.remove(seq)
                self._finish(seq, FinishReason.CANCELLED)

    def _fail_all(self) -> None:
        self._pending_fetches.clear()  # drop in-flight token fetches
        self._pipeline_members = set()
        for seq in list(self.scheduler.running) + list(self.scheduler.waiting):
            seq.awaiting_fetch = False
            self.scheduler.remove(seq)
            self._finish(seq, FinishReason.ERROR)

    def _note_prefill_requeues(self) -> None:
        """Reset the mixed-phase chunk cadence when a mid-prefill sequence
        was requeued since the last scheduling pass: it restarts chunking
        from zero, so a stale count would burst too early."""
        reqs = self.scheduler.prefill_requeues
        if reqs != self._prefill_requeues_seen:
            self._prefill_requeues_seen = reqs
            self._chunks_since_burst = 0

    # ------------------------------------------------------------ accounting
    def _note_prefill_chunk(self, wall_s: float, tokens: int) -> None:
        """Account one prefill chunk (every unified step that advanced
        prompt tokens): cumulative counters and the bounded trace behind
        dynamo_tpu_prefill_chunk_seconds."""
        self.prefill_chunks += 1
        self.prefill_wall_s += wall_s
        self.prefill_tokens += tokens
        self._prefill_chunk_trace.append(wall_s)

    def prefill_summary(self) -> Dict[str, Any]:
        """Prefill-chunk latency: cumulative counters plus p50/p99 over the
        bounded per-chunk trace window."""
        times = sorted(self._prefill_chunk_trace)
        m = len(times)
        return {
            "chunks": self.prefill_chunks,
            "wall_s": round(self.prefill_wall_s, 4),
            "prompt_tokens": self.prefill_tokens,
            "p50_ms": round(times[m // 2] * 1e3, 2) if m else 0.0,
            "p99_ms": round(times[min(m - 1, int(m * 0.99))] * 1e3, 2) if m else 0.0,
        }

    def step_summary(self) -> Dict[str, Any]:
        """The dispatch trace per step kind: counts, wall, device tokens,
        latency percentiles."""
        out: Dict[str, Any] = {}
        for kind in sorted({k for k, *_ in self.step_trace}):
            times = sorted(t for k, t, _, _ in self.step_trace if k == kind)
            toks = sum(n for k, _, _, n in self.step_trace if k == kind)
            m = len(times)
            out[kind] = {
                "dispatches": m,
                "wall_s": round(sum(times), 4),
                "device_tokens": toks,
                "p50_ms": round(times[m // 2] * 1e3, 2),
                "p99_ms": round(times[min(m - 1, int(m * 0.99))] * 1e3, 2),
            }
        return out

    def reset_dispatch_stats(self) -> None:
        """Zero the dispatch trace and the session counters together (a
        timed window's start)."""
        self.step_trace.clear()
        self.pipeline_sessions = 0
        self.pipeline_rebuilds = 0
        self.continuous_admissions = 0
        self.continuous_retired = 0
        self.pipeline_wall_s = 0.0
        self.decode_busy_s = 0.0
        self.decode_stalls = 0
        self.last_stall = None
        self.prefill_chunks = 0
        self.prefill_wall_s = 0.0
        self.prefill_tokens = 0
        self._prefill_chunk_trace.clear()

    def dispatch_summary(self) -> Dict[str, Any]:
        """Decode-pipeline health, the JAX engine's keys: the per-kind
        dispatch trace plus the session counters and ``host_gap_frac``, the
        share of fused-session wall not covered by in-session device work
        (dispatch, wait, admission prefill).  0.0 before any session."""
        wall = self.pipeline_wall_s
        gap = max(0.0, wall - self.decode_busy_s) / wall if wall > 0 else 0.0
        return {
            "kinds": self.step_summary(),
            # Both kernels take the device's route (no selector, no fallback).
            "decode_kernel": kernel_route(self.device),
            "prefill_kernel": kernel_route(self.device),
            "prefill": self.prefill_summary(),
            "pipeline": {
                "sessions": self.pipeline_sessions,
                "rebuilds": self.pipeline_rebuilds,
                "continuous_admissions": self.continuous_admissions,
                "continuous_retired": self.continuous_retired,
                "wall_s": round(wall, 4),
                "host_gap_frac": round(gap, 4),
                "stalls": self.decode_stalls,
                "last_stall": self.last_stall,
            },
        }

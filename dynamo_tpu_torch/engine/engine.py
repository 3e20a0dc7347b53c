"""TorchEngine: the native PyTorch engine behind the AsyncEngine interface.

Port of the JAX package's ``TpuEngine`` (engine/engine.py) for the dense
serving path, token-level requests in, ``LLMEngineOutput`` items out:

- ONE unified step (``_step``): a flat ragged run of tokens mixing prompt
  chunks and decode tokens (models/llama.py forward_ragged), followed by
  the batched sampler;
- a fused multi-step decode (``_multi``): ``decode_steps`` iterations per
  dispatch, the sampled token, position, rng step and penalty counts
  staying on the device between iterations, one host fetch per dispatch;
- the same continuous-batching scheduler and paged-KV block manager
  (copies of the JAX package's host modules), KV events and
  ForwardPassMetrics included.

Device work runs in a worker thread (``asyncio.to_thread``) so the event
loop keeps serving ingress while the card computes; the paged KV slab is
updated in place.  Attention goes through the hand-written CUDA kernels on
a CUDA device and through their plain versions on the CPU — chosen by the
device, never by a fallback.  Out of this engine so far: int8 weights, KV
scale calibration, speculative decoding, LoRA, grammar constraints, the KV
tiers, transfer and migration, tp/sp and multi-host.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import time
from typing import Any, AsyncIterator, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import default_device
from ..llm.kv_router.protocols import ForwardPassMetrics, KvCacheEvent
from ..llm.protocols import FinishReason, PreprocessedRequest
from ..models.config import ModelConfig, get_config
from ..models.llama import (
    PagedKVCache,
    RaggedBatch,
    forward_ragged,
    fuse_projections,
    init_params,
    torch_dtype,
)
from ..ops.ragged_attention import resolve_kernel
from ..ops.sampling import SampleOut, SamplingParams, sample_tokens
from ..runtime.engine import AsyncEngine, Context, ResponseStream
from .config import EngineConfig
from .kv_manager import KvBlockManager
from .pipeline import _FINISHED, DecodePipelineMixin
from .scheduler import Scheduler, SequenceState, StepPlan

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


class TorchEngine(DecodePipelineMixin, AsyncEngine):
    """Token-in/token-out engine on one device."""

    def __init__(
        self,
        cfg: EngineConfig,
        params: Optional[Dict[str, Any]] = None,
        device: Optional[torch.device] = None,
        event_callback: Optional[Callable[[KvCacheEvent], None]] = None,
    ):
        self.cfg = cfg
        self.device = default_device(device)
        self.model_config: ModelConfig = get_config(cfg.model).with_overrides(dtype=cfg.dtype)
        # The attention route follows the device; an explicit config value
        # must agree with it (no selector, no fallback).
        self.decode_kernel = resolve_kernel(cfg.decode_kernel, self.device)
        self.prefill_kernel = resolve_kernel(cfg.prefill_kernel, self.device)
        if self.model_config.is_moe:
            raise NotImplementedError("MoE models are not supported by this engine yet")
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
        # Mixed-phase cadence: prefill chunks run since the last decode burst.
        self._chunks_since_burst = 0
        self._prefill_requeues_seen = 0
        # Device time and count of prefill steps and fused decode
        # dispatches, timed on the stream: a prefill step that skips the
        # fetch returns once queued, and the next fetch (often a decode
        # dispatch's) waits for its work, so host walls would misplace it.
        self.prefill_spans = StreamSpans(self.device)
        self.decode_spans = StreamSpans(self.device)

        # --- device state -------------------------------------------------
        dev = self.device
        if params is None:
            params = init_params(self.model_config, cfg.seed, dev)
        else:
            params = {
                k: ({n: w.to(dev) for n, w in v.items()} if k == "layers" else v.to(dev))
                for k, v in params.items()
            }
        self.params = fuse_projections(params)
        cache_dtype = torch_dtype(cfg.cache_dtype)
        self.cache = PagedKVCache.create(
            self.model_config, cfg.num_blocks, cfg.block_size, cache_dtype, dev
        )
        if cache_dtype.itemsize == 1:
            if isinstance(cfg.kv_scale, str):
                raise ValueError(
                    f"kv_scale {cfg.kv_scale!r}: calibration is not supported by "
                    "this engine yet; pass a float or a per-layer sequence"
                )
            if isinstance(cfg.kv_scale, (list, tuple, np.ndarray)):
                self.kv_scale: Any = np.asarray(cfg.kv_scale, np.float32)
            else:
                self.kv_scale = float(cfg.kv_scale)
        else:
            self.kv_scale = None
        S = cfg.max_batch
        self._zero_counts = torch.zeros(
            (S, self.model_config.vocab_size), dtype=torch.int16, device=dev
        )
        self._rows = torch.arange(S, device=dev)
        self._decode_cu = torch.arange(S + 1, dtype=torch.int32, device=dev)
        self._decode_num = torch.full((1,), S, dtype=torch.int32, device=dev)

    # ----------------------------------------------------------- device ops
    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _step(self, rb: RaggedBatch, samp: SamplingParams) -> SampleOut:
        """One unified ragged step: forward + sample (device, no sync)."""
        logits = forward_ragged(
            self.params, self.model_config, rb, self.cache, kv_scale=self.kv_scale
        )
        return sample_tokens(logits, samp)

    def _multi(
        self,
        tok0: torch.Tensor,  # [S] int64
        pos0: torch.Tensor,  # [S] int32, -1 = padding row
        tables: torch.Tensor,  # [S, PP] int32
        limits: torch.Tensor,  # [S] int32 allocated KV capacity
        samp: SamplingParams,
    ) -> SampleOut:
        """``decode_steps`` fused decode iterations in one dispatch: each
        sampled token feeds the next iteration on the device; returns the
        stacked ``[decode_steps, S]`` outputs, not yet fetched.

        Steps whose position reaches ``limits`` skip the cache write (their
        tokens are discarded host-side).  Padding rows attend over one
        garbage position (kv_len 1, never 0)."""
        bs, PP = self.cfg.block_size, tables.shape[1]
        rows = self._rows
        active = pos0 >= 0
        tok, pos = tok0, pos0
        steps, counts = samp.steps, samp.counts
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
            )
            logits = forward_ragged(
                self.params, self.model_config, rb, self.cache,
                kv_scale=self.kv_scale, decode=True,
            )
            out = sample_tokens(logits, samp, steps=steps, counts=counts)
            outs.append(out)
            tok = out.tokens
            if samp.any_penalty:  # one token a row: gather, add, scatter back
                col = tok[:, None]
                counts = counts.scatter(1, col, counts.gather(1, col) + active[:, None].to(counts.dtype))
            pos = torch.where(active, pos + 1, pos)
            steps = torch.where(active, steps + 1, steps)
        return SampleOut(*(torch.stack(f) for f in zip(*outs)))

    @staticmethod
    def _fetch(out: SampleOut, need_lp: bool):
        """The one host fetch of a dispatch's sampled outputs."""
        tokens = out.tokens.cpu().numpy()
        if not need_lp:
            return tokens, None, None, None
        return (
            tokens,
            out.logprob.cpu().numpy(),
            out.top_ids.cpu().numpy(),
            out.top_logprobs.cpu().numpy(),
        )

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
        if pre.grammar:
            raise ValueError("grammar-constrained requests are not supported by this engine yet")
        if pre.annotations.get("adapter"):
            raise ValueError("LoRA adapters are not supported by this engine yet")
        self._ensure_loop()
        seq = SequenceState.from_request(request.id, pre, self.cfg)
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
        self._fail_all()  # no generate() stream is left hanging

    # -------------------------------------------------------------- the loop
    def _ensure_loop(self) -> None:
        if self._loop_task is None or self._loop_task.done():
            self._loop_task = asyncio.get_running_loop().create_task(self._run_loop())

    async def _run_loop(self) -> None:
        while not self._closed:
            self._cancel_stopped()
            plan = self.scheduler.schedule()
            self._note_prefill_requeues()
            for seq in self.scheduler.take_rejected():
                self._finish(seq, FinishReason.ERROR)
            if plan is None:
                if self.scheduler.num_waiting and not self.scheduler.num_running:
                    # e.g. decode just preempted everyone back to waiting:
                    # retry admission (each pass admits or rejects one).
                    await asyncio.sleep(0)
                    continue
                self._wake.clear()
                await self._wake.wait()
                continue
            try:
                did_work = False
                if plan.pure_decode and self.cfg.decode_steps > 1:
                    self._chunks_since_burst = 0
                    did_work = await self._decode_pipeline([s for s, _, _ in plan.items])
                elif self.cfg.decode_steps > 1:
                    # Mixed phase: prefill-only steps at device rate, and
                    # every prefill_chunks_per_burst of them one fused burst
                    # advancing every decode row decode_steps tokens.
                    decode_items = [it for it in plan.items if it[1] >= len(it[0].prompt)]
                    prefill_items = [it for it in plan.items if it[1] < len(it[0].prompt)]
                    if decode_items and prefill_items:
                        await self._run_unified(StepPlan(prefill_items))
                        self._chunks_since_burst += 1
                        if self._chunks_since_burst >= self.cfg.prefill_chunks_per_burst:
                            self._chunks_since_burst = 0
                            burst = [s for s, _, _ in decode_items if not s.finished]
                            if burst and not await self._decode_burst(burst):
                                # No KV headroom for a whole burst: the
                                # 1-token slots are already allocated.
                                await self._run_unified(StepPlan(
                                    [it for it in decode_items if not it[0].finished]
                                ))
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
        for seq in list(self.scheduler.running) + list(self.scheduler.waiting):
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

    async def _run_unified(self, plan: StepPlan) -> None:
        """One unified step for ``plan``; rows whose prompt completes get
        their first token, decode rows their next one."""
        rb = self._build_ragged(plan.items)
        samp = self._sampling_arrays([s for s, _, _ in plan.items])
        # A step whose every row stays mid-prefill samples nothing anyone
        # consumes: skip the fetch, and with it the host-device sync.
        need_tokens = any(start + n >= len(seq.prompt) for seq, start, n in plan.items)

        prefill = any(start < len(seq.prompt) for seq, start, _ in plan.items)

        def run():
            with torch.inference_mode():
                span = self.prefill_spans.start() if prefill else None
                out = self._step(rb, samp)
                if prefill:
                    self.prefill_spans.stop(span)
                return self._fetch(out, samp.need_logprobs) if need_tokens else None

        fetched = await asyncio.to_thread(run)
        for i, (seq, start, n) in enumerate(plan.items):
            if seq.finished:
                continue  # cancelled while the step ran
            if start >= len(seq.prompt):
                # Decode row: the fed token joins the hash stream.
                seq.block_seq.append((seq.prompt + seq.output)[start])
            seq.num_computed = start + n
            self._seal_completed_blocks(seq)
            if not seq.in_prefill:
                sampled, logp, top_ids, top_lp = fetched
                self._accept_token(
                    seq, int(sampled[i]),
                    logprobs=self._lp_info(seq, i, logp, top_ids, top_lp),
                )

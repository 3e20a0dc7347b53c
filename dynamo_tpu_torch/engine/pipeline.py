"""Fused decode pipeline, batch building and token acceptance for
TorchEngine (a mixin, as in the JAX package's engine/pipeline.py).

Fetches are synchronous in this version: a fused dispatch runs
``decode_steps`` iterations on the device and its outputs come back in one
fetch before the next dispatch is planned from host state.  Deferred
pinned-memory copies, CUDA events and CUDA graphs are later work.
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..llm.protocols import FinishReason, LLMEngineOutput
from ..models.llama import RaggedBatch
from ..ops.sampling import SamplingParams
from .scheduler import SequenceState

_FINISHED = object()  # queue sentinel (engine.py imports this)


class DecodePipelineMixin:
    # ------------------------------------------------------------ batch build
    def _sampling_arrays(self, seqs: List[Optional[SequenceState]]) -> SamplingParams:
        """Per-row sampling state for one step, one entry per batch row
        (None = padding row, greedy defaults).  The [S, V] penalty counts
        are the cached device zeros unless some row uses a penalty."""
        S = self.cfg.max_batch
        V = self.model_config.vocab_size
        seeds = np.zeros((S,), np.uint32)
        steps = np.zeros((S,), np.int64)
        temp = np.zeros((S,), np.float32)
        topk = np.zeros((S,), np.int64)
        topp = np.ones((S,), np.float32)
        fpen = np.zeros((S,), np.float32)
        ppen = np.zeros((S,), np.float32)
        need_lp = False
        for i, seq in enumerate(seqs):
            if seq is None:
                continue
            seeds[i] = seq.sampling_seed
            steps[i] = seq.num_output_tokens
            temp[i] = seq.sampling_temperature
            topk[i] = seq.sampling_top_k
            topp[i] = seq.sampling_top_p
            fpen[i] = seq.freq_penalty
            ppen[i] = seq.pres_penalty
            need_lp = need_lp or seq.logprobs is not None
        if np.any(fpen != 0) or np.any(ppen != 0):
            counts_np = np.zeros((S, V), np.int16)
            for i, seq in enumerate(seqs):
                if seq is None:
                    continue
                # Generated tokens since the ORIGINAL prompt: preemption
                # folds output into ``prompt``.
                gen = np.asarray((seq.prompt + seq.output)[seq.orig_prompt_len:], np.int64)
                if gen.size:
                    np.add.at(counts_np[i], gen % V, 1)
            counts = self._to_device(counts_np)
        else:
            counts = self._zero_counts
        return SamplingParams.from_numpy(
            self.device, seeds, steps, temp, topk, topp, fpen, ppen, counts, need_lp
        )

    def _tables_row(self, out: np.ndarray, i: int, seq: SequenceState) -> None:
        ids = seq.block_ids[: out.shape[1]]
        out[i, : len(ids)] = ids

    def _build_ragged(self, items) -> RaggedBatch:
        """Host-built ragged step for ``items`` = [(seq, start, n)], padded
        to a power-of-two token bucket, moved to the device."""
        bs = self.cfg.block_size
        S = self.cfg.max_batch
        PP = self.cfg.max_blocks_per_seq
        total = sum(n for _, _, n in items)
        T = self.cfg.bucket_tokens(total)
        tok = np.zeros((T,), np.int64)
        pos = np.zeros((T,), np.int32)
        slots = np.full((T,), -1, np.int32)
        kv_lens = np.zeros((S,), np.int32)
        tables = np.zeros((S, PP), np.int32)
        cu = np.zeros((S + 1,), np.int32)
        at = 0
        for i, (seq, start, n) in enumerate(items):
            all_toks = seq.prompt + seq.output
            tok[at: at + n] = all_toks[start: start + n]
            p = np.arange(start, start + n, dtype=np.int32)
            pos[at: at + n] = p
            blk = np.asarray(seq.block_ids, np.int32)
            slots[at: at + n] = blk[p // bs] * bs + p % bs
            self._tables_row(tables, i, seq)
            kv_lens[i] = start + n
            at += n
            cu[i + 1] = at
        cu[len(items) + 1:] = at
        d = self._to_device
        return RaggedBatch(
            token_ids=d(tok),
            positions=d(pos),
            slot_mapping=d(slots),
            kv_lens=d(kv_lens),
            page_indices=d(tables),
            cu_q_lens=d(cu),
            num_seqs=d(np.asarray([len(items)], np.int32)),
        )

    # ------------------------------------------------- fused decode dispatch
    async def _decode_pipeline(self, members: List[SequenceState]) -> bool:
        """Steady-state decode: fused dispatches over a fixed membership
        until a member finishes or is cancelled, a waiting request could be
        admitted, or KV headroom for a whole dispatch runs out — then the
        scheduler replans.  Returns whether anything was dispatched."""
        dispatched = False
        while not self._closed:
            for seq in members:
                if self._stopped(seq):
                    seq.finished = True
                    self.scheduler.remove(seq)
                    self._finish(seq, FinishReason.CANCELLED)
            if any(s.finished for s in members) or self.scheduler.admission_ready():
                break
            if not await self._decode_burst(members):
                break
            dispatched = True
            await asyncio.sleep(0)  # let ingress/egress run between dispatches
        return dispatched

    async def _decode_burst(self, members: List[SequenceState]) -> bool:
        """One fused ``_multi`` dispatch for ``members`` (all decoding) and
        its accept.  Returns False, dispatching nothing, when KV headroom
        for a whole dispatch is missing."""
        cfg = self.cfg
        bs = cfg.block_size
        S, T = cfg.max_batch, cfg.decode_steps
        tok0 = np.zeros((S,), np.int64)
        pos0 = np.full((S,), -1, np.int32)
        tables = np.zeros((S, cfg.max_blocks_per_seq), np.int32)
        limits = np.zeros((S,), np.int32)
        for i, seq in enumerate(members):
            if seq.finished or seq.frozen or seq.grammar is not None:
                return False
            if not self.scheduler._ensure_slot(seq, lookahead=T):
                return False
            tok0[i] = (seq.prompt + seq.output)[seq.num_computed]
            pos0[i] = seq.num_computed
            self._tables_row(tables, i, seq)
            limits[i] = min(len(seq.block_ids) * bs, cfg.max_blocks_per_seq * bs)
        samp = self._sampling_arrays(list(members))
        d = self._to_device
        args = (d(tok0), d(pos0), d(tables), d(limits))

        def run():
            with torch.inference_mode():
                span = self.decode_spans.start()
                out = self._multi(*args, samp)
                self.decode_spans.stop(span)
                return self._fetch(out, samp.need_logprobs)

        sampled, logp, top_ids, top_lp = await asyncio.to_thread(run)
        self._accept_chunk(members, pos0, sampled, logp, top_ids, top_lp)
        for seq in members:
            if seq.finished and seq in self.scheduler.running:
                self.scheduler.remove(seq)
        return True

    # ------------------------------------------------------------ per-token
    def _seal_completed_blocks(self, seq: SequenceState) -> None:
        complete = seq.num_computed // self.cfg.block_size
        hashed = len(seq.block_seq.blocks)
        while seq.num_sealed_blocks < min(complete, hashed):
            idx = seq.num_sealed_blocks
            self.kv.seal_block(seq.block_ids[idx], seq.block_seq.blocks[idx])
            seq.num_sealed_blocks += 1

    def _accept_chunk(self, members, pos0, sampled, logp, top_ids, top_lp) -> None:
        """Apply one fused dispatch's ``[decode_steps, S]`` samples: per row,
        tokens are accepted in order until a stop, the budget, or the
        allocation wall; the rest were over-decoded and are dropped.  A row
        without logprobs gets its accepted tokens as ONE multi-token item,
        as the JAX engine's vectorized accept emits them; a row with
        logprobs gets one item per token (each carries its payload)."""
        bs = self.cfg.block_size
        for i, seq in enumerate(members):
            if seq is None or seq.finished or pos0[i] < 0:
                continue
            p0 = int(pos0[i])
            if seq.num_computed != p0:
                continue
            pending: Optional[List[int]] = [] if seq.logprobs is None else None
            for t in range(sampled.shape[0]):
                if seq.num_computed >= len(seq.block_ids) * bs:
                    break  # beyond allocation: the token was never KV-backed
                seq.block_seq.append((seq.prompt + seq.output)[seq.num_computed])
                seq.num_computed += 1
                self._seal_completed_blocks(seq)
                self._accept_token(
                    seq,
                    int(sampled[t, i]),
                    defer_removal=True,
                    logprobs=self._lp_info(
                        seq, i,
                        None if logp is None else logp[t],
                        None if top_ids is None else top_ids[t],
                        None if top_lp is None else top_lp[t],
                    ),
                    pending=pending,
                )
                if seq.finished:
                    break
            self._emit_pending(seq, pending)

    def _lp_info(self, seq: SequenceState, i: int, logp, top_ids, top_lp) -> Optional[Dict[str, Any]]:
        """Per-token logprob payload for row ``i`` (None unless requested)."""
        if seq.logprobs is None or logp is None:
            return None
        k = min(int(seq.logprobs), top_ids.shape[-1])
        return {
            "logprob": float(logp[i]),
            "top": [(int(top_ids[i, j]), float(top_lp[i, j])) for j in range(k)],
        }

    def _accept_token(
        self,
        seq: SequenceState,
        token: int,
        defer_removal: bool = False,
        logprobs: Optional[Dict[str, Any]] = None,
        pending: Optional[List[int]] = None,
    ) -> None:
        """Append ``token`` to ``seq`` and emit it — into ``pending`` when
        given (one item for a fused chunk, flushed before any finish item),
        else as its own item."""
        seq.output.append(token)
        reason = self._check_stop(seq, token)
        queue = self._queues.get(seq.request_id)
        # Stop-triggering tokens (eos / stop_token_ids) are not emitted.
        if reason is not FinishReason.STOP:
            if pending is not None:
                pending.append(token)
            elif queue is not None:
                item = LLMEngineOutput.token(token)
                if logprobs is not None:
                    item["logprobs"] = logprobs
                queue.put_nowait(item)
        if reason is not None:
            seq.finished = True
            if not defer_removal:
                self.scheduler.remove(seq)
            self._emit_pending(seq, pending)
            self._finish(seq, reason)

    def _emit_pending(self, seq: SequenceState, pending: Optional[List[int]]) -> None:
        if pending:
            queue = self._queues.get(seq.request_id)
            if queue is not None:
                queue.put_nowait(LLMEngineOutput.tokens(pending))
            pending.clear()

    def _check_stop(self, seq: SequenceState, token: int) -> Optional[FinishReason]:
        n_out = seq.num_output_tokens  # survives preemption's prompt-folding
        min_ok = seq.min_new_tokens is None or n_out >= seq.min_new_tokens
        if min_ok and token in seq.stop_token_ids:
            return FinishReason.STOP
        if min_ok and not seq.ignore_eos and token in self.model_config.eos_token_ids:
            return FinishReason.STOP
        if seq.max_new_tokens is not None and n_out >= seq.max_new_tokens:
            return FinishReason.LENGTH
        if seq.total_tokens >= self.cfg.max_model_len:
            return FinishReason.LENGTH
        return None

    def _finish(self, seq: SequenceState, reason: FinishReason) -> None:
        queue = self._queues.get(seq.request_id)
        if queue is None:
            return
        queue.put_nowait(
            LLMEngineOutput.finished(
                reason,
                usage={
                    "prompt_tokens": seq.orig_prompt_len,
                    "completion_tokens": seq.num_output_tokens,
                    "total_tokens": seq.total_tokens,
                },
            )
        )
        queue.put_nowait(_FINISHED)

"""Draft-free speculative decoding: n-gram proposer + in-step verification.

Port of the JAX package's ``engine/spec.py``.  The engine needs no new
device program: the unified ragged step already mixes rows of any q_len /
kv_len with per-row sampling, so a draft of ``k`` tokens verifies as
``k+1`` single-token rows of one step (``TorchEngine._step``, a captured
graph per token bucket on CUDA).  Row ``j`` feeds position
``num_computed + j`` with ``kv_len = num_computed + j + 1`` over the
sequence's own page table and is sampled with its rng ``steps`` at the
output index of its own position (``_sampling_arrays(step_offsets=)``).
The sampler's noise is a pure function of ``(seed, step, token)``
(ops/sampling.py ``gumbel_noise``), so the sample at a position depends
only on the committed prefix, not on how it was batched.

Acceptance is exact-stream: the longest draft prefix matching the sampled
tokens row by row, plus the correcting sample.  Speculation on and off give
identical token streams at any temperature.

Rollback is bookkeeping only: rejected rows wrote KV into slots past
``num_computed``, but blocks seal (hash-publish) only once accepted tokens
cover them, so a rejected tail is scratch that the next real token
overwrites.  A drafted row is parked (``awaiting_fetch``) from dispatch to
harvest, so no fused dispatch or retirement touches it meanwhile.

The per-sequence adaptive controller moves each sequence's draft length
inside [k_min, k] and benches collapsed proposers; when no sequence drafts,
or the expected tokens per round trip fall below the fused pipeline's, the
engine runs the fused pipeline unchanged.  Grammar and LoRA rows, which the
JAX version also handles, are refused by this engine's ``generate``.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..llm.metrics import spec_metrics
from .config import SpecDecodeConfig
from .scheduler import SequenceState, StepPlan

logger = logging.getLogger(__name__)


def propose_ngram(hist: np.ndarray, ngram_min: int, ngram_max: int, k: int) -> np.ndarray:
    """Prompt-lookup proposal: match the last ``n`` tokens (longest ``n``
    first) against the rest of ``hist`` and return up to ``k`` tokens that
    followed an earlier occurrence — the most recent one whose continuation
    covers ``k``, else the one with the longest continuation (pure recency
    would cap drafts at period-1 tokens on short loops).  Empty when
    nothing matches."""
    empty = np.empty((0,), dtype=hist.dtype)
    size = int(hist.size)
    if k < 1 or size < ngram_min + 1:
        return empty
    # Windows over hist[:-1]: a match always has >= 1 continuation token,
    # and the suffix can never match itself.
    for n in range(min(ngram_max, size - 1), ngram_min - 1, -1):
        pattern = hist[size - n:]
        windows = np.lib.stride_tricks.sliding_window_view(hist[: size - 1], n)
        hits = np.nonzero((windows == pattern).all(axis=1))[0]
        if hits.size:
            cont = size - (hits + n)
            full = hits[cont >= k]
            start = int(full[-1] if full.size else hits[np.argmax(cont)]) + n
            return hist[start: start + k].copy()
    return empty


class AcceptanceController:
    """Per-sequence adaptive draft length, EWMA-driven.  State lives on the
    SequenceState (spec_k / spec_ewma / spec_bench_until), so it follows
    the request through preemption; the controller is pure policy."""

    def __init__(self, sd: SpecDecodeConfig):
        self.sd = sd

    def current_k(self, seq: SequenceState) -> int:
        sd = self.sd
        if seq.spec_k < 0:
            seq.spec_k = sd.k
        if seq.spec_bench_until >= 0:
            if seq.num_output_tokens < seq.spec_bench_until:
                return 0
            # Cooldown served: re-probe gently (k_min) with the EWMA reset
            # above the floor so one miss doesn't instantly re-bench.
            seq.spec_bench_until = -1
            seq.spec_k = sd.k_min
            seq.spec_ewma = min(1.0, 2.0 * sd.accept_floor)
        return seq.spec_k

    def record(self, seq: SequenceState, drafted: int, accepted: int) -> None:
        sd = self.sd
        if drafted <= 0:
            return
        ratio = accepted / drafted
        seq.spec_ewma += sd.ewma_alpha * (ratio - seq.spec_ewma)
        if accepted >= drafted:
            # Fully accepted: the match run is longer than we dared — grow.
            seq.spec_k = min(sd.k, max(seq.spec_k + 1, seq.spec_k * 2))
        else:
            # Partial/none: the next draft need only cover the observed run.
            seq.spec_k = max(sd.k_min, min(seq.spec_k, accepted + 1))
        if seq.spec_ewma < sd.accept_floor:
            seq.spec_bench_until = seq.num_output_tokens + sd.cooldown_tokens


class SpecDecodeMixin:
    """TorchEngine methods of the speculative decode path (``self._spec_ctl``
    is the AcceptanceController, or None when spec_decode.enable is
    false)."""

    # Session-probe backoff: accept rounds to skip after a probe whose
    # drafts failed the engagement bar.
    _spec_probe_skip = 0
    _spec_probe_miss = 0

    # ------------------------------------------------------------- proposal
    def _spec_draft_for(self, seq: SequenceState, start: int,
                        rows_free: int) -> Optional[np.ndarray]:
        """One sequence's draft candidate at position ``start``, budgeted
        against free batch rows and the sequence's remaining output /
        context / table headroom, but not against KV block allocation (so
        the fused pipeline can probe mid-session)."""
        cfg = self.cfg
        sd = cfg.spec_decode
        if not seq.spec_enabled:
            return None
        if seq.freq_penalty != 0 or seq.pres_penalty != 0:
            # Penalty counts are built per dispatch; mid-draft accepts
            # would need in-window count updates.
            return None
        k = self._spec_ctl.current_k(seq)
        if k < 1:
            return None
        if seq.total_tokens < seq.spec_next_try:
            return None  # backing off after misses: skip the scan entirely
        out_budget = (
            seq.max_new_tokens - seq.num_output_tokens
            if seq.max_new_tokens is not None
            else cfg.max_model_len
        )
        len_budget = cfg.max_model_len - seq.total_tokens
        cap = min(k, rows_free, out_budget - 1, len_budget - 1,
                  cfg.max_blocks_per_seq * cfg.block_size - start - 1)
        if cap < 1:
            return None
        # Slice the tails before concatenating, so a proposal stays within
        # the lookback bound at long contexts.
        lb = sd.lookback
        if lb and len(seq.prompt) + len(seq.output) > lb:
            out_tail = seq.output[-lb:]
            need = lb - len(out_tail)
            hist_list = (seq.prompt[-need:] if need > 0 else []) + out_tail
        else:
            hist_list = seq.prompt + seq.output
        hist = np.asarray(hist_list, np.int64)
        d = propose_ngram(hist, sd.ngram_min, sd.ngram_max, cap)
        if d.size == 0:
            # Exponential miss backoff (2..64 tokens): random traffic must
            # not pay a history scan per scheduling round forever.
            seq.spec_miss = min(seq.spec_miss + 1, 6)
            seq.spec_next_try = seq.total_tokens + (1 << seq.spec_miss)
            return None
        seq.spec_miss = 0
        seq.spec_next_try = 0
        return d

    def _spec_collect(self, pairs: List[Tuple[SequenceState, int]],
                      rows_free: int) -> List[Tuple[SequenceState, List[int]]]:
        """Draft candidates for (seq, start) pairs, trimmed to the free-row
        budget, popping from the longest draft first so the budget spreads
        across drafting sequences."""
        cands: List[Tuple[SequenceState, List[int]]] = []
        for seq, start in pairs:
            d = self._spec_draft_for(seq, start, rows_free)
            if d is not None:
                cands.append((seq, [int(x) for x in d]))
        total = sum(len(d) for _, d in cands)
        while total > rows_free:
            _, longest = max(cands, key=lambda c: len(c[1]))
            longest.pop()
            total -= 1
        return [(s, d) for s, d in cands if d]

    def _spec_engaged(self, expected: int, n_decode: int) -> bool:
        """Engagement bar vs the fused pipeline (pipeline_margin)."""
        cfg = self.cfg
        if cfg.decode_steps <= 1:
            return True
        return expected >= cfg.spec_decode.pipeline_margin * n_decode * cfg.decode_steps

    def _spec_propose(self, plan: StepPlan) -> Dict[str, List[int]]:
        """Drafts for this plan's decode rows: {request_id: tokens}.  For
        pure-decode plans speculation must also beat the fused pipeline
        (_spec_engaged), else it stands down."""
        cfg = self.cfg
        decode_items = [(seq, start) for seq, start, n in plan.items
                        if n == 1 and start >= len(seq.prompt)]
        if not decode_items:
            return {}
        rows_free = cfg.max_batch - len(plan.items)
        if rows_free <= 0:
            return {}
        cands = self._spec_collect(decode_items, rows_free)
        if not cands:
            return {}
        if plan.pure_decode:
            # Engagement before allocation: standing down must not have paid
            # _ensure_slot evictions for drafts that never run.
            expected = sum(len(d) + 1 for _, d in cands) + (len(decode_items) - len(cands))
            if not self._spec_engaged(expected, len(decode_items)):
                spec_metrics.fallback_total += 1
                return {}
        drafts: Dict[str, List[int]] = {}
        bs = cfg.block_size
        for seq, d in cands:
            start = seq.num_computed
            # KV slots for the fed tail token and every draft position; on a
            # tight pool, trim the draft to the blocks actually obtained.
            if not self.scheduler._ensure_slot(seq, lookahead=len(d) + 1):
                limit = len(seq.block_ids) * bs
                d = d[: max(0, limit - start - 1)]
                if not d:
                    continue
            drafts[seq.request_id] = d
        return drafts

    def _spec_session_probe(self, members: List[SequenceState]) -> bool:
        """Would speculation beat the fused pipeline for ``members`` now?
        Called by the fused pipeline after each accept round (drafts appear
        only as output accrues).  Numpy over the committed history, no
        allocation; True drains the session so the next schedule()
        proposes for real."""
        if self._spec_ctl is None:
            return False
        rows_free = self.cfg.max_batch - len(members)
        if rows_free <= 0:
            return False  # saturated batch: no rows for draft expansion
        if any(seq.finished for seq in members):
            return False  # the session is about to change anyway
        if self._spec_probe_skip > 0:
            self._spec_probe_skip -= 1
            return False
        cands = self._spec_collect([(seq, seq.num_computed) for seq in members], rows_free)
        if not cands:
            return False
        expected = sum(len(d) + 1 for _, d in cands) + (len(members) - len(cands))
        if not self._spec_engaged(expected, len(members)):
            # Drafts exist but are not worth leaving the pipeline for:
            # exponential probe backoff caps the re-scan rate.
            self._spec_probe_miss = min(self._spec_probe_miss + 1, 3)
            self._spec_probe_skip = 1 << self._spec_probe_miss
            return False
        self._spec_probe_miss = 0
        return True

    # ------------------------------------------------------------- dispatch
    async def _run_spec_unified(self, plan: StepPlan, drafts: Dict[str, List[int]]) -> None:
        """One unified step verifying every drafted row in-step.  Drafted
        decode rows expand to ``1 + len(draft)`` single-token rows; prefill
        chunks and undrafted decode rows ride along as in _run_unified.
        The token fetch is deferred (kind "spec"): acceptance, rollback and
        metrics land at the harvest point."""
        cfg = self.cfg
        bs, S, PP = cfg.block_size, cfg.max_batch, cfg.max_blocks_per_seq
        tok_l: List[int] = []
        pos_l: List[int] = []
        slot_l: List[int] = []
        kv_lens = np.zeros((S,), np.int32)
        tables = np.zeros((S, PP), np.int32)
        cu = np.zeros((S + 1,), np.int32)
        row_seqs: List[SequenceState] = []
        offsets: List[int] = []
        spec_groups: List[Tuple[SequenceState, int, List[int]]] = []
        plain_rows: List[Tuple[SequenceState, int, int, int]] = []
        at = row = 0
        for seq, start, n in plan.items:
            d = drafts.get(seq.request_id) if n == 1 and start >= len(seq.prompt) else None
            all_toks = seq.prompt + seq.output
            blk = np.asarray(seq.block_ids, np.int32)
            if d:
                row0 = row
                for j, t in enumerate([all_toks[start]] + list(d)):
                    p = start + j
                    tok_l.append(int(t))
                    pos_l.append(p)
                    slot_l.append(int(blk[p // bs]) * bs + p % bs)
                    self._tables_row(tables, row, seq)
                    kv_lens[row] = p + 1
                    at += 1
                    cu[row + 1] = at
                    row_seqs.append(seq)
                    offsets.append(j)  # row j samples output index +j
                    row += 1
                seq.awaiting_fetch = True
                spec_groups.append((seq, row0, list(d)))
            else:
                tok_l.extend(all_toks[start: start + n])
                p = np.arange(start, start + n, dtype=np.int32)
                pos_l.extend(p.tolist())
                slot_l.extend((blk[p // bs] * bs + p % bs).tolist())
                self._tables_row(tables, row, seq)
                kv_lens[row] = start + n
                at += n
                cu[row + 1] = at
                row_seqs.append(seq)
                offsets.append(0)
                plain_rows.append((seq, start, n, row))
                if start + n >= len(seq.prompt):
                    seq.awaiting_fetch = True  # parked before the dispatch
                row += 1
        cu[row + 1:] = at
        T = cfg.bucket_tokens(at)
        tok = np.zeros((T,), np.int64)
        tok[:at] = tok_l
        pos = np.zeros((T,), np.int32)
        pos[:at] = pos_l
        slots = np.full((T,), -1, np.int32)
        slots[:at] = slot_l
        rb = dict(token_ids=tok, positions=pos, slot_mapping=slots, kv_lens=kv_lens,
                  page_indices=tables, cu_q_lens=cu, num_seqs=np.asarray([row], np.int32))
        samp = self._sampling_arrays(row_seqs, step_offsets=offsets)
        need_lp = samp.flags.need_logprobs
        prefill_tokens = sum(min(n, len(seq.prompt) - start) for seq, start, n in plan.items
                             if start < len(seq.prompt))
        while self._pending_fetches and self._pending_fetches[0][1].done():
            await self._harvest_pending()  # free: the task already completed

        def run():
            with torch.inference_mode():
                span = self.prefill_spans.start() if prefill_tokens else None
                out = self._run_step(rb, samp)
                if prefill_tokens:
                    self.prefill_spans.stop(span)
                return self._start_d2h(out, need_lp)

        await self._pace()
        t0 = time.perf_counter()
        async with self._device_lock:
            fetch = await self._await_device(self._device_task(run), "spec_dispatch",
                                             len(plan.items))
        wall = time.perf_counter() - t0
        self.step_trace.append(("spec_verify", wall, len(plan.items), at))
        if prefill_tokens:
            self._note_prefill_chunk(wall, prefill_tokens)
        spec_metrics.dispatches_total += 1

        first_rows: List[Tuple[SequenceState, int]] = []
        for seq, start, n, r in plain_rows:
            if seq.finished:
                seq.awaiting_fetch = False  # pre-marked; never parked
                continue
            if start >= len(seq.prompt):
                # Decode row: the fed token joins the hash stream.
                seq.block_seq.append((seq.prompt + seq.output)[start])
            seq.num_computed = start + n
            self._seal_completed_blocks(seq)
            if not seq.in_prefill:
                seq.awaiting_fetch = True
                first_rows.append((seq, r))
        self._stash_fetch("spec", fetch, first_rows, spec_groups)

    # -------------------------------------------------------------- harvest
    def _harvest_spec(self, entry, sampled, logp, top_ids, top_lp) -> None:
        """Apply a spec step's tokens: plain rows accept like "first"
        entries; each drafted group commits its longest sampled-matching
        prefix plus the correcting sample, rolls the rest back
        (num_computed stops at the accepted frontier; rejected KV is
        unsealed scratch), and feeds the acceptance controller."""
        first_rows, groups = entry[2], entry[3]
        for seq, i in first_rows:
            seq.awaiting_fetch = False
            if seq.finished:
                continue  # cancelled while the token was in flight
            self._accept_token(seq, int(sampled[i]),
                               logprobs=self._lp_info(seq, i, logp, top_ids, top_lp))
        bs = self.cfg.block_size
        ctl = self._spec_ctl
        finished: List[SequenceState] = []
        for seq, row0, draft in groups:
            seq.awaiting_fetch = False
            if seq.finished:
                continue
            accepted = committed = 0
            limit = len(seq.block_ids) * bs
            for j in range(len(draft) + 1):
                if seq.num_computed >= limit:
                    break  # beyond allocation: never KV-backed
                fed = (seq.prompt + seq.output)[seq.num_computed]
                if seq.num_computed >= len(seq.prompt):
                    seq.block_seq.append(fed)
                seq.num_computed += 1
                self._seal_completed_blocks(seq)
                tok = int(sampled[row0 + j])
                self._accept_token(seq, tok, defer_removal=True,
                                   logprobs=self._lp_info(seq, row0 + j, logp, top_ids, top_lp))
                committed += 1
                if seq.finished:
                    finished.append(seq)
                    break
                if j < len(draft):
                    if int(draft[j]) != tok:
                        break  # rejection: rows past here are rolled back
                    accepted += 1
            ctl.record(seq, drafted=len(draft), accepted=accepted)
            spec_metrics.drafted_total += len(draft)
            spec_metrics.accepted_total += accepted
            spec_metrics.emitted_total += committed
        for seq in finished:
            self.scheduler.remove(seq)

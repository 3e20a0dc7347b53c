"""Engine-side live-migration primitives: snapshot, freeze, cutover (a
port of the JAX package's ``engine/migrate.py``, mixed into TorchEngine).

Llumnix-style (OSDI'24) live sequence migration needs three things from the
engine that preemption-style rescheduling does not:

- a **serializable decode-state snapshot** (``SequenceSnapshot``,
  llm/migration/snapshot.py): everything needed to continue the stream
  token-identically on another engine — fed tokens, the per-request sampler
  seed and rng-stream position (``orig_prompt_len``), stop conditions, and
  the speculative-decoding controller state;
- a **freeze** primitive for the brief final-delta window: the sequence
  keeps its KV blocks and output queue but stops being planned, so the
  source can export the last sealed blocks and the snapshot against a
  frontier that no in-flight dispatch is still advancing;
- a **cutover/rollback** pair: cutover emits one last stream item (the
  ``migrated`` splice marker the routed client consumes) and releases the
  sequence WITHOUT a finish_reason; rollback simply unfreezes — the source
  never stopped being authoritative, so a failed migration costs nothing
  but the copied bytes (which land as harmless prefix-cache fills on the
  target).

KV itself moves over the existing hash-addressed transfer plane
(engine/transfer.py): decode seals complete blocks as it goes, so the
sealed frontier of ``prompt + output`` is exportable with
``export_prompt_blocks`` at any time, and the unsealed tail (< block_size
tokens) is recomputed by the target as an ordinary partial prefix hit.
"""

from __future__ import annotations

import asyncio
import time
import logging
from typing import Any, Dict, List, Optional

from .pipeline import _FINISHED
from .scheduler import SequenceState

logger = logging.getLogger(__name__)


class MigrationMixin:
    """TorchEngine methods backing llm/migration's source-side protocol."""

    def find_sequence(self, request_id: str) -> Optional[SequenceState]:
        for seq in self.scheduler.running:
            if seq.request_id == request_id:
                return seq
        for seq in self.scheduler.waiting:
            if seq.request_id == request_id:
                return seq
        return None

    def live_request_ids(self) -> List[str]:
        """Requests a migrate-out drain would move (not finished/frozen)."""
        return [
            s.request_id
            for s in list(self.scheduler.running) + list(self.scheduler.waiting)
            if not s.finished and not s.frozen
        ]

    def sequence_tokens(self, request_id: str) -> Optional[List[int]]:
        """The full fed-token stream (prompt + output) at this instant —
        the hash-addressed identity the KV transfer plane exports by."""
        seq = self.find_sequence(request_id)
        if seq is None:
            return None
        return list(seq.prompt) + list(seq.output)

    def snapshot_sequence(self, request_id: str):
        """Serializable decode-state checkpoint (llm/migration/snapshot.py).

        Valid for resume only when taken on a QUIESCENT sequence (after
        ``freeze_sequence``); an unfrozen snapshot is still useful as a
        progress probe (phase-1 copy loops read the token frontier)."""
        from ..llm.migration.snapshot import SequenceSnapshot

        seq = self.find_sequence(request_id)
        if seq is None:
            return None
        ctx = self._contexts.get(request_id)
        deadline = getattr(ctx, "deadline", None) if ctx is not None else None
        return SequenceSnapshot(
            request_id=request_id,
            token_ids=list(seq.prompt) + list(seq.output),
            orig_prompt_len=seq.orig_prompt_len,
            sampling={
                # Resolved values (engine defaults applied) so the target
                # reproduces the sampler stream exactly even when its own
                # engine seed differs.
                "seed": int(seq.sampling_seed),
                "temperature": float(seq.sampling_temperature),
                "top_k": int(seq.sampling_top_k),
                "top_p": float(seq.sampling_top_p),
                "frequency_penalty": float(seq.freq_penalty),
                "presence_penalty": float(seq.pres_penalty),
                "logprobs": seq.logprobs,
                "spec_decode": seq.spec_enabled,
            },
            stop={
                "max_tokens": seq.max_new_tokens,
                "min_tokens": seq.min_new_tokens,
                "stop_token_ids": sorted(seq.stop_token_ids),
                "ignore_eos": bool(seq.ignore_eos),
            },
            spec={
                "k": seq.spec_k,
                "ewma": seq.spec_ewma,
                "bench_until": seq.spec_bench_until,
                "next_try": seq.spec_next_try,
                "miss": seq.spec_miss,
            },
            deadline_s=(
                max(deadline.remaining(), 0.0) if deadline is not None else None
            ),
            # Tenant identity (llm/tenancy): the adapter + KV salt travel
            # with the sequence; the grammar automaton ships serialized and
            # the target re-derives its state from the resumed tokens.
            adapter=None,  # LoRA adapters: ROADMAP queue 1 item 6.4
            kv_salt=seq.kv_salt,
            tenant=seq.tenant or None,
            priority=seq.priority or None,
            grammar=seq.grammar.to_dict() if seq.grammar is not None else None,
            # Tracing continuity (runtime/tracing.py): only the CONTEXT
            # travels — the target opens its own spans under the same
            # trace_id; source-side anchors stay source-local.
            trace=seq.trace.ctx.to_dict() if seq.trace is not None else None,
        )

    async def freeze_sequence(
        self, request_id: str, timeout: float = 10.0
    ) -> Optional[SequenceState]:
        """Stop planning ``request_id`` and wait until no in-flight dispatch
        can still advance it (deferred fetches harvested; fused-pipeline
        membership released).  Under the continuous pipeline
        (docs/decode_pipeline.md) the frozen row is parked OUT of a live
        fused session at its write barrier — ``_pipeline_members`` drops
        the id a few chunks later while the session keeps fusing for
        everyone else, and any not-yet-harvested chunk tokens for the row
        are dropped (recomputed identically on resume: seeded sampler), so
        the snapshot frontier always equals the emitted stream.  Returns
        the quiescent SequenceState, or None if the sequence is
        gone/finished or quiescence didn't land in ``timeout`` (the flag
        is cleared again — the sequence keeps decoding)."""
        seq = self.find_sequence(request_id)
        if seq is None or seq.finished:
            return None
        seq.frozen = True
        self._wake.set()
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            if seq.finished:
                # Finished (stop token landed from an in-flight chunk, or
                # the client cancelled) while we were freezing: nothing
                # left to migrate.
                seq.frozen = False
                return None
            if (
                not seq.awaiting_fetch
                and request_id not in self._pipeline_members
            ):
                # Quiescent: publish the sealed frontier so the final-delta
                # export sees every complete block.
                self._seal_completed_blocks(seq)
                return seq
            await asyncio.sleep(0.005)
        self.unfreeze_sequence(request_id)
        return None

    def unfreeze_sequence(self, request_id: str) -> None:
        """Rollback: the source resumes decoding exactly where it froze."""
        seq = self.find_sequence(request_id)
        if seq is not None:
            seq.frozen = False
        self._wake.set()

    def finish_migrated(
        self, request_id: str, item: Optional[Dict[str, Any]] = None
    ) -> None:
        """Cutover: emit ``item`` (the ``migrated`` splice marker) as the
        stream's last payload, end the stream WITHOUT a finish_reason, and
        release the sequence's slot and blocks.  The freed blocks keep
        their contents in the reuse pool, so an aborted client-side
        re-dispatch could still fall back to this worker with a prefix hit.
        """
        seq = self.find_sequence(request_id)
        if seq is not None:
            # A sequence migrated out mid-prefill leaves the mixed phase:
            # its chunk count must not carry into the cadence of whoever
            # prefills next (same invariant as preemption requeue).
            if seq.in_prefill:
                self._chunks_since_burst = 0
            seq.finished = True
            seq.frozen = False
            # The JAX engine drops the sequence's LoRA adapter-slot ref here
            # (cutover bypasses pipeline._finish); it comes with the port of
            # the adapter banks (ROADMAP queue 1 item 6.4).
            self.scheduler.remove(seq)
        queue = self._queues.get(request_id)
        if queue is not None:
            if item is not None:
                queue.put_nowait(item)
            queue.put_nowait(_FINISHED)
        self._wake.set()

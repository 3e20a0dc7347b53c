"""Fused decode pipeline, unified steps, deferred fetches and token
acceptance for TorchEngine (a mixin, as in the JAX package's
engine/pipeline.py, whose default decode path this ports).

- Every dispatch goes through the engine's device programs
  (engine/graphs.py): on CUDA a replayed CUDA graph, fed by one staged
  host→device copy; on the CPU the same functions eagerly.
- A dispatch's sampled outputs start their device→host copy into a pinned
  ring slot at dispatch (``_start_d2h``); the accept is deferred to a
  harvest point (``_stash_fetch``/``_harvest_pending``), so the round trip
  overlaps later dispatches.
- The continuous ``_decode_pipeline`` keeps up to ``pipeline_depth`` fused
  dispatches in flight, chained on the device carry, and admits and
  retires rows inside the loop.

Speculative decoding (engine/spec.py) enters here twice: the ``"spec"``
kind of deferred fetch, applied by ``_harvest_spec``, and the session probe
that leaves a fused session once its output turns repetitive enough for
speculation to beat it.  Request tracing enters at the first accepted
token (``_trace_first_token``: the ``engine.prefill`` span) and once per
fused dispatch (``_trace_decode_chunk``), on host clocks only.  Left out,
with the later slices that port them: migration freeze entry points and the
multi-host publisher.  The ``frozen`` and ``grammar`` guards stay as the
copied modules have them.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..llm.protocols import FinishReason, LLMEngineOutput
from ..ops.sampling import SAMPLING_DTYPES, SamplingFlags
from ..runtime.tracing import _wall_ms
from ..runtime.tracing import collector as trace_collector
from .graphs import HostFetch
from .scheduler import RowSlots, SequenceState, StepPlan

logger = logging.getLogger(__name__)

_FINISHED = object()  # queue sentinel (engine.py imports this)


class HostSampling(NamedTuple):
    """Per-row sampling state for one dispatch, on the host: the arrays of
    ``SAMPLING_DTYPES``, the [S, V] penalty counts when some row uses a
    penalty (else None: the device zeros serve), and the flags."""

    arrays: Dict[str, np.ndarray]
    counts: Optional[np.ndarray]
    flags: SamplingFlags


class DecodePipelineMixin:
    # Continuous batching in the fused decode loop: retire finished rows and
    # admit waiting sequences between chunk dispatches instead of draining
    # the whole pipeline on every membership change.  Tests flip this off
    # to run the drain-on-any-change behaviour as the exact-stream control
    # (both modes are token-identical; only the scheduling shape differs).
    _continuous_decode = True

    # ------------------------------------------------------------ batch build
    def _sampling_arrays(self, seqs: List[Optional[SequenceState]],
                         step_offsets: Optional[List[int]] = None) -> HostSampling:
        """Per-row sampling state for one step, one entry per batch row
        (None = padding or a free row slot, greedy defaults).  A sequence
        may own several rows (a speculative verification step):
        ``step_offsets[i]`` then shifts row i's rng-stream position to the
        output index it scores (engine/spec.py)."""
        S = self.cfg.max_batch
        V = self.model_config.vocab_size
        a = {k: np.zeros((S,), dt) for k, dt in SAMPLING_DTYPES.items()}
        a["top_p"][:] = 1.0
        need_lp = False
        for i, seq in enumerate(seqs):
            if seq is None:
                continue
            a["seeds"][i] = seq.sampling_seed & 0xFFFFFFFF
            a["steps"][i] = seq.num_output_tokens + (step_offsets[i] if step_offsets else 0)
            a["temperature"][i] = seq.sampling_temperature
            a["top_k"][i] = seq.sampling_top_k
            a["top_p"][i] = seq.sampling_top_p
            a["freq_penalty"][i] = seq.freq_penalty
            a["pres_penalty"][i] = seq.pres_penalty
            need_lp = need_lp or seq.logprobs is not None
        flags = SamplingFlags.of(a["temperature"], a["top_k"], a["top_p"],
                                 a["freq_penalty"], a["pres_penalty"], need_lp)
        counts = None
        if flags.any_penalty:
            counts = np.zeros((S, V), np.int16)
            for i, seq in enumerate(seqs):
                if seq is None:
                    continue
                # Generated tokens since the ORIGINAL prompt: preemption
                # folds output into ``prompt``.
                gen = np.asarray((seq.prompt + seq.output)[seq.orig_prompt_len:], np.int64)
                if gen.size:
                    np.add.at(counts[i], gen % V, 1)
        return HostSampling(a, counts, flags)

    def _tables_row(self, out: np.ndarray, i: int, seq: SequenceState) -> None:
        ids = seq.block_ids[: out.shape[1]]
        out[i, : len(ids)] = ids

    def _build_ragged(self, items) -> Dict[str, np.ndarray]:
        """Host arrays of the ragged step for ``items`` = [(seq, start, n)],
        padded to a power-of-two token bucket (RaggedBatch's fields)."""
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
        return dict(
            token_ids=tok, positions=pos, slot_mapping=slots, kv_lens=kv_lens,
            page_indices=tables, cu_q_lens=cu, num_seqs=np.asarray([len(items)], np.int32),
        )

    # ------------------------------------------------------ deferred fetches
    def _start_d2h(self, out, need_lp: bool) -> HostFetch:
        """Start the sampled outputs' device→host copy into a pinned ring
        slot, with an event behind it.  Called right after the dispatch, in
        the same thread: the graph's static outputs stay valid only until
        the next replay, which stream order puts after this copy."""
        tensors = [out.tokens]
        if need_lp:
            tensors += [out.logprob, out.top_ids, out.top_logprobs]
        return self._fetch_ring.start(tensors)

    @staticmethod
    def _fetch_outs(fetch: HostFetch):
        """Wait for a started fetch (worker thread): (tokens, logprob,
        top_ids, top_logprobs), the last three None without logprobs."""
        got = fetch.result()
        return got if len(got) == 4 else (got[0], None, None, None)

    def _stash_fetch(self, kind: str, fetch: HostFetch, *meta) -> None:
        """Park a dispatched step's token fetch: the wait runs on a worker
        thread starting now, and the loop applies the result at a harvest
        point once the task completes."""
        task = asyncio.get_running_loop().create_task(asyncio.to_thread(self._fetch_outs, fetch))
        self._pending_fetches.append((kind, task, *meta))

    async def _harvest_pending(self, all_pending: bool = False) -> None:
        """Apply deferred fetches in dispatch order: the oldest entry
        (awaiting its task), or everything outstanding."""
        while self._pending_fetches:
            entry = self._pending_fetches.pop(0)
            kind, task = entry[0], entry[1]
            await self._pace()
            t0 = time.perf_counter()
            sampled, logp, top_ids, top_lp = await self._await_device(
                task, f"{kind}_fetch", len(entry[2])
            )
            self.step_trace.append((f"{kind}_harvest", time.perf_counter() - t0, len(entry[2]), 0))
            if kind == "first":
                for seq, i in entry[2]:
                    seq.awaiting_fetch = False
                    if seq.finished:
                        continue  # cancelled while the token was in flight
                    self._accept_token(
                        seq, int(sampled[i]),
                        logprobs=self._lp_info(seq, i, logp, top_ids, top_lp),
                    )
            elif kind == "spec":  # speculative verification (engine/spec.py)
                self._harvest_spec(entry, sampled, logp, top_ids, top_lp)
            else:  # burst
                members, pos0, chained = entry[2], entry[3], entry[4]
                self._accept_chunk(members, pos0, sampled, logp, top_ids, top_lp, [])
                if chained:
                    # A chained chunk for these rows is still in flight:
                    # keep them parked, and defer removals to the final
                    # chunk's harvest, so no member's blocks are freed while
                    # a dispatch that writes them is in flight.
                    for seq in members:
                        if not seq.finished:
                            seq.awaiting_fetch = True
                else:
                    # Sweep by flag: a row that stopped in the FIRST chunk
                    # of a chained burst is skipped by this chunk's accept
                    # and must still be removed here.
                    for seq in members:
                        if seq.finished and any(s is seq for s in self.scheduler.running):
                            self.scheduler.remove(seq)
            if not all_pending:
                break

    async def _pace(self) -> None:
        """Await the injectable pace hook (``pace_hook``) before a device
        op, always OUTSIDE ``_device_lock``: the hook may block."""
        if self.pace_hook is not None:
            await self.pace_hook()

    async def _await_device(self, task, kind: str, rows: int):
        """Await a device-op task (fetch or dispatch) under the decode-stall
        watchdog: past ``decode_stall_s`` it logs the recent dispatch trace,
        bumps ``decode_stalls`` and records ``last_stall`` — then keeps
        waiting (it attributes a hang, it does not guess at recovery)."""
        thr = self._stall_threshold_s
        if thr <= 0:
            return await task
        waited = 0.0
        while True:
            done, _ = await asyncio.wait({task}, timeout=thr)
            if done:
                return task.result()
            if waited == 0.0:
                self.decode_stalls += 1
            waited += thr
            trace = [[k, round(t, 4), r, n] for k, t, r, n in list(self.step_trace)[-8:]]
            self.last_stall = {"kind": kind, "rows": rows, "waited_s": round(waited, 3),
                               "trace": trace}
            logger.error(
                "decode stall: %s (%d rows) exceeded %.1fs (waited %.1fs, threshold "
                "decode_stall_s/DYN_DECODE_STALL_S); recent dispatch trace: %s",
                kind, rows, thr, waited, trace,
            )

    def _device_task(self, fn):
        """A device-op thread wrapped in a Task for _await_device."""
        return asyncio.get_running_loop().create_task(asyncio.to_thread(fn))

    # ------------------------------------------------------- unified steps
    async def _run_unified(self, plan: StepPlan) -> None:
        """One unified step for ``plan``.  Rows whose prompt completes, and
        decode rows, get their token through a deferred fetch: they are
        parked (``awaiting_fetch``) until a harvest point applies it."""
        rb = self._build_ragged(plan.items)
        samp = self._sampling_arrays([s for s, _, _ in plan.items])
        need_lp = samp.flags.need_logprobs
        # A step whose every row stays mid-prefill samples nothing anyone
        # consumes: no fetch at all.
        need_tokens = any(start + n >= len(seq.prompt) for seq, start, n in plan.items)
        prefill = any(start < len(seq.prompt) for seq, start, _ in plan.items)
        # Park rows BEFORE the first suspension point (see the JAX engine):
        # from here to the harvest the row has a token en route.
        for seq, start, n in plan.items:
            if not seq.finished and start + n >= len(seq.prompt):
                seq.awaiting_fetch = True
        while self._pending_fetches and self._pending_fetches[0][1].done():
            await self._harvest_pending()  # free: the task already completed

        def run():
            with torch.inference_mode():
                span = self.prefill_spans.start() if prefill else None
                out = self._run_step(rb, samp)
                if prefill:
                    self.prefill_spans.stop(span)
                return self._start_d2h(out, need_lp) if need_tokens else None

        await self._pace()
        t0 = time.perf_counter()
        async with self._device_lock:
            fetch = await self._await_device(self._device_task(run), "unified_dispatch",
                                             len(plan.items))
        wall = time.perf_counter() - t0
        self.step_trace.append(
            ("unified_fetch" if need_tokens else "unified", wall, len(plan.items),
             len(rb["token_ids"]))
        )
        prefill_tokens = sum(
            min(n, len(seq.prompt) - start) for seq, start, n in plan.items
            if start < len(seq.prompt)
        )
        if prefill_tokens > 0:
            self._note_prefill_chunk(wall, prefill_tokens)

        pending_rows: List[Tuple[SequenceState, int]] = []
        for i, (seq, start, n) in enumerate(plan.items):
            if seq.finished:
                seq.awaiting_fetch = False  # pre-marked above; never parked
                continue
            if start >= len(seq.prompt):
                # Decode row: the fed token joins the hash stream.
                seq.block_seq.append((seq.prompt + seq.output)[start])
            seq.num_computed = start + n
            self._seal_completed_blocks(seq)
            if not seq.in_prefill:
                seq.awaiting_fetch = True
                pending_rows.append((seq, i))
        if pending_rows:
            self._stash_fetch("first", fetch, pending_rows)

    # ------------------------------------------------- fused decode pipeline
    async def _decode_pipeline(self, members: List[SequenceState]) -> bool:
        """Continuous fused decode: multi-step dispatches with the token
        carry on the device, up to ``pipeline_depth`` in flight, host
        readback overlapped, and continuous membership:

        - in-loop retirement: a row that stops or is cancelled is excluded
          from further dispatches at once (``pos_disp = -1``); its slot and
          KV blocks are released once the write barrier passes (every chunk
          dispatched while it was active has been harvested);
        - in-loop admission: compatible waiting sequences take free row
          slots; their prompts prefill through ordinary unified steps
          interleaved between fused chunks, and once the first token lands
          they join the chain at the next chain-break merge;
        - the oldest chunk's fetch runs in a worker thread while the next
          chunk's planning, the admission prefill and completed first-token
          harvests proceed.

        Exactness: samples depend only on (seed, output index, committed
        prefix), and a chain-break merge re-seeds the carry with exactly
        the values it holds, so continuous and drain-rebuild scheduling give
        byte-identical streams at any temperature
        (tests/test_torch_pipeline.py; ``_continuous_decode = False`` is
        the control)."""
        cfg = self.cfg
        bs = cfg.block_size
        S, T = cfg.max_batch, cfg.decode_steps
        continuous = self._continuous_decode
        self._pipeline_members = {s.request_id for s in members}
        self.pipeline_sessions += 1
        session_t0 = time.perf_counter()

        tok0 = np.zeros((S,), np.int64)
        pos_disp = np.full((S,), -1, np.int32)  # dispatch frontier (-1 = free)
        tables = np.zeros((S, cfg.max_blocks_per_seq), np.int32)
        limits = np.zeros((S,), np.int32)
        slots = RowSlots(S)
        samp: Optional[HostSampling] = None
        need_lp = False
        # Whether the device carry (engine._carry) holds the last dispatch's
        # (token, rng step, penalty counts); False re-seeds from the host.
        chained = False

        inflight: deque = deque()  # (fetch, pos0, chunk_id, need_lp)
        chunk_id = 0  # monotone dispatch counter: the write-barrier clock
        harvested = 0  # highest chunk id applied so far
        retired: List[Tuple[SequenceState, int, int]] = []  # (seq, slot, barrier)
        prefilling: List[SequenceState] = []  # admitted in-loop, prompt computing
        # Sequences joining the chain at the next chain-break merge; the
        # initial members seed through the same merge.
        ready: List[SequenceState] = list(members)
        rebuild = False
        dispatched_any = False

        def merge_ready() -> None:
            """Chain-break merge: assign slots to joining sequences and
            re-seed the chain from host state.  Only legal with nothing in
            flight (accepted == dispatched for every continuing row)."""
            nonlocal samp, need_lp, chained
            for seq in ready:
                slots.assign(seq)
            ready.clear()
            for i, seq in slots.active():
                tok0[i] = (seq.prompt + seq.output)[seq.num_computed]
                pos_disp[i] = seq.num_computed
            samp = self._sampling_arrays(slots.rows)
            need_lp = samp.flags.need_logprobs
            chained = False

        def sweep_retire() -> int:
            """Retire finished (and, continuous, cancelled) rows: excluded
            from future dispatches now, slot and blocks released once the
            write barrier passes."""
            m = 0
            for i, seq in slots.active():
                if continuous and self._stopped(seq):
                    seq.finished = True
                    self._finish(seq, FinishReason.CANCELLED)
                if seq.finished:
                    slots.retire(i)
                    pos_disp[i] = -1
                    retired.append((seq, i, chunk_id))
                    if continuous:
                        self.continuous_retired += 1
                    m += 1
            return m

        def flush_retired() -> None:
            """Release retirements whose write barrier has passed."""
            while retired and retired[0][2] <= harvested:
                seq, i, _ = retired.pop(0)
                self.scheduler.remove(seq)
                self._pipeline_members.discard(seq.request_id)
                slots.free(i)

        def rejoin_strays() -> None:
            """Running decode rows outside the session rejoin at the next
            chain break."""
            nonlocal rebuild
            known = slots.num_active + len(prefilling) + len(ready) + len(retired)
            if len(self.scheduler.running) == known:
                return
            in_session = (
                {id(s) for _, s in slots.active()} | {id(s) for s in prefilling}
                | {id(s) for s in ready} | {id(s) for s, _, _ in retired}
            )
            for seq in self.scheduler.running:
                if id(seq) in in_session or seq.frozen or seq.finished or seq.awaiting_fetch:
                    continue
                if seq.grammar is not None:
                    rebuild = True
                    continue
                (prefilling if seq.in_prefill else ready).append(seq)
                self._pipeline_members.add(seq.request_id)

        def want_rebuild() -> bool:
            if self._closed:
                return True
            if any(s.frozen for s in prefilling) or any(s.frozen for s in ready):
                return True
            if not continuous:
                # Static membership: ANY change drains the session.
                return (
                    any(s.frozen for _, s in slots.active())
                    or self.scheduler.admission_ready()
                    or any(s.finished for _, s in slots.active())
                    or any(self._stopped(s) for _, s in slots.active())
                )
            return self.scheduler.admission_ready() and not self.scheduler.waiting_head_compatible()

        def admit() -> None:
            if not continuous or rebuild:
                return
            room = slots.capacity_left - len(prefilling) - len(ready)
            if room <= 0 or not self.scheduler.admission_ready():
                return
            if not self.scheduler.waiting_head_compatible():
                return
            for seq in self.scheduler.admit_continuous(room):
                self._pipeline_members.add(seq.request_id)
                self.continuous_admissions += 1
                prefilling.append(seq)

        async def prefill_step() -> bool:
            """One unified step advancing every in-loop-admitted prompt by a
            chunk (chunked prefill, deferred first-token fetch)."""
            budget = cfg.prefill_chunk
            items: List[Tuple[SequenceState, int, int]] = []
            for seq in prefilling:
                if budget <= 0:
                    break
                if seq.finished or seq.frozen or seq.awaiting_fetch or not seq.in_prefill:
                    continue
                chunk = min(budget, len(seq.prompt) - seq.num_computed)
                items.append((seq, seq.num_computed, chunk))
                budget -= chunk
            if not items:
                return False
            # In-session device work for host_gap_frac.
            t0 = time.perf_counter()
            await self._run_unified(StepPlan(items))
            self.decode_busy_s += time.perf_counter() - t0
            return True

        def promote_ready() -> None:
            for seq in list(prefilling):
                if seq.finished:
                    prefilling.remove(seq)
                    self._pipeline_members.discard(seq.request_id)
                elif not seq.in_prefill and not seq.awaiting_fetch:
                    prefilling.remove(seq)
                    ready.append(seq)

        def plan_chunk() -> Optional[np.ndarray]:
            """Host planning for one fused chunk: KV slot ensure, table
            refresh, per-row write limits.  None = nothing worth dispatching
            (or KV exhausted → rebuild)."""
            nonlocal rebuild
            # Checked BEFORE allocating lookahead blocks: a never-dispatched
            # chunk must not take KV capacity from other sequences.
            if not self._any_useful_rows(slots.rows, pos_disp):
                return None
            ok = True
            for i, seq in slots.active():
                need = int(pos_disp[i]) + T - seq.num_computed
                if not self.scheduler._ensure_slot(seq, lookahead=need):
                    ok = False
                self._tables_row(tables, i, seq)
                limits[i] = min(len(seq.block_ids) * bs, cfg.max_blocks_per_seq * bs)
            if not ok:
                rebuild = True
                return None
            return pos_disp.copy()

        async def dispatch_chunk(pos0: np.ndarray) -> None:
            nonlocal chained, chunk_id, dispatched_any
            n_active = slots.num_active
            args = (None if chained else tok0.copy(), pos0, tables.copy(), limits.copy(), samp)
            lp = need_lp

            def run():
                with torch.inference_mode():
                    span = self.decode_spans.start()
                    out = self._run_multi(*args)
                    self.decode_spans.stop(span)
                    return self._start_d2h(out, lp)

            await self._pace()
            t0 = time.perf_counter()
            async with self._device_lock:
                fetch = await self._await_device(self._device_task(run), "decode_dispatch",
                                                 n_active)
            chained = True
            t1 = time.perf_counter()
            wall = t1 - t0
            self.decode_busy_s += wall
            self.step_trace.append(("decode_dispatch", wall, n_active, n_active * T))
            self._trace_decode_chunk(slots.active(), t0, t1, T)
            chunk_id += 1
            inflight.append((fetch, pos0, chunk_id))
            dispatched_any = True
            pos_disp[:] = np.where(pos_disp >= 0, pos_disp + T, pos_disp)

        while True:
            if sweep_retire() and not continuous:
                rebuild = True
            flush_retired()
            if continuous and not rebuild:
                rejoin_strays()
            if want_rebuild():
                rebuild = True
            if ready and not inflight and not rebuild:
                merge_ready()

            # Pop the oldest chunk and start its fetch FIRST: everything
            # below overlaps the wait running in the fetch thread.
            fetch_task = None
            if inflight:
                fetch, pos0_c, cid = inflight.popleft()
                wait_t0 = time.perf_counter()
                fetch_task = asyncio.get_running_loop().create_task(
                    asyncio.to_thread(self._fetch_outs, fetch)
                )

            # Top up the dispatch window.  With anyone waiting to join, cap
            # the in-flight depth at 2 so the drain a join waits for stays
            # bounded; a pending merge holds fused dispatch entirely.
            depth = (
                min(cfg.pipeline_depth, 2)
                if (self.scheduler.num_waiting or prefilling or ready)
                else cfg.pipeline_depth
            )
            in_flight_now = len(inflight) + (1 if fetch_task is not None else 0)
            progressed = False
            while not rebuild and not ready and samp is not None and in_flight_now < depth:
                pos0 = plan_chunk()
                if pos0 is None:
                    break
                await dispatch_chunk(pos0)
                in_flight_now += 1
                progressed = True
                if want_rebuild():
                    rebuild = True
            if not rebuild:
                admit()
                if await prefill_step():
                    dispatched_any = True
                    progressed = True
            # Completed deferred fetches (admitted rows' first tokens) apply
            # for free while the oldest chunk is still in flight.
            while self._pending_fetches and self._pending_fetches[0][1].done():
                await self._harvest_pending()
                progressed = True

            if fetch_task is not None:
                await self._pace()
                sampled, logp, top_ids, top_lp = await self._await_device(
                    fetch_task, "decode_wait", slots.num_active
                )
                wait_wall = time.perf_counter() - wait_t0
                self.decode_busy_s += wait_wall
                # "wait", not "fetch": the copy started at dispatch, so this
                # wall is mostly the chunk's device compute.
                self.step_trace.append(
                    ("decode_wait", wait_wall, slots.num_active, slots.num_active * T)
                )
                self._accept_chunk(slots.rows, pos0_c, sampled, logp, top_ids, top_lp, [])
                harvested = cid
                if not rebuild and self._spec_session_probe([s for _, s in slots.active()]):
                    # Output grew repetitive enough that in-step speculation
                    # now beats the fused chunks: drain and let schedule()
                    # propose for real (engine/spec.py).
                    rebuild = True
            elif not progressed:
                if self._pending_fetches:
                    # Nothing dispatchable until a first-token fetch lands.
                    await self._harvest_pending()
                else:
                    promote_ready()
                    if ready and not rebuild:
                        continue  # late joiners: merge next iteration
                    break  # drained for a rebuild, or every member finished
            promote_ready()
            if rebuild and not inflight:
                break
            await asyncio.sleep(0)  # let ingress/egress run between chunks

        # Drained: every dispatched chunk was harvested, so every write
        # barrier has passed.
        sweep_retire()
        flush_retired()
        self._pipeline_members = set()
        self.pipeline_wall_s += time.perf_counter() - session_t0
        if rebuild:
            self.pipeline_rebuilds += 1
        return dispatched_any

    async def _decode_burst(self, members: List[SequenceState]) -> bool:
        """Fused dispatch(es) for ``members`` (all decoding) in mixed
        phases, accepted at a later harvest point.  When KV headroom covers
        two chunks and some row can still use the second, a second dispatch
        is CHAINED off the first's device carry.  Returns False,
        dispatching nothing, when KV headroom for one burst is missing."""
        cfg = self.cfg
        bs = cfg.block_size
        S, T = cfg.max_batch, cfg.decode_steps
        n = len(members)
        tok0 = np.zeros((S,), np.int64)
        pos0 = np.full((S,), -1, np.int32)
        tables = np.zeros((S, cfg.max_blocks_per_seq), np.int32)
        limits = np.zeros((S,), np.int32)
        chain = True  # headroom for a second chained chunk on every row?
        for i, seq in enumerate(members):
            if seq.finished or seq.frozen or seq.grammar is not None:
                return False  # membership changed under us: replan
            if not self.scheduler._ensure_slot(seq, lookahead=T):
                return False
            if chain and not self.scheduler._ensure_slot(seq, lookahead=2 * T):
                chain = False
            tok0[i] = (seq.prompt + seq.output)[seq.num_computed]
            pos0[i] = seq.num_computed
            self._tables_row(tables, i, seq)
            limits[i] = min(len(seq.block_ids) * bs, cfg.max_blocks_per_seq * bs)
        if chain:
            chain = self._any_useful_rows(members, np.where(pos0 >= 0, pos0 + T, pos0))
        # Park BEFORE the first suspension point.
        for seq in members:
            seq.awaiting_fetch = True
        while self._pending_fetches and self._pending_fetches[0][1].done():
            await self._harvest_pending()
        samp = self._sampling_arrays(members)
        need_lp = samp.flags.need_logprobs
        pos0b = np.where(pos0 >= 0, pos0 + T, pos0)

        async def dispatch(tok_in, p0) -> HostFetch:
            def run():
                with torch.inference_mode():
                    span = self.decode_spans.start()
                    out = self._run_multi(tok_in, p0, tables, limits, samp)
                    self.decode_spans.stop(span)
                    return self._start_d2h(out, need_lp)

            await self._pace()
            t0 = time.perf_counter()
            async with self._device_lock:
                fetch = await self._await_device(self._device_task(run), "burst_dispatch", n)
            t1 = time.perf_counter()
            self.step_trace.append(("decode_burst", t1 - t0, n, n * T))
            self._trace_decode_chunk(enumerate(members), t0, t1, T)
            return fetch

        self._stash_fetch("burst", await dispatch(tok0, pos0), members, pos0, chain)
        if chain:
            # The chained chunk: the carry stays ON DEVICE (warmup captures
            # this carry form too, so no new program is reachable here).
            self._stash_fetch("burst", await dispatch(None, pos0b), members, pos0b, False)
        return True

    def _any_useful_rows(self, members: List[Optional[SequenceState]], pos_disp: np.ndarray) -> bool:
        """True if any active member could still accept a token from one
        more fused chunk, given how far its dispatch frontier overshoots its
        accepted position.  ``None`` entries are free/retired row slots."""
        for i, seq in enumerate(members):
            if seq is None or seq.finished or pos_disp[i] < 0:
                continue
            overshoot = int(pos_disp[i]) - seq.num_computed
            budget = self.cfg.max_model_len - seq.total_tokens
            if seq.max_new_tokens is not None:
                budget = min(budget, seq.max_new_tokens - seq.num_output_tokens)
            if budget - overshoot > 0:
                return True
        return False

    # ------------------------------------------------------------ per-token
    def _seal_completed_blocks(self, seq: SequenceState) -> None:
        complete = seq.num_computed // self.cfg.block_size
        hashed = len(seq.block_seq.blocks)
        while seq.num_sealed_blocks < min(complete, hashed):
            idx = seq.num_sealed_blocks
            tb = seq.block_seq.blocks[idx]
            self.kv.seal_block(seq.block_ids[idx], tb)
            seq.num_sealed_blocks += 1
            # Write-behind to the host tier (engine/offload.py drains it).
            if self.host_kv is not None and not self.host_kv.contains(tb.sequence_hash):
                self._offload_queue.append((seq.block_ids[idx], tb))

    def _accept_chunk(self, members, pos0, sampled, logp, top_ids, top_lp,
                      finished: List[SequenceState]) -> None:
        """Apply one fused chunk's ``[decode_steps, S]`` samples: per row,
        tokens are accepted in order until a stop, the budget, or the
        allocation wall; the rest were over-decoded and are dropped.  A row
        without logprobs gets its accepted tokens as ONE multi-token item,
        as the JAX engine's vectorized accept emits them; a row with
        logprobs gets one item per token.  ``None`` members are free row
        slots; rows that finish are appended to ``finished``."""
        bs = self.cfg.block_size
        for i, seq in enumerate(members):
            if seq is None:
                continue
            seq.awaiting_fetch = False
            if seq.finished or pos0[i] < 0:
                continue
            p0 = int(pos0[i])
            if seq.num_computed != p0:
                continue  # stopped or hit the allocation wall in a prior chunk
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
                    finished.append(seq)
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

    # ------------------------------------------------------------- tracing
    def _trace_first_token(self, seq: SequenceState) -> None:
        """First output token of a traced sequence: record the
        ``engine.prefill`` span (admission → first token — chunked prompt
        compute plus the first sampled fetch) with a ``first_token`` event,
        the TTFT decomposition's engine-side anchor.  One latch per
        sequence; untraced rows cost a single attr check."""
        st = seq.trace
        if st is None or st.first_done:
            return
        st.first_done = True
        now = time.perf_counter()
        trace_collector.record(
            st.ctx, "engine.prefill", "engine",
            st.t_admit or st.t_enqueue, now,
            attrs={
                "prompt_tokens": len(seq.prompt),
                "cached_tokens": seq.num_cached_prompt,
            },
            events=[{"name": "first_token", "t_ms": round(_wall_ms(now), 3)}],
        )

    def _trace_decode_chunk(self, rows, t0: float, t1: float, steps: int) -> None:
        """One ``engine.decode_chunk`` span per TRACED row per fused
        dispatch: decode records at chunk (dispatch) granularity only,
        never per token, from host clocks taken around the dispatch (no
        synchronisation, nothing inside the captured graph).  Untraced rows
        cost one attr check per chunk; rows whose first token has not
        landed yet are skipped (their wall belongs to engine.prefill)."""
        for _i, seq in rows:
            if seq is None:
                continue
            st = seq.trace
            if st is None or not st.first_done:
                continue
            trace_collector.record(
                st.ctx, "engine.decode_chunk", "engine", t0, t1, attrs={"steps": steps},
            )

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
        if seq.trace is not None:
            self._trace_first_token(seq)
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

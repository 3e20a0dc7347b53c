"""Continuous-batching scheduler: admission, chunked prefill, decode slots.

The reference's scheduling lives inside vLLM; this is the native equivalent
(a copy of the JAX package's scheduler): each unified device step carries
decode tokens for every running sequence plus prompt chunks up to the
prefill budget, padded to a power-of-two token bucket.

Admission is blocks-aware: a sequence is only admitted when the KV manager
can allocate its prompt blocks (minus prefix-cache hits).  Decode growth
allocates one block at a time; if the pool is exhausted a victim sequence is
preempted back to the waiting queue (its blocks freed — recomputed later,
matching the reference engines' recompute-style preemption).  Victims are
chosen QoS-aware: ``batch``-priority rows first (they signed up to be the
degradation buffer), youngest first within a class, so one
tenant's burst can never preempt another tenant's interactive rows while
batch rows are available.

The waiting queue is a weighted-fair queue (``WfqQueue``) keyed on tenant
identity, not a FIFO: under overload one flooding tenant's backlog cannot
crowd admission away from others — each backlogged tenant drains in
proportion to its configured weight (EngineConfig ``qos.tenant_weights``),
with a provable starvation bound (see WfqQueue).  Single-tenant traffic
degenerates to exact FIFO, so the pre-QoS behaviour is unchanged.
"""

from __future__ import annotations

import time
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

from ..llm.protocols import PreprocessedRequest
from ..runtime.tracing import collector as trace_collector
from ..tokens import TokenBlockSequence
from .config import EngineConfig
from .kv_manager import KvBlockManager

# QoS priority classes: interactive (default, protected) and batch (first
# preemption victim).  The edge parses them from x-priority / nvext.priority.
INTERACTIVE = "interactive"
BATCH = "batch"
PRIORITIES = (INTERACTIVE, BATCH)


def normalize_priority(value: Any, default: str = INTERACTIVE) -> str:
    """Clamp any wire value to a known class (unknown → default, never an
    error: priority is a hint, not a schema)."""
    if isinstance(value, str) and value.lower() in PRIORITIES:
        return value.lower()
    return default


@dataclass
class SequenceState:
    """Everything the engine tracks per in-flight request."""

    request_id: str
    prompt: List[int]
    block_seq: TokenBlockSequence  # hashes prompt+output as blocks complete
    sampling_temperature: float = 0.0
    sampling_top_k: int = 0
    sampling_top_p: float = 1.0
    sampling_seed: int = 0  # per-request rng stream (engine fills default)
    freq_penalty: float = 0.0
    pres_penalty: float = 0.0
    # None = no logprobs; 0 = chosen-token only; N = chosen + top-N
    logprobs: Optional[int] = None
    max_new_tokens: Optional[int] = None
    min_new_tokens: Optional[int] = None
    stop_token_ids: frozenset = frozenset()
    ignore_eos: bool = False

    output: List[int] = field(default_factory=list)
    # Reference-held prefix blocks (sp-prefill / host-restore sealed them
    # just before admission): keeps the reuse-pool LRU from evicting the
    # work between sealing and allocate_sequence.  Released by the
    # scheduler once admission lands (or the request leaves the queue).
    pin_ids: Optional[List[int]] = None
    # A sampled token for this row is in flight device→host (the engine's
    # deferred first-token fetch): the scheduler must not plan the row
    # until the engine harvests it (engine.py _harvest_pending).
    awaiting_fetch: bool = False
    # Live-migration freeze (engine/migrate.py): the sequence keeps its KV
    # blocks and queue but is never planned, never a preemption victim, and
    # blocks no one — the brief final-delta window of a migration, ended by
    # cutover (finish_migrated) or rollback (unfreeze_sequence).
    frozen: bool = False
    # Original request prompt length.  Preemption folds generated tokens into
    # ``prompt`` for recompute, so stop checks and usage must count output as
    # total_tokens - orig_prompt_len, never len(output).
    orig_prompt_len: int = 0
    block_ids: List[int] = field(default_factory=list)
    num_computed: int = 0  # tokens whose KV is resident
    num_cached_prompt: int = 0  # prefix-cache hit length (metrics)
    finished: bool = False
    # blocks sealed (hash-published) so far — index into block_seq.blocks
    num_sealed_blocks: int = 0
    # Queue-entry timestamp (time.perf_counter): admission latency =
    # admit time - this.  The dominant TTFT-tail term at saturation is a
    # newcomer waiting out a fused pure-decode session (r5 stall
    # diagnosis); admission_waits records it per request.
    enqueue_t: float = 0.0
    # --- speculative decoding (engine/spec.py) ---
    # Per-request opt-out (sampling_options.spec_decode=false via nvext).
    spec_enabled: bool = True
    # Adaptive draft length: -1 = unresolved (controller seeds it from
    # SpecDecodeConfig.k on first use).  Survives preemption — acceptance
    # history is a property of the traffic, not of the KV residency.
    spec_k: int = -1
    # EWMA of per-dispatch acceptance (accepted/drafted).
    spec_ewma: float = 1.0
    # Proposer bench: no drafts until num_output_tokens reaches this
    # (-1 = not benched).
    spec_bench_until: int = -1
    # Miss backoff: matching is skipped until total_tokens reaches this
    # (exponential in consecutive misses, capped) so non-repetitive
    # traffic stops paying the n-gram scan almost immediately.
    spec_next_try: int = 0
    spec_miss: int = 0
    # --- multi-tenancy (llm/tenancy) ---
    # Tenant salt mixed into the chained block hashes (tokens.py): equal
    # token streams from different adapters never share KV — engine
    # sealing, host offload, transfer plane and kv_router all key on the
    # salted hashes, so one field isolates every tier.
    kv_salt: Optional[str] = None
    # LoRA adapter (None = base model) + its resident device-bank slot.
    adapter: Optional[str] = None
    adapter_slot: int = -1
    # Registry ref dropped (engine _finish is reachable from several paths;
    # the flag makes the release idempotent).
    adapter_released: bool = False
    # Grammar constraint: TokenMaskAutomaton + the sequence's current
    # state, advanced host-side per ACCEPTED token.  Constrained rows are
    # excluded from the fused multi-step decode programs (the mask must be
    # rebuilt between tokens, and fused steps feed tokens forward on
    # device) — they advance through single unified steps instead.
    grammar: Any = None
    grammar_state: int = 0
    # --- QoS ---
    # Fairness identity for the WFQ waiting queue: explicit annotation, the
    # LoRA adapter, or the served model name — "" means the shared default
    # tenant (single-tenant traffic collapses to FIFO).
    tenant: str = ""
    # interactive (default, protected) | batch (first preemption victim,
    # shed first under brownout).  Threaded from nvext.priority via
    # PreprocessedRequest.priority.
    priority: str = INTERACTIVE
    # --- request tracing (runtime/tracing.py) ---
    # SeqTrace (context + timing anchors + first-token latch) for sampled
    # requests, parsed from ``annotations.trace`` at engine admission; None
    # = untraced (the zero-cost path — every engine instrumentation point
    # is behind this check).
    trace: Any = None

    def __post_init__(self) -> None:
        if self.orig_prompt_len == 0:
            self.orig_prompt_len = len(self.prompt)

    @property
    def total_tokens(self) -> int:
        return len(self.prompt) + len(self.output)

    @property
    def num_output_tokens(self) -> int:
        """Generated tokens across preemptions (see orig_prompt_len)."""
        return self.total_tokens - self.orig_prompt_len

    @property
    def in_prefill(self) -> bool:
        # The final prompt token's forward pass produces the first output
        # token, so prefill is done once num_computed == len(prompt).
        return self.num_computed < len(self.prompt)

    @classmethod
    def from_request(
        cls, request_id: str, pre: PreprocessedRequest, cfg: EngineConfig
    ) -> "SequenceState":
        samp, stop = pre.sampling_options, pre.stop_conditions
        # Live-migration resume (llm/migration): the prompt is the original
        # prompt PLUS every token already emitted elsewhere; orig_prompt_len
        # restores the rng-stream position (sampler steps count from it) and
        # the stop/usage accounting, so the continued stream is
        # token-identical to the never-migrated run.
        resume = pre.annotations.get("resume") or {}
        orig_len = 0
        if isinstance(resume, dict):
            try:
                v = int(resume.get("orig_prompt_len", 0))
            except (TypeError, ValueError):
                v = 0
            if 0 < v <= len(pre.token_ids):
                orig_len = v
        # Tenant identity (llm/tenancy): the salt roots the block-hash
        # chain, so it must be fixed before the first block seals.
        kv_salt = pre.annotations.get("kv_salt") or None
        if kv_salt is not None and not isinstance(kv_salt, str):
            kv_salt = str(kv_salt)
        seq = cls(
            request_id=request_id,
            prompt=list(pre.token_ids),
            block_seq=TokenBlockSequence(block_size=cfg.block_size, salt=kv_salt),
            kv_salt=kv_salt,
            sampling_temperature=samp.temperature or 0.0,
            sampling_top_k=samp.top_k or 0,
            sampling_top_p=samp.top_p if samp.top_p is not None else 1.0,
            sampling_seed=(
                # Masked to uint32 either way: a user seed of -1 or 2**64
                # must not blow up the numpy cast in _sampling_arrays.
                samp.seed & 0xFFFFFFFF
                if samp.seed is not None
                # Engine-assigned deterministic default: stable per request
                # id (crc32 — not Python's salted hash), so replays
                # reproduce without a global stream.
                else (zlib.crc32(request_id.encode()) ^ cfg.seed) & 0xFFFFFFFF
            ),
            freq_penalty=samp.frequency_penalty or 0.0,
            pres_penalty=samp.presence_penalty or 0.0,
            logprobs=getattr(samp, "logprobs", None),
            max_new_tokens=stop.max_tokens,
            min_new_tokens=stop.min_tokens,
            stop_token_ids=frozenset(stop.stop_token_ids or ()),
            ignore_eos=bool(stop.ignore_eos),
            spec_enabled=getattr(samp, "spec_decode", None) is not False,
            orig_prompt_len=orig_len,
            # QoS identity: tenant keys the WFQ waiting queue,
            # priority picks the class band.  Both default benign — absent
            # fields reproduce the pre-QoS scheduler exactly.
            tenant=str(
                pre.annotations.get("tenant")
                or pre.annotations.get("adapter")
                or pre.model
                or ""
            ),
            priority=normalize_priority(
                pre.priority
                if pre.priority is not None
                else pre.annotations.get("priority")
            ),
        )
        spec = resume.get("spec") if isinstance(resume, dict) else None
        if isinstance(spec, dict):
            # Speculation controller state travels with the sequence — the
            # acceptance history is a property of the traffic, not of which
            # worker holds the KV (same rationale as surviving preemption).
            seq.spec_k = int(spec.get("k", seq.spec_k))
            seq.spec_ewma = float(spec.get("ewma", seq.spec_ewma))
            seq.spec_bench_until = int(spec.get("bench_until", seq.spec_bench_until))
            seq.spec_next_try = int(spec.get("next_try", seq.spec_next_try))
            seq.spec_miss = int(spec.get("miss", seq.spec_miss))
        return seq


class WfqQueue:
    """Weighted fair queue over (priority class, tenant) with FIFO per flow.

    Classic virtual-finish-time WFQ: each arriving sequence is stamped
    ``vft = max(V, last_vft[flow]) + cost / weight`` where ``V`` is the
    queue's virtual time (advanced to the departing head's vft on every
    pop), ``cost`` is the request's worst-case token work (prompt +
    generation budget) and ``weight`` the tenant's configured share.  The
    head is always the minimum-vft entry, so each backlogged tenant drains
    work in proportion to its weight regardless of arrival order or burst
    size.

    **Starvation bound** (the fairness contract tests assert): a backlogged
    tenant of weight ``w`` with head cost ``c`` is admitted after at most
    ``(W/w)·c`` token-work units of other tenants' admissions, where ``W``
    is the total weight of backlogged tenants — its head's vft is at most
    ``V + c/w``, and every competing admission advances ``V`` by at least
    ``cost/W``.  No request waits forever while the queue drains.

    **Priority classes**: interactive flows are served before batch flows,
    EXCEPT that after ``batch_every`` consecutive interactive admissions
    with batch backlogged, one batch admission is forced — so batch is
    starved by at most ``batch_every`` admissions, never indefinitely.

    **Urgent lane**: ``appendleft`` (preemption requeue) bypasses WFQ —
    a preempted sequence already earned its admission and re-enters first,
    preserving the pre-QoS recompute semantics.

    Single tenant + single class degenerates to exact FIFO (vft is
    monotone per flow), so existing single-tenant behaviour is unchanged.
    Duck-types the deque surface the scheduler/engine/migration layers use:
    ``[0]``, ``popleft``, ``append``, ``appendleft``, ``remove``, ``in``,
    ``len``, truthiness, iteration, ``clear``.
    """

    def __init__(
        self,
        tenant_weights: Optional[Dict[str, float]] = None,
        default_weight: float = 1.0,
        batch_every: int = 4,
    ):
        self.tenant_weights = dict(tenant_weights or {})
        self.default_weight = max(default_weight, 1e-9)
        self.batch_every = max(1, int(batch_every))
        self._urgent: Deque[SequenceState] = deque()
        # flow = (priority, tenant) → FIFO of seqs; vft rides on the seq.
        self._flows: Dict[Tuple[str, str], Deque[SequenceState]] = {}
        self._last_vft: Dict[Tuple[str, str], float] = {}
        self._vt = 0.0
        self._since_batch = 0

    # -- helpers -----------------------------------------------------------

    def _weight(self, tenant: str) -> float:
        return max(float(self.tenant_weights.get(tenant, self.default_weight)), 1e-9)

    @staticmethod
    def _cost(seq: SequenceState) -> float:
        # Worst-case token work: prompt prefill + generation budget.  add()
        # trims max_new_tokens before enqueue, so the budget is always set.
        return float(max(1, len(seq.prompt) + (seq.max_new_tokens or 0)))

    def _flow_head(self, priority: str) -> Optional[SequenceState]:
        """Min-vft head among ``priority``-class flows (tenant name breaks
        ties deterministically)."""
        best: Optional[SequenceState] = None
        best_key: Optional[Tuple[float, str]] = None
        for (prio, tenant), q in self._flows.items():
            if prio != priority or not q:
                continue
            key = (q[0]._wfq_vft, tenant)
            if best_key is None or key < best_key:
                best, best_key = q[0], key
        return best

    def _select(self) -> Optional[SequenceState]:
        """The next sequence WFQ would admit (pure — no counter updates)."""
        if self._urgent:
            return self._urgent[0]
        interactive = self._flow_head(INTERACTIVE)
        batch = self._flow_head(BATCH)
        if interactive is None:
            return batch
        if batch is not None and self._since_batch >= self.batch_every:
            return batch  # anti-starvation: batch head jumps the class gap
        return interactive

    # -- deque surface -----------------------------------------------------

    def append(self, seq: SequenceState) -> None:
        flow = (seq.priority, seq.tenant)
        vft = max(self._vt, self._last_vft.get(flow, 0.0)) + self._cost(
            seq
        ) / self._weight(seq.tenant)
        seq._wfq_vft = vft
        self._last_vft[flow] = vft
        self._flows.setdefault(flow, deque()).append(seq)

    def appendleft(self, seq: SequenceState) -> None:
        self._urgent.appendleft(seq)

    def popleft(self) -> SequenceState:
        seq = self._select()
        if seq is None:
            raise IndexError("pop from an empty WfqQueue")
        self._remove_entry(seq)
        # Virtual time advances to the ADMITTED head's finish time — the
        # WFQ invariant that keeps newly arriving flows from replaying
        # history.  Only real admissions advance it: a cancellation deep
        # in a backlogged flow (remove()) must not jump V to that flow's
        # far-future finish time, or every later arrival from OTHER
        # tenants would be stamped behind the whole backlog — exactly the
        # starvation WFQ exists to prevent.  Same for the batch counter:
        # only admissions count toward the anti-starvation window.
        self._vt = max(self._vt, getattr(seq, "_wfq_vft", self._vt))
        if seq.priority == BATCH:
            self._since_batch = 0
        elif self._flow_head(BATCH) is not None:
            self._since_batch += 1
        return seq

    def _remove_entry(self, seq: SequenceState) -> None:
        if seq in self._urgent:
            self._urgent.remove(seq)
            return
        flow = (seq.priority, seq.tenant)
        q = self._flows.get(flow)
        if q is None or seq not in q:
            raise ValueError("sequence not in WfqQueue")
        q.remove(seq)
        if not q:
            # Prune the flow's virtual-time memory with its queue: tenant
            # ids are wire-controlled, so _last_vft must not grow without
            # bound as tenants churn — and a flow whose whole backlog was
            # CANCELLED must not keep the cancelled tail's far-future
            # finish time as a penalty on its next genuine request.  (An
            # admission-drained flow's last_vft is <= the advanced V, so
            # deletion is a no-op semantically.)
            del self._flows[flow]
            self._last_vft.pop(flow, None)
        elif getattr(seq, "_wfq_vft", None) == self._last_vft.get(flow):
            # Cancelled the flow's TAIL: roll last_vft back to the new
            # tail (per-flow vfts are FIFO-monotone) so later arrivals
            # are not stamped behind cancelled, never-served work.
            self._last_vft[flow] = q[-1]._wfq_vft

    def remove(self, seq: SequenceState) -> None:
        """Drop a cancelled/aborted entry WITHOUT advancing virtual time
        or the batch admission counter (see popleft)."""
        self._remove_entry(seq)

    def clear(self) -> None:
        self._urgent.clear()
        self._flows.clear()
        self._last_vft.clear()
        self._since_batch = 0

    def __getitem__(self, index: int) -> SequenceState:
        if index != 0:
            raise IndexError("WfqQueue only exposes its head ([0])")
        seq = self._select()
        if seq is None:
            raise IndexError("WfqQueue is empty")
        return seq

    def __contains__(self, seq: SequenceState) -> bool:
        return seq in self._urgent or any(
            seq in q for q in self._flows.values()
        )

    def __len__(self) -> int:
        return len(self._urgent) + sum(len(q) for q in self._flows.values())

    def __bool__(self) -> bool:
        return len(self._urgent) > 0 or any(self._flows.values())

    def __iter__(self):
        yield from self._urgent
        for q in self._flows.values():
            yield from q


class RowSlots:
    """Row-slot free list for the continuous fused decode pipeline
    (engine/pipeline.py _decode_pipeline).

    The fused multi-step decode program is dispatched over ``max_batch``
    device rows.  Continuous batching keeps a persistent slot map: retiring
    a finished row frees its slot after the in-flight-write barrier (the
    retired sequence's KV blocks are released only once every dispatched
    chunk that could write them has been harvested), and a newly admitted
    sequence takes a free slot at the next chain-break merge.  The per-row
    ``pos0``/``tables``/``limits``/sampling arrays are all indexed by these
    slots.

    Retired slots pass through a PENDING state (``retire`` → barrier →
    ``free``) so a slot is never handed to a newcomer while an in-flight
    chunk could still write the old row's blocks; ``capacity_left`` counts
    pending slots as available because admission decisions happen strictly
    before the merge that would reuse them (by which point every barrier
    has passed).
    """

    def __init__(self, size: int):
        self.size = size
        self.rows: List[Optional[SequenceState]] = [None] * size
        # Pop from the end: lowest index first.
        self._free: List[int] = list(range(size - 1, -1, -1))
        self._pending: set = set()  # retired, awaiting the write barrier

    def assign(self, seq: SequenceState) -> int:
        i = self._free.pop()
        self.rows[i] = seq
        return i

    def retire(self, i: int) -> None:
        """Row finished/cancelled: excluded from future dispatches now,
        reusable only after ``free(i)`` (the caller's write barrier)."""
        self.rows[i] = None
        self._pending.add(i)

    def free(self, i: int) -> None:
        self._pending.discard(i)
        self._free.append(i)

    def active(self) -> List[Tuple[int, SequenceState]]:
        return [(i, s) for i, s in enumerate(self.rows) if s is not None]

    @property
    def num_active(self) -> int:
        return sum(1 for s in self.rows if s is not None)

    @property
    def capacity_left(self) -> int:
        return len(self._free) + len(self._pending)


@dataclass
class StepPlan:
    """One unified device step: per-row (state, start, n_tokens).

    Decode rows have n_tokens == 1; prefill rows carry their next prompt
    chunk.  ``pure_decode`` marks a steady state (every running sequence is
    decoding, nothing waiting) where the engine can switch to the fused
    multi-step decode pipeline instead of single unified steps.
    """

    items: List[Tuple[SequenceState, int, int]]
    pure_decode: bool = False


class Scheduler:
    def __init__(self, cfg: EngineConfig, kv: KvBlockManager):
        self.cfg = cfg
        self.kv = kv
        self.waiting: WfqQueue = WfqQueue(
            tenant_weights=cfg.qos.tenant_weights,
            default_weight=cfg.qos.default_weight,
            batch_every=cfg.qos.batch_every,
        )
        self.running: List[SequenceState] = []
        self.rejected: List[SequenceState] = []  # can never fit; engine fails them
        self.preempted = 0  # cumulative, for metrics
        # Cumulative mid-prefill requeues (preemption of a sequence whose
        # prompt was only partially computed).  The engine compares this
        # against its last-seen value each scheduling pass and resets the
        # mixed-phase chunk cadence (_chunks_since_burst): the requeued
        # sequence restarts chunking from zero, so a stale count would
        # skew the first decode burst after re-admission.
        self.prefill_requeues = 0
        # Queue->admission latencies (s), bounded; loadgen reads per level.
        self.admission_waits: Deque[float] = deque(maxlen=16384)

    # ------------------------------------------------------------------ entry
    def add(self, seq: SequenceState) -> None:
        # Trim the generation budget to the context limit rather than reject;
        # over-long prompts are rejected by the engine before reaching us.
        # The budget counts from the ORIGINAL prompt (orig_prompt_len ==
        # len(prompt) for fresh requests): a migrated resume folds emitted
        # tokens into the prompt, and trimming against the folded length
        # would silently shrink the remaining budget by the emitted count.
        room = self.cfg.max_model_len - seq.orig_prompt_len
        if seq.max_new_tokens is None or seq.max_new_tokens > room:
            seq.max_new_tokens = room
        seq.enqueue_t = time.perf_counter()
        self.waiting.append(seq)

    def _record_admission(self, seq: SequenceState) -> None:
        """Shared admission bookkeeping: the queue→admission latency sample
        plus, for traced requests, the ``engine.queue_wait`` span — the
        dominant TTFT-tail term at saturation (a newcomer waiting out a
        fused pure-decode session) attributable per request."""
        now = time.perf_counter()
        if seq.enqueue_t:
            self.admission_waits.append(now - seq.enqueue_t)
        st = seq.trace
        if st is not None:
            st.t_admit = now
            trace_collector.record(
                st.ctx, "engine.queue_wait", "engine",
                seq.enqueue_t or now, now,
                attrs={"request_id": seq.request_id},
            )

    def remove(self, seq: SequenceState) -> None:
        """Drop a sequence (finished or cancelled) and release its blocks."""
        if seq in self.running:
            self.running.remove(seq)
        elif seq in self.waiting:
            self.waiting.remove(seq)
        if seq.block_ids:
            self.kv.free_sequence(seq.block_ids)
            seq.block_ids = []
        self._release_pin(seq)

    def _release_pin(self, seq: SequenceState) -> None:
        if seq.pin_ids:
            self.kv.free_sequence(seq.pin_ids)
            seq.pin_ids = None

    # --------------------------------------------------------------- planning
    def _prompt_piece(self, seq: SequenceState, budget: int) -> int:
        """Prompt tokens ``seq`` computes in a step with ``budget`` left: as
        many as fit, or under ``batch_invariant`` its next whole
        ``prefill_chunk`` piece or none, so where a prompt is cut never
        depends on the step's other rows (a piece's attention is computed
        per piece)."""
        left = len(seq.prompt) - seq.num_computed
        if not self.cfg.batch_invariant:
            return min(budget, left)
        piece = min(self.cfg.prefill_chunk, left)
        return piece if piece <= budget else 0

    def schedule(self) -> Optional[StepPlan]:
        """Plan the next unified device step: decode tokens FIRST (every
        decoding sequence advances — no ITL starvation behind prefills), then
        prompt chunks fill the remaining token budget (chunked prefill mixed
        into the same step, vLLM-chunked-prefill style).  Returns None when
        nothing is runnable."""
        budget = self.cfg.prefill_chunk
        items: List[Tuple[SequenceState, int, int]] = []

        # Decode rows: one token per running decoded sequence.  On block
        # exhaustion preempt the YOUNGEST BATCH-class sequence if any (QoS:
        # batch rows are the degradation buffer), else the
        # youngest overall (vLLM recompute policy: protect older requests'
        # progress) and retry.  Victims must come from sequences NOT yet
        # scheduled this step: preempting one already in ``items`` would
        # leave a stale row whose blocks were freed (block_ids=[]) and
        # crash _build_ragged downstream.
        scheduled: set = set()
        for seq in [
            s
            for s in self.running
            if not s.in_prefill
            and not s.finished
            and not s.awaiting_fetch
            and not s.frozen
        ]:
            if seq not in self.running:
                continue  # preempted as a victim below
            ok = self._ensure_slot(seq)
            while not ok:
                # Rows parked on an in-flight token fetch are not victims:
                # preempting one would fold/rewind state the engine's
                # harvest is about to append a token to.  Frozen rows are
                # not victims either: preemption frees exactly the KV
                # blocks a migration is transferring.
                victims = [
                    s
                    for s in self.running
                    if s is not seq
                    and id(s) not in scheduled
                    and not s.awaiting_fetch
                    and not s.frozen
                ]
                if not victims:
                    break
                batch_victims = [s for s in victims if s.priority == BATCH]
                self._preempt((batch_victims or victims)[-1])
                ok = self._ensure_slot(seq)
            if not ok:
                # No unscheduled victim left: self-preempt and recompute later.
                self._preempt(seq)
                continue
            items.append((seq, seq.num_computed, 1))
            scheduled.add(id(seq))
            # Decode rows do NOT consume the prefill budget: the unified
            # step is sized for prefill_chunk + max_batch tokens
            # (config.max_step_tokens), so a full decode batch must never
            # starve prompt chunks — with max_batch > prefill_chunk it
            # would permanently block admission at saturation.

        # Prefill continuations (chunked prefill of already-running prompts).
        for seq in self.running:
            if budget <= 0 or len(items) >= self.cfg.max_batch:
                break
            if seq.in_prefill and not seq.finished and not seq.frozen:
                chunk = self._prompt_piece(seq, budget)
                if not chunk:
                    break
                items.append((seq, seq.num_computed, chunk))
                budget -= chunk

        # Admit newcomers while slots + blocks + budget allow.  Track
        # whether the waiting head is BLOCKED (slots/blocks full): waiting
        # requests that cannot land must not hold the fused decode pipeline
        # off — that inverts throughput exactly at saturation (conc 32 below
        # conc 16 in round 3), when the queue is never empty.
        admission_blocked = (
            bool(self.waiting) and len(self.running) >= self.cfg.max_batch
        )
        while budget > 0 and self.waiting and len(items) < self.cfg.max_batch:
            if len(self.running) >= self.cfg.max_batch:
                admission_blocked = True
                break
            seq = self.waiting[0]
            if self.cfg.batch_invariant and not self._prompt_piece(seq, budget):
                break  # its next whole piece waits for a step with room
            if seq.frozen:
                # A preempted sequence frozen mid-migration must not be
                # admitted and recomputed — a sampled token the snapshot
                # lacks would reach the client twice after the splice.
                # Freezes are sub-second; treat the head as blocked.
                admission_blocked = True
                break
            if not self._try_admit(seq):
                own_pins = len(seq.pin_ids or [])
                if (
                    not self.running
                    and self.kv.active_blocks <= own_pins
                    and not self._pressure_reserve()
                ):
                    # Pool entirely free (apart from this request's OWN
                    # pre-admission pin) and it still doesn't fit: this
                    # request can never run — reject instead of deadlocking.
                    # (Not under an armed kv_pressure squeeze: that pool is
                    # SYNTHETICALLY small and the right behaviour is to
                    # stall until the fault clears, exactly like waiting
                    # out a real tenant's HBM.)
                    self.waiting.popleft()
                    self._release_pin(seq)
                    self.rejected.append(seq)
                    continue
                admission_blocked = True
                break
            self.waiting.popleft()
            self.running.append(seq)
            self._record_admission(seq)
            # Admission always leaves >= 1 prompt token to compute (a fully
            # cached prompt still recomputes its last token for logits).
            chunk = self._prompt_piece(seq, budget)
            items.append((seq, seq.num_computed, chunk))
            budget -= chunk

        if not items:
            return None
        pure = (
            (not self.waiting or admission_blocked)
            and all(n == 1 for _, _, n in items)
            and not any(
                s.in_prefill and not s.frozen for s in self.running
            )
            # Grammar-constrained rows bar the fused multi-step programs:
            # their token mask advances host-side per accepted token, and a
            # fused chunk feeds sampled tokens forward ON DEVICE.  The
            # engine's mixed-phase path still bursts the unconstrained rows
            # (engine.py _run_loop).
            and not any(
                s.grammar is not None and not s.finished and not s.frozen
                for s in self.running
            )
        )
        return StepPlan(items, pure_decode=pure)

    def admission_ready(self) -> bool:
        """Non-destructive check: would the waiting head admit right now?
        The fused decode pipeline polls this between chunks — it keeps
        fusing while admission is impossible (slots/blocks full) and drains
        for a rebuild the moment a newcomer could actually land."""
        if not self.waiting:
            return False
        if len(self.running) >= self.cfg.max_batch:
            return False
        seq = self.waiting[0]
        if seq.frozen:
            return False  # mid-migration: schedule() will not admit it
        prompt_blocks = (len(seq.prompt) + self.cfg.block_size) // self.cfg.block_size
        reserve = self._pressure_reserve()
        if reserve and prompt_blocks + reserve > self.kv.free_blocks:
            return False  # squeezed pool: the head cannot land right now
        if prompt_blocks <= self.kv.free_blocks:
            return True  # fits even with zero prefix hits: skip the hashing
        # The fused pipeline polls this twice per chunk at saturation; the
        # prompt is immutable while waiting, so hash it once per sequence
        # (invalidate on preemption, which folds output into the prompt).
        cached = getattr(seq, "_admit_hash_cache", None)
        if cached is None or cached[0] != len(seq.prompt):
            from ..tokens import hash_token_blocks

            cached = (
                len(seq.prompt),
                hash_token_blocks(seq.prompt, self.cfg.block_size, seq.kv_salt),
            )
            seq._admit_hash_cache = cached
        return self.kv.would_fit(cached[1], prompt_blocks)

    def waiting_head_compatible(self) -> bool:
        """Can the waiting head join a running fused decode session via
        in-loop admission (engine/pipeline.py)?  Grammar-constrained rows
        cannot, and frozen (mid-migration) heads must not be admitted at
        all.  An incompatible-but-admissible head is the one remaining
        reason the continuous pipeline drains for a full scheduler
        rebuild."""
        if not self.waiting:
            return False
        seq = self.waiting[0]
        return not seq.frozen and seq.grammar is None

    def admit_continuous(self, limit: int) -> List[SequenceState]:
        """In-loop admission for the continuous fused decode pipeline: pop
        and admit up to ``limit`` compatible waiting heads (same WFQ order,
        same ``_try_admit`` block accounting and admission-wait metrics as
        ``schedule()``'s admission loop).  Stops at the first head that is
        incompatible, frozen, or doesn't fit; never rejects (the never-fits
        reject path needs an EMPTY engine to be provable, and mid-pipeline
        the batch is running)."""
        admitted: List[SequenceState] = []
        while limit > 0 and self.waiting and len(self.running) < self.cfg.max_batch:
            seq = self.waiting[0]
            if seq.frozen or seq.grammar is not None:
                break
            if not self._try_admit(seq):
                break
            self.waiting.popleft()
            self.running.append(seq)
            self._record_admission(seq)
            admitted.append(seq)
            limit -= 1
        return admitted

    def _pressure_reserve(self) -> int:
        """Blocks withheld from ADMISSION by the ``kv_pressure`` fault point
        (chaos ladder): a squeezed pool stalls newcomers — queue depth and
        TTFT rise exactly as they would when real tenants hold the HBM —
        without destabilizing already-running sequences."""
        from ..runtime.faultinject import faults

        if not faults.enabled:
            return 0
        level = faults.level_for("kv_pressure")
        if level <= 0:
            return 0
        return int(self.kv.num_blocks * min(level, 1.0))

    def _try_admit(self, seq: SequenceState) -> bool:
        """Allocate prompt blocks (sharing any cached prefix)."""
        prompt_blocks = (len(seq.prompt) + self.cfg.block_size) // self.cfg.block_size
        # ^ +1 slack block so the first decode token always has a slot.
        reserve = self._pressure_reserve()
        if reserve and prompt_blocks + reserve > self.kv.free_blocks:
            return False  # kv_pressure fault: pool squeezed, head waits
        seq.block_seq.extend(seq.prompt)
        alloc = self.kv.allocate_sequence(seq.block_seq.blocks, prompt_blocks)
        if alloc is None:
            seq.block_seq = TokenBlockSequence(
                block_size=self.cfg.block_size, salt=seq.kv_salt
            )
            return False
        seq.block_ids, cached_tokens = alloc
        # Admission holds its own references now; the pre-admission pin
        # (sp-prefill / host-restore) has done its job.
        self._release_pin(seq)
        # A fully-cached prompt must still recompute its last token to get
        # logits for sampling the first output token.
        if cached_tokens >= len(seq.prompt):
            cached_tokens = len(seq.prompt) - 1
        seq.num_computed = cached_tokens
        seq.num_cached_prompt = cached_tokens
        seq.num_sealed_blocks = cached_tokens // self.cfg.block_size
        return True

    def _ensure_slot(self, seq: SequenceState, lookahead: int = 1) -> bool:
        """Allocate KV blocks so ``lookahead`` tokens past num_computed have
        slots (the decode pipeline asks for its whole in-flight window; the
        device-side `limits` guard keeps steps past the allocation from
        writing)."""
        needed_blocks = min(
            (seq.num_computed + lookahead + self.cfg.block_size - 1)
            // self.cfg.block_size,
            self.cfg.max_blocks_per_seq,
        )
        while len(seq.block_ids) < needed_blocks:
            bid = self.kv.allocate_block()
            if bid is None:
                return False
            seq.block_ids.append(bid)
        return True

    def _preempt(self, seq: SequenceState) -> None:
        """Recompute-style preemption: free blocks, rewind to waiting."""
        self.running.remove(seq)
        self.kv.free_sequence(seq.block_ids)
        seq.block_ids = []
        # Mid-prefill must be detected BEFORE the fold below: folding sets
        # num_computed = 0, after which EVERY preempted sequence looks
        # mid-prefill.
        if seq.in_prefill:
            self.prefill_requeues += 1
        # Fold generated tokens into the prompt so recompute resumes exactly.
        seq.prompt = seq.prompt + seq.output
        seq.output = []
        seq.num_computed = 0
        seq.num_sealed_blocks = 0
        seq.block_seq = TokenBlockSequence(
            block_size=self.cfg.block_size, salt=seq.kv_salt
        )
        # Wait-since-preemption: without this reset, re-admission would
        # record the span since the ORIGINAL enqueue — including time the
        # request spent RUNNING — inflating admission_waits exactly in the
        # KV-pressure regime the metric exists to attribute.
        seq.enqueue_t = time.perf_counter()
        self.waiting.appendleft(seq)
        self.preempted += 1

    def take_rejected(self) -> List[SequenceState]:
        out, self.rejected = self.rejected, []
        return out

    # ---------------------------------------------------------------- metrics
    @property
    def num_waiting(self) -> int:
        return len(self.waiting)

    @property
    def num_running(self) -> int:
        return len(self.running)

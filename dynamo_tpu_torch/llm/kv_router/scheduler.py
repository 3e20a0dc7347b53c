"""KV-aware worker selection (the router's cost function).  A copy of the
JAX package's ``llm/kv_router/scheduler.py``.

Reference semantics: lib/llm/src/kv_router/scheduler.rs:236-340 —
``DefaultWorkerSelector``:

    score  = overlap_blocks * block_size / isl_tokens        (prefix hit ratio)
    logit  = 2*score − cache_usage − active_slots/total_slots
    winner = argmax(logit), random tie-break

plus a ``KVHitRateEvent`` published per decision so dashboards/metrics can
track fleet-wide prefix-hit quality.  ``WorkerSelector`` is pluggable
(components/router custom-selector example, src/main.rs:56-95).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Protocol

from .indexer import OverlapScores, WorkerId
from .protocols import ForwardPassMetrics

KV_HIT_RATE_SUBJECT = "kv-hit-rate"


@dataclass(frozen=True)
class KVHitRateEvent:
    worker_id: WorkerId
    isl_blocks: int
    overlap_blocks: int

    def to_dict(self) -> Dict:
        return {
            "worker_id": self.worker_id,
            "isl_blocks": self.isl_blocks,
            "overlap_blocks": self.overlap_blocks,
        }


@dataclass
class WorkerSnapshot:
    """A worker's latest ForwardPassMetrics plus identity."""

    worker_id: WorkerId
    metrics: ForwardPassMetrics = field(default_factory=ForwardPassMetrics)


@dataclass
class SchedulingRequest:
    isl_tokens: int
    overlap: OverlapScores
    workers: List[WorkerSnapshot]
    block_size: int


class WorkerSelector(Protocol):
    def select(self, request: SchedulingRequest) -> Optional[WorkerId]: ...


class DefaultWorkerSelector:
    """The reference cost function (scheduler.rs:236-340)."""

    def __init__(self, rng: Optional[random.Random] = None):
        # Seeded by default: tie-breaks must replay identically run-to-run
        # (router decisions feed the sim/replay planes); callers that want
        # spread pass their own generator.
        self._rng = rng or random.Random(0)

    def select(self, request: SchedulingRequest) -> Optional[WorkerId]:
        if not request.workers:
            return None
        best_logit: Optional[float] = None
        best: List[WorkerId] = []
        for snap in request.workers:
            m = snap.metrics
            # Tier-discounted overlap (indexer.OverlapScores): a block
            # restorable only from host/disk contributes less than a live
            # HBM block, so a deep-but-cold prefix loses to a
            # shallow-but-hot one DETERMINISTICALLY (distinct tier weights
            # break what used to be an exact tie).  Raw block counts are
            # still what KVHitRateEvents report.
            eff_blocks = request.overlap.discounted_for(snap.worker_id)
            score = (
                eff_blocks * request.block_size / request.isl_tokens
                if request.isl_tokens
                else 0.0
            )
            slots = (
                m.request_active_slots / m.request_total_slots
                if m.request_total_slots
                else 0.0
            )
            logit = 2.0 * score - m.gpu_cache_usage_perc - slots
            if best_logit is None or logit > best_logit + 1e-12:
                best_logit, best = logit, [snap.worker_id]
            elif abs(logit - best_logit) <= 1e-12:
                best.append(snap.worker_id)
        return self._rng.choice(best)


class KvScheduler:
    """Applies a selector and reports hit-rate events via a callback."""

    def __init__(
        self,
        block_size: int,
        selector: Optional[WorkerSelector] = None,
        hit_rate_callback: Optional[Callable[[KVHitRateEvent], None]] = None,
    ):
        self.block_size = block_size
        self.selector = selector or DefaultWorkerSelector()
        self._hit_rate_callback = hit_rate_callback

    def schedule(
        self,
        isl_tokens: int,
        overlap: OverlapScores,
        workers: List[WorkerSnapshot],
    ) -> Optional[WorkerId]:
        request = SchedulingRequest(
            isl_tokens=isl_tokens,
            overlap=overlap,
            workers=workers,
            block_size=self.block_size,
        )
        winner = self.selector.select(request)
        if winner is not None and self._hit_rate_callback is not None:
            self._hit_rate_callback(
                KVHitRateEvent(
                    worker_id=winner,
                    isl_blocks=isl_tokens // self.block_size,
                    overlap_blocks=overlap.scores.get(winner, 0),
                )
            )
        return winner

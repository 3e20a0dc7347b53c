"""Planner signal plane: windowed, per-pool views of the metrics topics.  A
copy of the JAX package's ``planner/signals.py``.

``SignalCollector`` consumes the same namespace subjects as
``MetricsAggregatorService`` (llm/metrics_service.py) — per-worker
``ForwardPassMetrics`` on ``kv_metrics`` and router hit-rate events on
``kv-hit-rate`` — plus edge-reported TTFT/ITL percentiles published by the
HTTP frontend (``slo_metrics``), and maintains per-pool views with
staleness eviction: a worker that stops publishing (or whose discovery
registration disappears) drops out of the pool view instead of pinning the
planner's picture of the fleet forever.

``StalenessTracker`` is the shared eviction primitive — the metrics
aggregator reuses it so its ``/metrics`` rows stop leaking dead workers
(the pre-planner bug: ``_metrics`` rows outlived discovery forever).
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from ..llm.kv_router.protocols import ForwardPassMetrics
from ..llm.kv_router.publisher import KV_METRICS_TOPIC, unpack_message
from ..llm.kv_router.scheduler import KV_HIT_RATE_SUBJECT
from ..runtime.component import INSTANCE_PREFIX, instance_prefix
from ..runtime.health import QUARANTINE_PREFIX, worker_latency

logger = logging.getLogger(__name__)

# Namespace subject the HTTP edge publishes rolling TTFT/ITL percentiles on
# (llm/metrics.py EdgeSloPublisher → planner).
SLO_METRICS_TOPIC = "slo_metrics"


def percentile(xs: List[float], p: float) -> float:
    """Nearest-rank percentile (shared by the sim and collectors)."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * p))]


class StalenessTracker:
    """Dict of key → value where every entry carries a last-update stamp
    and expires ``ttl_s`` after its last put (None = never).

    Iteration (`items()`/`values()`) evicts expired entries first, so a
    consumer that only ever reads still converges — no background task
    required.  The clock is injectable for deterministic tests.
    """

    def __init__(
        self,
        ttl_s: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.ttl_s = ttl_s
        self._clock = clock
        self._data: Dict[Any, Tuple[Any, float]] = {}

    def put(self, key: Any, value: Any) -> None:
        self._data[key] = (value, self._clock())

    def get(self, key: Any, default: Any = None) -> Any:
        entry = self._data.get(key)
        if entry is None:
            return default
        if self.ttl_s is not None and self._clock() - entry[1] > self.ttl_s:
            self._data.pop(key, None)
            return default
        return entry[0]

    def pop(self, key: Any, default: Any = None) -> Any:
        entry = self._data.pop(key, None)
        return default if entry is None else entry[0]

    def age(self, key: Any) -> Optional[float]:
        entry = self._data.get(key)
        return None if entry is None else self._clock() - entry[1]

    def evict_stale(self) -> List[Any]:
        """Drop entries older than ttl; returns the evicted keys."""
        if self.ttl_s is None:
            return []
        now = self._clock()
        dead = [k for k, (_, t) in self._data.items() if now - t > self.ttl_s]
        for k in dead:
            del self._data[k]
        return dead

    def items(self) -> Iterator[Tuple[Any, Any]]:
        self.evict_stale()
        for k, (v, _) in list(self._data.items()):
            yield k, v

    def values(self) -> Iterator[Any]:
        for _, v in self.items():
            yield v

    def keys(self) -> Iterator[Any]:
        for k, _ in self.items():
            yield k

    def __contains__(self, key: Any) -> bool:
        return self.get(key, _MISSING) is not _MISSING

    def __len__(self) -> int:
        self.evict_stale()
        return len(self._data)


_MISSING = object()


# ---------------------------------------------------------------- snapshots


@dataclass
class PoolStats:
    """Aggregated view over one worker pool (prefill or decode)."""

    workers: Tuple[int, ...] = ()
    queue_depth: int = 0  # requests waiting at the workers
    active_slots: int = 0
    total_slots: int = 0
    kv_usage: float = 0.0  # mean KV cache usage fraction
    per_worker_load: Dict[int, float] = field(default_factory=dict)

    @property
    def size(self) -> int:
        return len(self.workers)

    def coldest_worker(self) -> Optional[int]:
        """Deterministic flip victim: lowest load, ties to lowest id."""
        if not self.workers:
            return None
        return min(
            self.workers,
            key=lambda w: (self.per_worker_load.get(w, 0.0), w),
        )


@dataclass
class SignalSnapshot:
    """One planner tick's input — everything the policy may read."""

    t: float = 0.0
    pools: Dict[str, PoolStats] = field(default_factory=dict)
    ttft_p95_ms: Optional[float] = None
    itl_p95_ms: Optional[float] = None
    ttft_p50_ms: Optional[float] = None
    itl_p50_ms: Optional[float] = None
    prefill_queue_depth: int = 0
    hit_isl_blocks: int = 0
    hit_overlap_blocks: int = 0
    # Worst brownout rung any live edge reports (llm/qos.py ladder): >0
    # means latency/queue signals are already brownout-suppressed — a
    # scale-down policy must not read that suppression as idle capacity.
    edge_brownout_rung: int = 0
    # Mean engine prefix-cache hit rate across live edges' kv_tier
    # publications (docs/kv_tiering.md), or None when no edge publishes
    # tier gauges.  A sagging fleet hit rate with tiered capacity free is
    # the planner's cue to warm prefixes (kv_prefetch) before scaling.
    fleet_prefix_hit_rate: Optional[float] = None
    # Measured per-hop restore/pull percentiles (ms) from the colocated
    # engine's kv_tier windows, worst-merged across live edges — keys like
    # ``restore_p95_ms``/``pull_p95_ms``.  The autopilot's measured-latency
    # routing EWMAs these into live tier weights (docs/autopilot.md);
    # None until an edge has observed at least one restore.
    restore_pct: Optional[Dict[str, float]] = None
    # Fused-decode host-gap fraction (engine dispatch_summary
    # ``host_gap_frac``), worst-merged across edges: sustained drift out
    # of band is the autopilot's tune_decode trigger.  None when no edge
    # colocates an engine.
    host_gap: Optional[float] = None

    def pool(self, name: str) -> PoolStats:
        return self.pools.get(name) or PoolStats()

    def to_dict(self) -> Dict[str, Any]:
        """Wire form (dry-run transcripts, /state, replay fixtures).
        Optional signals are omitted when absent — consumers must d.get()
        them (the established omit-when-absent idiom)."""
        d: Dict[str, Any] = {
            "t": self.t,
            "pools": {
                name: {
                    "workers": list(p.workers),
                    "queue_depth": p.queue_depth,
                    "active_slots": p.active_slots,
                    "total_slots": p.total_slots,
                    "kv_usage": p.kv_usage,
                    "per_worker_load": {
                        str(w): v for w, v in p.per_worker_load.items()
                    },
                }
                for name, p in self.pools.items()
            },
            "prefill_queue_depth": self.prefill_queue_depth,
            "hit_isl_blocks": self.hit_isl_blocks,
            "hit_overlap_blocks": self.hit_overlap_blocks,
            "edge_brownout_rung": self.edge_brownout_rung,
        }
        if self.ttft_p95_ms is not None:
            d["ttft_p95_ms"] = self.ttft_p95_ms
        if self.itl_p95_ms is not None:
            d["itl_p95_ms"] = self.itl_p95_ms
        if self.ttft_p50_ms is not None:
            d["ttft_p50_ms"] = self.ttft_p50_ms
        if self.itl_p50_ms is not None:
            d["itl_p50_ms"] = self.itl_p50_ms
        if self.fleet_prefix_hit_rate is not None:
            d["fleet_prefix_hit_rate"] = self.fleet_prefix_hit_rate
        if self.restore_pct is not None:
            d["restore_pct"] = dict(self.restore_pct)
        if self.host_gap is not None:
            d["host_gap"] = self.host_gap
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SignalSnapshot":
        pools = {
            name: PoolStats(
                workers=tuple(p.get("workers", ())),
                queue_depth=int(p.get("queue_depth", 0)),
                active_slots=int(p.get("active_slots", 0)),
                total_slots=int(p.get("total_slots", 0)),
                kv_usage=float(p.get("kv_usage", 0.0)),
                per_worker_load={
                    int(w): float(v)
                    for w, v in (p.get("per_worker_load") or {}).items()
                },
            )
            for name, p in (d.get("pools") or {}).items()
        }
        return cls(
            t=float(d.get("t", 0.0)),
            pools=pools,
            ttft_p95_ms=d.get("ttft_p95_ms"),
            itl_p95_ms=d.get("itl_p95_ms"),
            ttft_p50_ms=d.get("ttft_p50_ms"),
            itl_p50_ms=d.get("itl_p50_ms"),
            prefill_queue_depth=int(d.get("prefill_queue_depth", 0)),
            hit_isl_blocks=int(d.get("hit_isl_blocks", 0)),
            hit_overlap_blocks=int(d.get("hit_overlap_blocks", 0)),
            edge_brownout_rung=int(d.get("edge_brownout_rung", 0)),
            fleet_prefix_hit_rate=d.get("fleet_prefix_hit_rate"),
            restore_pct=d.get("restore_pct"),
            host_gap=d.get("host_gap"),
        )


def pool_stats(per_worker: Dict[int, ForwardPassMetrics]) -> PoolStats:
    """Fold per-worker ForwardPassMetrics into one PoolStats."""
    loads = {
        w: (m.request_active_slots / m.request_total_slots)
        if m.request_total_slots
        else 0.0
        for w, m in per_worker.items()
    }
    usages = [m.gpu_cache_usage_perc for m in per_worker.values()]
    return PoolStats(
        workers=tuple(sorted(per_worker)),
        queue_depth=sum(m.num_requests_waiting for m in per_worker.values()),
        active_slots=sum(m.request_active_slots for m in per_worker.values()),
        total_slots=sum(m.request_total_slots for m in per_worker.values()),
        kv_usage=sum(usages) / len(usages) if usages else 0.0,
        per_worker_load=loads,
    )


def classify_instance(key: str, info: Any) -> Optional[Tuple[int, str]]:
    """``instances/{ns}/{comp}/{ep}/{worker_id}`` → (worker_id, pool).

    Pool = the registration's ``metadata.role`` when present, else the
    endpoint name when it names a disagg role, else ``decode`` (an
    aggregated worker serves both phases; the decode pool is the
    conservative bucket for its KV/slot signals).
    """
    parts = key.split("/")
    if len(parts) != 5 or parts[0] != INSTANCE_PREFIX:
        return None
    try:
        worker_id = int(parts[4])
    except ValueError:
        return None
    role = None
    if isinstance(info, dict):
        role = (info.get("metadata") or {}).get("role")
    if not role:
        ep = parts[3]
        role = ep if ep in ("prefill", "decode") else "decode"
    return worker_id, role


# ---------------------------------------------------------------- collector


class SignalCollector:
    """Consume metrics/hit-rate/SLO topics into per-pool windowed views.

    Construction wants the namespace-scoped ``component`` whose workers
    publish (same as MetricsAggregatorService).  ``snapshot()`` is cheap
    and side-effect free apart from staleness eviction and (optionally)
    one hub queue-depth probe.
    """

    def __init__(
        self,
        component,
        model: Optional[str] = None,
        stale_after_s: float = 10.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.component = component
        self.model = model
        self._clock = clock
        # worker_id → ForwardPassMetrics, TTL-evicted (same tracker the
        # metrics aggregator uses).
        self._metrics = StalenessTracker(ttl_s=stale_after_s, clock=clock)
        # edge id → slo snapshot dict
        self._edges = StalenessTracker(ttl_s=stale_after_s, clock=clock)
        # worker_id → pool name, maintained from the discovery watch; no
        # TTL (instance-gone events delete rows — lease expiry IS the
        # liveness signal here, exactly like every other watcher).
        self._pool_of: Dict[int, str] = {}
        # Watchdog quarantine view (runtime/health.py): quarantined workers
        # are excluded from the pool stats so the planner never counts a
        # draining straggler as usable capacity.
        self._quarantined: set = set()
        self._hit_isl = 0
        self._hit_overlap = 0
        self._tasks: List[asyncio.Task] = []
        self._subs: List[Any] = []
        self._watcher = None
        self._q_watcher = None

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> "SignalCollector":
        loop = asyncio.get_running_loop()
        m_sub = await self.component.subscribe(KV_METRICS_TOPIC)
        h_sub = await self.component.subscribe(KV_HIT_RATE_SUBJECT)
        e_sub = await self.component.namespace.subscribe(SLO_METRICS_TOPIC)
        self._subs = [m_sub, h_sub, e_sub]
        ns = self.component.namespace.name
        hub = self.component.runtime.hub
        self._watcher = await hub.watch_prefix(instance_prefix(ns))
        self._q_watcher = await hub.watch_prefix(QUARANTINE_PREFIX)
        self._tasks = [
            loop.create_task(self._consume_metrics(m_sub)),
            loop.create_task(self._consume_hit_rate(h_sub)),
            loop.create_task(self._consume_edges(e_sub)),
            loop.create_task(self._consume_instances()),
            loop.create_task(self._consume_quarantine()),
        ]
        await self._watcher.synced.wait()
        return self

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except asyncio.CancelledError:
                pass
        self._tasks = []
        for sub in self._subs:
            if hasattr(sub, "aclose"):
                await sub.aclose()
        self._subs = []
        for attr in ("_watcher", "_q_watcher"):
            w = getattr(self, attr)
            if w is not None:
                await w.aclose()
                setattr(self, attr, None)

    # -- consumers ---------------------------------------------------------

    async def _consume_metrics(self, sub) -> None:
        try:
            async for msg in sub:
                payload = unpack_message(msg)
                try:
                    self._metrics.put(
                        payload["worker_id"],
                        ForwardPassMetrics.from_dict(payload["metrics"]),
                    )
                except (KeyError, TypeError):
                    logger.warning("malformed kv_metrics payload: %r", payload)
        except asyncio.CancelledError:
            pass

    async def _consume_hit_rate(self, sub) -> None:
        try:
            async for msg in sub:
                payload = unpack_message(msg)
                try:
                    self._hit_isl += payload["isl_blocks"]
                    self._hit_overlap += payload["overlap_blocks"]
                except (KeyError, TypeError):
                    pass
        except asyncio.CancelledError:
            pass

    async def _consume_edges(self, sub) -> None:
        try:
            async for msg in sub:
                payload = unpack_message(msg)
                if isinstance(payload, dict) and "edge_id" in payload:
                    self._edges.put(payload["edge_id"], payload)
        except asyncio.CancelledError:
            pass

    async def _watch_consume(self, attr: str, prefix: str, on_event, on_resync) -> None:
        """Shared watch-consume loop with hub-restart recovery: a dead
        watcher (e.g. ``HubSessionLost`` after a hub crash) is re-armed and
        the derived state fully resynced from a fresh snapshot — deletes
        missed during the outage must not leave phantom state (the same
        recovery shape as the routed Client's instance watch)."""
        hub = self.component.runtime.hub
        backoff = 0.1
        while True:
            try:
                async for event in getattr(self, attr):
                    backoff = 0.1
                    on_event(event)
                return  # closed cleanly (collector shutdown)
            except asyncio.CancelledError:
                return
            except Exception:  # noqa: BLE001 — re-arm below
                logger.warning(
                    "planner watch %r died; re-arming", prefix, exc_info=True
                )
            while True:
                try:
                    await asyncio.sleep(backoff)
                    backoff = min(backoff * 2, 5.0)
                    old = getattr(self, attr)
                    setattr(self, attr, None)
                    if old is not None:
                        try:
                            await old.aclose()
                        except asyncio.CancelledError:
                            raise
                        except Exception:  # noqa: BLE001 — dead watcher
                            pass
                    setattr(self, attr, await hub.watch_prefix(prefix))
                    on_resync(await hub.kv_get_prefix(prefix))
                    break
                except asyncio.CancelledError:
                    return
                except Exception:  # noqa: BLE001 — hub still down
                    logger.warning(
                        "planner watch %r re-arm failed; retrying", prefix
                    )

    # instance watch: pool membership
    def _apply_instance_event(self, event) -> None:
        parsed = classify_instance(event.key, event.value)
        if parsed is None:
            return
        worker_id, pool = parsed
        if event.type == "put":
            self._pool_of[worker_id] = pool
        else:  # lease expiry / deregistration: worker is GONE
            self._pool_of.pop(worker_id, None)
            self._metrics.pop(worker_id)

    def _resync_instances(self, snapshot: Dict[str, Any]) -> None:
        fresh: Dict[int, str] = {}
        for key, value in snapshot.items():
            parsed = classify_instance(key, value)
            if parsed is not None:
                fresh[parsed[0]] = parsed[1]
        for wid in set(self._pool_of) - set(fresh):
            self._metrics.pop(wid)
        self._pool_of = fresh

    async def _consume_instances(self) -> None:
        ns = self.component.namespace.name
        await self._watch_consume(
            "_watcher",
            instance_prefix(ns),
            self._apply_instance_event,
            self._resync_instances,
        )

    # quarantine watch: watchdog markers → pool-view exclusion
    def _apply_quarantine_event(self, event) -> None:
        try:
            wid = int(event.key[len(QUARANTINE_PREFIX):])
        except ValueError:
            return
        if event.type == "put":
            self._quarantined.add(wid)
        else:
            self._quarantined.discard(wid)

    def _resync_quarantine(self, snapshot: Dict[str, Any]) -> None:
        fresh = set()
        for key in snapshot:
            try:
                fresh.add(int(key[len(QUARANTINE_PREFIX):]))
            except ValueError:
                continue
        self._quarantined = fresh

    async def _consume_quarantine(self) -> None:
        await self._watch_consume(
            "_q_watcher",
            QUARANTINE_PREFIX,
            self._apply_quarantine_event,
            self._resync_quarantine,
        )

    # -- views -------------------------------------------------------------

    def evict_worker(self, worker_id: int) -> None:
        self._pool_of.pop(worker_id, None)
        self._metrics.pop(worker_id)

    def _edge_percentile(self, key: str) -> Optional[float]:
        """Merge the live edges' windows: worst (max) fresh percentile —
        the conservative read when several frontends report."""
        vals = [
            e[key]
            for e in self._edges.values()
            if isinstance(e.get(key), (int, float))
        ]
        return max(vals) if vals else None

    def _edge_mean(self, key: str) -> Optional[float]:
        """Mean of a fresh edge-published scalar (rates, not latencies —
        the representative read, unlike the worst-case percentile merge)."""
        vals = [
            e[key]
            for e in self._edges.values()
            if isinstance(e.get(key), (int, float))
        ]
        return sum(vals) / len(vals) if vals else None

    def worker_slo_view(self) -> Dict[int, Dict[str, Any]]:
        """Merged per-worker TTFT/ITL view from the live edges' slo_metrics
        publications (``workers`` key) — a planner-side HealthWatchdog's
        ``latency_source`` when it does not share a process with the
        routed client."""
        merged: Dict[int, Dict[str, Any]] = {}
        for edge in self._edges.values():
            for wid, row in (edge.get("workers") or {}).items():
                try:
                    wid = int(wid)
                except (TypeError, ValueError):
                    continue
                prev = merged.get(wid)
                if prev is None or row.get("n", 0) > prev.get("n", 0):
                    merged[wid] = row
        return merged

    async def snapshot(self) -> SignalSnapshot:
        by_pool: Dict[str, Dict[int, ForwardPassMetrics]] = {}
        for worker_id, m in self._metrics.items():
            if worker_id in self._quarantined:
                continue  # draining under watchdog quarantine: not capacity
            pool = self._pool_of.get(worker_id, "decode")
            by_pool.setdefault(pool, {})[worker_id] = m
        # Discovery-known workers that have not published metrics yet still
        # count toward pool SIZE (a just-scaled-up worker must not read as
        # "pool shrank" while it warms up).
        for worker_id, pool in self._pool_of.items():
            if worker_id in self._quarantined:
                continue
            by_pool.setdefault(pool, {}).setdefault(
                worker_id, ForwardPassMetrics()
            )
        queue_depth = 0
        if self.model is not None:
            from ..llm.disagg.prefill_queue import (  # lazy: llm imports planner
                prefill_queue_name,
            )
            try:
                queue_depth = await self.component.runtime.hub.q_len(
                    prefill_queue_name(self.model)
                )
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — hub hiccup: signal degrades
                logger.warning("prefill queue depth probe failed")
        return SignalSnapshot(
            t=self._clock(),
            pools={p: pool_stats(w) for p, w in by_pool.items()},
            ttft_p95_ms=self._edge_percentile("ttft_p95_ms"),
            itl_p95_ms=self._edge_percentile("itl_p95_ms"),
            ttft_p50_ms=self._edge_percentile("ttft_p50_ms"),
            itl_p50_ms=self._edge_percentile("itl_p50_ms"),
            prefill_queue_depth=queue_depth,
            hit_isl_blocks=self._hit_isl,
            hit_overlap_blocks=self._hit_overlap,
            edge_brownout_rung=int(
                self._edge_percentile("brownout_rung") or 0
            ),
            fleet_prefix_hit_rate=self._edge_mean("prefix_hit_rate"),
            restore_pct=self._edge_restore_pct(),
            host_gap=self._edge_percentile("host_gap"),
        )

    def _edge_restore_pct(self) -> Optional[Dict[str, float]]:
        """Worst-merge (per key) the edges' measured restore/pull
        percentile dicts — the conservative read, matching the latency
        percentile merge above.  None until some edge publishes one."""
        merged: Dict[str, float] = {}
        for e in self._edges.values():
            pct = e.get("restore_pct")
            if not isinstance(pct, dict):
                continue
            for k, v in pct.items():
                if isinstance(v, (int, float)):
                    merged[k] = max(merged.get(k, float("-inf")), float(v))
        return merged or None


class EdgeSloPublisher:
    """HTTP-frontend side: periodically publish the edge's rolling
    TTFT/ITL percentiles (llm/metrics.py windows) on the namespace's
    ``slo_metrics`` subject — the planner's SLO input."""

    def __init__(
        self,
        namespace,
        metrics,
        edge_id: Optional[str] = None,
        interval: float = 2.0,
        qos=None,
    ):
        self.namespace = namespace
        self.metrics = metrics
        self.edge_id = edge_id or f"edge-{id(self):x}"
        self.interval = interval
        # Optional QosController (llm/qos.py): when the edge runs the
        # brownout ladder its current rung rides the publication, so the
        # planner can tell "latency is fine because the edge is already
        # degrading service" from "latency is fine" — scale-down decisions
        # should not read brownout-suppressed load as idle capacity.
        self.qos = qos
        self._task: Optional[asyncio.Task] = None

    async def start(self) -> "EdgeSloPublisher":
        self._task = asyncio.get_running_loop().create_task(self._run())
        return self

    async def publish_once(self) -> None:
        snap = self.metrics.edge_slo_snapshot()
        snap["edge_id"] = self.edge_id
        if self.qos is not None and self.qos.ladder is not None:
            snap["brownout_rung"] = self.qos.rung
        # Tiered-KV view (docs/kv_tiering.md): when an engine is colocated
        # (kv_tier_metrics source wired), the fleet's prefix-hit rate rides
        # the SLO publication so the planner can distinguish "TTFT is high
        # because prefixes run cold" from "TTFT is high because we're out
        # of compute".
        from ..llm.metrics import kv_tier_metrics

        tier = kv_tier_metrics.tier_summary()
        if tier:
            snap["prefix_hit_rate"] = float(tier.get("prefix_hit_rate", 0.0))
            snap["kv_tier"] = {
                t: dict(tier[t])
                for t in ("hbm", "host", "disk", "objstore")
                if t in tier
            }
        # Measured restore/pull percentiles + fused-decode host gap ride
        # the same publication (the autopilot's measured-latency routing
        # and tune_decode inputs) — omitted when nothing was measured, per
        # the wire idiom.
        restore_pct: Dict[str, float] = {}
        for name, window in (
            ("restore", kv_tier_metrics.restore_latency_ms),
            ("pull", kv_tier_metrics.pull_latency_ms),
        ):
            if len(window):
                restore_pct[f"{name}_p50_ms"] = round(window.percentile(0.5), 3)
                restore_pct[f"{name}_p95_ms"] = round(window.percentile(0.95), 3)
        if restore_pct:
            snap["restore_pct"] = restore_pct
        from ..llm.metrics import engine_dispatch_metrics

        gap = engine_dispatch_metrics.host_gap_frac()
        if gap is not None:
            snap["host_gap"] = gap
        # Per-worker TTFT/ITL p50s observed by this edge's routed clients
        # (runtime/health.py): the planner-side watchdog's straggler feed.
        workers = worker_latency.snapshot()
        if workers:
            snap["workers"] = {str(wid): row for wid, row in workers.items()}
        await self.namespace.publish(SLO_METRICS_TOPIC, snap)

    async def _run(self) -> None:
        while True:
            try:
                await self.publish_once()
            except asyncio.CancelledError:
                return
            except Exception:  # noqa: BLE001 — transient hub hiccup: the
                # feed must survive it (a dead publisher silently disables
                # SLO-driven scaling for the life of the frontend).
                logger.warning("edge SLO publish failed; retrying", exc_info=True)
            try:
                await asyncio.sleep(self.interval)
            except asyncio.CancelledError:
                return

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

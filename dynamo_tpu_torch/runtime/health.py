"""Health watchdog: probes, straggler detection, quarantine → drain → eject.

A copy of the JAX package's ``runtime/health.py``.

The lease plane answers "is the process alive?"; the request-resilience
layer answers "did THIS request survive?".  Neither catches the fleet's
worst citizen: the worker that is alive enough to keep its lease but sick
enough to drag every stream routed to it (the straggler), or the worker
whose service plane is wedged while its hub connection keeps breathing.
This module closes that gap (SURVEY §5 failure detection; reference Dynamo
delegates the equivalent to etcd health + operator-level probes):

- ``probe_address``       — liveness/readiness over the EXISTING endpoint
  plane: every ``ServiceServer`` answers a built-in ``__health__`` stream
  (no new port, no new protocol), so a probe exercises the exact transport
  requests ride.
- ``WorkerLatencyTracker`` — process-global per-worker TTFT/ITL rolling
  windows, recorded by the routed client as it streams (the only vantage
  point that sees scheduling + transport + engine latency together).  The
  JAX package's HTTP edge publishes the snapshot on ``slo_metrics`` for a
  planner-side watchdog (the planner is not ported yet).
- ``HealthWatchdog``      — periodic probe + outlier scan over the instance
  registrations; consecutive failures or a sustained ITL/TTFT outlier
  (vs the fleet median) quarantine the worker (``health/quarantine/{id}``
  in the hub KV — the planner's pool view excludes it), live sequences are
  drained via the migration plane, and after the grace window the worker's
  instance registrations are ejected so no router ever picks it again.
  A worker that recovers while quarantined (probes pass, outlier clears)
  is reinstated instead of ejected — transient GC pauses don't cost a
  healthy worker.

Everything here is host-side asyncio/stdlib; the migration drain is a lazy
import so the runtime layer stays importable without the llm stack.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from dataclasses import dataclass, field

from ..labels import escape_label
from typing import Any, Awaitable, Callable, Dict, List, Optional, Set

logger = logging.getLogger(__name__)

# Hub KV prefix for quarantine markers (durable, NOT lease-bound: a
# quarantine decision must survive both the worker and the watchdog).
QUARANTINE_PREFIX = "health/quarantine/"


def quarantine_key(worker_id: int) -> str:
    """Quarantine marker key for one worker (shard-map routed: DYN401)."""
    from .transports.shard import hub_key  # lazy: shard imports hub only

    return hub_key("health", "quarantine", worker_id)

# Service-plane path every ServiceServer answers without registration.
HEALTH_ENDPOINT = "__health__"


def _median(xs: List[float]) -> float:
    if not xs:
        return 0.0
    xs = sorted(xs)
    return xs[len(xs) // 2]


# --------------------------------------------------------------------------
# Per-worker latency tracking (client-side vantage point)
# --------------------------------------------------------------------------


class WorkerLatencyTracker:
    """Rolling per-worker TTFT/ITL windows, fed by the routed client.

    Bounded deques per worker; ``snapshot()`` renders p50s for the
    straggler scan and for the edge's ``slo_metrics`` publication.  Workers
    that stop being observed age out via ``prune`` (called on snapshot)."""

    def __init__(self, window: int = 64, stale_after_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.window = window
        self.stale_after_s = stale_after_s
        self._clock = clock
        self._ttft: Dict[int, deque] = {}
        self._itl: Dict[int, deque] = {}
        self._address: Dict[int, str] = {}
        self._last_seen: Dict[int, float] = {}

    def record_ttft(self, worker_id: int, address: str, ms: float) -> None:
        if worker_id is None:
            return
        self._ttft.setdefault(worker_id, deque(maxlen=self.window)).append(ms)
        self._address[worker_id] = address
        self._last_seen[worker_id] = self._clock()

    def record_itl(self, worker_id: int, address: str, ms: float) -> None:
        if worker_id is None:
            return
        self._itl.setdefault(worker_id, deque(maxlen=self.window)).append(ms)
        self._address[worker_id] = address
        self._last_seen[worker_id] = self._clock()

    def forget(self, worker_id: int) -> None:
        self._ttft.pop(worker_id, None)
        self._itl.pop(worker_id, None)
        self._address.pop(worker_id, None)
        self._last_seen.pop(worker_id, None)

    def _prune(self) -> None:
        now = self._clock()
        for wid, t in list(self._last_seen.items()):
            if now - t > self.stale_after_s:
                self.forget(wid)

    def snapshot(self) -> Dict[int, Dict[str, Any]]:
        """worker_id → {address, ttft_p50_ms, itl_p50_ms, n} for every
        worker with at least one sample in the window."""
        self._prune()
        out: Dict[int, Dict[str, Any]] = {}
        for wid in set(self._ttft) | set(self._itl):
            ttft = list(self._ttft.get(wid, ()))
            itl = list(self._itl.get(wid, ()))
            out[wid] = {
                "address": self._address.get(wid, ""),
                "ttft_p50_ms": _median(ttft) if ttft else None,
                "itl_p50_ms": _median(itl) if itl else None,
                "n": len(ttft) + len(itl),
            }
        return out

    def reset(self) -> None:
        self._ttft.clear()
        self._itl.clear()
        self._address.clear()
        self._last_seen.clear()


# Process-global tracker the routed client records into (runtime/client.py)
# and the edge publishes from (planner/signals.py EdgeSloPublisher).
worker_latency = WorkerLatencyTracker()


# --------------------------------------------------------------------------
# KV corruption ledger (the integrity plane's watchdog feed)
# --------------------------------------------------------------------------


class KvCorruptionLedger:
    """Sliding-window count of checksum-failed KV payloads per source
    worker (engine/integrity.py; docs/kv_tiering.md §integrity).

    Fed by ``inject_blocks(donor=...)`` when a pulled/transferred payload
    fails verification, and by engines whose OWN tiers detect rot (via
    ``set_integrity_reporter`` wiring).  The watchdog folds the counts
    into its scan: one flipped byte is weather, but a donor (or a local
    medium) that keeps shipping poison is a sick worker — every pull from
    it costs a detection + recompute, so it gets the same quarantine →
    drain → eject path as a prober failure.  Counts age out of the
    ``window_s`` horizon so a healed worker reinstates."""

    def __init__(self, window_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.window_s = window_s
        self._clock = clock
        self._events: Dict[int, deque] = {}

    def record(self, worker_id: int, n: int = 1) -> None:
        if worker_id is None:
            return
        q = self._events.setdefault(worker_id, deque(maxlen=256))
        now = self._clock()
        for _ in range(n):
            q.append(now)

    def count(self, worker_id: int) -> int:
        q = self._events.get(worker_id)
        if not q:
            return 0
        horizon = self._clock() - self.window_s
        while q and q[0] < horizon:
            q.popleft()
        if not q:
            self._events.pop(worker_id, None)
            return 0
        return len(q)

    def counts(self) -> Dict[int, int]:
        return {
            wid: c for wid in list(self._events)
            if (c := self.count(wid)) > 0
        }

    def reset(self) -> None:
        self._events.clear()


# Process-global ledger: engines record into it (transfer/offload paths),
# the watchdog scans it each tick.
kv_corruption = KvCorruptionLedger()


# --------------------------------------------------------------------------
# Probing
# --------------------------------------------------------------------------


async def probe_address(address: str, timeout_s: float = 1.0) -> bool:
    """Liveness+readiness probe over the service plane's ``__health__``
    stream.  True only if the worker answered ok AND reports at least one
    registered endpoint (alive-but-empty = not ready)."""
    from .engine import Context
    from .transports.service import RemoteEngine

    if not address:
        return True  # endpoint-less registrations (prefill heartbeats)
    try:
        async def _roundtrip() -> bool:
            stream = await RemoteEngine(address, HEALTH_ENDPOINT).generate(
                Context({})
            )
            try:
                async for item in stream:
                    return bool(item.get("ok")) and int(item.get("endpoints", 0)) > 0
                return False
            finally:
                # `async for` does not aclose() on early return: without
                # this, every SUCCESSFUL probe leaked its mux stream slot
                # and a pending forward_cancel task — one per probe tick,
                # forever (caught by the suite-wide orphan-task detector).
                await stream.aclose()

        return await asyncio.wait_for(_roundtrip(), timeout_s)
    except asyncio.CancelledError:
        raise
    except Exception:  # noqa: BLE001 — any failure IS the probe result
        return False


# --------------------------------------------------------------------------
# Watchdog
# --------------------------------------------------------------------------


@dataclass
class HealthConfig:
    probe_interval_s: float = 1.0
    probe_timeout_s: float = 1.0
    # consecutive probe failures before quarantine (1 = first failure)
    quarantine_after: int = 2
    # straggler: worker p50 > factor × fleet median, sustained for
    # ``straggler_streak`` scans, with an absolute floor so microsecond
    # jitter between idle workers never reads as an outlier
    straggler_factor: float = 3.0
    straggler_min_ms: float = 50.0
    straggler_min_samples: int = 5
    straggler_streak: int = 2
    # KV-corruption quarantine bar: checksum-failed payloads attributed to
    # one worker within the ledger window (``kv_corruption``) before it is
    # quarantined — one flip is weather, a streak is a sick medium/donor
    corrupt_after: int = 3
    # quarantine → eject grace (drain budget); recovery within it reinstates
    eject_grace_s: float = 5.0
    # eject = delete the worker's instance registrations (permanent until
    # the process re-registers); False = quarantine+drain only
    eject: bool = True

    @classmethod
    def from_config(cls, cfg: Optional[Dict[str, Any]]) -> "HealthConfig":
        cfg = cfg or {}
        kw = {}
        for f in (
            "probe_interval_s", "probe_timeout_s", "straggler_factor",
            "straggler_min_ms", "eject_grace_s",
        ):
            if cfg.get(f) is not None:
                kw[f] = float(cfg[f])
        for f in ("quarantine_after", "straggler_min_samples",
                  "straggler_streak", "corrupt_after"):
            if cfg.get(f) is not None:
                kw[f] = int(cfg[f])
        if cfg.get("eject") is not None:
            kw["eject"] = bool(cfg["eject"])
        return cls(**kw)


@dataclass
class WorkerHealth:
    """Watchdog-side record for one discovered worker."""

    worker_id: int
    address: str = ""
    keys: Set[str] = field(default_factory=set)
    info: Optional[Dict[str, Any]] = None  # last instance record w/ metadata
    state: str = "healthy"  # healthy | quarantined | ejected
    fail_streak: int = 0
    straggler_streak: int = 0
    quarantined_at: float = 0.0
    reason: str = ""


class HealthMetrics:
    """Process-global watchdog counters (appended to /metrics)."""

    def __init__(self):
        self.probes_total = 0
        self.probe_failures_total = 0
        self.stragglers_detected_total = 0
        self.quarantines_total = 0
        self.recoveries_total = 0
        self.drains_total = 0
        self.drained_sequences_total = 0
        self.ejections_total = 0
        self.corruption_quarantines_total = 0
        self.state_counts: Dict[str, int] = {}

    def reset(self) -> None:
        self.__init__()

    def render(self, prefix: str = "dynamo_tpu") -> str:
        ns = f"{prefix}_health"
        lines = []

        def counter(name: str, help_: str, value: int) -> None:
            lines.append(f"# HELP {ns}_{name} {help_}")
            lines.append(f"# TYPE {ns}_{name} counter")
            lines.append(f"{ns}_{name} {value}")

        counter("probes_total", "Worker liveness probes sent", self.probes_total)
        counter("probe_failures_total", "Failed worker probes",
                self.probe_failures_total)
        counter("stragglers_detected_total",
                "ITL/TTFT outlier detections", self.stragglers_detected_total)
        counter("quarantines_total", "Workers quarantined",
                self.quarantines_total)
        counter("recoveries_total", "Quarantined workers reinstated",
                self.recoveries_total)
        counter("drains_total", "Quarantine drains attempted", self.drains_total)
        counter("drained_sequences_total",
                "Sequences migrated off quarantined workers",
                self.drained_sequences_total)
        counter("ejections_total", "Workers ejected from the fleet",
                self.ejections_total)
        counter("corruption_quarantines_total",
                "Quarantines attributed to repeated KV corruption",
                self.corruption_quarantines_total)
        lines.append(f"# HELP {ns}_workers Worker count by health state")
        lines.append(f"# TYPE {ns}_workers gauge")
        for state in ("healthy", "quarantined", "ejected"):
            lines.append(
                f'{ns}_workers{{state="{escape_label(state)}"}} '
                f"{self.state_counts.get(state, 0)}"
            )
        return "\n".join(lines) + "\n"


health_metrics = HealthMetrics()


class HealthWatchdog:
    """Periodic fleet health scan over one instance prefix.

    Each ``tick``: read the instance registrations, probe every distinct
    worker address, merge the latency tracker's outlier view, advance the
    per-worker state machine, and act:

    quarantine  — write ``health/quarantine/{worker_id}`` (the planner's
                  SignalCollector watches this prefix and drops the worker
                  from its pool view) and kick off drain-via-migration for
                  its live sequences (remote ``migrate_out``, targets
                  exclude quarantined peers).
    reinstate   — probes pass and the outlier cleared before the grace
                  window ended: delete the marker, reset streaks.
    eject       — grace expired and the worker is still sick: delete its
                  instance registrations (watchers see the delete; routing
                  stops) and stamp the marker ``ejected``.

    ``prober``/``drainer``/``latency_source``/``clock`` are injectable for
    deterministic tests and for cross-process wiring (a planner-side
    watchdog feeds ``latency_source`` from the collector's slo_metrics
    view instead of the in-process tracker)."""

    def __init__(
        self,
        hub,
        instance_prefix: str,
        config: Optional[HealthConfig] = None,
        prober: Optional[Callable[[str, float], Awaitable[bool]]] = None,
        drainer: Optional[Callable[[Dict[str, Any]], Awaitable[int]]] = None,
        latency_source: Optional[Callable[[], Dict[int, Dict[str, Any]]]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.hub = hub
        self.instance_prefix = instance_prefix
        self.config = config or HealthConfig()
        self._prober = prober or probe_address
        self._drainer = drainer or self._drain_via_migration
        self._latency_source = latency_source or worker_latency.snapshot
        self._clock = clock
        self.workers: Dict[int, WorkerHealth] = {}
        self._task: Optional[asyncio.Task] = None

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> "HealthWatchdog":
        self._task = asyncio.get_running_loop().create_task(self._run())
        return self

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _run(self) -> None:
        while True:
            try:
                await self.tick()
            except asyncio.CancelledError:
                return
            except Exception:  # noqa: BLE001 — the watchdog must outlive hubs
                logger.exception("health watchdog tick failed")
            try:
                await asyncio.sleep(self.config.probe_interval_s)
            except asyncio.CancelledError:
                return

    # -- one scan ------------------------------------------------------------

    async def tick(self) -> None:
        cfg = self.config
        try:
            snapshot = await self.hub.kv_get_prefix(self.instance_prefix)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — hub down: skip the scan, not die
            logger.warning("health scan: hub unreachable; skipping tick")
            return
        # Fold registrations into per-worker records.
        seen: Set[int] = set()
        for key, info in snapshot.items():
            if not isinstance(info, dict) or "worker_id" not in info:
                continue
            wid = info["worker_id"]
            seen.add(wid)
            rec = self.workers.get(wid)
            if rec is None:
                rec = self.workers[wid] = WorkerHealth(worker_id=wid)
            if rec.state == "ejected":
                # Re-registration after eject = operator brought it back:
                # start over with a clean slate.
                rec.state = "healthy"
                rec.fail_streak = rec.straggler_streak = 0
                await self._clear_marker(wid)
            rec.keys.add(key)
            rec.keys &= set(snapshot.keys())
            if info.get("address"):
                rec.address = info["address"]
                rec.info = info
        for wid in list(self.workers):
            if wid not in seen and self.workers[wid].state not in (
                "quarantined", "ejected"
            ):
                # Gone from discovery (lease expiry / clean stop): forget.
                # Quarantined AND ejected records are kept — an ejected
                # worker that re-registers later (operator intervention,
                # lease-monitor re-put after a hub restart) must hit the
                # clean-slate branch above so its durable quarantine marker
                # is cleared; forgetting it would leave the marker excluding
                # a serving worker from the planner pool view forever.
                del self.workers[wid]
        # Probe every live worker address concurrently.
        probed = [
            rec for rec in self.workers.values()
            if rec.state != "ejected" and rec.address
        ]
        results = await asyncio.gather(
            *(self._prober(rec.address, cfg.probe_timeout_s) for rec in probed),
            return_exceptions=True,
        )
        for rec, ok in zip(probed, results):
            health_metrics.probes_total += 1
            if ok is True:
                rec.fail_streak = 0
            else:
                rec.fail_streak += 1
                health_metrics.probe_failures_total += 1
        # Straggler scan: each worker's p50 vs the fleet median.
        self._scan_stragglers()
        # KV-corruption ledger scan (engine/integrity.py feeds it through
        # inject_blocks donor attribution + local-tier reporters): repeated
        # checksum failures attributed to one worker inside the ledger
        # window quarantine it like a probe-failure streak would.
        corrupt_counts = kv_corruption.counts()
        # State transitions + actions.
        now = self._clock()
        for rec in list(self.workers.values()):
            poisoning = (
                corrupt_counts.get(rec.worker_id, 0) >= cfg.corrupt_after
            )
            if rec.state == "healthy":
                sick = rec.fail_streak >= cfg.quarantine_after
                slow = rec.straggler_streak >= cfg.straggler_streak
                if sick or slow or poisoning:
                    if sick:
                        rec.reason = f"probe_failures={rec.fail_streak}"
                    elif slow:
                        rec.reason = "latency_outlier"
                    else:
                        rec.reason = (
                            f"kv_corruption={corrupt_counts[rec.worker_id]}"
                        )
                        health_metrics.corruption_quarantines_total += 1
                        from ..llm.metrics import kv_integrity_metrics

                        kv_integrity_metrics.quarantined_total += 1
                    await self._quarantine(rec, now)
            elif rec.state == "quarantined":
                recovered = (
                    rec.fail_streak == 0
                    and rec.straggler_streak == 0
                    and not poisoning  # ledger entries age out of the window
                )
                if recovered:
                    await self._reinstate(rec)
                elif cfg.eject and now - rec.quarantined_at >= cfg.eject_grace_s:
                    await self._eject(rec)
        health_metrics.state_counts = {}
        for rec in self.workers.values():
            health_metrics.state_counts[rec.state] = (
                health_metrics.state_counts.get(rec.state, 0) + 1
            )

    def _scan_stragglers(self) -> None:
        cfg = self.config
        try:
            lat = self._latency_source() or {}
        except Exception:  # noqa: BLE001 — latency feed is best-effort
            return
        flagged: Set[int] = set()
        for metric in ("itl_p50_ms", "ttft_p50_ms"):
            vals = {
                wid: v[metric]
                for wid, v in lat.items()
                if isinstance(v.get(metric), (int, float))
                and v.get("n", 0) >= cfg.straggler_min_samples
            }
            if len(vals) < 2:
                continue  # nothing to be an outlier AGAINST
            fleet = _median(list(vals.values()))
            bar = max(fleet * cfg.straggler_factor, cfg.straggler_min_ms)
            for wid, v in vals.items():
                if v > bar and wid not in flagged:
                    flagged.add(wid)
                    rec = self.workers.get(wid)
                    if rec is None or rec.state == "ejected":
                        continue
                    rec.straggler_streak += 1
                    health_metrics.stragglers_detected_total += 1
                    logger.warning(
                        "straggler: worker %s %s=%.1fms vs fleet median "
                        "%.1fms (streak %d)",
                        wid, metric, v, fleet, rec.straggler_streak,
                    )
        # An outlier that cleared resets its streak — quarantine needs a
        # SUSTAINED signal, not two isolated blips a minute apart.
        for wid, rec in self.workers.items():
            if wid not in flagged and rec.straggler_streak:
                rec.straggler_streak = 0

    # -- actions -------------------------------------------------------------

    async def _quarantine(self, rec: WorkerHealth, now: float) -> None:
        rec.state = "quarantined"
        rec.quarantined_at = now
        health_metrics.quarantines_total += 1
        logger.warning(
            "quarantining worker %s (%s): %s",
            rec.worker_id, rec.address, rec.reason,
        )
        try:
            await self.hub.kv_put(
                quarantine_key(rec.worker_id),
                {"state": "quarantined", "reason": rec.reason,
                 "address": rec.address},
            )
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — marker is advisory; drain anyway
            logger.warning("could not write quarantine marker", exc_info=True)
        if rec.info is not None:
            health_metrics.drains_total += 1
            try:
                moved = await self._drainer(rec.info)
                health_metrics.drained_sequences_total += int(moved or 0)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — a stuck drain must not wedge
                logger.warning(
                    "drain of quarantined worker %s failed", rec.worker_id,
                    exc_info=True,
                )

    async def _drain_via_migration(self, info: Dict[str, Any]) -> int:
        """Default drainer: remote ``migrate_out`` of every live sequence to
        a non-quarantined migration-capable peer."""
        from ..llm.migration.coordinator import (  # lazy: llm imports runtime
            pick_migration_target,
            request_migrate_out,
        )

        quarantined = frozenset(
            wid for wid, r in self.workers.items() if r.state != "healthy"
        )
        target = await pick_migration_target(
            self.hub,
            self.instance_prefix,
            info.get("worker_id"),
            exclude=quarantined,
        )
        if target is None:
            logger.info("quarantine drain: no migration-capable peer")
            return 0
        resp = await request_migrate_out(info, target)
        return len(resp.get("migrated") or ())

    async def _reinstate(self, rec: WorkerHealth) -> None:
        rec.state = "healthy"
        rec.quarantined_at = 0.0
        health_metrics.recoveries_total += 1
        logger.info("worker %s recovered; reinstating", rec.worker_id)
        await self._clear_marker(rec.worker_id)

    async def _eject(self, rec: WorkerHealth) -> None:
        rec.state = "ejected"
        health_metrics.ejections_total += 1
        logger.warning(
            "ejecting worker %s (%s) after quarantine grace",
            rec.worker_id, rec.address,
        )
        for key in sorted(rec.keys):
            try:
                await self.hub.kv_delete(key)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — keep deleting the rest
                logger.warning("eject: delete %s failed", key, exc_info=True)
        try:
            await self.hub.kv_put(
                quarantine_key(rec.worker_id),
                {"state": "ejected", "reason": rec.reason,
                 "address": rec.address},
            )
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001
            pass

    async def _clear_marker(self, worker_id: int) -> None:
        try:
            await self.hub.kv_delete(quarantine_key(worker_id))
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001
            pass

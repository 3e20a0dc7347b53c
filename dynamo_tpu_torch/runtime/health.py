"""Worker health signals of the routed client and the worker.

The part of the JAX package's ``runtime/health.py`` that the client and
the worker use:

- ``WorkerLatencyTracker`` / ``worker_latency`` — process-global per-worker
  TTFT/ITL rolling windows, recorded by the routed client as it streams
  (the only vantage point that sees scheduling + transport + engine
  latency together).
- ``KvCorruptionLedger`` / ``kv_corruption`` — a sliding-window count of
  checksum-failed KV payloads per worker; a worker's engine reports its own
  tiers' detections into it (``set_integrity_reporter``).
The ``HealthWatchdog`` (probes over the service plane's ``__health__``
stream, straggler scan, quarantine, drain through live migration, eject)
that reads these comes with the migration plane.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, List


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

"""Namespace metrics aggregator service + mock worker.  A copy of the JAX
package's ``llm/metrics_service.py`` that serves ``/metrics`` on the
standard library's asyncio streams (llm/http_service.py ``RouteServer``)
instead of aiohttp, with the same exposition text.

Reference semantics: components/metrics (src/main.rs:16-200) — a standalone
service that aggregates every worker's ForwardPassMetrics and the router's
KV-hit-rate events for one namespace and exposes them as Prometheus text
(port 9091 there); plus a mock worker (src/bin/mock_worker.rs) that
publishes synthetic metrics/events so the whole observability path is
testable with no engine and no accelerator (SURVEY §4 engine-free serving).
"""

from __future__ import annotations

import asyncio
import logging
import random
from typing import Dict, List, Optional

from ..llm.kv_router.protocols import ForwardPassMetrics, KvCacheEvent, KvCacheStoredBlockData
from ..llm.kv_router.publisher import (
    KV_EVENTS_TOPIC,
    KV_METRICS_TOPIC,
    unpack_message,
)
from ..llm.kv_router.scheduler import KV_HIT_RATE_SUBJECT
from ..labels import escape_label
from ..planner.signals import StalenessTracker, classify_instance
from ..runtime.component import INSTANCE_PREFIX, instance_prefix

logger = logging.getLogger(__name__)


class MetricsAggregatorService:
    """Aggregates worker metrics + hit-rate events; serves /metrics.

    Rows are TTL-evicted (``StalenessTracker`` — shared with the
    planner's SignalCollector) and dropped immediately when the worker's
    discovery registration disappears, so ``/metrics`` never serves a
    dead worker's last snapshot forever."""

    def __init__(
        self,
        component,
        host: str = "0.0.0.0",
        port: int = 9091,
        stale_after_s: Optional[float] = 30.0,
    ):
        self.component = component
        self.host = host
        self.port = port
        self._metrics: StalenessTracker = StalenessTracker(ttl_s=stale_after_s)
        self._hit_isl_blocks = 0
        self._hit_overlap_blocks = 0
        self._tasks: List[asyncio.Task] = []
        self._subs: List = []
        self._watcher = None
        self._server = None

    async def start(self) -> "MetricsAggregatorService":
        loop = asyncio.get_running_loop()
        m_sub = await self.component.subscribe(KV_METRICS_TOPIC)
        h_sub = await self.component.subscribe(KV_HIT_RATE_SUBJECT)
        self._subs = [m_sub, h_sub]
        self._tasks = [
            loop.create_task(self._consume_metrics(m_sub)),
            loop.create_task(self._consume_hit_rate(h_sub)),
        ]
        # Instance-gone eviction: watch the namespace's discovery prefix;
        # a delete (lease expiry / deregistration) drops the row at once —
        # the TTL only covers workers that die without ever registering.
        ns = self.component.namespace.name
        self._watcher = await self.component.runtime.hub.watch_prefix(
            instance_prefix(ns)
        )
        self._tasks.append(loop.create_task(self._consume_instances(self._watcher)))
        from .http_service import RouteServer

        self._server = await RouteServer(
            {"/metrics": self._handle_metrics}, self.host, self.port
        ).start()
        self.port = self._server.port  # resolve port 0
        return self

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except asyncio.CancelledError:
                pass
        for sub in self._subs:
            if hasattr(sub, "aclose"):
                await sub.aclose()
        if self._watcher is not None:
            await self._watcher.aclose()
            self._watcher = None
        if self._server is not None:
            await self._server.close()
            self._server = None

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
                    pass
        except asyncio.CancelledError:
            pass

    async def _consume_instances(self, watcher) -> None:
        try:
            async for event in watcher:
                if event.type != "delete":
                    continue
                parsed = classify_instance(event.key, event.value)
                if parsed is not None:
                    self._metrics.pop(parsed[0])
        except asyncio.CancelledError:
            pass

    async def _consume_hit_rate(self, sub) -> None:
        try:
            async for msg in sub:
                payload = unpack_message(msg)
                try:
                    self._hit_isl_blocks += payload["isl_blocks"]
                    self._hit_overlap_blocks += payload["overlap_blocks"]
                except (KeyError, TypeError):
                    pass
        except asyncio.CancelledError:
            pass

    def render(self) -> str:
        """Prometheus exposition text (namespace-level, per-worker labels)."""
        lines: List[str] = []

        def gauge(name: str, help_: str, per_worker) -> None:
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} gauge")
            for wid, m in self._metrics.items():
                lines.append(f'{name}{{worker_id="{escape_label(wid)}"}} {per_worker(m)}')

        gauge("dynamo_tpu_worker_active_slots", "Active request slots",
              lambda m: m.request_active_slots)
        gauge("dynamo_tpu_worker_total_slots", "Total request slots",
              lambda m: m.request_total_slots)
        gauge("dynamo_tpu_worker_kv_active_blocks", "Active KV blocks",
              lambda m: m.kv_active_blocks)
        gauge("dynamo_tpu_worker_kv_total_blocks", "Total KV blocks",
              lambda m: m.kv_total_blocks)
        gauge("dynamo_tpu_worker_requests_waiting", "Queued requests",
              lambda m: m.num_requests_waiting)
        gauge("dynamo_tpu_worker_cache_usage", "KV cache usage fraction",
              lambda m: m.gpu_cache_usage_perc)
        gauge("dynamo_tpu_worker_prefix_hit_rate", "Prefix cache hit rate",
              lambda m: m.gpu_prefix_cache_hit_rate)
        lines.append("# HELP dynamo_tpu_router_isl_blocks Router-observed prompt blocks")
        lines.append("# TYPE dynamo_tpu_router_isl_blocks counter")
        lines.append(f"dynamo_tpu_router_isl_blocks {self._hit_isl_blocks}")
        lines.append("# HELP dynamo_tpu_router_overlap_blocks Router-matched prefix blocks")
        lines.append("# TYPE dynamo_tpu_router_overlap_blocks counter")
        lines.append(f"dynamo_tpu_router_overlap_blocks {self._hit_overlap_blocks}")
        return "\n".join(lines) + "\n"

    def _handle_metrics(self):
        from .http_service import _text_response

        return _text_response(200, self.render())


class MockWorker:
    """Publishes synthetic ForwardPassMetrics + KV events (reference:
    components/metrics/src/bin/mock_worker.rs) — lets the full router +
    observability path run with no engine."""

    def __init__(self, component, worker_id: int, block_size: int = 16,
                 interval: float = 0.5, seed: int = 0):
        self.component = component
        self.worker_id = worker_id
        self.block_size = block_size
        self.interval = interval
        self._rng = random.Random(seed)
        self._task: Optional[asyncio.Task] = None
        self._event_id = 0

    async def start(self) -> "MockWorker":
        self._task = asyncio.get_running_loop().create_task(self._run())
        return self

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    async def _run(self) -> None:
        try:
            while True:
                metrics = ForwardPassMetrics(
                    request_active_slots=self._rng.randint(0, 8),
                    request_total_slots=8,
                    kv_active_blocks=self._rng.randint(0, 256),
                    kv_total_blocks=256,
                    num_requests_waiting=self._rng.randint(0, 4),
                    gpu_cache_usage_perc=self._rng.random(),
                    gpu_prefix_cache_hit_rate=self._rng.random(),
                )
                await self.component.publish(
                    KV_METRICS_TOPIC,
                    {"worker_id": self.worker_id, "metrics": metrics.to_dict()},
                )
                self._event_id += 1
                event = KvCacheEvent.stored(
                    self._event_id,
                    None,
                    [
                        KvCacheStoredBlockData(
                            self._rng.getrandbits(63), self._rng.getrandbits(63)
                        )
                    ],
                )
                await self.component.publish(
                    KV_EVENTS_TOPIC,
                    {"worker_id": self.worker_id, "event": event.to_dict()},
                )
                await asyncio.sleep(self.interval)
        except asyncio.CancelledError:
            pass

"""Event/metrics publishers (worker side) and the metrics aggregator
(router side), over the runtime's event plane.  A copy of the JAX
package's ``llm/kv_router/publisher.py``.

Reference semantics: lib/llm/src/kv_router/publisher.rs (KvEventPublisher:
worker-stamped cache events on subject ``kv_events``; KvMetricsPublisher:
ForwardPassMetrics via watch channel + stats scrape) and
metrics_aggregator.rs / scoring.rs (ProcessedEndpoints{endpoints, load_avg,
load_std}).  This build pushes metrics on the event plane (subject
``kv_metrics``) instead of NATS ``$SRV.STATS`` polling — same data, push
instead of scrape.
"""

from __future__ import annotations

import asyncio
import logging
import statistics
from typing import Callable, Dict, List, Optional

from .indexer import WorkerId
from .protocols import ForwardPassMetrics, KvCacheEvent
from .scheduler import WorkerSnapshot

logger = logging.getLogger(__name__)

KV_EVENTS_TOPIC = "kv_events"
KV_METRICS_TOPIC = "kv_metrics"


def unpack_message(msg) -> dict:
    """Event-plane subscriptions yield ``(subject, payload)`` tuples."""
    if isinstance(msg, tuple) and len(msg) == 2:
        return msg[1]
    return getattr(msg, "payload", msg)


class KvEventPublisher:
    """Worker-side: stamp cache events with worker_id and publish them.

    Sync-callable (``__call__``) so it can be handed directly to the engine's
    ``event_callback``.  Publishes are serialized through one internal queue
    drained by a single sender task: the indexer depends on Stored arriving
    before its Removed (the reference preserves this via a single channel,
    publisher.rs) — independent create_task per event could reorder over a
    TCP hub.
    """

    def __init__(self, component, worker_id: WorkerId):
        self._component = component
        self.worker_id = worker_id
        self._queue: asyncio.Queue = asyncio.Queue()
        self._sender: Optional[asyncio.Task] = None

    def _enqueue(self, event: KvCacheEvent) -> "asyncio.Future":
        done: asyncio.Future = asyncio.get_event_loop().create_future()
        self._queue.put_nowait(
            ({"worker_id": self.worker_id, "event": event.to_dict()}, done)
        )
        if self._sender is None or self._sender.done():
            self._sender = asyncio.get_event_loop().create_task(self._drain())
        return done

    def __call__(self, event: KvCacheEvent) -> None:
        done = self._enqueue(event)
        # Fire-and-forget path: failures are logged by _drain; mark the
        # future's exception as retrieved so it doesn't warn at GC.
        done.add_done_callback(lambda f: f.exception())

    async def _drain(self) -> None:
        while not self._queue.empty():
            payload, done = self._queue.get_nowait()
            try:
                await self._component.publish(KV_EVENTS_TOPIC, payload)
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                logger.exception("kv event publish failed")
                if not done.done():
                    done.set_exception(exc)
            else:
                if not done.done():
                    done.set_result(None)

    async def publish(self, event: KvCacheEvent) -> None:
        """Awaitable publish that preserves queue ordering AND propagates
        transport failures to the caller (unlike the fire-and-forget path)."""
        await self._enqueue(event)

    async def flush(self) -> None:
        if self._sender is not None and not self._sender.done():
            await asyncio.shield(self._sender)


class KvMetricsPublisher:
    """Worker-side: periodically push ForwardPassMetrics snapshots."""

    def __init__(
        self,
        component,
        worker_id: WorkerId,
        source: Callable[[], ForwardPassMetrics],
        interval: float = 1.0,
    ):
        self._component = component
        self.worker_id = worker_id
        self._source = source
        self._interval = interval
        self._task: Optional[asyncio.Task] = None

    async def start(self) -> "KvMetricsPublisher":
        self._task = asyncio.get_running_loop().create_task(self._run())
        return self

    async def publish_once(self) -> None:
        await self._component.publish(
            KV_METRICS_TOPIC,
            {"worker_id": self.worker_id, "metrics": self._source().to_dict()},
        )

    async def _run(self) -> None:
        try:
            while True:
                await self.publish_once()
                await asyncio.sleep(self._interval)
        except asyncio.CancelledError:
            pass
        except Exception:
            logger.exception("metrics publisher failed")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None


class KvMetricsAggregator:
    """Router-side: subscribe to metrics pushes, keep the latest snapshot per
    worker, expose ProcessedEndpoints-style load statistics."""

    def __init__(self, component):
        self._component = component
        self._snapshots: Dict[WorkerId, ForwardPassMetrics] = {}
        self._task: Optional[asyncio.Task] = None
        self._sub = None

    async def start(self) -> "KvMetricsAggregator":
        self._sub = await self._component.subscribe(KV_METRICS_TOPIC)
        self._task = asyncio.get_running_loop().create_task(self._run())
        return self

    async def _run(self) -> None:
        try:
            async for msg in self._sub:
                payload = unpack_message(msg)
                try:
                    wid = payload["worker_id"]
                    self._snapshots[wid] = ForwardPassMetrics.from_dict(
                        payload["metrics"]
                    )
                except (KeyError, TypeError):
                    logger.warning("malformed kv_metrics payload: %r", payload)
        except asyncio.CancelledError:
            pass

    def remove_worker(self, worker_id: WorkerId) -> None:
        self._snapshots.pop(worker_id, None)

    def snapshot(self, worker_id: WorkerId) -> ForwardPassMetrics:
        return self._snapshots.get(worker_id, ForwardPassMetrics())

    def endpoints(self, worker_ids: List[WorkerId]) -> List[WorkerSnapshot]:
        return [WorkerSnapshot(w, self.snapshot(w)) for w in worker_ids]

    def load_stats(self) -> Dict[str, float]:
        """ProcessedEndpoints load_avg/load_std over kv_active_blocks."""
        loads = [m.kv_active_blocks for m in self._snapshots.values()]
        if not loads:
            return {"load_avg": 0.0, "load_std": 0.0}
        return {
            "load_avg": float(statistics.fmean(loads)),
            "load_std": float(statistics.pstdev(loads)) if len(loads) > 1 else 0.0,
        }

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        if self._sub is not None and hasattr(self._sub, "aclose"):
            await self._sub.aclose()

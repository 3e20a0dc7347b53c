"""Trace assembly + the edge's request-trace glue.

A copy of the JAX package's ``llm/trace_service.py``.  ``TraceAggregator``
takes span batches from the hub event plane's ``traces`` subject
(``start``; workers' ``SpanExporter``s publish there) or directly as a
``SpanExporter`` sink (a colocated engine), assembles them by trace_id
with a TTL, and serves the ``/traces/{id}`` / ``/traces?recent=N`` JSON
views plus the per-hop TTFT decomposition rollup (DistServe-style
TTFT-vs-TPOT attribution per phase).  Under ``DYN_BULK_PLANE`` workers
push their batches straight to the edge's bulk ingest
(``make_bulk_span_sink`` / ``start_bulk_ingest``) instead of the hub.

``EdgeRequestTrace`` is the HTTP edge's per-request handle: it owns the
root span (``edge.request``), the admission-wait span, the first-token
event, and the tail-keep decision — head-unsampled requests that error or
violate the TTFT SLO still leave their edge spans behind (tail-keep is
edge-scoped by construction: downstream hops never recorded anything for
an unsampled context, so only the edge's own timeline can be kept
retroactively).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Dict, List, Optional

from ..runtime.tracing import (
    TraceContext,
    TraceSampler,
    collector,
    span,
    tracing_metrics,
)

logger = logging.getLogger(__name__)

# The TTFT decomposition hops, in request order.  Each maps a rollup key to
# the span names that attribute it (first match wins per span).
TTFT_HOPS = (
    ("edge_queue", ("edge.admission_wait",)),
    ("preprocess", ("edge.preprocess",)),
    ("route", ("client.route",)),
    ("engine_queue", ("engine.queue_wait",)),
    ("prefill_or_pull", (
        "engine.prefill",
        "engine.kv_pull",
        "engine.kv_restore",
        "disagg.remote_prefill_wait",
    )),
    ("first_decode", ("engine.decode_chunk",)),
)


def ttft_decomposition(spans: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-hop duration rollup over one trace's spans.

    ``hops`` sums each decomposition phase's span wall; ``ttft_ms`` is the
    root span start → first ``first_token`` event; ``unattributed_ms`` is
    the TTFT window time covered by NO hop span (interval union, clipped to
    the window) — the gap-free bar the CPU smoke asserts on."""
    root = next((s for s in spans if s.get("parent_id") is None), None)
    hops: Dict[str, float] = {}
    intervals: List[List[float]] = []
    first_token_ms: Optional[float] = None
    for s in spans:
        for ev in s.get("events") or ():
            if ev.get("name") == "first_token":
                t = float(ev["t_ms"])
                if first_token_ms is None or t < first_token_ms:
                    first_token_ms = t
    window_start = float(root["start_ms"]) if root else None
    windowed = window_start is not None and first_token_ms is not None
    for s in spans:
        name = s.get("name", "")
        for hop, names in TTFT_HOPS:
            if name in names:
                start, dur = float(s["start_ms"]), float(s["dur_ms"])
                if windowed:
                    # Clip each hop's contribution to the TTFT window: a
                    # migrated/preempted trace records post-first-token
                    # prefill/queue spans (the target's resume admission)
                    # that would otherwise inflate a hop past TTFT itself.
                    dur = min(start + dur, first_token_ms) - max(
                        start, window_start
                    )
                    if dur <= 0:
                        break  # entirely outside TTFT: not a TTFT hop
                if hop == "first_decode" and hop in hops:
                    break  # only the FIRST decode chunk is TTFT
                hops[hop] = round(hops.get(hop, 0.0) + dur, 3)
                intervals.append([start, start + float(s["dur_ms"])])
                break
    out: Dict[str, Any] = {"hops": hops}
    if window_start is not None and first_token_ms is not None:
        ttft = max(first_token_ms - window_start, 0.0)
        covered = 0.0
        cur: Optional[List[float]] = None
        for lo, hi in sorted(intervals):
            lo = max(lo, window_start)
            hi = min(hi, first_token_ms)
            if hi <= lo:
                continue
            if cur is None or lo > cur[1]:
                if cur is not None:
                    covered += cur[1] - cur[0]
                cur = [lo, hi]
            else:
                cur[1] = max(cur[1], hi)
        if cur is not None:
            covered += cur[1] - cur[0]
        out["ttft_ms"] = round(ttft, 3)
        out["unattributed_ms"] = round(max(ttft - covered, 0.0), 3)
    return out


class TraceAggregator:
    """Assemble exported span batches by trace_id with TTL eviction.

    Feed it either by subscribing to the event plane (``start``) or
    directly as an exporter sink (``ingest``) when edge and engine share a
    process.  A trace is ROOTED once a span with ``parent_id == None``
    arrives (the edge/loadgen root); a trace whose TTL expires without one
    counts its spans as orphans — the cross-process-assembly health signal
    the goodput ladder's ``tracing`` block reports."""

    def __init__(
        self,
        ttl_s: float = 120.0,
        max_traces: int = 2048,
        clock=time.monotonic,
    ):
        self.ttl_s = ttl_s
        self.max_traces = max_traces
        self._clock = clock
        # trace_id → {"spans": [...], "t_first", "t_last"} (insertion order
        # = recency order for /traces?recent=N)
        self._traces: Dict[str, Dict[str, Any]] = {}
        self.orphan_spans_total = 0
        self.evicted_total = 0
        self._sub = None
        self._task: Optional[asyncio.Task] = None
        tracing_metrics.set_aggregator_source(self.stats)

    # ------------------------------------------------------------- ingest
    def ingest(self, payload: Any) -> None:
        spans = payload.get("spans") if isinstance(payload, dict) else None
        if not spans:
            return
        now = self._clock()
        for s in spans:
            tid = s.get("trace_id")
            if not tid:
                continue
            entry = self._traces.get(tid)
            if entry is None:
                entry = {"spans": [], "t_first": now}
                self._traces[tid] = entry
            entry["spans"].append(s)
            entry["t_last"] = now
            # Recency order: move to the end on update.
            self._traces[tid] = self._traces.pop(tid)
        self._prune(now)

    def _prune(self, now: Optional[float] = None) -> None:
        now = self._clock() if now is None else now
        dead = [
            tid
            for tid, e in self._traces.items()
            if now - e["t_last"] > self.ttl_s
        ]
        for tid in dead:
            self._evict(tid)
        while len(self._traces) > self.max_traces:
            self._evict(next(iter(self._traces)))

    def _evict(self, trace_id: str) -> None:
        entry = self._traces.pop(trace_id, None)
        if entry is None:
            return
        self.evicted_total += 1
        if not any(
            s.get("parent_id") is None for s in entry["spans"]
        ):
            # Expired without a root: the exporting side never delivered
            # the edge's span (or nothing at the edge sampled it) — these
            # spans can never assemble into a request timeline.
            self.orphan_spans_total += len(entry["spans"])

    # -------------------------------------------------------------- views
    def get(self, trace_id: str) -> Optional[Dict[str, Any]]:
        # Prune on read too: on a quiet edge no ingest runs, and the TTL
        # contract must hold for /traces/{id} as well as /traces?recent.
        self._prune()
        entry = self._traces.get(trace_id)
        if entry is None:
            return None
        spans = sorted(entry["spans"], key=lambda s: s.get("start_ms", 0.0))
        return {
            "trace_id": trace_id,
            "spans": spans,
            "components": sorted({s.get("component", "") for s in spans}),
            "procs": sorted({s.get("proc", "") for s in spans}),
            "rollup": ttft_decomposition(spans),
        }

    def recent(self, n: int = 20) -> List[Dict[str, Any]]:
        self._prune()
        if int(n) <= 0:
            return []  # list[-0:] would be the WHOLE list
        out = []
        for tid in list(self._traces)[-int(n):][::-1]:
            entry = self._traces[tid]
            root = next(
                (s for s in entry["spans"] if s.get("parent_id") is None),
                None,
            )
            out.append({
                "trace_id": tid,
                "spans": len(entry["spans"]),
                "components": sorted(
                    {s.get("component", "") for s in entry["spans"]}
                ),
                "root": (root or {}).get("name"),
                "dur_ms": (root or {}).get("dur_ms"),
            })
        return out

    def stats(self) -> Dict[str, Any]:
        return {
            "traces": len(self._traces),
            "orphan_spans": self.orphan_spans_total,
            "evicted": self.evicted_total,
        }

    # ---------------------------------------------------------- event plane
    async def start(self, namespace) -> "TraceAggregator":
        """Subscribe to ``{namespace}.traces`` and assemble everything the
        fleet publishes (the hub client re-arms the subscription across
        hub restarts — transports/hub.py)."""
        from ..runtime.tracing import TRACES_TOPIC

        self._sub = await namespace.subscribe(TRACES_TOPIC)
        self._task = asyncio.get_running_loop().create_task(self._run())
        return self

    async def _run(self) -> None:
        from .kv_router.publisher import unpack_message

        try:
            async for msg in self._sub:
                try:
                    self.ingest(unpack_message(msg))
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 — malformed batch
                    logger.warning("malformed span batch", exc_info=True)
        except asyncio.CancelledError:
            pass

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
            self._sub = None
        # Detach the /metrics gauge source IF it is still ours (a newer
        # aggregator may have replaced it): a stopped aggregator must not
        # keep feeding /metrics or be pinned in memory by the singleton.
        if tracing_metrics._aggregator_source == self.stats:
            tracing_metrics.set_aggregator_source(None)


#: Bulk-sink kind the edge aggregator registers under (``bulk_sink_key``);
#: worker SpanExporters rendezvous on it when ``DYN_BULK_PLANE`` is on.
BULK_TRACES_SINK = "traces"


def make_bulk_span_sink(rendezvous, fallback):
    """SpanExporter sink over the bulk plane (``DYN_BULK_PLANE``): the
    batch pushes directly to a registered ``traces`` bulk sink (the edge
    aggregator's ingest) instead of fanning through the hub's pub/sub
    plane.  Any miss counts one ``dynamo_tpu_bulk_fallbacks_total`` and
    delegates to ``fallback`` (the hub-publish sink, the A/B oracle) — a
    span batch is never dropped by the bulk plane."""
    from ..runtime.transports import codec
    from ..runtime.transports.bulk import bulk_push
    from .metrics import bulk_metrics

    async def sink(payload: Dict[str, Any]) -> None:
        blob = codec.encode(payload)
        try:
            prep = await rendezvous.prepare_sink(
                BULK_TRACES_SINK, budget=len(blob)
            )
            if prep is None:
                raise RuntimeError("no bulk traces sink registered")
            address, ticket = prep
            await bulk_push(address, BULK_TRACES_SINK, ticket, blob)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — fallback ladder: hub path next
            logger.warning(
                "bulk span export failed; falling back to the hub path",
                exc_info=True,
            )
            bulk_metrics.fallbacks_total += 1
            await fallback(payload)

    return sink


async def start_bulk_ingest(aggregator: TraceAggregator, runtime,
                            host: str = "127.0.0.1"):
    """Run a bulk *sink* server in front of ``aggregator`` and register it
    in the hub under ``bulk/sink/traces/<worker>`` so worker exporters can
    rendezvous with it; returns the started ``BulkServer``."""
    from ..runtime.transports import codec
    from ..runtime.transports.bulk import BulkServer, bulk_sink_key

    async def sink(blob: bytes, meta: Dict[str, Any]) -> Dict[str, Any]:
        aggregator.ingest(codec.decode(blob))
        return {"ok": True}

    server = BulkServer(
        host, worker_id=runtime.worker_id, hub=runtime.hub
    )
    server.register_sink(BULK_TRACES_SINK, sink)
    await server.start()
    await runtime.register_key(
        bulk_sink_key(BULK_TRACES_SINK, runtime.worker_id),
        {"address": server.address, "worker_id": str(runtime.worker_id)},
    )
    return server


class EdgeRequestTrace:
    """Per-request edge tracing handle (llm/http_service.py).

    Created for EVERY request when a sampler is configured; when the head
    decision said no, the handle records edge timestamps locally (cheap:
    two floats) so tail-keep can still materialize the edge spans for an
    error / SLO-violating request after the fact."""

    __slots__ = ("sampler", "tc", "t0", "model", "endpoint", "_admit_t0",
                 "_admit_t1", "_first_token_t", "_events", "_finished")

    def __init__(self, sampler: Optional[TraceSampler], headers, body):
        self.sampler = sampler
        self.tc: Optional[TraceContext] = (
            sampler.decide(headers, body) if sampler is not None else None
        )
        self.t0 = time.perf_counter()
        self.model = ""
        self.endpoint = ""
        self._admit_t0: Optional[float] = None
        self._admit_t1: Optional[float] = None
        self._first_token_t: Optional[float] = None
        self._events: List[Dict[str, Any]] = []
        self._finished = False

    @property
    def active(self) -> bool:
        return self.tc is not None

    def admission_started(self) -> None:
        self._admit_t0 = time.perf_counter()

    def admission_done(self) -> None:
        self._admit_t1 = time.perf_counter()

    def event(self, name: str, **attrs) -> None:
        from ..runtime.tracing import _wall_ms

        ev: Dict[str, Any] = {
            "name": name,
            "t_ms": round(_wall_ms(time.perf_counter()), 3),
        }
        if attrs:
            ev.update(attrs)
        self._events.append(ev)

    def on_first_token(self) -> None:
        if self._first_token_t is None:
            self._first_token_t = time.perf_counter()
            self.event("first_token")

    @property
    def ttft_ms(self) -> Optional[float]:
        if self._first_token_t is None:
            return None
        return (self._first_token_t - self.t0) * 1e3

    def finish(self, status: str, model: str = "", endpoint: str = "") -> None:
        """Record the edge spans.  Head/forced traces always record; an
        untraced request records only if tail-keep promotes it."""
        if self._finished:
            return
        self._finished = True
        tc = self.tc
        if tc is None:
            # NOT "rejected": shedding is deliberate and high-volume by
            # design — tail-keeping every 429/503 during an overload storm
            # would turn over the span ring and evict the sampled traces
            # exactly when they matter (forced x-trace requests still
            # capture shed timelines; they never rely on tail-keep).
            if self.sampler is None or not self.sampler.tail_eligible(
                error=status == "error", ttft_ms=self.ttft_ms
            ):
                return
            tc = TraceContext.new()
            tracing_metrics.tail_kept_total += 1
            self.event("tail_kept", status=status)
        end = time.perf_counter()
        if self._admit_t0 is not None:
            # A request REJECTED while queued never saw admission_done():
            # the wait it died in ends at finish time, not at zero.
            collector.record(
                tc, "edge.admission_wait", "edge",
                self._admit_t0,
                self._admit_t1 if self._admit_t1 is not None else end,
            )
        attrs: Dict[str, Any] = {"status": status}
        if model or self.model:
            attrs["model"] = model or self.model
        if endpoint or self.endpoint:
            attrs["endpoint"] = endpoint or self.endpoint
        if self.ttft_ms is not None:
            attrs["ttft_ms"] = round(self.ttft_ms, 3)
        collector.record(
            tc, "edge.request", "edge", self.t0, end,
            attrs=attrs, events=self._events or None, parent_id=None,
        )


def preprocess_span(ctx):
    """The preprocessor's span under the request context's trace (None-safe;
    llm/preprocessor.py wraps template+tokenize+grammar-compile in it)."""
    return span(getattr(ctx, "trace", None), "edge.preprocess", "edge")

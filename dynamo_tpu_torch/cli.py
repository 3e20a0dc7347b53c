"""CLI launcher for the port — the ``hub``, ``http`` and ``run`` commands
of the JAX package's ``cli.py`` (reference: launch/dynamo-run,
``dynamo-run in=… out=…``; components/http, the standalone frontend; the
hub stands in for the docker-compose etcd + NATS).

Usage:
  python -m dynamo_tpu_torch.cli run in=http out=torch --arch llama-3.1-8b \\
        --model llama-3.1-8b [--port 8000] [--device cpu]   # OpenAI server
  python -m dynamo_tpu_torch.cli run in=text out=torch ...       # chat REPL
  python -m dynamo_tpu_torch.cli run in=stdin out=torch ...      # one prompt
  python -m dynamo_tpu_torch.cli run in=batch:FILE.jsonl out=torch ...
  python -m dynamo_tpu_torch.cli run in=http out=echocore        # no model
  python -m dynamo_tpu_torch.cli hub [--host H] [--port 6650] [--persist FILE]
  python -m dynamo_tpu_torch.cli run in=dyn://ns.comp.ep out=torch --hub H:P \\
        --model NAME --arch ARCH     # worker: serve the engine, register the model
  python -m dynamo_tpu_torch.cli http --hub H:P [--port 8000] [--router kv]
  # disaggregated prefill/decode: a prefill worker and a decode worker
  python -m dynamo_tpu_torch.cli run in=dyn://dynamo.TorchWorker.prefill out=torch \
        --hub H:P --disagg prefill ...
  python -m dynamo_tpu_torch.cli run in=dyn://dynamo.TorchWorker.generate out=torch \
        --hub H:P --disagg decode [--max-local-prefill 512] ...

``out=torch`` is ``TorchEngine`` on the first CUDA device unless
``--device cpu`` is given; ``out=echocore|echofull`` echo the prompt.
``in=http`` and the ``http`` command read the edge's ``qos`` and
``tracing`` sections from the layered config (``DYN_RUNTIME_CONFIG`` file,
then ``DYN_QOS__*`` / ``DYN_TRACING__*`` env), as the JAX commands do;
``http`` also reads ``resilience`` under its own flags.  A worker
(``in=dyn://``) serves its engine on the service plane under its lease,
publishes KV events and ``ForwardPassMetrics`` for the KV router, registers
the model with the engine's block size, reports its tiers' integrity
detections, and with tracing on publishes its spans on the namespace's
``traces`` subject, which the ``http`` edge's aggregator assembles at
``/traces/{id}``.  With ``--disagg decode`` the worker serves its engine
through ``DisaggDecodeWorker`` (llm/disagg): prompts whose uncached part
exceeds ``--max-local-prefill`` (live-updated from the hub) are prefilled
by a ``--disagg prefill`` worker, which pulls them from the model's prefill
queue and pushes their KV blocks to the decode worker's ``kv_import``
endpoint; ``disagg_stats`` serves its counters.  A decode-role worker on
``out=torch`` also serves live migration (llm/migration): the engine goes
through ``MigratableWorker`` with ``migrate_in`` / ``migrate_out``
endpoints, advertised as ``metadata["migrate"]``, and shutdown drains its
live streams to a peer through migration before it stops; the routed
client splices each moved stream.  It serves its sealed blocks to peers at
``kv_export``, pulls a deeper peer prefix at admission when the KV router
stamps a ``kv_pull`` hint (``--kv-pull-mb`` budget), and with a disk tier
consumes the router's ``kv_prefetch`` plane.  With ``DYN_BULK_PLANE=1``
(runtime/transports/bulk.py) such a worker also runs a ``BulkServer``
(the ``kv_export`` source and the ``migrate_in`` sink), registers its
address under ``bulk/addr/<worker id>``, and moves prefix pulls, migration
copy rounds and its span batches worker to worker, with the service plane
and the hub beneath as the fallback; the ``http`` edge with tracing on
runs the bulk span ingest.  The flags keep the JAX parser's names and
defaults.  Options the port does not have yet fail when set
(engine/__init__.py UNSUPPORTED_OPTIONS); the planner's role flips
(``RoleFlipWatcher``, ROADMAP queue 1 item 10.7) and ``EdgeSloPublisher``,
and the other JAX subcommands (model, metrics, mock-worker, planner,
deploy) are not ported (ROADMAP queue 1 items 10.6–10.8).  The tokenizer is the self-contained
byte tokenizer, the JAX CLI's default without ``--tokenizer`` or
``--checkpoint``.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import signal
from typing import Callable, Optional

from .engine import build_torch_engine
from .llm.backend import Backend
from .llm.engines import EchoEngineCore, EchoEngineFull
from .llm.discovery import ModelWatcher, register_model
from .llm.http_service import HttpService
from .llm.metrics import engine_dispatch_metrics, kv_tier_metrics
from .llm.preprocessor import OpenAIPreprocessor
from .llm.tokenizer import ByteTokenizer
from .runtime.component import DistributedRuntime, parse_endpoint_path
from .runtime.config import RuntimeConfig
from .runtime.pipeline import build_pipeline
from .runtime.transports.hub import HubServer

logger = logging.getLogger(__name__)

INPUTS = ("http", "text", "stdin", "none")  # and batch:FILE


def _build_engine(out: str, args):
    """out= engine factory: (engine, "core" | "full")."""
    if out == "echocore":
        return EchoEngineCore(), "core"
    if out == "echofull":
        return EchoEngineFull(), "full"
    if out == "torch":
        return build_torch_engine(args), "core"
    raise SystemExit(f"unknown out= engine: {out!r} (the port has torch, echocore, echofull)")


def _tokenizer(args):
    if getattr(args, "tokenizer", None):
        raise SystemExit(
            "--tokenizer: HF and sentencepiece tokenizers are not ported yet "
            "(ROADMAP queue 1 item 6); the port serves with the byte tokenizer"
        )
    return ByteTokenizer()


def _edge_tracing():
    """Edge-side tracing surfaces (runtime/tracing.py): the TraceSampler
    (head + forced + tail-keep sampling decisions) and a TraceAggregator
    serving /traces.  Returns (sampler, aggregator, cfg) — (None, None,
    cfg) when the ``tracing`` config section disables the plane, which
    removes every per-request cost at the edge."""
    from .llm.trace_service import TraceAggregator
    from .runtime.tracing import TraceSampler, TracingConfig

    cfg = TracingConfig.from_config(RuntimeConfig.from_layers().tracing)
    if not cfg.enabled:
        return None, None, cfg
    return TraceSampler(cfg), TraceAggregator(ttl_s=cfg.ttl_s), cfg


def _edge_qos(args=None):
    """QosController for the HTTP edge from the layered ``qos`` config
    section under explicit --qos-*/--brownout flags (llm/qos.py; the
    ``http`` command has them, ``run`` does not).  Returns None when
    neither quotas nor the brownout ladder are enabled — zero behaviour
    change by default."""
    from .llm.qos import QosConfig, QosController

    section = dict(RuntimeConfig.from_layers().qos)
    for key in ("tenant_weights", "default_weight", "batch_every"):
        section.pop(key, None)  # scheduler half (engine/__init__.py)
    if getattr(args, "qos_rate", None) is not None:
        section["rate"] = args.qos_rate
    if getattr(args, "qos_burst", None) is not None:
        section["burst"] = args.qos_burst
    if getattr(args, "brownout", False) and not section.get("brownout"):
        # The explicit flag wins over an absent/disabled config value, but
        # a configured brownout DICT (custom thresholds) is kept as-is.
        section["brownout"] = True
    cfg = QosConfig.from_dict(section)
    if cfg.rate is None and cfg.brownout is None:
        return None
    return QosController(cfg)


async def _wait_forever() -> None:
    """Until SIGINT/SIGTERM (handled where the loop runs in the main
    thread), or until this task is cancelled."""
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except (NotImplementedError, RuntimeError, ValueError):
            pass  # not the main thread: cancellation ends the wait
    try:
        await stop.wait()
    finally:
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.remove_signal_handler(sig)
            except (NotImplementedError, RuntimeError, ValueError):
                pass


async def _run_hub(args) -> None:
    server = await HubServer(host=args.host, port=args.port, persist_path=args.persist).start()
    print(f"hub listening on {server.address}", flush=True)
    try:
        await _wait_forever()
    finally:
        await server.close()


async def _run_http_frontend(args, on_serving: Optional[Callable[[HttpService], None]] = None) -> None:
    """The ``http`` command: an OpenAI edge whose models are the hub's
    registrations (llm/discovery.ModelWatcher), routed by ``--router``."""
    from .runtime.client import RouterMode

    runtime = await DistributedRuntime.connect(args.hub)
    # CLI flags win over the layered config's `resilience` section
    # (DYN_RESILIENCE__HTTP_MAX_INFLIGHT=64 etc.), which wins over defaults.
    layers = RuntimeConfig.from_layers()
    res = layers.resilience
    raw_inflight = res.get("http_max_inflight")
    sampler, aggregator, tracing_cfg = _edge_tracing()
    service = HttpService(
        host=args.host,
        port=args.port,
        max_inflight=(
            args.max_inflight
            if args.max_inflight is not None
            else int(raw_inflight) if raw_inflight else None
        ),
        admission_queue=(
            args.admission_queue
            if args.admission_queue
            else int(res.get("http_admission_queue", 0))
        ),
        admission_timeout_s=(
            args.admission_timeout_s
            if args.admission_timeout_s != 1.0
            else float(res.get("http_admission_timeout_s", 1.0))
        ),
        default_deadline_s=(
            args.deadline_s
            if args.deadline_s is not None
            else res.get("request_deadline_s")
        ),
        qos=_edge_qos(args),
        tracing=sampler,
        trace_aggregator=aggregator,
        hub=runtime.hub,
    )
    watcher = exporter = bulk_ingest = None
    try:
        watcher = await ModelWatcher(runtime, service.models, router_mode=RouterMode(args.router)).start()
        await service.start()
        if aggregator is not None:
            # Span plane: workers publish span batches on the namespace's
            # ``traces`` subject; the aggregator subscribes and assembles
            # them with the edge's own spans (client.route, the
            # edge.request root), which export straight into it.
            from .runtime.tracing import SpanExporter
            from .runtime.transports.bulk import bulk_enabled

            await aggregator.start(runtime.namespace(layers.namespace))
            if bulk_enabled():
                # Bulk span ingest: worker exporters push batches straight
                # here instead of fanning through the hub's pub/sub plane;
                # the subscription above stays live as the fallback path
                # (and the A/B oracle).
                from .llm.trace_service import start_bulk_ingest

                bulk_ingest = await start_bulk_ingest(aggregator, runtime)
            exporter = await SpanExporter(
                [aggregator], interval_s=tracing_cfg.export_interval_s, proc="edge"
            ).start()
        print(f"OpenAI frontend on http://{service.host}:{service.port}", flush=True)
        if on_serving is not None:
            on_serving(service)
        await _wait_forever()
    finally:
        if exporter is not None:
            await exporter.stop()
        if bulk_ingest is not None:
            await bulk_ingest.close()
        if aggregator is not None:
            await aggregator.stop()
        if watcher is not None:
            await watcher.stop()
        await service.close()
        await runtime.close()


async def _serve_worker(args, engine, on_serving) -> None:
    """``run in=dyn://ns.comp.ep``: the JAX package's worker.  Without
    ``--disagg`` or with ``--disagg decode`` it serves the decode role
    (``WorkerRoles.start_decode``); with ``--disagg prefill`` the prefill
    role (``start_prefill``).  With tracing on, its spans publish on the
    namespace's ``traces`` subject.  Shutdown drains the roles."""
    from .runtime.tracing import TRACES_TOPIC, SpanExporter, TracingConfig
    from .runtime.tracing import collector as trace_collector

    if not args.hub:
        raise SystemExit("worker mode requires --hub HOST:PORT")
    role = getattr(args, "disagg", None)
    if role and not hasattr(engine, "inject_blocks"):
        raise SystemExit(
            f"--disagg {role} requires the native engine (out=torch), not out={args.out}")
    runtime = await DistributedRuntime.connect(args.hub)
    layers = RuntimeConfig.from_layers()
    ns, comp, ep = parse_endpoint_path(args.inp)
    endpoint = runtime.namespace(ns).component(comp).endpoint(ep)
    trace_exporter = roles = None
    try:
        tcfg = TracingConfig.from_config(layers.tracing)
        if tcfg.enabled:
            if tcfg.ring != trace_collector._ring.maxlen:
                trace_collector.set_capacity(tcfg.ring)
            namespace = runtime.namespace(layers.namespace)

            async def _publish_spans(payload):
                await namespace.publish(TRACES_TOPIC, payload)

            span_sink = _publish_spans
            from .runtime.transports.bulk import BulkRendezvous, bulk_enabled

            if bulk_enabled():
                # Bulk span export: batches push directly to the edge
                # aggregator's bulk sink; the hub publish above stays wired
                # as the fallback rung.
                from .llm.trace_service import make_bulk_span_sink

                span_sink = make_bulk_span_sink(
                    BulkRendezvous(runtime.hub, lease=runtime.primary_lease), _publish_spans)
            trace_exporter = await SpanExporter(
                [span_sink], interval_s=tcfg.export_interval_s,
                proc=f"worker-{runtime.worker_id}",
            ).start()
        roles = WorkerRoles(args, runtime, endpoint, engine)
        if role == "prefill":
            await roles.start_prefill()
        else:
            await roles.start_decode(disagg=role == "decode")
        if role:
            logger.info(
                "disagg %s role: the planner's role flips (RoleFlipWatcher, ROADMAP queue 1 "
                "item 10.7) are not ported", role)
        print(f"worker {runtime.worker_id} serving {args.inp} (model {args.model!r}"
              + (f", disagg={role}" if role else "") + ")", flush=True)
        if on_serving is not None:
            on_serving(runtime)
        await _wait_forever()
    finally:
        if roles is not None:
            await roles.shutdown()
        if trace_exporter is not None:
            # Final flush ships the last spans before the hub client closes
            # (best effort: a dead hub just counts an export error).
            await trace_exporter.stop()
        await runtime.close()


class WorkerRoles:
    """The decode and prefill roles of one ``dyn://`` worker on its one
    resident engine (the JAX package's ``WorkerRoles`` without the
    planner's role flips, ROADMAP queue 1 item 10.7).  The decode role's
    stop hook drains via LIVE MIGRATION first (llm/migration): sequences
    move to a peer in O(KV transfer) instead of being waited out in
    O(sequence length)."""

    def __init__(self, args, runtime, endpoint, engine):
        self.args = args
        self.runtime = runtime
        self.endpoint = endpoint
        self.engine = engine
        self._handles: dict = {}

    async def start_decode(self, disagg: bool) -> None:
        """Serve the engine at the endpoint under the runtime's lease
        (through ``DisaggDecodeWorker`` when ``disagg``, with its
        ``kv_import`` and ``disagg_stats`` endpoints and ``role: decode``
        metadata), through ``MigratableWorker`` on the native engine (with
        its ``migrate_in`` / ``migrate_out`` endpoints and ``migrate``
        metadata), publish its KV events and ``ForwardPassMetrics`` (the KV
        router's inputs), serve ``kv_export`` and pull router-hinted peer
        prefixes, consume ``kv_prefetch`` when the disk tier is on, feed its
        tiers' integrity detections to the ``kv_corruption`` ledger, under
        ``DYN_BULK_PLANE`` start the bulk plane (``_start_bulk``), and
        register the model with the engine's block size."""
        from .llm.kv_router.publisher import KvEventPublisher, KvMetricsPublisher
        from .runtime.health import kv_corruption

        args, runtime, endpoint, engine = self.args, self.runtime, self.endpoint, self.engine
        h: dict = {"serveds": []}
        self._handles["decode"] = h
        served_engine = engine
        metadata: dict = {"role": "decode"} if disagg else {}
        if disagg:
            from .llm.disagg import (
                KV_IMPORT_ENDPOINT,
                DisaggConfig,
                DisaggDecodeWorker,
                DisaggregatedRouter,
                PrefillQueue,
            )

            server = await runtime.service_server()
            import_ep = endpoint.component.endpoint(KV_IMPORT_ENDPOINT)
            h["router"] = await DisaggregatedRouter(
                args.model, DisaggConfig(max_local_prefill_length=args.max_local_prefill),
            ).watch_config(runtime.hub)
            worker = DisaggDecodeWorker(
                engine, PrefillQueue(runtime.hub, args.model), h["router"],
                import_address=server.address, import_path=import_ep.path,
            )
            h["serveds"].append(await import_ep.serve_endpoint(worker.kv_import_handler))
            stats_ep = endpoint.component.endpoint("disagg_stats")
            h["serveds"].append(await stats_ep.serve_endpoint(worker.stats_handler))
            h["disagg"] = worker
            served_engine = worker
        if hasattr(engine, "inject_blocks"):  # TorchEngine
            # Live-migration surface: peers (and the drain path) move
            # running sequences here preemption-free.  The instance
            # metadata advertises the capability so target discovery
            # (llm/migration/coordinator.py) finds this worker.
            from .llm.migration import (
                MIGRATE_IN_ENDPOINT,
                MIGRATE_OUT_ENDPOINT,
                MigratableWorker,
            )

            mig = MigratableWorker(engine, serve=served_engine)
            mig_in = endpoint.component.endpoint(MIGRATE_IN_ENDPOINT)
            mig_out = endpoint.component.endpoint(MIGRATE_OUT_ENDPOINT)
            h["serveds"].append(await mig_in.serve_endpoint(mig.migrate_in_handler))
            h["serveds"].append(await mig_out.serve_endpoint(mig.migrate_out_handler))
            metadata["migrate"] = {
                "import_path": mig_in.path,
                "out_path": mig_out.path,
                "generate_path": endpoint.path,
            }
            served_engine = mig
            h["mig"] = mig
        h["serveds"].append(await endpoint.serve_endpoint(served_engine, metadata=metadata or None))
        h["metadata"] = metadata
        kv_block_size = 16
        if hasattr(engine, "set_event_callback"):  # TorchEngine
            kv_block_size = engine.cfg.block_size
            h["events"] = KvEventPublisher(endpoint.component, runtime.worker_id)
            engine.set_event_callback(h["events"])
            h["metrics_pub"] = await KvMetricsPublisher(
                endpoint.component, runtime.worker_id, engine.metrics
            ).start()
            # Fleet-wide prefix reuse: serve this worker's sealed blocks to
            # peers at kv_export, pull a deeper peer prefix at admission
            # (router-stamped kv_pull hints), and — when the disk tier is
            # on — consume the router's kv_prefetch plane to warm
            # predicted prefixes disk→host.
            from .llm.kv_router.pull import (
                KV_EXPORT_ENDPOINT,
                KvPrefetchConsumer,
                PrefixPuller,
                make_client_exporter,
                make_kv_export_handler,
            )

            export_ep = endpoint.component.endpoint(KV_EXPORT_ENDPOINT)
            h["serveds"].append(await export_ep.serve_endpoint(make_kv_export_handler(engine)))
            h["pull_client"] = await export_ep.client()
            engine.set_prefix_puller(PrefixPuller(engine, make_client_exporter(h["pull_client"])))
            if engine.disk_kv is not None:
                h["prefetch"] = await KvPrefetchConsumer(endpoint.component, engine).start()
            wid = runtime.worker_id
            engine.set_integrity_reporter(lambda plane, _wid=wid: kv_corruption.record(_wid))
            kv_tier_metrics.set_source(engine.kv_tier_summary)
        from .runtime.transports.bulk import bulk_enabled

        if bulk_enabled() and hasattr(engine, "inject_blocks"):
            await self._start_bulk(h)
        h["model_key"] = await register_model(
            runtime, args.model, endpoint.path, tokenizer={"kind": "byte"},
            kv_block_size=kv_block_size,
        )

    async def _start_bulk(self, h: dict) -> None:
        """Bulk data plane (``DYN_BULK_PLANE``): run this worker's
        peer-to-peer stream server with the ``kv_export`` source and the
        ``migrate_in`` sink, register its address under the primary lease
        for hub rendezvous, and repoint the bulk producers (the prefix
        pull's exporter, migration's copy stream) at it.  Every producer
        keeps its service-plane transport beneath as the fallback rung, so
        a dead bulk peer costs a fallback tick, never a stream."""
        from .llm.kv_router.pull import (
            KV_EXPORT_ENDPOINT,
            PrefixPuller,
            make_bulk_export_source,
            make_bulk_exporter,
            make_client_exporter,
        )
        from .llm.migration import MIGRATE_IN_ENDPOINT
        from .llm.migration.worker import make_migrate_in_sink
        from .runtime.transports.bulk import BulkRendezvous, BulkServer, bulk_addr_key

        runtime, engine = self.runtime, self.engine
        bulk_srv = BulkServer(runtime._host, worker_id=runtime.worker_id, hub=runtime.hub)
        bulk_srv.register_source(KV_EXPORT_ENDPOINT, make_bulk_export_source(engine))
        if h.get("mig") is not None:
            bulk_srv.register_sink(MIGRATE_IN_ENDPOINT, make_migrate_in_sink(h["mig"]))
        await bulk_srv.start()
        h["bulk_srv"] = bulk_srv
        await runtime.register_key(
            bulk_addr_key(runtime.worker_id),
            {"address": bulk_srv.address, "worker_id": str(runtime.worker_id)},
        )
        rendezvous = BulkRendezvous(runtime.hub, lease=runtime.primary_lease)
        if h.get("mig") is not None:
            h["mig"].bulk = rendezvous
        if h.get("pull_client") is not None:
            engine.set_prefix_puller(PrefixPuller(engine, make_bulk_exporter(
                rendezvous, make_client_exporter(h["pull_client"]),
                max_bytes=engine.cfg.kv_pull_max_bytes,
            )))

    async def stop_decode(self) -> None:
        h = self._handles.pop("decode", None)
        if h is None:
            return
        if h.get("mig") is not None:
            # Close the drain race at BOTH ends.  (1) Accept-time gate:
            # refuse migrate-in from here on — even a peer holding a stale
            # hub snapshot that still advertises us gets refused when its
            # push arrives.  (2) De-advertise the migrate capability so
            # fresh target discovery stops picking us.
            from .llm.migration import drain_via_migration

            h["mig"].stop_accepting()
            try:
                md = {k: v for k, v in (h.get("metadata") or {}).items() if k != "migrate"}
                await self.endpoint.update_metadata(md)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — best effort; drain anyway
                logger.warning("could not de-advertise migrate capability", exc_info=True)
            # Drain via migration: live sequences hand off to a peer in
            # O(transfer); anything that could not move (no peer, rollback)
            # simply keeps decoding here until it finishes.
            await drain_via_migration(
                h["mig"], self.runtime.hub, self.endpoint.instance_prefix,
                self.runtime.worker_id,
            )
        if h.get("disagg") is not None:
            await h["disagg"].drain(timeout=10.0)
        for served in reversed(h["serveds"]):
            await served.stop()
        if h.get("bulk_srv") is not None:
            # De-advertise BEFORE closing so a rendezvous racing the close
            # resolves to nothing (a caller falls back) instead of dialing
            # a dead address until its resume budget runs out.
            from .runtime.transports.bulk import bulk_addr_key

            await self.runtime.unregister_key(bulk_addr_key(self.runtime.worker_id))
            await h["bulk_srv"].close()
        if h.get("prefetch") is not None:
            await h["prefetch"].stop()
        if h.get("pull_client") is not None:
            self.engine.set_prefix_puller(None)
            await h["pull_client"].close()
        if hasattr(self.engine, "set_event_callback"):
            self.engine.set_event_callback(None)
            self.engine.set_integrity_reporter(None)
            kv_tier_metrics.set_source(None)
        if h.get("events") is not None:
            # The events already queued reach the hub before its client
            # closes (bounded: a dead hub must not hold the shutdown).
            try:
                await asyncio.wait_for(h["events"].flush(), 5.0)
            except asyncio.TimeoutError:
                logger.warning("KV events still queued at shutdown were dropped")
        if h.get("metrics_pub") is not None:
            await h["metrics_pub"].stop()
        if h.get("router") is not None:
            await h["router"].stop()
        if h.get("model_key") is not None:
            await self.runtime.unregister_key(h["model_key"])

    async def start_prefill(self) -> None:
        """Dedicated prefill worker: drains the model's prefill queue and
        serves no endpoint.  It still registers a lease-bound heartbeat
        under its endpoint path (metadata ``role: prefill``) so prefill-pool
        membership and its death are observable — nothing routes to it."""
        from .llm.disagg import PrefillQueue, PrefillWorkerLoop

        ploop = await PrefillWorkerLoop(
            self.engine, PrefillQueue(self.runtime.hub, self.args.model)
        ).start()
        self._handles["prefill"] = {"ploop": ploop}
        await self.runtime.register_key(
            self.endpoint.instance_key(self.runtime.worker_id),
            {
                "address": "",
                "path": self.endpoint.path,
                "worker_id": self.runtime.worker_id,
                "metadata": {"role": "prefill"},
            },
        )

    async def stop_prefill(self) -> None:
        h = self._handles.pop("prefill", None)
        if h is None:
            return
        # Finish the in-flight queue item (bounded), then stop pulling; a
        # cancel that lands mid-dequeue requeues at-least-once.
        await h["ploop"].drain(timeout=10.0)
        await self.runtime.unregister_key(self.endpoint.instance_key(self.runtime.worker_id))

    async def shutdown(self) -> None:
        await self.stop_decode()
        await self.stop_prefill()


async def _run(args, on_serving: Optional[Callable] = None) -> None:
    """Serve ``args.inp`` through the pipeline onto ``args.out``.  With
    ``in=http``, ``on_serving`` is called with the service once it listens
    (its ``port`` resolved); with ``in=dyn://…``, with the worker's
    ``DistributedRuntime`` once the model is registered.  Servers run until
    this task is cancelled (or SIGINT/SIGTERM in the main thread)."""
    inp = args.inp
    if inp not in INPUTS and not inp.startswith(("batch:", "dyn://")):
        raise SystemExit(
            f"in={inp} is not supported by the port "
            "(it has in=http|text|stdin|batch:FILE|none|dyn://ns.comp.ep)"
        )
    tokenizer = _tokenizer(args)
    engine, level = _build_engine(args.out, args)
    if level == "core":
        pipeline = build_pipeline(
            [OpenAIPreprocessor(tokenizer, args.model), Backend(tokenizer)], engine
        )
    else:
        pipeline = engine
    try:
        if inp.startswith("dyn://"):
            await _serve_worker(args, engine, on_serving)
        elif inp == "http":
            # Colocated engine: its live KV usage feeds the brownout ladder,
            # and its decode-dispatch health rides /metrics
            # (dynamo_tpu_engine_dispatch_*; llm/metrics.py).
            kv_usage_fn = (
                (lambda: engine.metrics().gpu_cache_usage_perc)
                if hasattr(engine, "metrics") else None
            )
            if hasattr(engine, "dispatch_summary"):
                engine_dispatch_metrics.set_source(engine.dispatch_summary)
            # ... and its KV tier gauges (dynamo_tpu_kv_tier_*).
            if hasattr(engine, "kv_tier_summary"):
                kv_tier_metrics.set_source(engine.kv_tier_summary)
            # Colocated tracing: edge and engine share this process, so the
            # exporter feeds the aggregator directly and /traces serves
            # assembled timelines one export interval after a request ends.
            sampler, aggregator, tcfg = _edge_tracing()
            exporter = None
            if aggregator is not None:
                from .runtime.tracing import SpanExporter

                exporter = await SpanExporter(
                    [aggregator], interval_s=tcfg.export_interval_s
                ).start()
            service = HttpService(
                host=args.host, port=args.port,
                qos=_edge_qos(), kv_usage_fn=kv_usage_fn,
                tracing=sampler, trace_aggregator=aggregator,
            )
            service.models.add_chat_model(args.model, pipeline)
            service.models.add_completion_model(args.model, pipeline)
            try:
                await service.start()
                print(f"serving {args.model!r} on http://{args.host}:{service.port}", flush=True)
                if on_serving is not None:
                    on_serving(service)
                await asyncio.Event().wait()
            finally:
                await service.close()
                if exporter is not None:
                    await exporter.stop()
                if aggregator is not None:
                    await aggregator.stop()
        elif inp == "none":
            # Start the engine with no input surface (reference Input::None).
            print(f"engine up (in=none), model {args.model!r}; ctrl-C to exit", flush=True)
            await asyncio.Event().wait()
        else:
            from .llm.console import run_batch, run_stdin_prompt, run_text_chat

            if inp == "text":
                await run_text_chat(pipeline, args.model, args)
            elif inp == "stdin":
                await run_stdin_prompt(pipeline, args.model, args)
            else:
                await run_batch(pipeline, args.model, inp[len("batch:"):], args)
    finally:
        if inp == "http" and hasattr(engine, "dispatch_summary"):
            engine_dispatch_metrics.set_source(None)
            kv_tier_metrics.set_source(None)
        close = getattr(engine, "close", None)
        if close is not None:
            await close()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m dynamo_tpu_torch.cli")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_hub = sub.add_parser("hub", help="run the control-plane hub")
    p_hub.add_argument("--host", default="0.0.0.0")
    p_hub.add_argument("--port", type=int, default=6650)
    p_hub.add_argument(
        "--persist", default=None,
        help="snapshot file: durable KV + queues survive hub restart",
    )

    p_http = sub.add_parser("http", help="standalone OpenAI frontend w/ discovery")
    p_http.add_argument("--hub", required=True)
    p_http.add_argument("--host", default="0.0.0.0")
    p_http.add_argument("--port", type=int, default=8000, help="0 takes a free port")
    p_http.add_argument(
        "--router", default="round_robin", choices=["random", "round_robin", "kv"],
        help="worker selection policy (kv = cache-aware)",
    )
    # Admission control / deadlines (runtime/resilience.py); defaults keep
    # both disabled.
    p_http.add_argument(
        "--max-inflight", type=int, default=None, dest="max_inflight",
        help="in-flight request cap (unset = unlimited)",
    )
    p_http.add_argument(
        "--admission-queue", type=int, default=0, dest="admission_queue",
        help="bounded wait queue beyond the cap; overflow sheds 429",
    )
    p_http.add_argument(
        "--admission-timeout-s", type=float, default=1.0, dest="admission_timeout_s",
        help="max queue wait before shedding 503",
    )
    p_http.add_argument(
        "--deadline-s", type=float, default=None, dest="deadline_s",
        help="default per-request deadline (504 on exhaustion)",
    )
    # QoS / overload control (llm/qos.py); defaults keep both disabled.
    p_http.add_argument(
        "--qos-rate", type=float, default=None, dest="qos_rate",
        help="per-tenant sustained requests/s (token bucket; unset = off)",
    )
    p_http.add_argument(
        "--qos-burst", type=float, default=None, dest="qos_burst",
        help="per-tenant burst allowance (default 2x rate)",
    )
    p_http.add_argument(
        "--brownout", action="store_true",
        help="enable the brownout degradation ladder",
    )

    p_run = sub.add_parser("run", help="in=… out=… launcher")
    p_run.add_argument("inout", nargs=2, metavar="in=/out=")
    p_run.add_argument("--hub", default=None, help="host:port of the hub (in=dyn://…)")
    p_run.add_argument("--host", default="0.0.0.0")
    p_run.add_argument("--port", type=int, default=8000, help="0 takes a free port")
    p_run.add_argument("--model", default="echo", help="the served model name")
    # Console input modes (in=text/stdin/batch:FILE) sampling defaults.
    p_run.add_argument("--max-tokens", type=int, default=None, dest="max_tokens")
    p_run.add_argument("--temperature", type=float, default=None)
    p_run.add_argument("--tokenizer", default=None, help="not ported yet")
    # out=torch engine knobs (reference: launch/dynamo-run/src/flags.rs)
    p_run.add_argument("--arch", default=None, help="model architecture name (out=torch)")
    p_run.add_argument(
        "--device", default=None,
        help="torch device for out=torch (default: the first CUDA device; "
        "'cpu' runs the plain attention versions)",
    )
    p_run.add_argument("--block-size", type=int, default=16, dest="block_size")
    p_run.add_argument("--num-blocks", type=int, default=256, dest="num_blocks")
    p_run.add_argument("--max-batch", type=int, default=8, dest="max_batch")
    p_run.add_argument("--max-model-len", type=int, default=1024, dest="max_model_len")
    p_run.add_argument("--prefill-chunk", type=int, default=512, dest="prefill_chunk")
    p_run.add_argument(
        "--dtype", default="bfloat16",
        help="weight/activation dtype (bfloat16; float32 for CPU runs)",
    )
    p_run.add_argument(
        "--decode-steps", type=int, default=4, dest="decode_steps",
        help="decode iterations fused into one device dispatch",
    )
    p_run.add_argument(
        "--pipeline-depth", type=int, default=2, dest="pipeline_depth",
        help="fused decode dispatches kept in flight",
    )
    p_run.add_argument(
        "--kv-cache-dtype", default=None, dest="cache_dtype",
        help="KV page dtype (e.g. int8 or float8_e4m3fn with --kv-scale)",
    )
    p_run.add_argument(
        "--kv-scale",
        type=lambda s: s if s == "auto" else float(s),
        default=1.0,
        dest="kv_scale",
        help="scale of quantized KV pages: a float, or 'auto' to calibrate per layer at start",
    )
    # The KV memory tiers (engine/offload.py), the JAX flags' names,
    # defaults and MiB units.
    p_run.add_argument(
        "--host-cache-mb", type=int, default=0, dest="host_cache_mb",
        help="host (CPU RAM, pinned on CUDA) KV tier budget in MiB: sealed blocks "
        "survive device eviction and restore as prefix hits (0 = off)",
    )
    p_run.add_argument(
        "--disk-cache-mb", type=int, default=0, dest="disk_cache_mb",
        help="disk KV tier budget in MiB: host-tier eviction demotes blocks to "
        "hash-named files instead of dropping them (requires --host-cache-mb)",
    )
    p_run.add_argument(
        "--disk-cache-dir", default=None, dest="disk_cache_dir",
        help="directory for the disk KV tier's block files "
        "(default: a per-process dir under the system temp root, removed at exit)",
    )
    p_run.add_argument(
        "--object-store-mb", type=int, default=0, dest="object_store_mb",
        help="durable object-store KV tier budget in MiB: disk-tier eviction lands "
        "in an object layout that outlives the worker, so a replacement boots warm "
        "(requires --disk-cache-mb and --object-store-dir)",
    )
    p_run.add_argument(
        "--object-store-dir", default=None, dest="object_store_dir",
        help="object layout root for the durable KV tier (required with "
        "--object-store-mb: the store outlives the process)",
    )
    p_run.add_argument(
        "--kv-pull-mb", type=int, default=None, dest="kv_pull_mb",
        help="cross-worker prefix pull byte budget in MiB (the router "
        "hints a peer holding a deeper prefix; the engine pulls the "
        "delta over the KV transfer plane instead of recomputing)",
    )
    # The JAX parser's options that out=torch lacks: accepted so that
    # setting one fails with where it waits (build_torch_engine).
    p_run.add_argument("--checkpoint", default=None)
    for flag in ("--tp", "--dp", "--ep", "--sp", "--nnodes"):
        p_run.add_argument(flag, type=int, default=1)
    p_run.add_argument("--spec-decode", action="store_true", default=None)
    for flag in ("--spec-k", "--spec-ngram-min", "--spec-ngram-max",
                 "--lora-max-adapters", "--lora-rank"):
        p_run.add_argument(flag, type=int, default=None)
    p_run.add_argument("--lora", action="append", default=None, metavar="NAME=SPEC")
    p_run.add_argument(
        "--disagg", default=None, choices=["decode", "prefill"],
        help="disaggregated role for this worker (requires --hub)",
    )
    p_run.add_argument(
        "--max-local-prefill", type=int, default=512, dest="max_local_prefill",
        help="prefills longer than this (minus prefix hit) go remote",
    )
    return parser


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    args = build_parser().parse_args(argv)
    if args.cmd != "run":
        return args
    io = {}
    for part in args.inout:
        key, sep, value = part.partition("=")
        if not sep:
            raise SystemExit(f"run expects in=… out=…, got {part!r}")
        io[key] = value
    if "in" not in io or "out" not in io:
        raise SystemExit("run requires in=… out=…")
    args.inp, args.out = io["in"], io["out"]
    return args


def main(argv: Optional[list] = None) -> None:
    logging.basicConfig(
        level=os.environ.get("DYN_LOG", "info").upper(),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    args = parse_args(argv)
    run = {"hub": _run_hub, "http": _run_http_frontend, "run": _run}[args.cmd]
    try:
        asyncio.run(run(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()

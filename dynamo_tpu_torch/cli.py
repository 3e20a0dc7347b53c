"""CLI launcher for the port — the commands of the JAX package's ``cli.py``
(reference: launch/dynamo-run, ``dynamo-run in=… out=…``; components/http,
the standalone frontend; components/metrics and its mock worker; llmctl;
the operator and the api-store; the hub stands in for the docker-compose
etcd + NATS).

Usage:
  python -m dynamo_tpu_torch.cli run in=http out=torch --arch llama-3.1-8b \\
        --model llama-3.1-8b [--port 8000] [--device cpu]   # OpenAI server
  python -m dynamo_tpu_torch.cli run in=http out=torch --arch llama-3.1-8b --tp 2 \\
        [--sp 2 --sp-prefill-min 1024] [--nnodes 2 --node-rank R --coordinator H:P]
  python -m dynamo_tpu_torch.cli run in=http out=torch --checkpoint DIR|FILE.gguf \
        [--tokenizer X.model] [--lora NAME=DIR --lora-max-adapters R --lora-rank r]
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
  python -m dynamo_tpu_torch.cli metrics --hub H:P [--port 9091]  # aggregator
  python -m dynamo_tpu_torch.cli mock-worker --hub H:P   # synthetic metrics
  python -m dynamo_tpu_torch.planner run --hub H:P ...   # the SLA planner
  python -m dynamo_tpu_torch.cli model add|list|remove [NAME ENDPOINT] --hub H:P
  python -m dynamo_tpu_torch.cli deploy render|preview -f CR.yaml   # needs PyYAML
  python -m dynamo_tpu_torch.cli prepare MODEL [--cache DIR]   # local specs only
  python -m dynamo_tpu_torch.cli operator [--namespace NS]      # in-cluster
  python -m dynamo_tpu_torch.cli api-store --hub H:P [--kube] [--token T]
  python -m dynamo_tpu_torch.sdk.runner MODULE:GRAPH -f CFG.yaml --http-port P  # SDK

``out=torch`` is ``TorchEngine`` on the first CUDA device unless
``--device cpu`` is given; ``out=echocore|echofull`` echo the prompt.
``in=http`` and the ``http`` command read the edge's ``qos`` and
``tracing`` sections from the layered config (``DYN_RUNTIME_CONFIG`` file,
then ``DYN_QOS__*`` / ``DYN_TRACING__*`` env), as the JAX commands do;
``http`` also reads ``resilience`` under its own flags, and publishes its
rolling TTFT/ITL percentiles on the namespace's ``slo_metrics`` subject
(the planner's SLO input, planner/signals.py ``EdgeSloPublisher``).  A worker
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
runs the bulk span ingest.  A ``--disagg decode|prefill`` worker also
runs the planner's ``RoleFlipWatcher`` (planner/actuate.py): a put on
``planner/roles/<worker id>`` naming the other role drains the current
role (decode: through live migration) and starts the new one on the same
resident engine, then acks the key.  ``run --record FILE`` taps every
stream to JSONL (runtime/recorder.py).  The flags keep the JAX parser's
names and defaults.  ``--tp/--dp/--ep/--sp`` run one process per rank:
this one is its node's local rank 0 and starts the others (the hidden
``__rank__`` role, the same command line), global rank 0 serves and
publishes its dispatches on the step plane (engine/multihost.py), and
every other rank replays them; ``--nnodes/--node-rank/--coordinator
/--step-port`` spread the ranks over hosts, one command each, and
``--device cpu`` or ``--cpu-devices N`` runs them on the CPU over gloo.
``model`` writes and removes the
JAX command's static registry entries (an ``hf`` tokenizer spec is
registered as given; the frontend's watcher refuses to build it);
``deploy`` renders a DynamoTpuDeployment CR into manifests that run the
port (deploy/renderer.py; a TPU topology is refused); ``prepare``
resolves a local directory, a ``.gguf`` file or a pre-staged copy and
prints its path, and refuses a remote repo id (models/hub.py: no
download); ``operator`` runs the deployment and model-cache reconcilers
over the standard-library ``KubeApi``; ``api-store`` serves the deployment
REST API (deploy/api_store.py).  Weights come from ``--checkpoint`` (a local HF
safetensors directory, a ``.gguf`` file or a pre-staged copy; the
architecture from its ``config.json`` or GGUF metadata) or a seeded random
init.  The tokenizer is ``--tokenizer`` (a ``tokenizer.json``, a directory
holding one, a ``.gguf`` or a sentencepiece ``.model``), else the
checkpoint's own (its ``tokenizer.json``, the GGUF's embedded one or its
``tokenizer.model``), else the self-contained byte tokenizer; HF
tokenizers and chat templates run in plain Python (llm/hf_tokenizer.py,
llm/chat_template.py).
``--lora NAME=SPEC`` serves adapters as extra model names on the same
engine, batched in one forward pass; a worker registers each as an adapter
entry the frontend's watcher routes.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import signal
import sys
from typing import Callable, Optional

from .engine import build_torch_engine
from .engine.ranks import RANK_ROLE, die_with_parent, mesh_config, run_rank, start_ranks
from .llm.backend import Backend
from .llm.engines import EchoEngineCore, EchoEngineFull
from .llm.discovery import ModelWatcher, make_tokenizer, register_model
from .llm.http_service import HttpService
from .llm.metrics import engine_dispatch_metrics, kv_tier_metrics
from .llm.preprocessor import OpenAIPreprocessor
from .llm.tenancy.grammar import GrammarCompiler
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


def _tokenizer_spec(args) -> dict:
    tok = getattr(args, "tokenizer", None)
    if tok:
        if tok.endswith(".gguf"):
            return {"kind": "gguf", "file": tok}
        if tok.endswith(".model"):
            # Explicit sentencepiece file.
            return {"kind": "sp", "file": tok}
        if os.path.isdir(tok):
            return {"kind": "hf", "dir": tok}
        return {"kind": "hf", "file": tok}
    ckpt = getattr(args, "checkpoint", None)
    if ckpt:
        # build_torch_engine resolved the checkpoint spec to a local path;
        # serve its own tokenizer when it ships one.  The ORIGINAL spec
        # rides along so a frontend on another host can re-resolve it.
        from .models.hub import tokenizer_spec

        spec = tokenizer_spec(ckpt)
        if spec is not None:
            source = getattr(args, "checkpoint_source", None)
            if source:
                spec["source"] = source
            return spec
    return {"kind": "byte"}


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
    ``http`` and ``run`` commands have them).  Returns None when
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
    qos_ctl = _edge_qos(args)
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
        qos=qos_ctl,
        tracing=sampler,
        trace_aggregator=aggregator,
        hub=runtime.hub,
    )
    watcher = exporter = bulk_ingest = slo_pub = None
    try:
        watcher = await ModelWatcher(runtime, service.models, router_mode=RouterMode(args.router)).start()
        await service.start()
        # Publish the edge's rolling TTFT/ITL percentiles on the namespace's
        # slo_metrics subject — the planner's SLO input (planner/signals.py).
        from .planner.signals import EdgeSloPublisher

        slo_pub = await EdgeSloPublisher(
            runtime.namespace(layers.namespace), service.metrics, qos=qos_ctl
        ).start()
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
        if slo_pub is not None:
            await slo_pub.stop()
        if watcher is not None:
            await watcher.stop()
        await service.close()
        await runtime.close()


async def _serve_worker(args, engine, on_serving) -> None:
    """``run in=dyn://ns.comp.ep``: the JAX package's worker.  Without
    ``--disagg`` or with ``--disagg decode`` it serves the decode role
    (``WorkerRoles.start_decode``); with ``--disagg prefill`` the prefill
    role (``start_prefill``).  A ``--disagg`` worker flips between the two
    on the planner's role key (``RoleFlipWatcher``).  With tracing on, its
    spans publish on the namespace's ``traces`` subject.  Shutdown stops
    the flip watcher, then drains the roles."""
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
    trace_exporter = roles = flipper = None
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
        roles = WorkerRoles(args, runtime, endpoint, engine, _tokenizer_spec(args))
        if role == "prefill":
            await roles.start_prefill()
        else:
            await roles.start_decode(disagg=role == "decode")
        if role:
            # Planner role flips (planner/actuate.py LocalActuator →
            # planner/roles/{worker_id}) work BOTH directions on the same
            # resident engine: decode→prefill migrates live sequences out
            # then starts a queue-drain loop; prefill→decode finishes the
            # in-flight queue item then brings up the full decode surface
            # (kv_import endpoint included).
            from .planner.actuate import RoleFlipWatcher

            async def _switch_decode() -> None:
                await roles.start_decode(disagg=True)

            flipper = await RoleFlipWatcher(
                runtime.hub, runtime.worker_id, role,
                drain={"decode": roles.stop_decode, "prefill": roles.stop_prefill},
                switch={"prefill": roles.start_prefill, "decode": _switch_decode},
            ).start()
        print(f"worker {runtime.worker_id} serving {args.inp} (model {args.model!r}"
              + (f", disagg={role}" if role else "") + ")", flush=True)
        if on_serving is not None:
            on_serving(runtime)
        await _wait_forever()
    finally:
        if flipper is not None:
            await flipper.stop()
        if roles is not None:
            await roles.shutdown()
        if trace_exporter is not None:
            # Final flush ships the last spans before the hub client closes
            # (best effort: a dead hub just counts an export error).
            await trace_exporter.stop()
        await runtime.close()


class WorkerRoles:
    """The decode and prefill roles of one ``dyn://`` worker on its one
    resident engine (the JAX package's ``WorkerRoles``): weights never
    reload across the planner's role flips.  The decode role's stop hook
    drains via LIVE MIGRATION first (llm/migration): sequences move to a
    peer in O(KV transfer) instead of being waited out in O(sequence
    length), which is what makes planner scale-down/flip actuation cheap."""

    def __init__(self, args, runtime, endpoint, engine, tokenizer_spec=None):
        self.args = args
        self.runtime = runtime
        self.endpoint = endpoint
        self.engine = engine
        self.tokenizer_spec = tokenizer_spec or {"kind": "byte"}
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
            runtime, args.model, endpoint.path, tokenizer=self.tokenizer_spec,
            kv_block_size=kv_block_size,
        )
        # LoRA adapters register as additional model names on the SAME
        # endpoint: the frontend's watcher builds adapter-stamping
        # pipelines for them, and tenant KV salting keeps router overlap
        # exact.
        h["adapter_keys"] = [
            await register_model(
                runtime, adapter, endpoint.path, tokenizer=self.tokenizer_spec,
                kv_block_size=kv_block_size, lora={"adapter": adapter, "base": args.model},
            )
            for adapter in (engine.adapter_names() if hasattr(engine, "adapter_names") else [])
        ]

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
        for key in h.get("adapter_keys", ()):
            await self.runtime.unregister_key(key)

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
    this task is cancelled (or SIGINT/SIGTERM in the main thread).

    At more than one rank (``--tp/--dp/--ep/--sp``) this process is its
    node's local rank 0 and starts the others (engine/ranks.py
    ``start_ranks``); global rank 0 serves and publishes its dispatches,
    every other rank replays them (engine/multihost.py)."""
    inp = args.inp
    if inp not in INPUTS and not inp.startswith(("batch:", "dyn://")):
        raise SystemExit(
            f"in={inp} is not supported by the port "
            "(it has in=http|text|stdin|batch:FILE|none|dyn://ns.comp.ep)"
        )
    ranks = None
    if mesh_config(args).num_devices > 1 or getattr(args, "nnodes", 1) > 1:
        engine, ranks = await start_ranks(args, build_torch_engine)
        if engine is None:  # a follower node: it replayed the leader until it closed
            return
        level = "core"
    else:
        engine, level = _build_engine(args.out, args)
    tokenizer = make_tokenizer(_tokenizer_spec(args))
    if getattr(args, "record", None):
        # Tap every request/response stream to JSONL (reference:
        # recorder.rs) — replayable via runtime.recorder.replay_into.
        # Wrapped HERE so every input mode records (in=http included).
        from .runtime.recorder import RecordingEngine, StreamRecorder

        recorder = StreamRecorder(args.record)
        engine = RecordingEngine(engine, recorder)
        print(f"recording streams to {args.record}", flush=True)
    # One grammar compile cache for every core-level pipeline on this
    # tokenizer (base model and adapter aliases alike): constraint →
    # automaton indexing is the expensive step (llm/tenancy/grammar.py).
    grammar_compiler = GrammarCompiler(tokenizer) if level == "core" else None
    if level == "core":
        pipeline = build_pipeline(
            [
                OpenAIPreprocessor(tokenizer, args.model, grammar_compiler=grammar_compiler),
                Backend(tokenizer),
            ],
            engine,
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
                qos=_edge_qos(args), kv_usage_fn=kv_usage_fn,
                tracing=sampler, trace_aggregator=aggregator,
            )
            service.models.add_chat_model(args.model, pipeline)
            service.models.add_completion_model(args.model, pipeline)
            # LoRA adapters serve as additional MODEL NAMES on the same
            # resident engine, each through a preprocessor that stamps the
            # adapter id + KV salt.
            adapters = engine.adapter_names() if hasattr(engine, "adapter_names") else []
            if level == "core":
                for name in adapters:
                    apipe = build_pipeline(
                        [
                            OpenAIPreprocessor(
                                tokenizer, name, adapter=name, grammar_compiler=grammar_compiler
                            ),
                            Backend(tokenizer),
                        ],
                        engine,
                    )
                    service.models.add_chat_model(name, apipe)
                    service.models.add_completion_model(name, apipe)
            try:
                await service.start()
                print(f"serving {args.model!r}"
                      + (f" + adapters {adapters}" if adapters else "")
                      + f" on http://{args.host}:{service.port}", flush=True)
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
        if ranks is not None:
            await ranks.stop()


async def _run_metrics(args) -> None:
    """Namespace metrics aggregator (reference: components/metrics)."""
    from .llm.metrics_service import MetricsAggregatorService

    runtime = await DistributedRuntime.connect(args.hub)
    component = runtime.namespace(args.namespace).component(args.component)
    service = await MetricsAggregatorService(
        component, host=args.host, port=args.port
    ).start()
    print(f"metrics aggregator on http://{args.host}:{service.port}/metrics", flush=True)
    try:
        await _wait_forever()
    finally:
        await service.stop()
        await runtime.close()


async def _run_mock_worker(args) -> None:
    """Synthetic metrics/KV-event publisher (reference: mock_worker.rs)."""
    from .llm.metrics_service import MockWorker

    runtime = await DistributedRuntime.connect(args.hub)
    component = runtime.namespace(args.namespace).component(args.component)
    worker = await MockWorker(
        component, runtime.worker_id, interval=args.interval
    ).start()
    print(f"mock worker {runtime.worker_id} publishing", flush=True)
    try:
        await _wait_forever()
    finally:
        await worker.stop()
        await runtime.close()


async def _run_model_cmd(args) -> None:
    """llmctl equivalent (reference: launch/llmctl/src/main.rs:26-124): the
    JAX command's registry entries, so a mixed fleet shares them."""
    from .llm.discovery import MODEL_PREFIX, model_prefix

    runtime = await DistributedRuntime.connect(args.hub)
    try:
        if args.verb == "add":
            key = await register_model(
                runtime,
                args.name,
                args.endpoint,
                model_type=args.type,
                tokenizer={"kind": "hf", "file": args.tokenizer}
                if args.tokenizer
                else {"kind": "byte"},
                kv_block_size=args.block_size,
                static=True,
            )
            print(f"registered {args.name} -> {args.endpoint} ({key})", flush=True)
        elif args.verb == "list":
            kvs = await runtime.hub.kv_get_prefix(MODEL_PREFIX)
            for key, entry in sorted(kvs.items()):
                print(f"{entry['name']}\t{entry['model_type']}\t{entry['endpoint']}")
            if not kvs:
                print("(no models registered)")
        elif args.verb == "remove":
            kvs = await runtime.hub.kv_get_prefix(model_prefix(args.name))
            for key in kvs:
                await runtime.hub.kv_delete(key)
            print(f"removed {len(kvs)} registration(s) for {args.name}", flush=True)
    finally:
        await runtime.close()


def _run_deploy(args) -> None:
    """``deploy render|preview``: a DynamoTpuDeployment CR file → the
    manifests (YAML) or the commands each service runs.  Needs PyYAML."""
    from .deploy import render_to_yaml, shell_preview
    from .deploy.renderer import require_yaml

    try:
        yaml = require_yaml()
    except RuntimeError as e:
        raise SystemExit(f"deploy: {e}") from None
    with open(args.cr_file) as f:
        cr = yaml.safe_load(f)
    try:
        print(render_to_yaml(cr) if args.verb == "render" else shell_preview(cr))
    except ValueError as e:
        raise SystemExit(f"deploy: {e}") from None


def _run_prepare(args) -> None:
    """Pre-stage a checkpoint into the model cache (the model-cache Job's
    entrypoint): the local half of the JAX command.  A local directory, a
    ``.gguf`` file or a copy pre-staged under ``--cache`` (or
    ``DYN_MODEL_CACHE``) resolves and prints its path; a remote repo id is
    refused (models/hub.py: the port downloads nothing)."""
    if args.cache:
        os.environ["DYN_MODEL_CACHE"] = args.cache
    from .models.hub import resolve_model

    try:
        path = resolve_model(args.model, revision=args.revision)
    except FileNotFoundError as e:
        raise SystemExit(f"prepare: {e}") from None
    print(path, flush=True)


async def _run_operator(args) -> None:
    """In-cluster reconcile loop (reference: the Go operator binary) —
    drives BOTH CRDs: deployments and model caches (the reference's
    dynamonimdeployment + dynamonimrequest controller pair)."""
    from .deploy.controller import KubeApi, Reconciler
    from .deploy.model_cache import ModelCacheReconciler

    kube = KubeApi(namespace=args.namespace, base=args.api_server)
    print(
        f"operator reconciling {args.namespace}/dynamotpudeployments "
        f"+ dynamotpumodelcaches (watch-triggered, {args.poll_interval}s "
        f"resync)",
        flush=True,
    )
    try:
        # Both controllers run watch-triggered with periodic resync; a
        # failing watch degrades each to pure polling independently.
        await asyncio.gather(
            Reconciler(kube).run(poll_interval=args.poll_interval),
            ModelCacheReconciler(kube).run(poll_interval=args.poll_interval),
        )
    finally:
        await kube.close()


async def _run_api_store(args) -> None:
    """Deployment-management REST API (reference: api-store FastAPI app)."""
    from .deploy.api_store import ApiStore
    from .runtime.transports.hub import HubClient

    hub = await HubClient(args.hub).connect()
    reconciler = None
    if args.kube:
        from .deploy.controller import KubeApi, Reconciler

        # Distinct manager identity: the operator's orphan sweep must never
        # treat api-store children as its own (and vice versa).
        reconciler = Reconciler(KubeApi(namespace=args.namespace), manager="api-store")
    token = args.token or os.environ.get("DYN_API_TOKEN") or None
    if token is None and args.host not in ("127.0.0.1", "localhost", "::1"):
        print(
            "api-store WARNING: binding a non-loopback address with no "
            "--token/DYN_API_TOKEN — any network peer can create/delete "
            "deployments",
            flush=True,
        )
    store = await ApiStore(hub, reconciler, host=args.host, port=args.port, token=token).start()
    print(f"api-store on http://{args.host}:{store.port}", flush=True)
    try:
        await _wait_forever()
    finally:
        await store.close()
        if reconciler is not None:
            await reconciler.kube.close()
        await hub.close()


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

    p_metrics = sub.add_parser("metrics", help="namespace metrics aggregator")
    p_metrics.add_argument("--hub", required=True)
    p_metrics.add_argument("--namespace", default="dynamo")
    p_metrics.add_argument("--component", default="TpuWorker")
    p_metrics.add_argument("--host", default="0.0.0.0")
    p_metrics.add_argument("--port", type=int, default=9091, help="0 takes a free port")

    p_mock = sub.add_parser("mock-worker", help="synthetic metrics/KV events")
    p_mock.add_argument("--hub", required=True)
    p_mock.add_argument("--namespace", default="dynamo")
    p_mock.add_argument("--component", default="TpuWorker")
    p_mock.add_argument("--interval", type=float, default=0.5)

    p_model = sub.add_parser("model", help="model registry (llmctl equivalent)")
    p_model.add_argument("verb", choices=["add", "list", "remove"])
    p_model.add_argument("name", nargs="?", default=None)
    p_model.add_argument("endpoint", nargs="?", default=None, help="dyn://ns.comp.ep")
    p_model.add_argument("--hub", required=True)
    p_model.add_argument("--type", default="both", choices=["chat", "completion", "both"])
    p_model.add_argument("--tokenizer", default=None)
    p_model.add_argument("--block-size", type=int, default=16, dest="block_size")

    p_deploy = sub.add_parser(
        "deploy", help="render k8s manifests from a DynamoTpuDeployment CR"
    )
    p_deploy.add_argument("verb", choices=["render", "preview"])
    p_deploy.add_argument("-f", "--file", required=True, dest="cr_file")

    p_prep = sub.add_parser(
        "prepare",
        help="pre-stage a model checkpoint into the cache "
             "(model-cache Job entrypoint)",
    )
    p_prep.add_argument("model")
    p_prep.add_argument("--cache", default=None,
                        help="destination dir (overrides DYN_MODEL_CACHE)")
    p_prep.add_argument("--revision", default=None)

    p_op = sub.add_parser(
        "operator",
        help="k8s controller: reconcile DynamoTpuDeployment + "
             "DynamoTpuModelCache CRs in-cluster",
    )
    p_op.add_argument("--namespace", default="default")
    p_op.add_argument("--poll-interval", type=float, default=10.0,
                      dest="poll_interval")
    p_op.add_argument("--api-server", default=None, dest="api_server",
                      help="override the in-cluster API server URL")

    p_store = sub.add_parser(
        "api-store",
        help="deployment-management REST API over the hub store",
    )
    p_store.add_argument("--hub", required=True)
    # Loopback by default: the store can create/delete k8s objects (with
    # --kube), so exposure beyond localhost is opt-in and should come with
    # --token.
    p_store.add_argument("--host", default="127.0.0.1")
    p_store.add_argument("--port", type=int, default=7070)
    p_store.add_argument(
        "--kube", action="store_true",
        help="also reconcile created deployments against the k8s API",
    )
    p_store.add_argument("--namespace", default="default")
    p_store.add_argument(
        "--token", default=None,
        help="bearer token required on every request (default: "
        "DYN_API_TOKEN env; unset = unauthenticated)",
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
    p_run.add_argument(
        "--tokenizer", default=None,
        help="path to tokenizer.json (or a directory holding one, a .gguf, or a "
        "sentencepiece tokenizer.model)",
    )
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
    p_run.add_argument(
        "--checkpoint", default=None,
        help="local HF safetensors checkpoint dir, a .gguf file, or a model "
        "name pre-staged under DYN_MODEL_CACHE (nothing is downloaded)",
    )
    p_run.add_argument("--model-config", default=None, dest="model_config",
                       help="model config json (HF config.json format)")
    p_run.add_argument("--tp", type=int, default=1, help="tensor parallel size")
    p_run.add_argument("--dp", type=int, default=1, help="data parallel size")
    p_run.add_argument("--ep", type=int, default=1, help="expert parallel size")
    p_run.add_argument(
        "--sp", type=int, default=1,
        help="sequence parallel size (ring-attention long-prompt prefill)",
    )
    p_run.add_argument(
        "--sp-prefill-min", type=int, default=1024, dest="sp_prefill_min",
        help="prompts at least this long use the sp whole-prompt prefill",
    )
    p_run.add_argument("--spec-decode", action="store_true", default=None)
    for flag in ("--spec-k", "--spec-ngram-min", "--spec-ngram-max"):
        p_run.add_argument(flag, type=int, default=None)
    p_run.add_argument(
        "--lora", action="append", default=None, metavar="NAME=SPEC",
        help="serve a LoRA adapter under model name NAME (repeatable; SPEC is a "
        "PEFT directory, a name pre-staged under DYN_MODEL_CACHE, or random[:seed])",
    )
    p_run.add_argument("--lora-max-adapters", type=int, default=None, dest="lora_max_adapters",
                       help="resident adapter slots in the device banks")
    p_run.add_argument("--lora-rank", type=int, default=None, dest="lora_rank",
                       help="per-slot LoRA rank ceiling")
    p_run.add_argument(
        "--record", default=None,
        help="capture every request/response stream to this JSONL file "
        "(replayable — runtime/recorder.py)",
    )
    p_run.add_argument(
        "--disagg", default=None, choices=["decode", "prefill"],
        help="disaggregated role for this worker (requires --hub)",
    )
    p_run.add_argument(
        "--max-local-prefill", type=int, default=512, dest="max_local_prefill",
        help="prefills longer than this (minus prefix hit) go remote",
    )
    # multi-host scale-out (reference: MultiNodeConfig, engines.rs:40-105)
    p_run.add_argument(
        "--nnodes", type=int, default=1, help="total hosts in this engine"
    )
    p_run.add_argument(
        "--node-rank", type=int, default=0, dest="node_rank",
        help="this host's rank (0 = leader)",
    )
    p_run.add_argument(
        "--coordinator", default="",
        help="host:port of rank 0's torch.distributed store",
    )
    p_run.add_argument(
        "--step-port", type=int, default=6651, dest="step_port",
        help="leader port for the follower dispatch stream",
    )
    p_run.add_argument(
        "--cpu-devices", type=int, default=None, dest="cpu_devices",
        help="TEST ONLY: run this node's ranks on the CPU, N of them at most (gloo)",
    )
    # QoS / overload control for in=http (llm/qos.py; defaults disabled).
    p_run.add_argument(
        "--qos-rate", type=float, default=None, dest="qos_rate",
        help="per-tenant sustained requests/s (token bucket; unset = off)",
    )
    p_run.add_argument(
        "--qos-burst", type=float, default=None, dest="qos_burst",
        help="per-tenant burst allowance (default 2x rate)",
    )
    p_run.add_argument(
        "--brownout", action="store_true",
        help="enable the brownout degradation ladder (docs/qos.md)",
    )
    return parser


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.cmd == "model" and args.verb in ("add", "remove") and not args.name:
        parser.error(f"model {args.verb} requires a model name")
    if args.cmd == "model" and args.verb == "add" and not args.endpoint:
        parser.error("model add requires an endpoint path")
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
    # The command line as given: the node's other ranks run it again.
    args.run_argv = list(argv if argv is not None else sys.argv[1:])
    return args


def main(argv: Optional[list] = None) -> None:
    # DYN_LOG / DYN_LOG_FORMAT / DYN_LOG_FILE (reference logging.rs)
    from .runtime.logging_config import setup_logging

    setup_logging()
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == [RANK_ROLE]:
        # A node's other local rank, started by its rank 0 (start_ranks).
        die_with_parent(int(argv[2]))
        try:
            asyncio.run(run_rank(int(argv[1]), parse_args(argv[3:])))
        except KeyboardInterrupt:
            pass
        return
    args = parse_args(argv)
    if args.cmd == "deploy":
        _run_deploy(args)
        return
    if args.cmd == "prepare":
        _run_prepare(args)
        return
    run = {
        "hub": _run_hub, "http": _run_http_frontend, "run": _run,
        "metrics": _run_metrics, "mock-worker": _run_mock_worker,
        "model": _run_model_cmd, "operator": _run_operator, "api-store": _run_api_store,
    }[args.cmd]
    try:
        asyncio.run(run(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()

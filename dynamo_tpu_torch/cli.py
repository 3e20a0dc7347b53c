"""CLI launcher for the port — the ``run`` command of the JAX package's
``cli.py`` (reference: launch/dynamo-run, ``dynamo-run in=… out=…``).

Usage:
  python -m dynamo_tpu_torch.cli run in=http out=torch --arch llama-3.1-8b \\
        --model llama-3.1-8b [--port 8000] [--device cpu]   # OpenAI server
  python -m dynamo_tpu_torch.cli run in=text out=torch ...       # chat REPL
  python -m dynamo_tpu_torch.cli run in=stdin out=torch ...      # one prompt
  python -m dynamo_tpu_torch.cli run in=batch:FILE.jsonl out=torch ...
  python -m dynamo_tpu_torch.cli run in=http out=echocore        # no model

``out=torch`` is ``TorchEngine`` on the first CUDA device unless
``--device cpu`` is given; ``out=echocore|echofull`` echo the prompt.
``in=http`` reads the edge's ``qos`` and ``tracing`` sections from the
layered config (``DYN_RUNTIME_CONFIG`` file, then ``DYN_QOS__*`` /
``DYN_TRACING__*`` env), as the JAX ``run in=http`` does: per-tenant
quotas and the brownout ladder fed by the engine's KV usage, and a
colocated span exporter feeding the ``/traces`` aggregator.  The
flags keep the JAX parser's names and defaults.  Its options that the port
does not have yet fail when set (engine/__init__.py UNSUPPORTED_OPTIONS);
the other JAX subcommands (hub, http over a hub, workers, planner, deploy)
are not ported.  The tokenizer is the self-contained byte tokenizer, the
JAX CLI's default without ``--tokenizer`` or ``--checkpoint``.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
from typing import Callable, Optional

from .engine import build_torch_engine
from .llm.backend import Backend
from .llm.engines import EchoEngineCore, EchoEngineFull
from .llm.http_service import HttpService
from .llm.metrics import engine_dispatch_metrics, kv_tier_metrics
from .llm.preprocessor import OpenAIPreprocessor
from .llm.tokenizer import ByteTokenizer
from .runtime.config import RuntimeConfig
from .runtime.pipeline import build_pipeline

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


def _edge_qos():
    """QosController for the HTTP edge from the layered ``qos`` config
    section (llm/qos.py; the JAX ``http`` command's --qos-*/--brownout
    overrides come with that command, ROADMAP queue 1 item 10).  Returns
    None when neither quotas nor the brownout ladder are enabled — zero
    behaviour change by default."""
    from .llm.qos import QosConfig, QosController

    section = dict(RuntimeConfig.from_layers().qos)
    for key in ("tenant_weights", "default_weight", "batch_every"):
        section.pop(key, None)  # scheduler half (engine/__init__.py)
    cfg = QosConfig.from_dict(section)
    if cfg.rate is None and cfg.brownout is None:
        return None
    return QosController(cfg)


async def _run(args, on_serving: Optional[Callable[[HttpService], None]] = None) -> None:
    """Serve ``args.inp`` through the pipeline onto ``args.out``.  With
    ``in=http``, ``on_serving`` is called with the service once it listens
    (its ``port`` resolved); the server runs until this task is cancelled."""
    inp = args.inp
    if inp not in INPUTS and not inp.startswith("batch:"):
        raise SystemExit(
            f"in={inp} is not supported by the port (it has in=http|text|stdin|batch:FILE|none; "
            "workers over a hub are ROADMAP queue 1 item 10)"
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
        if inp == "http":
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
    p_run = sub.add_parser("run", help="in=… out=… launcher")
    p_run.add_argument("inout", nargs=2, metavar="in=/out=")
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
    # The JAX parser's options that out=torch lacks: accepted so that
    # setting one fails with where it waits (build_torch_engine).
    p_run.add_argument("--checkpoint", default=None)
    for flag in ("--tp", "--dp", "--ep", "--sp", "--nnodes"):
        p_run.add_argument(flag, type=int, default=1)
    p_run.add_argument("--kv-pull-mb", type=int, default=None)
    p_run.add_argument("--spec-decode", action="store_true", default=None)
    for flag in ("--spec-k", "--spec-ngram-min", "--spec-ngram-max",
                 "--lora-max-adapters", "--lora-rank"):
        p_run.add_argument(flag, type=int, default=None)
    p_run.add_argument("--lora", action="append", default=None, metavar="NAME=SPEC")
    return parser


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    args = build_parser().parse_args(argv)
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
    try:
        asyncio.run(_run(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()

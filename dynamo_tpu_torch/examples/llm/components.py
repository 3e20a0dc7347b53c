"""Example LLM serving components — the port's copy of the JAX package's
``examples/llm/components.py`` (the SDK counterpart of the reference's
examples/llm/components/{frontend,processor,worker}.py), on ``TorchEngine``.

Services:
- ``TorchWorker`` — the port's engine serving token-in/token-out,
  publishing KV events + metrics (1 GPU by default; ``device: cpu`` in its
  service config runs it on the CPU, as ``run --device cpu`` does; ``tp``
  above 1 starts the other ranks as ``run --tp`` does and serves as their
  leader).
- ``Processor``  — tokenizes OpenAI requests and routes token requests to
  workers (round-robin here; the HTTP frontend's --router kv does KV-aware
  routing in the main serving path).
- ``Frontend``   — entry service; in this deployment the OpenAI HTTP edge
  runs via ``--http-port`` on the runner, so Frontend only anchors the graph.
"""

from __future__ import annotations

import asyncio
from typing import Any, AsyncIterator, Dict

from ...engine.config import EngineConfig
from ...llm.backend import Backend
from ...llm.discovery import make_tokenizer, register_model
from ...llm.preprocessor import OpenAIPreprocessor
from ...runtime.engine import Context
from ...runtime.pipeline import build_pipeline
from ...sdk import async_on_start, depends, dynamo_endpoint, service


@service(namespace="examples", resources={"gpu": 1})
class TorchWorker:
    """Native engine worker (reference: components/worker.py VllmWorker)."""

    def __init__(self, config: Dict[str, Any] | None = None):
        self.config = config or {}
        self.engine = None
        self._ready = asyncio.Event()

    @async_on_start
    async def boot(self) -> None:
        from ...engine.engine import TorchEngine
        from ...llm.kv_router.publisher import (
            KvEventPublisher,
            KvMetricsPublisher,
        )

        tp = int(self.config.get("tp", 1))
        cfg = EngineConfig(
            model=self.config.get("model", "debug-tiny"),
            block_size=int(self.config.get("block_size", 16)),
            num_blocks=int(self.config.get("num_blocks", 256)),
            max_batch=int(self.config.get("max_batch", 8)),
            max_model_len=int(self.config.get("max_model_len", 1024)),
            tp=tp,
        )
        # Weights are drawn (or loaded) for seconds at full size: off the
        # event loop, so the instance's lease keeps being renewed.  A
        # request that arrives meanwhile waits in ``generate``.
        if tp > 1:
            self.engine = await self._boot_ranks(cfg)
        else:
            self.engine = await asyncio.to_thread(
                TorchEngine, cfg, device=self.config.get("device")
            )
        self._ready.set()
        component = self.runtime.namespace("examples").component("TorchWorker")
        self.engine.set_event_callback(
            KvEventPublisher(component, self.runtime.worker_id)
        )
        self._metrics_pub = await KvMetricsPublisher(
            component, self.runtime.worker_id, self.engine.metrics
        ).start()
        await register_model(
            self.runtime,
            self.config.get("served_model_name", "example-model"),
            "examples.TorchWorker.generate",  # ns.component.endpoint
            tokenizer={"kind": "byte"},
            kv_block_size=cfg.block_size,
        )

    async def _boot_ranks(self, cfg: EngineConfig):
        """``tp`` ranks as ``run --tp`` starts them (engine/ranks.py): the
        other ranks run ``run in=none`` with this engine's settings and
        replay this one's dispatches."""
        from ...cli import parse_args
        from ...engine import build_torch_engine
        from ...engine.ranks import start_ranks

        argv = ["run", "in=none", "out=torch", "--arch", cfg.model,
                "--block-size", str(cfg.block_size), "--num-blocks", str(cfg.num_blocks),
                "--max-batch", str(cfg.max_batch), "--max-model-len", str(cfg.max_model_len),
                "--tp", str(cfg.tp)]
        if self.config.get("device"):
            argv += ["--device", str(self.config["device"])]
        engine, self._ranks = await start_ranks(parse_args(argv), build_torch_engine)
        return engine

    @dynamo_endpoint
    async def generate(self, request: Context) -> AsyncIterator[Dict]:
        await self._ready.wait()
        stream = await self.engine.generate(request)
        async for item in stream:
            yield item


@service(namespace="examples")
class Processor:
    """Tokenize + forward (reference: components/processor.py)."""

    worker = depends(TorchWorker, endpoint="generate")

    def __init__(self, config: Dict[str, Any] | None = None):
        self.config = config or {}
        tokenizer = make_tokenizer({"kind": "byte"})
        model = self.config.get("served_model_name", "example-model")
        self._stages = [OpenAIPreprocessor(tokenizer, model), Backend(tokenizer)]

    @dynamo_endpoint
    async def chat(self, request: Context) -> AsyncIterator[Dict]:
        pipeline = build_pipeline(list(self._stages), self.worker.client)
        stream = await pipeline.generate(request)
        async for item in stream:
            yield item


@service(namespace="examples")
class Frontend:
    """Graph entry (reference: components/frontend.py — there it spawns the
    HTTP binary; here the runner's --http-port serves the OpenAI edge)."""

    processor = depends(Processor, endpoint="chat")

    @dynamo_endpoint
    async def health(self, request: Context) -> AsyncIterator[Dict]:
        yield {"ok": True}


@service(namespace="examples")
class PlannerService:
    """SLA planner riding the worker graph (dynamo_tpu_torch/planner):
    watches the TorchWorker component's metrics topics and emits
    scale/flip decisions — dry-run by default inside the example graph."""

    def __init__(self, config: Dict[str, Any] | None = None):
        self.config = config or {}
        self.planner = None

    @async_on_start
    async def boot(self) -> None:
        from ...planner import (
            DecisionEngine,
            LocalActuator,
            Planner,
            PolicyConfig,
            SignalCollector,
            SloTargets,
        )

        component = self.runtime.namespace("examples").component("TorchWorker")
        collector = await SignalCollector(
            component, model=self.config.get("served_model_name")
        ).start()
        self._collector = collector
        self.planner = await Planner(
            collector,
            DecisionEngine(
                SloTargets.from_dict(self.config),
                PolicyConfig.from_dict(self.config),
            ),
            LocalActuator(self.runtime.hub),
            interval_s=float(self.config.get("interval_s", 2.0)),
            dry_run=bool(self.config.get("dry_run", True)),
        ).start()

    @dynamo_endpoint
    async def status(self, request: Context) -> AsyncIterator[Dict]:
        from ...planner import planner_metrics

        yield planner_metrics.state()

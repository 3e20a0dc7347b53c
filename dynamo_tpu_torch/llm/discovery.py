"""Model discovery: hub-watched ModelEntry registry → live HTTP models.

A copy of the JAX package's ``llm/discovery.py``.  Reference semantics:
lib/llm/src/http/service/discovery.rs:36-166 — the HTTP frontend watches
``models/`` registrations; a Put builds a typed remote pipeline and adds it
to the ModelManager, a Delete (lease expiry = worker death) removes it.
Workers register a ``ModelEntry`` naming the token-level endpoint they
serve plus enough tokenizer info for the frontend to run the preprocessor
locally (the reference ships this in the ModelDeploymentCard).

Entry key: ``models/{model_name}/{worker_id}`` so multiple workers can back
one model; the engine is added on the first entry, removed with the last.

LoRA adapter entries (``register_model(lora=...)``) build adapter-stamping
pipelines onto the base model's endpoint.  Tokenizer specs: ``byte``,
``hf`` (a ``tokenizer.json`` file or a directory holding one,
llm/hf_tokenizer.py), ``gguf`` (the tokenizer a GGUF embeds) and ``sp``
(the sentencepiece ``tokenizer.model``, llm/sp.py).  The watcher keeps one
``GrammarCompiler`` per tokenizer spec, shared by every pipeline of that
tokenizer (llm/tenancy/grammar.py).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
from typing import Any, Dict, Optional

from ..runtime.client import RouterMode
from ..runtime.component import DistributedRuntime, parse_endpoint_path
from ..runtime.pipeline import build_pipeline
from ..runtime.transports.shard import hub_key, hub_prefix
from .backend import Backend
from .http_service import ModelManager
from .preprocessor import OpenAIPreprocessor
from .tenancy.grammar import GrammarCompiler
from .tokenizer import BaseTokenizer, ByteTokenizer, HFTokenizer

logger = logging.getLogger(__name__)

MODEL_PREFIX = "models/"


def model_key(name: str, worker_id: int) -> str:
    """Per-worker model registration key (shard-map routed)."""
    return hub_key("models", name, worker_id)


def model_prefix(name: str) -> str:
    """Query prefix for one model's registrations across workers."""
    return hub_prefix("models", name)


def make_tokenizer(spec: Dict[str, Any]) -> BaseTokenizer:
    kind = (spec or {}).get("kind", "byte")
    if kind == "byte":
        return ByteTokenizer()
    if kind == "hf":
        if "file" in spec:
            return HFTokenizer(spec["file"])
        d = spec["dir"]
        if not os.path.exists(os.path.join(d, "tokenizer.json")) and spec.get("source"):
            # Registered dirs are paths on the REGISTERING worker's
            # filesystem; a frontend on another host re-resolves the
            # original model spec (a pre-staged copy, models/hub.py)
            # instead of silently failing the model registration.
            from ..models.hub import resolve_model

            logger.info("tokenizer dir %s not on this host; resolving %r locally",
                        d, spec["source"])
            d = resolve_model(spec["source"])
        return HFTokenizer.from_pretrained_dir(d)
    if kind == "gguf":
        f = spec["file"]
        if not os.path.exists(f) and spec.get("source"):
            from ..models.hub import resolve_model

            f = resolve_model(spec["source"])
        from ..models.gguf import GGUFFile

        return GGUFFile(f).to_tokenizer()
    if kind == "sp":
        from .tokenizer import SentencePieceTokenizer

        f = spec["file"]
        if not os.path.exists(f) and spec.get("source"):
            # Registered paths are the REGISTERING worker's; a frontend on
            # another host re-resolves the original model spec (a
            # pre-staged copy, models/hub.py).
            from ..models.hub import resolve_model

            f = os.path.join(resolve_model(spec["source"]), "tokenizer.model")
        return SentencePieceTokenizer(f)
    raise ValueError(f"unknown tokenizer kind {kind!r}")


async def register_model(
    runtime: DistributedRuntime,
    name: str,
    endpoint_path: str,
    model_type: str = "both",  # chat | completion | both
    tokenizer: Optional[Dict[str, Any]] = None,
    lease: Optional[int] = None,
    kv_block_size: int = 16,
    static: bool = False,  # no lease: survives the registrar (llmctl mode)
    lora: Optional[Dict[str, Any]] = None,  # adapter entry: {"adapter", "base"}
) -> str:
    """Worker-side model registration (reference: llmctl + ModelEntry).

    ``lora`` marks the entry as a LoRA adapter alias (llm/tenancy): the
    frontend's ModelWatcher builds its pipeline with an adapter-stamping
    preprocessor, so requests naming this model route to the base engine
    with tenant identity (adapter id + KV salt) attached."""
    key = model_key(name, runtime.worker_id)
    entry = {
        "name": name,
        "endpoint": endpoint_path,
        "model_type": model_type,
        "tokenizer": tokenizer or {"kind": "byte"},
        # Routers must hash with the engine's block size or overlap is zero.
        "kv_block_size": kv_block_size,
    }
    if lora:
        entry["lora"] = dict(lora)
    if static:
        await runtime.hub.kv_put(key, entry)  # persistent, no liveness tie
        return key
    if lease is None:
        await runtime.register_key(key, entry)  # self-healing registration
        return key
    await runtime.hub.kv_put(key, entry, lease)
    return key


class ModelWatcher:
    """Watches model registrations and maintains a ModelManager."""

    def __init__(
        self,
        runtime: DistributedRuntime,
        manager: ModelManager,
        router_mode: RouterMode = RouterMode.ROUND_ROBIN,
    ):
        self.runtime = runtime
        self.manager = manager
        self.router_mode = router_mode
        self._refcount: Dict[str, int] = {}
        self._clients: Dict[str, Any] = {}
        # One grammar compile cache per tokenizer spec (llm/tenancy):
        # constraint→automaton indexing costs seconds on big vocabularies,
        # and the base model plus its adapter aliases share a tokenizer —
        # per-pipeline caches would recompile the same schema per served
        # name and lose the warm cache on every watch rebuild.
        self._grammar_compilers: Dict[str, Any] = {}
        self._router_cores: Dict[str, Any] = {}
        self._task: Optional[asyncio.Task] = None
        self._watcher = None

    async def start(self) -> "ModelWatcher":
        self._watcher = await self.runtime.hub.watch_prefix(MODEL_PREFIX)
        self._task = asyncio.create_task(self._run())
        await self._watcher.synced.wait()
        return self

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        if self._watcher is not None:
            await self._watcher.aclose()
        for core in self._router_cores.values():
            await core.stop()
        self._router_cores.clear()
        for client in self._clients.values():
            await client.close()
        self._clients.clear()

    async def _run(self) -> None:
        """Model watch with hub-restart recovery: on watcher death (e.g.
        ``HubSessionLost``) the watch is re-armed and the served-model set
        resynced — models deregistered during the outage tear down, new
        ones build, surviving ones keep their warm pipelines."""
        backoff = 0.1
        while True:
            try:
                async for event in self._watcher:
                    backoff = 0.1
                    name = event.key[len(MODEL_PREFIX) :].rsplit("/", 1)[0]
                    try:
                        if event.type == "put":
                            await self._handle_put(name, event.value)
                        else:
                            await self._handle_delete(name)
                    except asyncio.CancelledError:
                        raise
                    except Exception:  # noqa: BLE001 — keep watching
                        logger.exception(
                            "model watcher failed handling %s", event.key
                        )
                return  # closed cleanly (stop())
            except asyncio.CancelledError:
                return
            except Exception:  # noqa: BLE001 — re-arm below
                logger.exception("model watch died; re-arming + resync")
            while True:
                try:
                    await asyncio.sleep(backoff)
                    backoff = min(backoff * 2, 5.0)
                    old, self._watcher = self._watcher, None
                    if old is not None:
                        try:
                            await old.aclose()
                        except asyncio.CancelledError:
                            raise
                        except Exception:  # noqa: BLE001 — dead watcher
                            pass
                    self._watcher = await self.runtime.hub.watch_prefix(
                        MODEL_PREFIX
                    )
                    await self._resync()
                    break
                except asyncio.CancelledError:
                    return
                except Exception:  # noqa: BLE001 — hub still down
                    logger.warning("model watch re-arm failed; retrying")

    async def _resync(self) -> None:
        """Reconcile against the hub's current model registrations after a
        watch gap.  Names gone from the hub tear down now; refcounts reset
        to zero because the re-armed watch replays the current keys as its
        snapshot (each put re-counts one registration) — ``_handle_put``
        reuses live pipelines, so surviving models keep warm state."""
        snapshot = await self.runtime.hub.kv_get_prefix(MODEL_PREFIX)
        live = {
            key[len(MODEL_PREFIX):].rsplit("/", 1)[0]
            for key in snapshot
        }
        for name in [n for n in list(self._clients) if n not in live]:
            self._refcount[name] = 1  # force the teardown path
            await self._handle_delete(name)
        self._refcount = {}

    async def _handle_put(self, name: str, entry: Dict[str, Any]) -> None:
        self._refcount[name] = self._refcount.get(name, 0) + 1
        if name in self._clients:
            # Already built (refcount > 1, or a post-resync snapshot replay
            # re-counting a surviving model): keep the warm pipeline.
            return
        ns, comp, ep = parse_endpoint_path(entry["endpoint"])
        endpoint = self.runtime.namespace(ns).component(comp).endpoint(ep)
        client = await endpoint.client(router_mode=self.router_mode)
        self._clients[name] = client
        sink: Any = client
        if self.router_mode == RouterMode.KV:
            from .kv_router.router import KvPushRouter, KvRouterCore

            core = await KvRouterCore(
                endpoint.component,
                client,
                block_size=int(entry.get("kv_block_size", 16)),
            ).start()
            self._router_cores[name] = core
            sink = KvPushRouter(core)
        tokenizer = make_tokenizer(entry.get("tokenizer"))
        # Adapter-alias entries (llm/tenancy): the preprocessor stamps the
        # adapter id + KV salt so the engine (and the KV router above, when
        # router_mode == KV) resolves tenant identity per request.
        adapter = (entry.get("lora") or {}).get("adapter")
        tok_key = json.dumps(entry.get("tokenizer"), sort_keys=True)
        compiler = self._grammar_compilers.get(tok_key)
        if compiler is None:
            compiler = self._grammar_compilers[tok_key] = GrammarCompiler(tokenizer)
        pipeline = build_pipeline(
            [
                OpenAIPreprocessor(tokenizer, name, adapter=adapter, grammar_compiler=compiler),
                Backend(tokenizer),
            ],
            sink,
        )
        model_type = entry.get("model_type", "both")
        if model_type in ("chat", "both"):
            self.manager.add_chat_model(name, pipeline)
        if model_type in ("completion", "both"):
            self.manager.add_completion_model(name, pipeline)
        logger.info("model added: %s → %s", name, entry["endpoint"])

    async def _handle_delete(self, name: str) -> None:
        if name not in self._refcount:
            return
        self._refcount[name] -= 1
        if self._refcount[name] > 0:
            return
        del self._refcount[name]
        self.manager.remove_model(name)
        core = self._router_cores.pop(name, None)
        if core is not None:
            await core.stop()
        client = self._clients.pop(name, None)
        if client is not None:
            await client.close()
        logger.info("model removed: %s", name)

"""KvRouter: KV-cache-aware request routing as an AsyncEngine.

A copy of the JAX package's ``llm/kv_router/router.py``, with the
``kv_prefetch`` publisher the core starts, the ``kv_pull`` hint the push
router stamps for the cross-worker prefix pull (llm/kv_router/pull.py),
and the planner's ``PlannerDirectiveWatcher``, which enacts the
autopilot's directives through ``warm_hot_chains`` and
``apply_tier_weights``.

Reference semantics: lib/llm/src/kv_router.rs:52-169 — the router subscribes
the worker fleet's ``kv_events``, keeps the global prefix index, and answers
"which worker should run these tokens" by combining prefix overlap with live
worker load (ForwardPassMetrics).  Two faces:

- ``KvRouter``: the standalone service engine (components/router) —
  RouterRequest {"token_ids"} → RouterResponse {"worker_id",
  "overlap_blocks"}.
- ``KvPushRouter``: drop-in pipeline sink that routes a PreprocessedRequest
  to the chosen worker via ``client.direct`` (what the reference's processor
  does in examples/llm/components/kv_router.py + processor.py).

Worker liveness: instance set comes from the endpoint client's hub watch;
workers that disappear are pruned from the index (indexer.remove_worker —
the reference does this on etcd lease loss, kv_router/indexer.rs:380).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, AsyncIterator, Dict, Optional, Tuple

from ...runtime.client import Client
from ...runtime.engine import AsyncEngine, Context, ResponseStream
from ...tokens import fast_sequence_hashes
from .indexer import KvIndexer, KvIndexerSharded, OverlapScores, WorkerId
from .publisher import KV_EVENTS_TOPIC, KvMetricsAggregator, unpack_message
from .scheduler import KvScheduler, KVHitRateEvent, KV_HIT_RATE_SUBJECT, WorkerSelector

logger = logging.getLogger(__name__)


class HotChainTracker:
    """Decayed hit counts over routed prefix NODES — the prefetch plane's
    'hottest chains' source (docs/kv_tiering.md).

    Weight accumulates PER PREFIX NODE (each leading block hash), not per
    full chain: two multi-turn requests over one shared system prompt end
    in different deepest hashes, but their common leading nodes each get
    credited twice — so shared-prefix heat aggregates exactly where reuse
    happens, and per-request tail blocks stay at weight 1 and decay away.
    ``top()`` returns the hottest nodes' chains (deepest first on equal
    weight, strict prefixes of an already-selected chain deduplicated),
    which the KvPrefetchPublisher pushes to workers so they can warm those
    prefixes disk→host AHEAD of the next arrival."""

    def __init__(self, max_chains: int = 256, max_depth: int = 32):
        self.max_chains = max_chains
        self.max_depth = max_depth
        # prefix-node hash → [weight, [leading hashes up to this node]]
        self._chains: Dict[int, list] = {}

    def record(self, seq_hashes) -> None:
        hashes = list(seq_hashes[: self.max_depth])
        decayed = False
        for d, h in enumerate(hashes):
            row = self._chains.get(h)
            if row is not None:
                row[0] += 1.0
                continue
            if len(self._chains) >= self.max_chains:
                # Decay AT MOST ONCE per recorded chain: a single deep
                # never-seen chain must not halve the table per node (32
                # halvings would erase the entire heat history).
                if decayed:
                    continue
                self._decay_and_prune()
                decayed = True
                if len(self._chains) >= self.max_chains:
                    continue  # full of hotter nodes: drop this one
            self._chains[h] = [1.0, hashes[: d + 1]]

    def _decay_and_prune(self) -> None:
        """Make room: drop cold one-hit entries first; only if the table
        is STILL full does every weight halve, pruning what falls under
        1.0 — so the halving pass always frees the warm-but-not-hot band
        and steady per-request tail churn cannot erase genuinely hot
        nodes, while yesterday's hot prompt still fades instead of
        squatting forever."""
        for k in [k for k, row in self._chains.items() if row[0] < 1.5]:
            del self._chains[k]
        if len(self._chains) >= self.max_chains:
            for row in self._chains.values():
                row[0] *= 0.5
            for k in [k for k, row in self._chains.items() if row[0] < 1.0]:
                del self._chains[k]

    def top(self, n: int = 8):
        """The ``n`` hottest distinct chains, hottest first.  On equal
        weight the DEEPER node wins (its chain subsumes the shallower
        ones, which are then deduplicated as strict prefixes); remaining
        ties break on the node hash — fully deterministic."""
        ranked = sorted(
            self._chains.items(),
            key=lambda kv: (-kv[1][0], -len(kv[1][1]), kv[0]),
        )
        out: list = []
        for _, row in ranked:
            chain = row[1]
            if any(sel[: len(chain)] == chain for sel in out):
                continue  # strict prefix of a hotter selected chain
            out.append(chain)
            if len(out) >= n:
                break
        return out


class KvRouterCore:
    """Index + metrics + selection (shared by both router faces)."""

    def __init__(
        self,
        component,
        client: Client,
        block_size: int,
        selector: Optional[WorkerSelector] = None,
        sharded: bool = False,
        publish_hit_rate: bool = True,
    ):
        self.component = component
        self.client = client
        self.block_size = block_size
        self.indexer = (
            KvIndexerSharded(block_size) if sharded else KvIndexer(block_size)
        )
        self.aggregator = KvMetricsAggregator(component)
        self.scheduler = KvScheduler(
            block_size,
            selector=selector,
            hit_rate_callback=self._on_hit_rate if publish_hit_rate else None,
        )
        self._event_task: Optional[asyncio.Task] = None
        self._event_sub = None
        self._known_workers: set = set()
        self._bg: set = set()
        # Prefetch plane input: decayed hit counts over routed prefix
        # chains (KvPrefetchPublisher reads top()).
        self.hot_chains = HotChainTracker()
        self._prefetch_pub = None

    async def start(self) -> "KvRouterCore":
        self._event_sub = await self.component.subscribe(KV_EVENTS_TOPIC)
        self._event_task = asyncio.get_running_loop().create_task(self._event_loop())
        await self.aggregator.start()
        # Prefetch plane: push the hottest routed chains so workers with a
        # disk tier warm them ahead of arrivals.
        from .pull import KvPrefetchPublisher

        self._prefetch_pub = await KvPrefetchPublisher(self).start()
        return self

    async def stop(self) -> None:
        if self._prefetch_pub is not None:
            await self._prefetch_pub.stop()
            self._prefetch_pub = None
        if self._event_task is not None:
            self._event_task.cancel()
            try:
                await self._event_task
            except asyncio.CancelledError:
                pass
            self._event_task = None
        if self._event_sub is not None and hasattr(self._event_sub, "aclose"):
            await self._event_sub.aclose()
        await self.aggregator.stop()

    async def _event_loop(self) -> None:
        from .protocols import KvCacheEvent

        try:
            async for msg in self._event_sub:
                payload = unpack_message(msg)
                try:
                    worker = payload["worker_id"]
                    event = KvCacheEvent.from_dict(payload["event"])
                except (KeyError, TypeError):
                    logger.warning("malformed kv_event payload: %r", payload)
                    continue
                self.indexer.apply_event(worker, event)
        except asyncio.CancelledError:
            pass

    def _on_hit_rate(self, event: KVHitRateEvent) -> None:
        loop = asyncio.get_event_loop()
        task = loop.create_task(
            self.component.publish(KV_HIT_RATE_SUBJECT, event.to_dict())
        )
        self._bg.add(task)
        task.add_done_callback(self._bg.discard)

    def _prune_dead_workers(self, live: set) -> None:
        for gone in self._known_workers - live:
            logger.info("pruning dead worker %s from kv index", gone)
            self.indexer.remove_worker(gone)
            self.aggregator.remove_worker(gone)
        self._known_workers = live

    def select(
        self, token_ids, salt: Optional[str] = None
    ) -> Tuple[Optional[WorkerId], int]:
        """(best worker, overlap_blocks); None if no instances.  ``salt``
        is the tenant KV salt (llm/tenancy) — overlap hashing must match
        the engine's salted sealing or scores diverge from cache state."""
        winner, overlap = self.select_with_scores(token_ids, salt)
        return winner, overlap.scores.get(winner, 0) if winner is not None else 0

    def select_with_scores(
        self, token_ids, salt: Optional[str] = None
    ) -> Tuple[Optional[WorkerId], OverlapScores]:
        """``select`` plus the full per-worker overlap — what the push
        router needs to stamp cross-worker pull hints (a peer with a
        strictly deeper RAW prefix than the winner's)."""
        live = set(self.client.instance_ids)
        if live != self._known_workers:
            self._prune_dead_workers(live)
        if not live:
            return None, OverlapScores()
        hashes = fast_sequence_hashes(token_ids, self.block_size, salt)
        self.hot_chains.record(hashes)
        overlap = self.indexer.find_matches_for_hashes(hashes)
        # Dead workers may linger in the index until their Removed/watch
        # events land; never hint (or route) toward one.
        overlap = OverlapScores(
            {w: n for w, n in overlap.scores.items() if w in live},
            {w: d for w, d in overlap.discounted.items() if w in live},
        )
        workers = self.aggregator.endpoints(sorted(live))
        winner = self.scheduler.schedule(len(token_ids), overlap, workers)
        return winner, overlap

    async def warm_hot_chains(
        self, top_n: Optional[int] = None, persist: bool = False
    ) -> None:
        """Enact a ``kv_prefetch`` directive: push the hottest routed
        chains NOW (out of band of the publisher's own cadence), with
        ``persist=True`` pinning them into the durable object-store tier."""
        if self._prefetch_pub is not None:
            await self._prefetch_pub.publish_once(top_n=top_n, persist=persist)

    def apply_tier_weights(self, weights: Dict[str, float]) -> None:
        """Enact a ``set_tier_weights`` directive: replace the cold-start
        restore-cost table with the autopilot's measured weights."""
        self.indexer.set_tier_weights(weights)


class KvRouter(AsyncEngine):
    """Standalone routing service (reference: components/router)."""

    def __init__(self, core: KvRouterCore):
        self.core = core

    async def generate(self, request: Context) -> ResponseStream:
        token_ids = request.data["token_ids"]
        worker_id, overlap = self.core.select(
            token_ids, request.data.get("kv_salt")
        )

        async def gen() -> AsyncIterator[Dict[str, Any]]:
            yield {"worker_id": worker_id, "overlap_blocks": overlap}

        return ResponseStream(gen(), request.ctx)


class KvPushRouter(AsyncEngine):
    """Pipeline sink: route PreprocessedRequest to the overlap-best worker.

    Falls back to round-robin when no worker has been selected (e.g. no KV
    events yet) — the client handles that internally via ``generate``.
    """

    def __init__(self, core: KvRouterCore):
        self.core = core

    async def generate(self, request: Context) -> ResponseStream:
        token_ids = request.data.get("token_ids") or []
        # Tenant requests (llm/tenancy) carry their KV salt in annotations;
        # the engine seals their blocks under the same salt, so routing
        # overlap only means anything when hashed identically.
        annotations = request.data.get("annotations") or {}
        worker_id, overlap = self.core.select_with_scores(
            token_ids, annotations.get("kv_salt")
        )
        if worker_id is None:
            return await self.core.client.generate(request)
        # Cross-worker prefix pull hint: when a PEER holds a strictly
        # deeper RAW prefix than the winner (the winner won on tier heat /
        # load), tell the winner who to pull the sealed delta blocks from
        # instead of recomputing prefill.  The engine still compares
        # against its own tiers at admission — the hint is advisory and
        # bounded by the pull budgets.
        donor = overlap.deepest()
        if (
            donor is not None
            and donor != worker_id
            and overlap.scores.get(donor, 0) > overlap.scores.get(worker_id, 0)
        ):
            annotations = dict(annotations)
            annotations["kv_pull"] = {
                "worker_id": donor,
                "blocks": overlap.scores[donor],
            }
            request.data["annotations"] = annotations
        return await self.core.client.generate(request, worker_id=worker_id)


async def make_kv_router(
    endpoint,
    block_size: int,
    selector: Optional[WorkerSelector] = None,
    sharded: bool = False,
) -> KvRouterCore:
    """Build + start a router core watching ``endpoint``'s worker fleet."""
    from ...runtime.client import RouterMode

    client = await endpoint.client(router_mode=RouterMode.ROUND_ROBIN)
    core = KvRouterCore(
        endpoint.component, client, block_size, selector=selector, sharded=sharded
    )
    return await core.start()


class PlannerDirectiveWatcher:
    """Router-side consumer of the autopilot's directive slots
    (planner/actuate.py ``directive_key``): watches
    ``planner/directives/`` and enacts the router-enactable kinds —
    ``kv_prefetch`` (publish the hottest chains now, optionally pinning
    them into the durable object-store tier) and ``set_tier_weights``
    (live restore-cost retune).  ``migrate_out`` / ``tune_decode`` are
    supervisor/operator directives and pass through untouched.

    The watch replays standing slots on start, so a freshly (re)started
    router inherits the fleet's current measured tier weights instead of
    routing on the cold-start table until the next retune."""

    def __init__(self, hub, core: KvRouterCore):
        self.hub = hub
        self.core = core
        self.applied = 0
        self._task: Optional[asyncio.Task] = None
        self._watcher = None

    async def start(self) -> "PlannerDirectiveWatcher":
        from ...planner.actuate import DIRECTIVE_PREFIX

        self._watcher = await self.hub.watch_prefix(DIRECTIVE_PREFIX)
        self._task = asyncio.get_running_loop().create_task(self._run())
        await self._watcher.synced.wait()
        return self

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        if self._watcher is not None:
            await self._watcher.aclose()
            self._watcher = None

    async def _run(self) -> None:
        try:
            async for event in self._watcher:
                if event.type != "put" or not isinstance(event.value, dict):
                    continue
                await self._apply(event.value)
        except asyncio.CancelledError:
            pass

    async def _apply(self, directive: Dict[str, Any]) -> None:
        kind = directive.get("kind")
        params = directive.get("params") or {}
        try:
            if kind == "kv_prefetch":
                top_n = params.get("top_n")
                await self.core.warm_hot_chains(
                    top_n=int(top_n) if top_n is not None else None,
                    persist=bool(params.get("persist")),
                )
            elif kind == "set_tier_weights":
                weights = params.get("weights")
                if not isinstance(weights, dict):
                    return
                self.core.apply_tier_weights(
                    {str(t): float(w) for t, w in weights.items()}
                )
            else:
                return
            self.applied += 1
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — a bad directive must not kill the watch
            logger.warning("planner directive %r failed", kind, exc_info=True)

"""Cross-worker prefix pull + planner-led prefetch (a port of the JAX
package's llm/kv_router/pull.py; its docs/kv_tiering.md has the design).
The pull moves over the service plane (``make_client_exporter``), or under
``DYN_BULK_PLANE`` worker to worker over the bulk plane
(``make_bulk_export_source`` / ``make_bulk_exporter``) with the service
plane beneath it as the fallback.

Fleet-wide prefix reuse, layer by layer:

- the tier-aware index (indexer.py) knows which worker holds which prefix
  and in which tier;
- the push router (router.py) stamps ``annotations.kv_pull =
  {worker_id, blocks}`` when a PEER holds a strictly deeper raw prefix
  than the chosen worker;
- at admission the engine hands that hint to its ``PrefixPuller`` (below),
  which — only if the peer's depth strictly beats every LOCAL tier —
  fetches the sealed delta blocks over the existing
  ``export_prompt_blocks``/``inject_blocks`` plane, capped by the
  configured byte + latency budgets.  ANY failure (peer gone, timeout,
  payload rejected by inject validation) degrades to local prefill — the
  disagg degraded-mode shape: the request is never lost, only the
  optimization.

Exactness: a pulled block carries the same stored representation
``inject_blocks`` validates (block_size/dtype/kv_scale), and seals under
the same chained hash the donor sealed it under — so a pulled-prefix
stream is byte-identical to a recomputed one (tests/test_torch_pull.py
holds it, also across packages).

The prefetch half rides the same plane in the other direction: the router
core tracks the hottest routed chains (router.HotChainTracker) and a
``KvPrefetchPublisher`` pushes them on the ``kv_prefetch`` subject; each
worker's ``KvPrefetchConsumer`` promotes those chains disk→host ahead of
the next arrival (engine.prefetch_hashes) — restore cost paid before the
request exists, not inside its TTFT.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, AsyncIterator, Callable, Dict, List, Optional

from ...runtime.engine import Context

logger = logging.getLogger(__name__)

# Peer-serving endpoint name (registered next to kv_import by the CLI's
# decode role): {token_ids, start_block, max_blocks, salt} → one
# {"payload": export_prompt_blocks(...)} item.
KV_EXPORT_ENDPOINT = "kv_export"
KV_PREFETCH_TOPIC = "kv_prefetch"


def make_kv_export_handler(engine):
    """Build the service handler a worker registers at ``kv_export`` so
    peers can pull its sealed prefix blocks."""
    from ...runtime.tracing import parse_trace, span as trace_span

    async def kv_export_handler(request: Context) -> AsyncIterator[Dict]:
        d = request.data
        tokens = list(d["token_ids"])
        salt = d.get("salt")
        # Donor-side span: the export request ships the puller's trace
        # (``d["trace"]``, omit-when-absent — or the service-transport
        # header via request.ctx), so the donor's restore+gather cost shows
        # up inside the pulling request's timeline.
        tc = parse_trace(d.get("trace")) or getattr(request.ctx, "trace", None)
        with trace_span(tc, "kv.export", "kv_donor") as espan:
            # export_prompt_blocks reads HBM only, but the router hints raw
            # tier-tagged depth — a donor whose blocks were DEMOTED must
            # restore them first or the pull's primary scenario (tiered
            # donors) silently exports nothing.
            if getattr(engine, "host_kv", None) is not None:
                await engine.restore_prefix(tokens, salt)
            payload = await engine.export_prompt_blocks(
                tokens,
                start_block=int(d.get("start_block", 0)),
                max_blocks=int(d.get("max_blocks", 0)),
                salt=salt,
            )
            espan.set(
                blocks=int(payload["n_blocks"]) if payload else 0
            )
        yield {"payload": payload}

    return kv_export_handler


class PrefixPuller:
    """Admission-time cross-worker prefix pull for one engine.

    ``exporter(worker_id, data) -> payload|None`` is the peer transport —
    the CLI wires a direct-routed client on the fleet's ``kv_export``
    endpoint; tests wire peer engines directly.  Budgets come from the
    engine config (kv_pull_max_bytes / kv_pull_timeout_s)."""

    def __init__(
        self,
        engine,
        exporter: Callable[[int, Dict[str, Any]], Any],
        max_bytes: Optional[int] = None,
        timeout_s: Optional[float] = None,
    ):
        self.engine = engine
        self.exporter = exporter
        self.max_bytes = (
            engine.cfg.kv_pull_max_bytes if max_bytes is None else max_bytes
        )
        self.timeout_s = (
            engine.cfg.kv_pull_timeout_s if timeout_s is None else timeout_s
        )

    async def pull(
        self,
        token_ids: List[int],
        salt: Optional[str],
        hint: Dict[str, Any],
        trace=None,
    ) -> int:
        """Pull the delta blocks the hinted peer holds beyond every local
        tier.  Returns tokens covered; 0 on any failure or when the local
        tiers already match the peer's depth (nothing worth moving)."""
        from ..metrics import kv_tier_metrics

        try:
            peer = int(hint["worker_id"])
            peer_blocks = int(hint.get("blocks", 0))
        except (KeyError, TypeError, ValueError):
            return 0
        # Hash the chain ONCE: the local-depth walk and the integrity
        # negative-cache check below both consume it, and chained hashing
        # is O(prompt length) on every admission with a peer hint.
        from ...tokens import hash_token_blocks

        chain = hash_token_blocks(token_ids, self.engine.cfg.block_size, salt)
        local = self.engine.local_prefix_blocks(token_ids, salt, blocks=chain)
        if peer_blocks <= local:
            return 0  # local tiers already reach (or beat) the peer
        block_bytes = max(1, self.engine.block_nbytes())
        budget_blocks = max(0, int(self.max_bytes) // block_bytes)
        want = min(peer_blocks - local, budget_blocks)
        # Integrity negative cache: a recently checksum-failed hash in the
        # wanted delta means a pull would re-ship and re-fail the same
        # poison (the donor still HOLDS its corrupt copy — we can only
        # drop ours); recompute locally until the TTL expires.
        delta = chain[local : local + max(want, 0)]
        if self.engine.integrity.any_banned(
            [tb.sequence_hash for tb in delta]
        ) is not None:
            from ..metrics import kv_integrity_metrics

            kv_integrity_metrics.negative_cache_hits_total += 1
            return 0
        # Count the attempt BEFORE any bail-out so failed can never
        # exceed started (dashboards derive success rate from the pair).
        kv_tier_metrics.pulls_started_total += 1
        if want <= 0:
            kv_tier_metrics.pulls_failed_total += 1
            return 0  # byte budget cannot cover even one block
        t0 = time.perf_counter()
        data = {
            "token_ids": list(token_ids),
            "start_block": local,
            "max_blocks": want,
        }
        if salt:
            data["salt"] = salt
        if trace is not None and trace.sampled:
            # Omit-when-absent wire propagation (runtime/tracing.py): the
            # donor's kv_export handler records its span under this trace.
            data["trace"] = trace.to_dict()
        try:
            payload = await asyncio.wait_for(
                self.exporter(peer, data), self.timeout_s
            )
            if not payload:
                kv_tier_metrics.pulls_failed_total += 1
                return 0
            # donor=peer: a checksum-failed payload is attributed to its
            # sender in the health ledger (runtime/health.py) — repeated
            # poison from one donor feeds the watchdog's quarantine path.
            covered = await self.engine.inject_blocks(
                token_ids, payload, salt, donor=peer
            )
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — degraded mode: prefill locally
            logger.warning(
                "cross-worker prefix pull from %s failed; prefilling locally",
                hint.get("worker_id"),
                exc_info=True,
            )
            kv_tier_metrics.pulls_failed_total += 1
            return 0
        if covered <= 0:
            # inject validated and refused (layout/scale/capacity): the
            # blocks never landed — local prefill covers them.
            kv_tier_metrics.pulls_failed_total += 1
            return 0
        kv_tier_metrics.pulls_completed_total += 1
        kv_tier_metrics.pulled_blocks_total += covered // max(
            1, self.engine.cfg.block_size
        )
        kv_tier_metrics.pulled_bytes_total += (
            covered // max(1, self.engine.cfg.block_size)
        ) * block_bytes
        kv_tier_metrics.pull_latency_ms.observe(
            (time.perf_counter() - t0) * 1e3
        )
        return covered


def make_client_exporter(client):
    """Exporter over the service plane: direct-route the fleet's
    ``kv_export`` endpoint client at the donor worker."""

    async def exporter(worker_id: int, data: Dict[str, Any]):
        stream = await client.generate(Context(data), worker_id=worker_id)
        async for item in stream:
            return (item or {}).get("payload")
        return None

    return exporter


def make_bulk_export_source(engine):
    """Donor-side bulk *source* for ``KV_EXPORT_ENDPOINT``: the same
    restore+export the service handler runs, codec-encoded to one blob for
    the peer-to-peer plane (a ``None`` export encodes/decodes to ``None``)."""
    from ...runtime.tracing import parse_trace, span as trace_span
    from ...runtime.transports import codec

    async def source(meta: Dict[str, Any]) -> bytes:
        tokens = list(meta["token_ids"])
        salt = meta.get("salt")
        tc = parse_trace(meta.get("trace"))
        with trace_span(tc, "kv.export", "kv_donor") as espan:
            if getattr(engine, "host_kv", None) is not None:
                await engine.restore_prefix(tokens, salt)
            payload = await engine.export_prompt_blocks(
                tokens,
                start_block=int(meta.get("start_block", 0)),
                max_blocks=int(meta.get("max_blocks", 0)),
                salt=salt,
            )
            espan.set(blocks=int(payload["n_blocks"]) if payload else 0)
        return codec.encode(payload)

    return source


def make_bulk_exporter(rendezvous, fallback, max_bytes: int = 0):
    """Exporter over the bulk plane (``DYN_BULK_PLANE``): hub rendezvous
    mints the one-shot ticket, the payload itself moves worker↔worker over
    ``transports/bulk.py``.  ANY miss — peer runs no bulk server, ticket
    refused, transfer dead after resumes — counts one
    ``dynamo_tpu_bulk_fallbacks_total`` and delegates to ``fallback`` (the
    hub-path exporter, the byte-identity A/B oracle); the puller's own
    degraded mode (local prefill) stays the final rung."""
    from ...runtime.transports import codec
    from ...runtime.transports.bulk import bulk_fetch
    from ..metrics import bulk_metrics

    async def exporter(worker_id: int, data: Dict[str, Any]):
        salt = data.get("salt")
        try:
            # Budget: the pull byte budget plus framing/metadata slack.
            prep = await rendezvous.prepare(
                worker_id,
                salt=salt,
                budget=(int(max_bytes) * 2 + (1 << 20)) if max_bytes else 0,
            )
            if prep is None:
                raise RuntimeError("bulk rendezvous unavailable")
            address, ticket = prep
            blob = await bulk_fetch(
                address, KV_EXPORT_ENDPOINT, ticket, meta=data, salt=salt
            )
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — fallback ladder: hub path next
            logger.warning(
                "bulk prefix pull from %s failed; falling back to the hub "
                "path",
                worker_id,
                exc_info=True,
            )
            bulk_metrics.fallbacks_total += 1
            return await fallback(worker_id, data)
        return codec.decode(blob) if blob else None

    return exporter


class KvPrefetchPublisher:
    """Router-side: periodically publish the hottest routed prefix chains
    so workers can warm them disk→host ahead of arrivals (planner-led
    prefetch — the same push plane the planner's signal feeds ride)."""

    def __init__(self, core, interval: float = 2.0, top_n: int = 8):
        self.core = core
        self.interval = interval
        self.top_n = top_n
        self._task: Optional[asyncio.Task] = None

    async def start(self) -> "KvPrefetchPublisher":
        self._task = asyncio.get_running_loop().create_task(self._run())
        return self

    async def publish_once(
        self, top_n: Optional[int] = None, persist: bool = False
    ) -> None:
        """One push; the autopilot's warming directive calls this with
        ``persist=True`` so workers ALSO pin the chains into the durable
        object-store tier (engine.persist_hashes) — the next
        scale-from-zero worker restores them instead of recomputing."""
        chains = self.core.hot_chains.top(self.top_n if top_n is None else top_n)
        if chains:
            msg: dict = {"chains": chains}
            if persist:
                msg["persist"] = True
            await self.core.component.publish(KV_PREFETCH_TOPIC, msg)

    async def _run(self) -> None:
        while True:
            try:
                await self.publish_once()
            except asyncio.CancelledError:
                return
            except Exception:  # noqa: BLE001 — prefetch is best-effort
                logger.warning("kv prefetch publish failed", exc_info=True)
            try:
                await asyncio.sleep(self.interval)
            except asyncio.CancelledError:
                return

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None


class KvPrefetchConsumer:
    """Worker-side: subscribe ``kv_prefetch`` and promote the published
    chains disk→host (engine.prefetch_hashes).  Promotion is budgeted and
    skips anything already resident in a faster tier."""

    def __init__(self, component, engine):
        self.component = component
        self.engine = engine
        self._task: Optional[asyncio.Task] = None
        self._sub = None

    async def start(self) -> "KvPrefetchConsumer":
        self._sub = await self.component.subscribe(KV_PREFETCH_TOPIC)
        self._task = asyncio.get_running_loop().create_task(self._run())
        return self

    async def _run(self) -> None:
        from .publisher import unpack_message

        try:
            async for msg in self._sub:
                payload = unpack_message(msg)
                chains = (
                    payload.get("chains") if isinstance(payload, dict) else None
                )
                if not chains:
                    continue
                persist = bool(payload.get("persist"))
                for chain in chains:
                    hashes = [int(h) for h in chain]
                    try:
                        await self.engine.prefetch_hashes(hashes)
                        if persist and hasattr(self.engine, "persist_hashes"):
                            await self.engine.persist_hashes(hashes)
                    except asyncio.CancelledError:
                        raise
                    except Exception:  # noqa: BLE001 — best-effort warmup
                        logger.warning("kv prefetch failed", exc_info=True)
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

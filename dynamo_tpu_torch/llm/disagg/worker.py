"""Disaggregated decode + prefill worker orchestration (a copy of the JAX
package's ``llm/disagg/worker.py`` over ``TorchEngine``).

decode side (``DisaggDecodeWorker`` wraps the decode engine):
1. request arrives; ask the engine how much prefix is already local;
2. DisaggregatedRouter decides local vs remote using (prefill_len −
   prefix_hit, queue depth);
3. remote: enqueue {token_ids, reply address} on the PrefillQueue and wait;
4. the prefill worker computes the prompt KV on its own engine, then calls
   this worker's ``kv_import`` endpoint with the block payload;
5. ``inject_blocks`` seals the blocks into the decode cache → the normal
   ``engine.generate`` admission sees a (near-)full prefix hit and decode
   proceeds — no special remote state inside the scheduler;
6. timeout or transfer failure falls back to local prefill (the request is
   never lost — at-least-once queue semantics cover prefill-worker death).

prefill side (``PrefillWorkerLoop``): pull → generate(max_tokens=1, KV
retained via prefix cache) → export blocks → push to the decode worker's
import endpoint → ack.
"""

from __future__ import annotations

import asyncio
import logging
import time
import uuid
from typing import Any, AsyncIterator, Dict, Optional

from ...runtime.client import Client
from ...runtime.engine import AsyncEngine, Context, ResponseStream
from ...runtime.tracing import parse_trace, span as trace_span
from ..protocols import PreprocessedRequest
from .prefill_queue import PrefillQueue
from .router import DisaggregatedRouter

logger = logging.getLogger(__name__)

KV_IMPORT_ENDPOINT = "kv_import"


class DisaggDecodeWorker(AsyncEngine):
    def __init__(
        self,
        engine,
        queue: PrefillQueue,
        router: DisaggregatedRouter,
        import_address: str,
        import_path: str,
        transfer_timeout: float = 30.0,
    ):
        self.engine = engine
        self.queue = queue
        self.router = router
        self.import_address = import_address
        self.import_path = import_path
        self.transfer_timeout = transfer_timeout
        self._pending: Dict[str, asyncio.Future] = {}
        self._covered: Dict[str, int] = {}  # per-transfer chunk accumulation
        # Planner drain/role-flip support: while draining, no NEW remote
        # prefills are enqueued (everything serves locally) so the pending
        # set can only shrink.
        self.draining = False
        self.remote_prefills = 0
        self.local_prefills = 0
        # Degraded-mode fallbacks: remote prefill abandoned (timeout, queue
        # unreachable, deadline pressure) and served by local prefill instead.
        self.degraded_fallbacks = 0
        from collections import deque as _deque

        # rolling remote-prefill wait wall (TTFT input), bounded
        self.transfer_ms = _deque(maxlen=1024)

    def stats(self) -> Dict[str, Any]:
        """Disaggregation counters (served at the worker's disagg_stats
        endpoint).  remote_prefills counts transfers that LANDED; a
        timeout-fallback increments local_prefills instead — so an e2e can
        assert the remote path actually ran."""
        ms = list(self.transfer_ms)
        return {
            "remote_prefills": self.remote_prefills,
            "local_prefills": self.local_prefills,
            "degraded_fallbacks": self.degraded_fallbacks,
            "pending_transfers": len(self._pending),
            "transfer_ms_p50": (
                sorted(ms)[len(ms) // 2] if ms else None
            ),
            "transfer_ms_last": ms[-1] if ms else None,
        }

    async def stats_handler(self, request: Context) -> AsyncIterator[Dict]:
        yield self.stats()

    # The engine handler served at the decode worker's kv_import endpoint.
    async def kv_import_handler(self, request: Context) -> AsyncIterator[Dict]:
        data = request.data
        tokens = data["token_ids"]
        # Tenant transfers (llm/tenancy) seal under the tenant's salted hash
        # chain — same identity the prefill engine sealed them under.
        # ``data["trace"]`` (omit-when-absent) joins the import to the
        # request's trace — the decode-side half of the transfer.
        with trace_span(
            parse_trace(data.get("trace")), "disagg.kv_import", "disagg"
        ) as ispan:
            covered = await self.engine.inject_blocks(
                tokens, data["payload"], data.get("salt")
            )
            ispan.set(tokens_covered=covered)
        self._covered[data["transfer_id"]] = (
            self._covered.get(data["transfer_id"], 0) + covered
        )
        # Chunked transfer: the future resolves on the LAST chunk; earlier
        # chunks are already sealed, so decode admission can begin while the
        # tail is still in flight.
        if data.get("last", True):
            total = self._covered.pop(data["transfer_id"], covered)
            fut = self._pending.pop(data["transfer_id"], None)
            if fut is not None and not fut.done():
                fut.set_result(total)
        yield {"ok": True, "tokens_covered": covered}

    async def transfer_direct(
        self, transfer_id: str, tokens, src_engine, salt=None
    ) -> int:
        """Same-process fast path: device→device block copy, no host staging
        (engine.transfer_blocks_device).  A zero-block transfer leaves the
        future pending — the sender retries and the decode side's timeout
        fallback covers permanent failure."""
        from ...engine.transfer import transfer_blocks_device

        covered = await transfer_blocks_device(
            src_engine, self.engine, tokens, salt=salt
        )
        if covered > 0:
            fut = self._pending.pop(transfer_id, None)
            if fut is not None and not fut.done():
                fut.set_result(covered)
        return covered

    async def generate(self, request: Context) -> ResponseStream:
        pre = PreprocessedRequest.from_dict(request.data)
        tokens = pre.token_ids
        # Tenant requests (llm/tenancy) seal KV under a salted hash chain:
        # estimate with the same salt or the local-hit count is fiction.
        prefix_hit = self.engine.estimate_prefix_hit(
            tokens, (pre.annotations or {}).get("kv_salt")
        )
        # Cheap local length test first; the queue-depth RPC to the hub only
        # runs for prompts that are candidates for remote prefill.
        remote = (
            not self.draining
            and len(tokens) - prefix_hit > self.router.config.max_local_prefill_length
        )
        if remote:
            try:
                qsize = await self.queue.size()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — hub/queue unreachable
                # Degraded mode: can't even ask the queue — serve locally
                # rather than failing the request.
                logger.warning("prefill queue unreachable; degrading to local")
                self._degrade()
                remote = False
            else:
                remote = self.router.prefill_remote(len(tokens), prefix_hit, qsize)
        if remote:
            await self._remote_prefill(
                tokens,
                deadline=getattr(request.ctx, "deadline", None),
                annotations=pre.annotations,
            )
        else:
            self.local_prefills += 1
        return await self.engine.generate(request)

    async def drain(self, timeout: float = 30.0) -> None:
        """Quiesce remote-prefill activity (planner role flip): stop
        enqueueing new remote prefills, give in-flight transfers
        ``timeout`` to land, then resolve leftovers with 0 covered tokens
        — their requests fall back to local prefill, nothing is lost."""
        self.draining = True
        deadline = time.perf_counter() + timeout
        while self._pending and time.perf_counter() < deadline:
            await asyncio.sleep(0.02)
        for fut in list(self._pending.values()):
            if not fut.done():
                fut.set_result(0)
        self._pending.clear()
        self._covered.clear()

    def _degrade(self) -> None:
        self.local_prefills += 1
        self.degraded_fallbacks += 1
        from ...runtime.resilience import metrics as _metrics

        _metrics.degraded_prefills_total += 1

    async def _remote_prefill(self, tokens, deadline=None, annotations=None) -> None:
        # Tracing (runtime/tracing.py): the queue item's annotations carry
        # the trace, so the prefill worker's engine spans — and its
        # transfer span — join the request's trace; this side records the
        # decode worker's WAIT (the remote-prefill share of TTFT).
        wspan = trace_span(
            parse_trace((annotations or {}).get("trace")),
            "disagg.remote_prefill_wait", "disagg",
        )
        transfer_id = uuid.uuid4().hex
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[transfer_id] = fut
        item = {
            "transfer_id": transfer_id,
            "token_ids": list(tokens),
            "reply": {"address": self.import_address, "path": self.import_path},
        }
        if annotations:
            # Tenant identity (llm/tenancy): the prefill worker must run the
            # prompt under the same adapter + KV salt or the transferred
            # blocks would be wrong (adapter) or unaddressable (salt).
            # Omitted when empty so pre-tenancy queue consumers see the old
            # item shape.
            item["annotations"] = dict(annotations)
        try:
            await self.queue.enqueue(item)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — hub/queue unreachable
            self._pending.pop(transfer_id, None)
            logger.warning("prefill enqueue failed; degrading to local prefill")
            self._degrade()
            wspan.set(degraded="enqueue_failed").finish()
            return
        # The transfer wait never outlives the request's deadline: leave a
        # margin so local prefill still has budget to run after fallback.
        timeout = self.transfer_timeout
        if deadline is not None:
            timeout = min(timeout, max(deadline.remaining() * 0.5, 0.05))
        t0 = time.perf_counter()
        try:
            covered = await asyncio.wait_for(fut, timeout)
            self.remote_prefills += 1
            self.transfer_ms.append((time.perf_counter() - t0) * 1e3)
            wspan.set(tokens_covered=covered)
            logger.info("remote prefill covered %d tokens", covered)
        except asyncio.TimeoutError:
            # Fall back to local prefill; a late transfer still lands as a
            # harmless prefix-cache fill.
            self._pending.pop(transfer_id, None)
            self._covered.pop(transfer_id, None)  # orphaned chunk counts
            logger.warning("remote prefill timed out; prefilling locally")
            self._degrade()
            wspan.set(degraded="timeout")
        except BaseException as e:
            # Cancellation / future failed with an unexpected error: record
            # the wait span rather than leaking it unrecorded.
            wspan.set(error=type(e).__name__)
            raise
        finally:
            wspan.finish()


class PrefillWorkerLoop:
    """Dedicated prefill worker: drain the queue, compute KV, push blocks.

    Transfers stream in ``chunk_blocks``-block chunks (ordered per
    connection), so the decode side seals and can use early blocks while
    later ones are still in flight.  ``direct`` maps reply addresses of
    CO-LOCATED decode workers (same process) to their DisaggDecodeWorker:
    those transfers take the device→device path and never stage in host
    memory."""

    MAX_ATTEMPTS = 3
    # Adaptive chunk sizing targets this per-chunk transfer latency: large
    # enough to amortize framing, small enough that the decode side keeps
    # sealing (and decoding against) early blocks while the tail is in
    # flight.  On a fast link the chunk grows toward max; over a slow hop it
    # shrinks so pipelining stays fine-grained.
    TARGET_CHUNK_S = 0.05
    MIN_CHUNK_BLOCKS = 4
    MAX_CHUNK_BLOCKS = 256

    def __init__(
        self,
        engine,
        queue: PrefillQueue,
        chunk_blocks: int = 32,
        direct: Optional[Dict[str, "DisaggDecodeWorker"]] = None,
        adaptive_chunks: bool = True,
    ):
        self.engine = engine
        self.queue = queue
        self.chunk_blocks = max(1, chunk_blocks)  # default for new links
        # Adaptive size is PER DESTINATION: a fast link converges large while
        # a slow one converges small — one shared value would thrash between
        # them.
        self._chunk_by_dest: Dict[str, int] = {}
        self.adaptive_chunks = adaptive_chunks
        self.direct = direct or {}
        self._task: Optional[asyncio.Task] = None
        self._clients: Dict[str, Client] = {}
        self._attempts: Dict[str, int] = {}
        self._busy = False  # an item is between dequeue and ack/nack
        self.handled = 0
        self.dropped = 0
        self.direct_transfers = 0

    def chunk_for(self, dest: str) -> int:
        return self._chunk_by_dest.get(dest, self.chunk_blocks)

    def _adapt_chunk(self, dest: str, blocks_sent: int, elapsed_s: float) -> None:
        """Move ``dest``'s chunk size toward TARGET_CHUNK_S of measured link
        time (half-step toward the bandwidth-implied size — smooths jitter)."""
        if not self.adaptive_chunks or blocks_sent <= 0 or elapsed_s <= 0:
            return
        ideal = blocks_sent * self.TARGET_CHUNK_S / elapsed_s
        stepped = (self.chunk_for(dest) + ideal) / 2
        self._chunk_by_dest[dest] = int(
            min(self.MAX_CHUNK_BLOCKS, max(self.MIN_CHUNK_BLOCKS, stepped))
        )

    async def start(self) -> "PrefillWorkerLoop":
        self._task = asyncio.get_running_loop().create_task(self._run())
        return self

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def drain(self, timeout: float = 30.0) -> None:
        """Graceful stop (planner role flip): let the in-flight item
        finish (bounded by ``timeout``), then stop pulling.  A cancel
        that does land mid-dequeue requeues via the hub's at-least-once
        pop path, so no request is ever lost."""
        deadline = time.perf_counter() + timeout
        while self._busy and time.perf_counter() < deadline:
            await asyncio.sleep(0.02)
        await self.stop()

    async def _run(self) -> None:
        try:
            while True:
                item, token = await self.queue.dequeue()
                self._busy = True
                tid = item.get("transfer_id", "?")
                try:
                    await self._handle(item)
                    await self.queue.ack(token)
                    self._attempts.pop(tid, None)
                    self.handled += 1
                    dest = (item.get("reply") or {}).get("address", "")
                    logger.info(
                        "prefill %s done (%d tokens; next chunk to %s: %d blocks)",
                        tid, len(item["token_ids"]), dest, self.chunk_for(dest),
                    )
                except asyncio.CancelledError:
                    await self.queue.nack(token)
                    raise
                except Exception:
                    # Bounded retry with backoff: the decode side falls back
                    # to local prefill on timeout anyway, so a poisoned item
                    # (dead reply target, evicted blocks) is dropped rather
                    # than spun on forever.
                    attempts = self._attempts.get(tid, 0) + 1
                    self._attempts[tid] = attempts
                    if attempts >= self.MAX_ATTEMPTS:
                        logger.exception(
                            "prefill %s failed %d times; dropping", tid, attempts
                        )
                        await self.queue.ack(token)
                        self._attempts.pop(tid, None)
                        self.dropped += 1
                    else:
                        logger.warning("prefill %s failed; requeueing", tid)
                        await self.queue.nack(token)
                        await asyncio.sleep(0.2 * attempts)
                finally:
                    self._busy = False
        except asyncio.CancelledError:
            pass

    async def _handle(self, item: Dict[str, Any]) -> None:
        tokens = item["token_ids"]
        # Tenant items (llm/tenancy) carry the request annotations: the
        # prefill runs under the same adapter (correct KV contents) and
        # seals under the same salted hash chain (addressable transfer).
        annotations = dict(item.get("annotations") or {})
        salt = annotations.get("kv_salt")
        # Tracing: annotations.trace rides into the engine request below
        # (its prefill spans join the originating request's trace); this
        # side additionally records the block transfer back to the decode
        # worker.
        tc = parse_trace(annotations.get("trace"))
        pre = PreprocessedRequest(token_ids=list(tokens), annotations=annotations)
        pre.stop_conditions.max_tokens = 1
        pre.stop_conditions.ignore_eos = True
        # Run the prompt through the engine: prefix caching retains the KV
        # blocks (sealed, hash-addressed) after the request completes.
        stream = await self.engine.generate(Context(pre.to_dict()))
        async for _ in stream:
            pass
        reply = item["reply"]

        worker = self.direct.get(reply["address"])
        if worker is not None:
            with trace_span(
                tc, "disagg.prefill_transfer", "disagg-prefill",
                attrs={"direct": True},
            ):
                covered = await worker.transfer_direct(
                    item["transfer_id"], tokens, self.engine, salt=salt
                )
            if covered == 0:
                raise RuntimeError("direct transfer moved no blocks")
            self.direct_transfers += 1
            return

        client = self._client_for(reply["address"], reply["path"])
        dest = reply["address"]
        total_blocks = len(tokens) // self.engine.cfg.block_size
        start = 0
        tspan = trace_span(
            tc, "disagg.prefill_transfer", "disagg-prefill",
            attrs={"dest": dest},
        )
        while True:
            chunk = self.chunk_for(dest)
            payload = await self.engine.export_prompt_blocks(
                tokens, start_block=start, max_blocks=chunk, salt=salt
            )
            if payload is None:
                if start == 0:
                    raise RuntimeError(
                        "prompt blocks missing after prefill (evicted?)"
                    )
                # Partial run (tail evicted mid-transfer): finalize with an
                # empty chunk so the decode side resolves with what landed
                # and prefills the remainder locally.
                resp = await client.generate(
                    Context(
                        {
                            "transfer_id": item["transfer_id"],
                            "token_ids": list(tokens),
                            "payload": {"n_blocks": 0},
                            "last": True,
                            **({"salt": salt} if salt else {}),
                            **(
                                {"trace": tc.to_dict()}
                                if tc is not None
                                else {}
                            ),
                        }
                    )
                )
                async for _ack in resp:
                    pass
                break
            start += payload["n_blocks"]
            last = start >= total_blocks or payload["n_blocks"] < chunk
            t0 = time.perf_counter()
            resp = await client.generate(
                Context(
                    {
                        "transfer_id": item["transfer_id"],
                        "token_ids": list(tokens),
                        "payload": payload,
                        "last": last,
                        **({"salt": salt} if salt else {}),
                        **({"trace": tc.to_dict()} if tc is not None else {}),
                    }
                )
            )
            async for _ack in resp:
                pass
            self._adapt_chunk(
                dest, payload["n_blocks"], time.perf_counter() - t0
            )
            if last:
                break
        tspan.set(blocks=start).finish()

    def _client_for(self, address: str, path: str) -> Client:
        key = f"{address}/{path}"
        if key not in self._clients:
            self._clients[key] = Client.static(address, path)
        return self._clients[key]

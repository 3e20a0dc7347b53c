"""MigratableWorker: source/target halves of live sequence migration (a
port of the JAX package's llm/migration/worker.py; the copy stream rides
the service plane, or under ``DYN_BULK_PLANE`` the bulk plane, with
``make_migrate_in_sink`` the target's end).

Protocol (Llumnix-style two-phase commit over the service plane):

phase 1 — *copy while decoding*: the source streams the sequence's sealed
KV blocks (``export_prompt_blocks`` from a moving frontier) to the target's
``migrate_in`` endpoint, where ``inject_blocks`` seals them under the same
chained hashes.  The sequence KEEPS DECODING on the source; each round
picks up the blocks sealed since the last, so the un-copied delta shrinks
to at most ``delta_blocks`` regardless of sequence length.

phase 2 — *freeze, final delta, commit*: the source freezes the sequence
(engine ``freeze_sequence`` — planned out, in-flight dispatches drained),
exports the last sealed blocks plus the ``SequenceSnapshot``, and sends a
``commit``.  The target validates config + capacity and acks.

cutover — the source emits one final stream item carrying the ``migrated``
splice marker ({target, resume request}) and releases the sequence.  The
routed client (runtime/client.py) consumes the marker and re-dispatches
the resume request to the target, whose engine admits it against the
transferred blocks as an ordinary prefix hit — decode continues with only
the unsealed tail (< block_size tokens) recomputed, and the client-visible
token stream is byte-identical to the never-migrated run.

rollback — ANY failure after the freeze unfreezes the sequence and returns
the source to sole authority; the client never observes the attempt.
Blocks already copied stay on the target as harmless prefix-cache fills.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import (
    Any,
    AsyncIterator,
    Awaitable,
    Callable,
    Dict,
    List,
    Optional,
)

from ...runtime.client import Client
from ...runtime.engine import AsyncEngine, Context, ResponseStream
from ...runtime.tracing import parse_trace, span as trace_span
from ..metrics import migration_metrics as metrics

logger = logging.getLogger(__name__)

MIGRATE_IN_ENDPOINT = "migrate_in"
MIGRATE_OUT_ENDPOINT = "migrate_out"


class MigrationTargetError(RuntimeError):
    """Target refused blocks or the commit (config/capacity mismatch)."""


class MigratableWorker(AsyncEngine):
    """Wraps a TorchEngine (and optionally an inner serving engine such as a
    DisaggDecodeWorker) with the migration protocol's two endpoint handlers
    plus the source-side ``migrate_out`` driver."""

    def __init__(
        self,
        engine,
        serve: Optional[AsyncEngine] = None,
        chunk_blocks: int = 32,
        max_copy_rounds: int = 16,
        delta_blocks: int = 2,
        freeze_timeout: float = 10.0,
        direct: Optional[Dict[str, "MigratableWorker"]] = None,
    ):
        self.engine = engine
        self.serve = serve if serve is not None else engine
        self.chunk_blocks = max(1, chunk_blocks)
        self.max_copy_rounds = max(1, max_copy_rounds)
        # Stop phase-1 looping once the un-copied sealed delta is this
        # small; the remainder rides the final-delta freeze window.
        self.delta_blocks = max(0, delta_blocks)
        self.freeze_timeout = freeze_timeout
        # Co-located peers by address (same process / shared slice): pushes
        # short-circuit the service plane (tests; single-process fleets).
        self.direct = direct or {}
        self._clients: Dict[str, Client] = {}
        # Bulk data plane (transports/bulk.py, DYN_BULK_PLANE): when the
        # CLI wires a BulkRendezvous here, phase-1 copy payloads move
        # worker↔worker instead of through the hub; None = hub path only.
        self.bulk = None
        # Injectable copy-round barrier: awaited once after every phase-1
        # copy round as ``hook(cursor, final=False)`` and once more —
        # ``hook(cursor, final=True)`` — after the loop breaks, immediately
        # before the freeze (no suspension point between the final call
        # returning and ``frozen`` being set, so a gate released on
        # ``final`` cannot lose a plan-new-chunks race).  Tests pair it
        # with engine.pace_hook to make the copy-vs-decode race
        # count-bounded instead of wall-clock raced; None = zero cost.
        self.copy_round_hook: Optional[
            Callable[[int, bool], Awaitable[None]]
        ] = None
        # Accept-time capability gate: a draining worker flips this False
        # BEFORE starting its own migrate-out (cli WorkerRoles.stop_decode),
        # closing the de-advertise propagation race — a peer whose hub
        # snapshot predates the metadata rewrite can still PICK this worker,
        # but the pick is re-checked here at accept time and refused, so two
        # concurrent drains can never migrate into each other.
        self.accepting = True

    # ------------------------------------------------------------- serving
    async def generate(self, request: Context) -> ResponseStream:
        return await self.serve.generate(request)

    def stop_accepting(self) -> None:
        """Refuse future migrate-in traffic (drain/quarantine path)."""
        self.accepting = False

    # ---------------------------------------------------------- target side
    async def migrate_in_handler(self, request: Context) -> AsyncIterator[Dict]:
        yield await self._migrate_in(request.data)

    async def _migrate_in(self, data: Dict[str, Any]) -> Dict[str, Any]:
        if not self.accepting:
            # Sources treat any refusal as abort/rollback: the sequence
            # stays authoritative on the source and another target is
            # picked on the next drain round.
            return {"ok": False, "error": "target draining; migrate-in refused"}
        kind = data.get("kind", "blocks")
        tokens = list(data["token_ids"])
        # Tenant sequences (llm/tenancy) seal KV under a salted hash chain;
        # the source ships the salt so injected blocks land under the same
        # identity the resume request will look them up with.
        salt = data.get("salt")
        cfg = self.engine.cfg
        if int(data.get("block_size", cfg.block_size)) != cfg.block_size:
            return {
                "ok": False,
                "error": f"block_size {data.get('block_size')} != local "
                f"{cfg.block_size}",
            }
        if kind == "blocks":
            payload = data["payload"]
            covered = await self.engine.inject_blocks(tokens, payload, salt)
            if covered == 0 and int(payload.get("n_blocks", 0)) > 0:
                # inject_blocks validated and refused (stored-representation
                # or capacity mismatch): tell the source now, not at commit.
                return {"ok": False, "error": "kv import rejected"}
            return {"ok": True, "tokens_covered": covered}
        if kind == "commit":
            # Capacity gate: the resume request must be admittable — the
            # folded prompt needs room for at least one more token, and its
            # block count must fit the pool even with zero prefix hits.
            if len(tokens) >= cfg.max_model_len:
                return {"ok": False, "error": "no room before max_model_len"}
            need = (len(tokens) + cfg.block_size) // cfg.block_size
            if need > cfg.num_blocks:
                return {"ok": False, "error": "prompt exceeds KV pool"}
            covered = 0
            payload = data.get("payload")
            # Target-side span under the stream's trace (data["trace"],
            # omit-when-absent): the commit validation + final-delta seal
            # is the target's half of the cutover pause.
            with trace_span(
                parse_trace(data.get("trace")), "migrate.in_commit",
                "migration",
            ) as mspan:
                if payload is not None:
                    covered = await self.engine.inject_blocks(
                        tokens, payload, salt
                    )
                    if covered == 0 and int(payload.get("n_blocks", 0)) > 0:
                        return {
                            "ok": False,
                            "error": "final-delta import rejected",
                        }
                metrics.migrated_in_total += 1
                prefix_hit = self.engine.estimate_prefix_hit(tokens, salt)
                mspan.set(prefix_hit=prefix_hit)
            return {
                "ok": True,
                "tokens_covered": covered,
                "prefix_hit": prefix_hit,
            }
        return {"ok": False, "error": f"unknown migrate_in kind {kind!r}"}

    # ---------------------------------------------------------- source side
    async def migrate_out_handler(self, request: Context) -> AsyncIterator[Dict]:
        data = request.data
        target = data["target"]
        rids = (
            [data["request_id"]]
            if data.get("request_id")
            else self.engine.live_request_ids()
        )
        migrated: List[str] = []
        failed: List[str] = []
        for rid in rids:
            (migrated if await self.migrate_out(rid, target) else failed).append(
                rid
            )
        yield {"ok": True, "migrated": migrated, "failed": failed}

    async def migrate_all(self, target: Dict[str, Any]) -> List[str]:
        """Drain helper: migrate every live sequence to ``target``; returns
        the ids that cut over (failures stay live on this worker)."""
        out: List[str] = []
        for rid in self.engine.live_request_ids():
            if await self.migrate_out(rid, target):
                out.append(rid)
        return out

    async def migrate_out(self, request_id: str, target: Dict[str, Any]) -> bool:
        """Drive one sequence through copy → freeze → commit → cutover.

        Returns True on cutover; False leaves the source authoritative
        (sequence unfrozen and still decoding, or already finished)."""
        engine = self.engine
        bs = engine.cfg.block_size
        metrics.started_total += 1
        cursor = 0  # complete blocks already pushed
        # Tracing (runtime/tracing.py): migration spans record under the
        # SEQUENCE's trace — the same one the client stream carries — so a
        # migrated request's timeline shows copy/freeze/cutover inline.
        seq0 = engine.find_sequence(request_id)
        tc = seq0.trace.ctx if seq0 is not None and seq0.trace else None
        cspan = trace_span(
            tc, "migrate.copy", "migration",
            attrs={"target_worker": target.get("worker_id")},
        )
        # -- phase 1: copy while decoding --------------------------------
        salt = None
        for _ in range(self.max_copy_rounds):
            tokens = engine.sequence_tokens(request_id)
            seq = engine.find_sequence(request_id)
            if tokens is None or seq is None or seq.finished:
                metrics.aborted_total += 1
                cspan.set(aborted=True).finish()
                return False  # finished/cancelled under us: nothing to move
            # Tenant sequences (llm/tenancy) seal KV under a salted hash
            # chain: export with the same salt and ship it with every
            # payload so the target seals under the identity the resume
            # request will look blocks up with.
            salt = seq.kv_salt
            try:
                shipped = await self._push_blocks(
                    target, tokens, cursor, salt, trace=tc
                )
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.warning(
                    "migration %s: copy phase failed; aborting "
                    "(source keeps the sequence)", request_id, exc_info=True,
                )
                metrics.aborted_total += 1
                cspan.set(aborted=True).finish()
                return False
            cursor += shipped
            if self.copy_round_hook is not None:
                # Copy-round barrier (tests): one refill of the gated
                # decode budget per completed round — the race becomes
                # count-bounded (decode advances at most N paced ops per
                # shipped round) instead of wall-clock raced.
                await self.copy_round_hook(cursor, False)
            remaining = len(tokens) // bs - cursor
            if remaining <= self.delta_blocks or shipped == 0:
                # shipped == 0 with blocks still remaining means nothing is
                # exportable at the cursor (sealed prefix was LRU-evicted):
                # more rounds would re-hash the whole stream for nothing —
                # go freeze; the target recomputes what never arrived as an
                # ordinary prefix miss.
                break
            await asyncio.sleep(0)  # let decode advance between rounds
        if self.copy_round_hook is not None:
            # final=True: the copy race is decided; the gate must stop
            # PARKING decode before the freeze below — quiescence needs
            # the decode loop to harvest in-flight fetches and retire the
            # row's fused-session membership.  No await sits between this
            # call returning and freeze_sequence setting ``frozen``, so
            # the un-parked loop cannot plan new chunks for the row first.
            await self.copy_round_hook(cursor, True)
        cspan.set(blocks=cursor).finish()
        # -- phase 2: freeze + final delta + commit ----------------------
        fspan = trace_span(tc, "migrate.cutover", "migration")
        seq = await engine.freeze_sequence(request_id, timeout=self.freeze_timeout)
        if seq is None:
            metrics.aborted_total += 1
            fspan.set(aborted=True).finish()
            return False
        fspan.event("frozen")
        pause_t0 = time.perf_counter()
        try:
            snap = engine.snapshot_sequence(request_id)
            if snap is None:
                raise RuntimeError("sequence vanished after freeze")
            tokens = snap.token_ids
            cursor += await self._push_blocks(
                target, tokens, cursor, salt, trace=tc
            )
            # The commit carries only what the target validates against:
            # the decode state itself rides the cutover marker (the client
            # re-dispatches snap.to_resume_request()), so shipping the
            # snapshot here would double the freeze-window payload for
            # bytes the target drops.
            resp = await self._send(
                target,
                {
                    "kind": "commit",
                    "token_ids": tokens,
                    "block_size": bs,
                    "payload": None,
                    **({"salt": salt} if salt else {}),
                    # Omit-when-absent (like salt): the target records its
                    # migrate-in span under the stream's trace.
                    **({"trace": tc.to_dict()} if tc is not None else {}),
                },
            )
            if not resp.get("ok"):
                raise MigrationTargetError(resp.get("error", "commit refused"))
        except asyncio.CancelledError:
            engine.unfreeze_sequence(request_id)
            raise
        except Exception:
            # Rollback: the source never stopped being authoritative — the
            # sequence resumes decoding exactly where it froze, and the
            # client never saw a thing.
            logger.warning(
                "migration %s: commit failed; rolled back", request_id,
                exc_info=True,
            )
            engine.unfreeze_sequence(request_id)
            metrics.rolled_back_total += 1
            fspan.set(rolled_back=True).finish()
            return False
        # -- cutover ------------------------------------------------------
        item = {
            "token_ids": [],
            "text": None,
            "finish_reason": None,
            "migrated": {
                "worker_id": target.get("worker_id"),
                "address": target.get("address"),
                "path": target.get("generate_path") or target.get("path"),
                "request": snap.to_resume_request(),
            },
        }
        engine.finish_migrated(request_id, item)
        pause_ms = (time.perf_counter() - pause_t0) * 1e3
        metrics.cutover_pause_ms.observe(pause_ms)
        metrics.completed_total += 1
        fspan.set(pause_ms=round(pause_ms, 3), blocks=cursor).finish()
        logger.info(
            "migration %s: cut over to worker %s (%d tokens, %d blocks)",
            request_id, target.get("worker_id"), len(tokens), cursor,
        )
        return True

    # ------------------------------------------------------------ transport
    async def _push_blocks(
        self,
        target: Dict[str, Any],
        tokens: List[int],
        cursor: int,
        salt: Optional[str] = None,
        trace=None,
    ) -> int:
        """Export sealed blocks from ``cursor`` and push them; returns the
        number of complete blocks shipped.  Raises on a target refusal.
        ``salt`` is the owning tenant's KV salt (llm/tenancy) — the export
        lookup and the target's sealing must both use it."""
        from ...tokens import hash_token_blocks

        bs = self.engine.cfg.block_size
        sent = 0
        # Seal the chained hashes ONCE per push round: every chunk export
        # below walks the same token list, and recomputing the O(len(tokens))
        # chain inside export_prompt_blocks per chunk made the copy phase
        # quadratic in sequence length (the export asserts the passed chain
        # against a fresh recompute under __debug__).
        chain = hash_token_blocks(tokens, bs, salt)
        while True:
            payload = await self.engine.export_prompt_blocks(
                tokens, start_block=cursor + sent, max_blocks=self.chunk_blocks,
                salt=salt, blocks=chain,
            )
            if payload is None:
                return sent
            # Ship only the tokens the chunk's chained hashes depend on
            # (block 0 through this chunk's end) — resending the full,
            # still-growing list with every push made phase-1 wire cost
            # quadratic in sequence length for zero information.
            cover = (cursor + sent + int(payload["n_blocks"])) * bs
            resp = await self._send(
                target,
                {
                    "kind": "blocks",
                    "token_ids": tokens[:cover],
                    "block_size": bs,
                    "payload": payload,
                    **({"salt": salt} if salt else {}),
                    **({"trace": trace.to_dict()} if trace is not None else {}),
                },
            )
            if not resp.get("ok"):
                raise MigrationTargetError(resp.get("error", "blocks refused"))
            n = int(payload["n_blocks"])
            # The target reports what actually SEALED: integrity
            # verification (engine/integrity.py) may have truncated the
            # import at a corrupt block, and advancing the cursor past
            # unsealed blocks would leave a hole the target's prefix match
            # can never cross.  The next round re-exports from the
            # verified frontier (a fresh HBM gather — transient wire
            # corruption heals; persistent corruption ends the copy phase
            # and the target recomputes the tail as a prefix miss).
            got = min(n, int(resp.get("tokens_covered", n * bs)) // bs)
            sent += got
            metrics.blocks_total += got
            metrics.bytes_total += len(payload.get("k", b"")) + len(
                payload.get("v", b"")
            )
            if got < n or n < self.chunk_blocks:
                return sent

    async def _send(
        self, target: Dict[str, Any], data: Dict[str, Any]
    ) -> Dict[str, Any]:
        if self.bulk is not None and data.get("kind") == "blocks":
            # Bulk plane (DYN_BULK_PLANE): the KV copy stream — the only
            # bulk-sized migrate_in payload — moves worker↔worker; commits
            # stay on the service plane (control-sized, ordering-critical).
            resp = await self._send_bulk(target, data)
            if resp is not None:
                return resp
            from ..metrics import bulk_metrics

            bulk_metrics.fallbacks_total += 1
        peer = self.direct.get(target.get("address", ""))
        if peer is not None:
            return await peer._migrate_in(data)
        client = self._client_for(target["address"], target["import_path"])
        stream = await client.generate(Context(data))
        resp: Dict[str, Any] = {"ok": False, "error": "empty migrate_in reply"}
        async for item in stream:
            resp = item
        return resp

    async def _send_bulk(
        self, target: Dict[str, Any], data: Dict[str, Any]
    ) -> Optional[Dict[str, Any]]:
        """Push one copy-stream payload over the bulk plane; None means
        'use the hub path' (peer without a bulk server, rendezvous outage,
        transfer dead after resumes) — never an error, the stream survives
        on the fallback."""
        from ...runtime.transports import codec
        from ...runtime.transports.bulk import bulk_push

        wid = target.get("worker_id")
        if wid is None:
            return None
        salt = data.get("salt")
        blob = codec.encode(data)
        try:
            prep = await self.bulk.prepare(wid, salt=salt, budget=len(blob))
            if prep is None:
                return None
            address, ticket = prep
            reply = await bulk_push(
                address, MIGRATE_IN_ENDPOINT, ticket, blob, salt=salt
            )
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — fallback ladder: hub path next
            logger.warning(
                "bulk migrate push to worker %s failed; falling back to the "
                "hub path", wid, exc_info=True,
            )
            return None
        return reply if isinstance(reply, dict) else None

    def _client_for(self, address: str, path: str) -> Client:
        key = f"{address}/{path}"
        if key not in self._clients:
            self._clients[key] = Client.static(address, path)
        return self._clients[key]


def make_migrate_in_sink(worker: MigratableWorker):
    """Target-side bulk *sink* for ``MIGRATE_IN_ENDPOINT``: the blob is the
    codec-encoded migrate_in data dict; the reply is ``_migrate_in``'s
    verdict (ok / tokens_covered), which the source consumes exactly as it
    would a service-plane response."""
    from ...runtime.transports import codec

    async def sink(blob: bytes, meta: Dict[str, Any]) -> Dict[str, Any]:
        return await worker._migrate_in(codec.decode(blob))

    return sink

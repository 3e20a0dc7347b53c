"""Peer-to-peer bulk data plane: direct worker↔worker transfers with the
hub doing rendezvous only.

A copy of the JAX package's ``runtime/transports/bulk.py``: the same wire
format, tickets and resume, over the port's own codec (which writes the
JAX codec's bytes), so a port client and a JAX ``BulkServer`` interoperate
both ways.

Reference semantics: the reference Dynamo moves KV payloads over a
dedicated NIXL (UCX/RDMA) side channel while etcd/NATS carry only control
traffic.  Here every worker runs a lightweight ``BulkServer`` stream
server, registers its bulk address in the hub under ``bulk/addr/<worker>``
(``bulk_addr_key``), and a transfer proceeds as:

1. **Rendezvous** (hub, control-plane sized): the initiator looks up the
   peer's bulk address and mints a **one-shot transfer ticket** —
   ``{id, peer, lease, salt, budget, expires}`` — written to
   ``bulk/ticket/<id>`` under the initiator's lease so abandoned tickets
   die with it.
2. **Transfer** (direct TCP, hub not involved): the initiator dials the
   peer's ``BulkServer`` and fetches from a named *source* or pushes to a
   named *sink*.  The server spends the ticket exactly once (hub
   ``kv_delete`` is the fleet-wide arbiter; local used-set when the hub is
   unreachable), enforces the salt scope and the byte budget, then streams
   the payload chunked over the ``transports/codec.py`` framing.

Wire format (all frames are codec frames, ``[type][stream][len][payload]``):

    client → server   REQ_HEADER   {op, source, ticket, resume_from,
                                    size?, chunks?, salt?, meta?}
    client → server   REQ_DATA     {i, crc, data} ...        (push only)
    client → server   REQ_DATA     {done: true}              (push only)
    server → client   RESP_PROLOGUE {ok, size?, chunks?, have?, chunk_bytes,
                                     error?, kind?}
    server → client   RESP_ITEM    {i, crc, data} ...        (fetch only)
    server → client   RESP_ITEM    {reply}                   (push only)
    server → client   RESP_COMPLETE {crc, size}
    server → client   RESP_ERROR   {error, kind}

Every chunk carries a CRC-32 stamp (``engine/integrity.bytes_checksum``)
verified on receipt, and RESP_COMPLETE carries the whole-blob CRC, so a
damaged chunk is detected before anything is decoded.  The server caches
the produced chunk list per live transfer, so a transfer is **resumable
from the last verified chunk** after a connection drop: the client
reconnects with the same ticket and ``resume_from`` (fetch) or reads the
server's ``have`` watermark (push), and the resumed stream is
byte-identical to an undropped one.

Fallback ladder (each consumer wraps its bulk call in this order):

    bulk plane  →  hub path (today's transport, the A/B oracle)
                →  local recompute (KV only; engine integrity plane)

so a dead peer, an expired ticket, or a hub rendezvous outage never drops
a stream — it costs one ``dynamo_tpu_bulk_fallbacks_total`` tick and the
bytes ride the control plane as before.  The whole plane sits behind
``DYN_BULK_PLANE`` (default off).

Fault points (runtime/faultinject.py):
``bulk_conn_drop`` aborts the peer connection between chunks (keyed
``<address>/<source>``; the live transfer survives for resume), and
``bulk_slow_peer`` stalls ``delay_s`` per chunk.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
import uuid
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple

from ...engine.integrity import bytes_checksum
from ..faultinject import faults
from . import codec
from .codec import FrameType
from .shard import hub_key, hub_prefix

logger = logging.getLogger(__name__)

ENV_FLAG = "DYN_BULK_PLANE"
#: Default chunk size for bulk framing.  256 KiB keeps per-chunk CRC cost
#: negligible while a resume after a drop loses at most one chunk.
DEFAULT_CHUNK_BYTES = 1 << 18
TICKET_TTL_S = 30.0
#: Payloads at or above this ride the bulk plane; dynalint DYN402 flags
#: producers of bulk-sized payloads published through hub subjects.
BULK_THRESHOLD_BYTES = 64 * 1024


def bulk_enabled() -> bool:
    """True when ``DYN_BULK_PLANE`` opts this process into the bulk plane."""
    return os.environ.get(ENV_FLAG, "0").lower() not in ("", "0", "false", "no", "off")


def _chunk_bytes() -> int:
    try:
        return max(1, int(os.environ.get("DYN_BULK_CHUNK_BYTES", DEFAULT_CHUNK_BYTES)))
    except ValueError:
        return DEFAULT_CHUNK_BYTES


def _chunk_crcs(blob: bytes, chunk_bytes: int) -> Tuple[List[bytes], List[int], int]:
    """``blob`` cut into ``chunk_bytes`` chunks, each chunk's CRC-32 and
    the whole blob's.  The bulk paths run this in a worker thread
    (``asyncio.to_thread``): on a worker the event loop also drives the
    engine, and a 192 MiB blob's copy and CRCs held it for ~0.5 s.  The
    bytes and their order are the JAX package's, which takes them on the
    loop."""
    chunks = [blob[o : o + chunk_bytes] for o in range(0, len(blob), chunk_bytes)]
    return chunks, [bytes_checksum(c) for c in chunks], bytes_checksum(blob)


def _metrics():
    # Lazy: llm.metrics imports numpy-adjacent modules; the transport layer
    # must stay importable on its own.
    from ...llm.metrics import bulk_metrics

    return bulk_metrics


# --------------------------------------------------------------------------
# Hub keys (canonical builders — dynalint DYN401 sanctioned tails)
# --------------------------------------------------------------------------


def bulk_addr_key(worker_id: Any) -> str:
    """Hub key a worker registers its bulk-server address under."""
    return hub_key("bulk", "addr", str(worker_id))


def bulk_ticket_key(ticket_id: str) -> str:
    """Hub key a one-shot transfer ticket is parked under until spent."""
    return hub_key("bulk", "ticket", str(ticket_id))


def bulk_sink_key(kind: str, worker_id: Any) -> str:
    """Hub key a named bulk *sink* (e.g. the span aggregator's ``traces``
    ingest) registers its address under."""
    return hub_key("bulk", "sink", str(kind), str(worker_id))


def bulk_sink_prefix(kind: str) -> str:
    """Prefix listing every registered bulk sink of ``kind``."""
    return hub_prefix("bulk", "sink", str(kind))


# --------------------------------------------------------------------------
# Errors / tickets
# --------------------------------------------------------------------------


class TicketError(RuntimeError):
    """The server refused the ticket (expired, reused, wrong peer/salt)."""


class BulkTransferError(RuntimeError):
    """A bulk transfer failed.

    ``retryable`` distinguishes exhaustion of the resume budget (the
    caller's fallback ladder applies) from a hard protocol refusal
    (``kind`` in ``ticket|unavailable|budget|size|sink|crc``) where
    retrying the same ticket cannot succeed.
    """

    def __init__(self, msg: str, *, retryable: bool = False, kind: str = ""):
        super().__init__(msg)
        self.retryable = retryable
        self.kind = kind


class _ChunkDamage(Exception):
    """Internal: a chunk failed its CRC or arrived out of order; the
    transfer resumes from the last verified chunk."""

    def __init__(self, index: int):
        super().__init__(f"chunk {index} damaged or out of order")
        self.index = index


def mint_ticket(
    peer: Any,
    *,
    salt: Optional[str] = None,
    budget: int = 0,
    ttl_s: float = TICKET_TTL_S,
    clock: Callable[[], float] = time.time,
) -> Dict[str, Any]:
    """A one-shot transfer ticket: spendable once, by ``peer``, within
    ``ttl_s``, for at most ``budget`` bytes (0 = unbounded), scoped to
    ``salt`` so a ticket minted for one tenant's KV chain cannot fetch
    another's."""
    return {
        "id": uuid.uuid4().hex,
        "peer": str(peer),
        "lease": None,
        "salt": salt or "",
        "budget": int(budget),
        "expires": clock() + ttl_s,
    }


# --------------------------------------------------------------------------
# Server
# --------------------------------------------------------------------------

SourceFn = Callable[[Dict[str, Any]], Awaitable[bytes]]
SinkFn = Callable[[bytes, Dict[str, Any]], Awaitable[Any]]


class BulkServer:
    """One per worker: serves registered bulk *sources* (peer fetches from
    us) and *sinks* (peer pushes to us) over direct TCP.

    The hub appears only in ``_admit``'s one-shot ticket spend — and even
    there a hub outage degrades to the local used-set instead of failing
    the transfer, so the data path has no hard control-plane dependency.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        *,
        worker_id: Optional[Any] = None,
        hub: Optional[Any] = None,
        chunk_bytes: Optional[int] = None,
        clock: Callable[[], float] = time.time,
        live_ttl_s: float = 30.0,
    ):
        self.host = host
        self.worker_id = worker_id
        self.hub = hub
        self.chunk_bytes = int(chunk_bytes or _chunk_bytes())
        self.clock = clock
        self.live_ttl_s = live_ttl_s
        self._sources: Dict[str, SourceFn] = {}
        self._sinks: Dict[str, SinkFn] = {}
        self._used: Dict[str, float] = {}  # ticket id → expiry (reuse guard)
        self._live: Dict[str, Dict[str, Any]] = {}  # ticket id → transfer state
        self._server: Optional[asyncio.AbstractServer] = None
        self._port = 0
        self._conn_tasks: set = set()

    # -- registration --------------------------------------------------------

    def register_source(self, name: str, fn: SourceFn) -> None:
        self._sources[name] = fn

    def register_sink(self, name: str, fn: SinkFn) -> None:
        self._sinks[name] = fn

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> "BulkServer":
        self._server = await asyncio.start_server(self._accept, self.host, 0)
        self._port = self._server.sockets[0].getsockname()[1]
        logger.info("bulk server listening on %s", self.address)
        return self

    @property
    def address(self) -> str:
        return f"{self.host}:{self._port}"

    async def close(self) -> None:
        for task in list(self._conn_tasks):
            task.cancel()
        if self._conn_tasks:
            await asyncio.gather(*self._conn_tasks, return_exceptions=True)
        self._conn_tasks.clear()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    def _accept(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        task = asyncio.ensure_future(self._handle(reader, writer))
        self._conn_tasks.add(task)
        task.add_done_callback(self._conn_tasks.discard)

    # -- connection handling -------------------------------------------------

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            frame = await codec.read_frame(reader)
            if frame.type != FrameType.REQ_HEADER:
                return
            hdr = frame.unpack()
            try:
                live = await self._admit(hdr)
            except TicketError as exc:
                await codec.write_frame(
                    writer,
                    FrameType.RESP_PROLOGUE,
                    {"ok": False, "error": str(exc), "kind": "ticket"},
                )
                return
            op = hdr.get("op")
            if op == "fetch":
                await self._serve_fetch(hdr, live, writer)
            elif op == "push":
                await self._serve_push(hdr, live, reader, writer)
            else:
                self._live.pop(live["id"], None)
                await codec.write_frame(
                    writer,
                    FrameType.RESP_PROLOGUE,
                    {"ok": False, "error": f"unknown op {op!r}", "kind": "unavailable"},
                )
        except asyncio.CancelledError:
            raise
        except (ConnectionError, asyncio.IncompleteReadError, OSError, ValueError):
            pass  # peer vanished / garbage frame: nothing to answer to
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except asyncio.CancelledError:
                raise
            except (ConnectionError, OSError):
                pass

    def _expire(self) -> None:
        now = self.clock()
        for tid in [t for t, exp in self._used.items() if exp < now]:
            self._used.pop(tid, None)
        for tid in [t for t, st in self._live.items() if st["deadline"] < now]:
            self._live.pop(tid, None)

    async def _admit(self, hdr: Dict[str, Any]) -> Dict[str, Any]:
        """Validate + spend the ticket; returns the live transfer state.

        A reconnect for an in-flight transfer (same ticket id still live)
        is a **resume**, never a reuse — the ticket was spent when the
        transfer was admitted, and the cached state guarantees the resumed
        stream is byte-identical.
        """
        self._expire()
        ticket = hdr.get("ticket")
        if not isinstance(ticket, dict) or not ticket.get("id"):
            raise TicketError("missing transfer ticket")
        tid = str(ticket["id"])
        live = self._live.get(tid)
        if live is not None:
            live["deadline"] = self.clock() + self.live_ttl_s
            return live
        if int(hdr.get("resume_from") or 0) > 0:
            raise TicketError("resume for unknown transfer")
        if tid in self._used:
            raise TicketError("ticket already spent")
        if (
            self.worker_id is not None
            and str(ticket.get("peer") or "") != str(self.worker_id)
        ):
            raise TicketError("ticket minted for a different peer")
        expires = float(ticket.get("expires") or 0.0)
        if expires < self.clock():
            raise TicketError("ticket expired")
        if (ticket.get("salt") or "") != (hdr.get("salt") or ""):
            raise TicketError("ticket salt scope mismatch")
        if self.hub is not None:
            # The hub record is the fleet-wide one-shot arbiter: the first
            # delete wins; a second spend (replayed ticket) finds nothing.
            try:
                fresh = await self.hub.kv_delete(bulk_ticket_key(tid))
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.warning(
                    "bulk: hub unreachable for ticket %s; degrading to the "
                    "local reuse guard",
                    tid,
                )
                fresh = True
            if not fresh:
                raise TicketError("ticket already spent (hub)")
        self._used[tid] = max(expires, self.clock() + self.live_ttl_s)
        live = {
            "id": tid,
            "budget": int(ticket.get("budget") or 0),
            "deadline": self.clock() + self.live_ttl_s,
            "chunks": [],
            "nbytes": 0,
        }
        self._live[tid] = live
        return live

    # -- fetch (peer pulls from our source) ----------------------------------

    async def _serve_fetch(
        self,
        hdr: Dict[str, Any],
        live: Dict[str, Any],
        writer: asyncio.StreamWriter,
    ) -> None:
        name = str(hdr.get("source") or "")
        key = f"{self.address}/{name}"
        fn = self._sources.get(name)
        if fn is None:
            self._live.pop(live["id"], None)
            await codec.write_frame(
                writer,
                FrameType.RESP_PROLOGUE,
                {"ok": False, "error": f"no bulk source {name!r}", "kind": "unavailable"},
            )
            return
        if "blob_crc" not in live:
            # Produce once per ticket and cache the chunk list: a resumed
            # transfer re-serves the SAME bytes (byte-identity across drops).
            try:
                blob = await fn(hdr.get("meta") or {})
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                self._live.pop(live["id"], None)
                await codec.write_frame(
                    writer,
                    FrameType.RESP_PROLOGUE,
                    {"ok": False, "error": f"source failed: {exc}", "kind": "unavailable"},
                )
                return
            if live["budget"] and len(blob) > live["budget"]:
                self._live.pop(live["id"], None)
                await codec.write_frame(
                    writer,
                    FrameType.RESP_PROLOGUE,
                    {
                        "ok": False,
                        "error": f"{len(blob)}B exceeds ticket budget {live['budget']}B",
                        "kind": "budget",
                    },
                )
                return
            live["chunks"], live["crcs"], live["blob_crc"] = await asyncio.to_thread(
                _chunk_crcs, blob, self.chunk_bytes
            )
            live["size"] = len(blob)
        resume_from = int(hdr.get("resume_from") or 0)
        chunks: List[bytes] = live["chunks"]
        await codec.write_frame(
            writer,
            FrameType.RESP_PROLOGUE,
            {
                "ok": True,
                "size": live["size"],
                "chunks": len(chunks),
                "chunk_bytes": self.chunk_bytes,
            },
        )
        for i in range(resume_from, len(chunks)):
            if faults.enabled:
                delay = faults.delay_for("bulk_slow_peer", key)
                if delay:
                    await asyncio.sleep(delay)
            await codec.write_frame(
                writer,
                FrameType.RESP_ITEM,
                {"i": i, "crc": live["crcs"][i], "data": chunks[i]},
            )
            if faults.enabled and faults.should("bulk_conn_drop", key):
                # Abort (no FIN) AFTER a verified chunk shipped — the
                # drop_mid_stream shape: the client holds partial state and
                # resumes.  Live state survives — that is the point.
                writer.transport.abort()
                return
        await codec.write_frame(
            writer,
            FrameType.RESP_COMPLETE,
            {"crc": live["blob_crc"], "size": live["size"]},
        )
        self._live.pop(live["id"], None)

    # -- push (peer pushes into our sink) ------------------------------------

    async def _serve_push(
        self,
        hdr: Dict[str, Any],
        live: Dict[str, Any],
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
    ) -> None:
        name = str(hdr.get("source") or "")
        key = f"{self.address}/{name}"
        fn = self._sinks.get(name)
        if fn is None:
            self._live.pop(live["id"], None)
            await codec.write_frame(
                writer,
                FrameType.RESP_PROLOGUE,
                {"ok": False, "error": f"no bulk sink {name!r}", "kind": "unavailable"},
            )
            return
        size = int(hdr.get("size") or 0)
        if live["budget"] and size > live["budget"]:
            self._live.pop(live["id"], None)
            await codec.write_frame(
                writer,
                FrameType.RESP_PROLOGUE,
                {
                    "ok": False,
                    "error": f"declared {size}B exceeds ticket budget {live['budget']}B",
                    "kind": "budget",
                },
            )
            return
        chunks: List[bytes] = live["chunks"]
        await codec.write_frame(
            writer,
            FrameType.RESP_PROLOGUE,
            {"ok": True, "have": len(chunks), "chunk_bytes": self.chunk_bytes},
        )
        while True:
            if faults.enabled:
                delay = faults.delay_for("bulk_slow_peer", key)
                if delay:
                    await asyncio.sleep(delay)
            frame = await codec.read_frame(reader)
            if frame.type != FrameType.REQ_DATA:
                return
            item = frame.unpack()
            if item.get("done"):
                break
            if int(item.get("i", -1)) != len(chunks):
                await codec.write_frame(
                    writer,
                    FrameType.RESP_ERROR,
                    {"error": "chunk out of order", "kind": "order"},
                )
                return  # live survives; client restarts from `have`
            data = item.get("data") or b""
            if bytes_checksum(data) != item.get("crc"):
                await codec.write_frame(
                    writer,
                    FrameType.RESP_ERROR,
                    {"error": "chunk CRC mismatch", "kind": "crc"},
                )
                return  # live survives; the damaged chunk is re-sent
            live["nbytes"] += len(data)
            if live["budget"] and live["nbytes"] > live["budget"]:
                self._live.pop(live["id"], None)
                await codec.write_frame(
                    writer,
                    FrameType.RESP_ERROR,
                    {"error": "ticket byte budget exceeded", "kind": "budget"},
                )
                return
            chunks.append(data)
            if faults.enabled and faults.should("bulk_conn_drop", key):
                # Abort AFTER the chunk verified and landed: the reconnect's
                # prologue reports ``have`` past it, so the client resumes
                # from the server's verified frontier.
                writer.transport.abort()
                return
        blob = b"".join(chunks)
        if len(blob) != size:
            self._live.pop(live["id"], None)
            await codec.write_frame(
                writer,
                FrameType.RESP_ERROR,
                {
                    "error": f"assembled {len(blob)}B != declared {size}B",
                    "kind": "size",
                },
            )
            return
        try:
            reply = await fn(blob, hdr.get("meta") or {})
        except asyncio.CancelledError:
            raise
        except Exception as exc:
            self._live.pop(live["id"], None)
            await codec.write_frame(
                writer,
                FrameType.RESP_ERROR,
                {"error": f"sink failed: {exc}", "kind": "sink"},
            )
            return
        await codec.write_frame(writer, FrameType.RESP_ITEM, {"reply": reply})
        await codec.write_frame(
            writer,
            FrameType.RESP_COMPLETE,
            {"crc": bytes_checksum(blob), "size": len(blob)},
        )
        self._live.pop(live["id"], None)


# --------------------------------------------------------------------------
# Client
# --------------------------------------------------------------------------


async def _open(address: str) -> Tuple[asyncio.StreamReader, asyncio.StreamWriter]:
    host, _, port = address.rpartition(":")
    return await asyncio.open_connection(host, int(port))


async def _close(writer: asyncio.StreamWriter) -> None:
    writer.close()
    try:
        await writer.wait_closed()
    except asyncio.CancelledError:
        raise
    except (ConnectionError, OSError):
        pass


_RESUMABLE = (ConnectionError, EOFError, OSError, asyncio.TimeoutError, _ChunkDamage)


async def bulk_fetch(
    address: str,
    source: str,
    ticket: Dict[str, Any],
    meta: Optional[Dict[str, Any]] = None,
    *,
    salt: Optional[str] = None,
    timeout_s: float = 30.0,
    max_resumes: int = 3,
) -> bytes:
    """Fetch a blob from ``source`` on the peer at ``address``.

    Verified chunks accumulate across attempts: a connection drop resumes
    from ``len(received)`` instead of restarting, and the server's cached
    chunk list guarantees the resumed bytes match.  Raises
    ``BulkTransferError`` (``retryable=True`` once the resume budget is
    exhausted; ``retryable=False`` on a protocol refusal)."""
    received: List[bytes] = []
    attempt = 0
    while True:
        try:
            return await asyncio.wait_for(
                _fetch_once(address, source, ticket, received, meta=meta, salt=salt),
                timeout_s,
            )
        except asyncio.CancelledError:
            raise
        except BulkTransferError:
            raise
        except _RESUMABLE as exc:
            attempt += 1
            if attempt > max_resumes:
                raise BulkTransferError(
                    f"bulk fetch {source!r} from {address} failed after "
                    f"{attempt} attempts: {exc!r}",
                    retryable=True,
                ) from exc
            await asyncio.sleep(0.01 * attempt)


async def _fetch_once(
    address: str,
    source: str,
    ticket: Dict[str, Any],
    received: List[bytes],
    *,
    meta: Optional[Dict[str, Any]],
    salt: Optional[str],
) -> bytes:
    if received:
        _metrics().resumes_total += 1
    reader, writer = await _open(address)
    try:
        hdr: Dict[str, Any] = {
            "op": "fetch",
            "source": source,
            "ticket": ticket,
            "resume_from": len(received),
        }
        if meta is not None:
            hdr["meta"] = meta
        if salt:
            hdr["salt"] = salt
        await codec.write_frame(writer, FrameType.REQ_HEADER, hdr)
        frame = await codec.read_frame(reader)
        pro = frame.unpack()
        if frame.type != FrameType.RESP_PROLOGUE or not pro.get("ok"):
            raise BulkTransferError(
                f"bulk fetch refused by {address}: {pro.get('error')}",
                kind=str(pro.get("kind") or ""),
            )
        total = int(pro.get("chunks") or 0)
        while len(received) < total:
            frame = await codec.read_frame(reader)
            if frame.type == FrameType.RESP_ERROR:
                err = frame.unpack()
                raise BulkTransferError(
                    f"bulk fetch error from {address}: {err.get('error')}",
                    kind=str(err.get("kind") or ""),
                )
            if frame.type != FrameType.RESP_ITEM:
                raise _ChunkDamage(len(received))
            item = frame.unpack()
            if int(item.get("i", -1)) != len(received):
                raise _ChunkDamage(len(received))
            data = item.get("data") or b""
            if bytes_checksum(data) != item.get("crc"):
                raise _ChunkDamage(len(received))
            received.append(data)
        frame = await codec.read_frame(reader)
        done = frame.unpack()
        blob = b"".join(received)
        if (
            frame.type != FrameType.RESP_COMPLETE
            or bytes_checksum(blob) != done.get("crc")
            or len(blob) != done.get("size")
        ):
            raise BulkTransferError(
                f"bulk fetch from {address}: whole-stream verification failed",
                kind="crc",
            )
        m = _metrics()
        m.transfers_total += 1
        m.bytes_total += len(blob)
        return blob
    finally:
        await _close(writer)


async def bulk_push(
    address: str,
    sink: str,
    ticket: Dict[str, Any],
    blob: bytes,
    meta: Optional[Dict[str, Any]] = None,
    *,
    salt: Optional[str] = None,
    timeout_s: float = 30.0,
    max_resumes: int = 3,
    chunk_bytes: Optional[int] = None,
) -> Any:
    """Push ``blob`` into ``sink`` on the peer at ``address``; returns the
    sink's reply.  Resume is server-anchored: after a drop the reconnect's
    prologue reports how many chunks the server verified (``have``) and
    the client continues from there."""
    cb = int(chunk_bytes or _chunk_bytes())
    chunks, crcs, _ = await asyncio.to_thread(_chunk_crcs, blob, cb)
    attempt = 0
    while True:
        try:
            return await asyncio.wait_for(
                _push_once(address, sink, ticket, blob, chunks, crcs, meta=meta, salt=salt),
                timeout_s,
            )
        except asyncio.CancelledError:
            raise
        except BulkTransferError:
            raise
        except _RESUMABLE as exc:
            attempt += 1
            if attempt > max_resumes:
                raise BulkTransferError(
                    f"bulk push {sink!r} to {address} failed after "
                    f"{attempt} attempts: {exc!r}",
                    retryable=True,
                ) from exc
            await asyncio.sleep(0.01 * attempt)


async def _push_once(
    address: str,
    sink: str,
    ticket: Dict[str, Any],
    blob: bytes,
    chunks: List[bytes],
    crcs: List[int],
    *,
    meta: Optional[Dict[str, Any]],
    salt: Optional[str],
) -> Any:
    reader, writer = await _open(address)
    try:
        hdr: Dict[str, Any] = {
            "op": "push",
            "source": sink,
            "ticket": ticket,
            "resume_from": 0,
            "size": len(blob),
            "chunks": len(chunks),
        }
        if meta is not None:
            hdr["meta"] = meta
        if salt:
            hdr["salt"] = salt
        await codec.write_frame(writer, FrameType.REQ_HEADER, hdr)
        frame = await codec.read_frame(reader)
        pro = frame.unpack()
        if frame.type != FrameType.RESP_PROLOGUE or not pro.get("ok"):
            raise BulkTransferError(
                f"bulk push refused by {address}: {pro.get('error')}",
                kind=str(pro.get("kind") or ""),
            )
        have = int(pro.get("have") or 0)
        if have:
            _metrics().resumes_total += 1
        for i in range(have, len(chunks)):
            await codec.write_frame(
                writer,
                FrameType.REQ_DATA,
                {"i": i, "crc": crcs[i], "data": chunks[i]},
            )
        await codec.write_frame(writer, FrameType.REQ_DATA, {"done": True})
        reply: Any = None
        while True:
            frame = await codec.read_frame(reader)
            if frame.type == FrameType.RESP_ERROR:
                err = frame.unpack()
                if err.get("kind") in ("crc", "order"):
                    raise _ChunkDamage(-1)
                raise BulkTransferError(
                    f"bulk push error from {address}: {err.get('error')}",
                    kind=str(err.get("kind") or ""),
                )
            if frame.type == FrameType.RESP_ITEM:
                reply = frame.unpack().get("reply")
            elif frame.type == FrameType.RESP_COMPLETE:
                break
        m = _metrics()
        m.transfers_total += 1
        m.bytes_total += len(blob)
        return reply
    finally:
        await _close(writer)


# --------------------------------------------------------------------------
# Rendezvous (the hub's only role in a transfer)
# --------------------------------------------------------------------------


class BulkRendezvous:
    """Address lookup + ticket minting against the hub.

    Every method degrades instead of raising on hub trouble (``lookup``
    serves its TTL cache stale; ``prepare*`` returns ``None``) — the
    caller's fallback ladder, not an exception, handles a rendezvous
    outage."""

    def __init__(
        self,
        hub: Any,
        *,
        lease: Optional[int] = None,
        ttl_s: float = TICKET_TTL_S,
        clock: Callable[[], float] = time.time,
        cache_ttl_s: float = 5.0,
    ):
        self.hub = hub
        self.lease = lease
        self.ttl_s = ttl_s
        self.clock = clock
        self.cache_ttl_s = cache_ttl_s
        self._cache: Dict[str, Tuple[float, Dict[str, Any]]] = {}

    async def lookup(self, worker_id: Any) -> Optional[str]:
        """The peer's bulk address, or None when it runs no bulk server."""
        wid = str(worker_id)
        now = self.clock()
        hit = self._cache.get(wid)
        if hit is not None and hit[0] > now:
            return hit[1].get("address")
        try:
            rec = await self.hub.kv_get(bulk_addr_key(wid))
        except asyncio.CancelledError:
            raise
        except Exception:
            logger.warning("bulk rendezvous: hub lookup failed for %s", wid)
            return hit[1].get("address") if hit is not None else None
        if not isinstance(rec, dict) or not rec.get("address"):
            self._cache.pop(wid, None)
            return None
        self._cache[wid] = (now + self.cache_ttl_s, rec)
        return rec["address"]

    async def _park(self, ticket: Dict[str, Any]) -> bool:
        ticket["lease"] = self.lease
        try:
            await self.hub.kv_put(bulk_ticket_key(ticket["id"]), ticket, self.lease)
        except asyncio.CancelledError:
            raise
        except Exception:
            logger.warning("bulk rendezvous: ticket park failed")
            return False
        return True

    async def prepare(
        self, worker_id: Any, *, salt: Optional[str] = None, budget: int = 0
    ) -> Optional[Tuple[str, Dict[str, Any]]]:
        """Rendezvous for a transfer with ``worker_id``: (address, ticket),
        or None when the peer is unreachable / the hub is down."""
        address = await self.lookup(worker_id)
        if not address:
            return None
        ticket = mint_ticket(
            worker_id, salt=salt, budget=budget, ttl_s=self.ttl_s, clock=self.clock
        )
        if not await self._park(ticket):
            return None
        return address, ticket

    async def prepare_sink(
        self, kind: str, *, salt: Optional[str] = None, budget: int = 0
    ) -> Optional[Tuple[str, Dict[str, Any]]]:
        """Rendezvous with any registered sink of ``kind`` (e.g. the span
        aggregator's ``traces`` ingest): (address, ticket) or None."""
        try:
            recs = await self.hub.kv_get_prefix(bulk_sink_prefix(kind))
        except asyncio.CancelledError:
            raise
        except Exception:
            logger.warning("bulk rendezvous: sink scan failed for %s", kind)
            return None
        for rec in sorted((recs or {}).items()):
            rec = rec[1]
            if not isinstance(rec, dict) or not rec.get("address"):
                continue
            ticket = mint_ticket(
                rec.get("worker_id") or "",
                salt=salt,
                budget=budget,
                ttl_s=self.ttl_s,
                clock=self.clock,
            )
            if not await self._park(ticket):
                return None
            return rec["address"], ticket
        return None

"""The hub: self-contained control plane for discovery, events, and queues.

A copy of the JAX package's ``runtime/transports/hub.py``: the same
newline-delimited JSON on the wire and the same ``--persist`` snapshot
file, so a client of either package talks to a hub of the other.

The reference outsources these planes to external infrastructure — etcd
(lease-based discovery KV with prefix watches, lib/runtime/src/transports/
etcd.rs:41-330) and NATS core/JetStream (pub-sub event plane + work queues,
transports/nats.rs).  This build provides one self-contained hub speaking a
newline-delimited-JSON protocol over TCP, so a full distributed deployment
needs zero external services.  Three faces:

- ``HubState``   — the in-memory state machine (KV + leases + subs + queues).
- ``HubServer``  — asyncio TCP server exposing it (the ``docker-compose``
  etcd+NATS replacement; run via ``python -m dynamo_tpu_torch.cli hub``).
- ``HubClient``  — asyncio client; same async interface as ``InprocHub``.
- ``InprocHub``  — direct in-process binding for single-process serving and
  tests (the reference's "static mode", lib/runtime/src/distributed.rs).

Semantics preserved from the reference:
- KV entries may be attached to a **lease**; lease expiry deletes the keys and
  notifies prefix watchers (liveness = lease keep-alive; etcd/lease.rs:19-51).
- ``watch_prefix`` emits the current snapshot as Put events, then live deltas
  (etcd.rs:246-330 ``kv_get_and_watch_prefix``).
- Queues are at-least-once: popped items must be acked; a consumer
  disconnecting with unacked items requeues them (JetStream prefill queue,
  examples/llm/utils/nats_queue.py).
- Subjects support NATS-style wildcards: ``*`` one token, ``>`` tail.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import logging
import os
import random
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Callable, Dict, List, Optional, Set, Tuple

from ..faultinject import faults

logger = logging.getLogger(__name__)


class HubSessionLost(ConnectionError):
    """The hub connection dropped mid-watch.  Server-side watch state is
    gone, so deltas may have been missed: the consumer must re-arm the
    watch (``hub.watch_prefix`` again — it blocks until the hub is back)
    and RESYNC its derived state from a fresh ``kv_get_prefix`` snapshot.
    Every long-lived watcher in the tree follows this recovery shape."""


# Queue sentinel a reconnecting HubClient injects into live watch queues:
# the old server-side watch died with the connection, so the Watcher must
# surface HubSessionLost rather than silently starve.
_WATCH_LOST = object()


# --------------------------------------------------------------------------
# Events / small types
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class WatchEvent:
    """Put/Delete delta on a watched prefix (reference ``WatchEvent``)."""

    type: str  # "put" | "delete"
    key: str
    value: Any = None


def subject_matches(pattern: str, subject: str) -> bool:
    """NATS-style subject matching: ``*`` = one token, ``>`` = remainder."""
    pt, st = pattern.split("."), subject.split(".")
    for i, p in enumerate(pt):
        if p == ">":
            return len(st) > i  # '>' matches one or more remaining tokens
        if i >= len(st):
            return False
        if p != "*" and p != st[i]:
            return False
    return len(pt) == len(st)


# --------------------------------------------------------------------------
# State machine
# --------------------------------------------------------------------------


@dataclass
class _Lease:
    id: int
    ttl: float
    expires_at: float
    keys: Set[str] = field(default_factory=set)


@dataclass
class _QueueItem:
    item: Any
    ack_token: str


class HubState:
    """In-memory KV + lease + pub/sub + queue state with watcher fanout.

    All mutation goes through async methods on the owning event loop, so no
    locks are needed (single-threaded asyncio, the same reasoning as the
    reference's dedicated indexer thread).
    """

    def __init__(self):
        self._kv: Dict[str, Any] = {}
        self._kv_lease: Dict[str, int] = {}
        self._leases: Dict[int, _Lease] = {}
        self._next_lease_id = 1
        self._revision = 0
        # watch id → (prefix, asyncio.Queue of WatchEvent)
        self._watches: Dict[str, Tuple[str, asyncio.Queue]] = {}
        # sub id → (pattern, queue of (subject, payload))
        self._subs: Dict[str, Tuple[str, asyncio.Queue]] = {}
        # queue name → deque of _QueueItem
        self._queues: Dict[str, deque] = {}
        # queue name → waiters (futures)
        self._q_waiters: Dict[str, deque] = {}
        # ack token → (queue name, item) for in-flight redelivery
        self._inflight: Dict[str, Tuple[str, Any]] = {}
        self._expiry_task: Optional[asyncio.Task] = None
        # Replication taps: called (synchronously, on the owning loop) with
        # one op-log entry per durable-state mutation — exactly the deltas
        # a warm standby needs to keep a live copy of ``snapshot()``.
        self._repl_taps: List[Callable[[Dict[str, Any]], None]] = []

    # -- lifecycle ----------------------------------------------------------

    def start_expiry_loop(self) -> None:
        if self._expiry_task is None or self._expiry_task.done():
            self._expiry_task = asyncio.get_running_loop().create_task(
                self._expire_leases_loop()
            )

    async def close(self) -> None:
        if self._expiry_task is not None:
            self._expiry_task.cancel()
            try:
                await self._expiry_task
            except asyncio.CancelledError:
                pass
            self._expiry_task = None

    async def _expire_leases_loop(self) -> None:
        while True:
            await asyncio.sleep(0.2)
            now = time.monotonic()
            expired = [l for l in self._leases.values() if l.expires_at <= now]
            for lease in expired:
                await self.lease_revoke(lease.id)

    # -- replication ---------------------------------------------------------

    def add_replication_tap(self, tap: Callable[[Dict[str, Any]], None]) -> None:
        self._repl_taps.append(tap)

    def remove_replication_tap(self, tap: Callable[[Dict[str, Any]], None]) -> None:
        try:
            self._repl_taps.remove(tap)
        except ValueError:
            pass

    def _replicate(self, entry: Dict[str, Any]) -> None:
        for notify in self._repl_taps:
            notify(entry)

    # -- KV -----------------------------------------------------------------

    async def kv_put(self, key: str, value: Any, lease_id: Optional[int] = None) -> None:
        self._revision += 1
        self._kv[key] = value
        # Rebinding a key to a different lease (or to none) must detach it
        # from the previous lease, or that lease's later expiry would
        # delete a key it no longer owns (the composite-lease re-grant
        # path rebinds every registration onto a fresh lease).
        old_lease = self._kv_lease.get(key)
        if old_lease is not None and old_lease != lease_id:
            if old_lease in self._leases:
                self._leases[old_lease].keys.discard(key)
        if lease_id is not None:
            if lease_id not in self._leases:
                raise KeyError(f"unknown lease {lease_id}")
            self._kv_lease[key] = lease_id
            self._leases[lease_id].keys.add(key)
            if self._repl_taps:
                # Lease-bound keys are NOT durable (snapshot() skips them:
                # live workers re-register); a key that was durable and is
                # now leased leaves the standby's durable view.
                self._replicate({"op": "kv_delete", "key": key})
        else:
            self._kv_lease.pop(key, None)
            if self._repl_taps:
                self._replicate({"op": "kv_put", "key": key, "value": value})
        self._notify(WatchEvent("put", key, value))

    async def kv_get(self, key: str) -> Any:
        return self._kv.get(key)

    async def kv_get_prefix(self, prefix: str) -> Dict[str, Any]:
        return {k: v for k, v in self._kv.items() if k.startswith(prefix)}

    async def kv_delete(self, key: str) -> bool:
        if key not in self._kv:
            return False
        self._kv.pop(key)
        lease_id = self._kv_lease.pop(key, None)
        if lease_id is not None and lease_id in self._leases:
            self._leases[lease_id].keys.discard(key)
        if self._repl_taps and lease_id is None:
            self._replicate({"op": "kv_delete", "key": key})
        self._notify(WatchEvent("delete", key))
        return True

    def _notify(self, event: WatchEvent) -> None:
        if faults.enabled and (
            faults.is_armed("watch_stall") or faults.is_armed("hub_outage")
        ):
            # Simulated hub partition/outage: deltas silently stop reaching
            # watchers (their view goes stale until the fault clears).
            return
        for prefix, q in self._watches.values():
            if event.key.startswith(prefix):
                q.put_nowait(event)

    # -- watches ------------------------------------------------------------

    async def watch_create(self, prefix: str) -> Tuple[str, asyncio.Queue]:
        wid = uuid.uuid4().hex
        q: asyncio.Queue = asyncio.Queue()
        # snapshot first (kv_get_and_watch_prefix semantics), then a sync
        # marker so watchers know the snapshot is complete
        for k, v in self._kv.items():
            if k.startswith(prefix):
                q.put_nowait(WatchEvent("put", k, v))
        q.put_nowait(WatchEvent("sync", ""))
        self._watches[wid] = (prefix, q)
        return wid, q

    async def watch_cancel(self, wid: str) -> None:
        self._watches.pop(wid, None)

    # -- leases -------------------------------------------------------------

    async def lease_grant(self, ttl: float) -> int:
        lid = self._next_lease_id
        self._next_lease_id += 1
        self._leases[lid] = _Lease(lid, ttl, time.monotonic() + ttl)
        if self._repl_taps:
            # The standby tracks the id floor so a promoted shard never
            # re-issues an id a pre-failover client still keeps alive.
            self._replicate({"op": "lease_floor", "floor": self._next_lease_id})
        return lid

    async def lease_keepalive(self, lease_id: int) -> bool:
        lease = self._leases.get(lease_id)
        if lease is None:
            return False
        lease.expires_at = time.monotonic() + lease.ttl
        return True

    async def lease_revoke(self, lease_id: int) -> None:
        lease = self._leases.pop(lease_id, None)
        if lease is None:
            return
        for key in list(lease.keys):
            # Only delete keys STILL bound to this lease — a key rebound
            # to a fresh lease since must survive the old one's expiry.
            if self._kv_lease.get(key) == lease_id:
                await self.kv_delete(key)

    # -- pub/sub ------------------------------------------------------------

    async def subscribe(self, pattern: str) -> Tuple[str, asyncio.Queue]:
        sid = uuid.uuid4().hex
        q: asyncio.Queue = asyncio.Queue()
        self._subs[sid] = (pattern, q)
        return sid, q

    async def unsubscribe(self, sid: str) -> None:
        self._subs.pop(sid, None)

    async def publish(self, subject: str, payload: Any) -> int:
        if faults.enabled and faults.is_armed("hub_outage"):
            return 0  # event plane down with the hub
        n = 0
        for pattern, q in self._subs.values():
            if subject_matches(pattern, subject):
                q.put_nowait((subject, payload))
                n += 1
        return n

    # -- queues (at-least-once) --------------------------------------------

    async def q_push(self, queue: str, item: Any) -> None:
        waiters = self._q_waiters.setdefault(queue, deque())
        while waiters:
            fut = waiters.popleft()
            if not fut.done():
                token = uuid.uuid4().hex
                self._inflight[token] = (queue, item)
                if self._repl_taps:
                    self._replicate({
                        "op": "q_add", "queue": queue, "item": item,
                        "where": "inflight",
                    })
                fut.set_result(_QueueItem(item, token))
                return
        self._queues.setdefault(queue, deque()).append(
            _QueueItem(item, uuid.uuid4().hex)
        )
        if self._repl_taps:
            self._replicate({
                "op": "q_add", "queue": queue, "item": item, "where": "queue",
            })

    async def q_pop(self, queue: str) -> _QueueItem:
        dq = self._queues.setdefault(queue, deque())
        if dq:
            qi = dq.popleft()
            self._inflight[qi.ack_token] = (queue, qi.item)
            if self._repl_taps:
                self._replicate({"op": "q_take", "queue": queue, "item": qi.item})
            return qi
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._q_waiters.setdefault(queue, deque()).append(fut)
        try:
            return await fut
        except asyncio.CancelledError:
            if fut.done() and not fut.cancelled():
                # q_push handed us an item but our task was cancelled at the
                # await: requeue it so at-least-once holds
                qi = fut.result()
                await self.q_nack(qi.ack_token)
            else:
                fut.cancel()  # q_push skips done/cancelled waiters
            raise

    async def q_ack(self, token: str) -> bool:
        entry = self._inflight.pop(token, None)
        if entry is None:
            return False
        if self._repl_taps:
            queue, item = entry
            self._replicate({"op": "q_settle", "queue": queue, "item": item})
        return True

    async def q_nack(self, token: str) -> bool:
        """Requeue an in-flight item (redelivery; consumer died/declined)."""
        entry = self._inflight.pop(token, None)
        if entry is None:
            return False
        queue, item = entry
        if self._repl_taps:
            self._replicate({"op": "q_settle", "queue": queue, "item": item})
        await self.q_push(queue, item)
        return True

    async def q_len(self, queue: str) -> int:
        return len(self._queues.get(queue, ()))

    # -- persistence --------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Durable state: KV entries NOT bound to leases (lease-bound keys
        are live-worker registrations that must re-register on rejoin) plus
        queued + in-flight work items (at-least-once across restart).  The
        lease-id floor also persists: a restarted hub must never re-issue
        an id a pre-restart client still keeps alive (its keepalives would
        silently sustain a stranger's lease)."""
        return {
            "kv": {
                k: v for k, v in self._kv.items() if k not in self._kv_lease
            },
            "queues": {
                name: [qi.item for qi in dq]
                for name, dq in self._queues.items()
                if dq
            },
            "inflight": [
                [queue, item] for queue, item in self._inflight.values()
            ],
            "lease_floor": self._next_lease_id,
        }

    def restore(self, snap: Dict[str, Any]) -> None:
        try:
            floor = int(snap.get("lease_floor", 1))
        except (TypeError, ValueError):
            floor = 1
        self._next_lease_id = max(self._next_lease_id, floor)
        for k, v in (snap.get("kv") or {}).items():
            self._kv[k] = v
        for name, items in (snap.get("queues") or {}).items():
            dq = self._queues.setdefault(name, deque())
            for item in items:
                dq.append(_QueueItem(item, uuid.uuid4().hex))
        for queue, item in snap.get("inflight") or ():
            # undelivered at snapshot time from the consumer's perspective
            self._queues.setdefault(queue, deque()).append(
                _QueueItem(item, uuid.uuid4().hex)
            )


# --------------------------------------------------------------------------
# In-process binding
# --------------------------------------------------------------------------


class _QueueIter:
    """Async iterator over a queue with a None close-sentinel and aclose."""

    def __init__(self, queue: asyncio.Queue, cancel: Callable):
        self._queue = queue
        self._cancel = cancel
        self._closed = False

    def __aiter__(self):
        return self

    async def __anext__(self):
        if self._closed:
            raise StopAsyncIteration
        item = await self._queue.get()
        if item is None:
            raise StopAsyncIteration
        return item

    async def aclose(self) -> None:
        if not self._closed:
            self._closed = True
            await self._cancel()


class Watcher(_QueueIter):
    """Async iterator of WatchEvents.

    The snapshot is terminated by a ``sync`` marker event; it is not yielded —
    instead it sets ``synced`` so callers can wait for a consistent initial
    view before routing.
    """

    def __init__(self, queue: asyncio.Queue, cancel: Callable):
        super().__init__(queue, cancel)
        self.synced = asyncio.Event()

    async def __anext__(self) -> WatchEvent:
        if faults.enabled and faults.should("watch_error"):
            raise RuntimeError("[fault] injected watch stream failure")
        while True:
            ev = await super().__anext__()
            if ev is _WATCH_LOST:
                raise HubSessionLost(
                    "hub connection lost; re-arm the watch and resync"
                )
            if ev.type == "sync":
                self.synced.set()
                continue
            return ev


class Subscription(_QueueIter):
    """Async iterator of (subject, payload) with unsubscribe."""


def _payload_nbytes(payload: Any) -> int:
    """Approximate serialized size of a publish payload, for the per-shard
    control-plane volume counters (shard.HubShardMetrics.note_publish) —
    the series that proves bulk bytes left the hub under DYN_BULK_PLANE.
    Best-effort: an unencodable payload counts 0 rather than failing the
    publish."""
    from . import codec

    try:
        return len(codec.encode(payload))
    except Exception:  # noqa: BLE001 — metrics must never break a publish
        return 0


class InprocHub:
    """Direct in-process hub (single-process serving, tests, static mode).

    Leases granted here are auto-kept-alive (the owning process being alive IS
    the liveness signal), matching HubClient's keepalive behaviour, until
    ``lease_revoke``/``close``.
    """

    def __init__(self):
        self.state = HubState()
        self._keepalive_tasks: Dict[int, asyncio.Task] = {}

    async def start(self) -> "InprocHub":
        self.state.start_expiry_loop()
        return self

    async def close(self) -> None:
        for t in self._keepalive_tasks.values():
            t.cancel()
        self._keepalive_tasks.clear()
        await self.state.close()

    # KV
    async def kv_put(self, key, value, lease_id=None):
        await self.state.kv_put(key, value, lease_id)

    async def kv_get(self, key):
        return await self.state.kv_get(key)

    async def kv_get_prefix(self, prefix):
        return await self.state.kv_get_prefix(prefix)

    async def kv_delete(self, key):
        return await self.state.kv_delete(key)

    async def watch_prefix(self, prefix) -> Watcher:
        wid, q = await self.state.watch_create(prefix)

        async def cancel():
            await self.state.watch_cancel(wid)
            q.put_nowait(None)

        return Watcher(q, cancel)

    # leases
    async def lease_grant(self, ttl: float = 10.0) -> int:
        lid = await self.state.lease_grant(ttl)
        self._keepalive_tasks[lid] = asyncio.get_running_loop().create_task(
            self._keepalive_loop(lid, ttl)
        )
        return lid

    async def _keepalive_loop(self, lease_id: int, ttl: float) -> None:
        try:
            while await self.state.lease_keepalive(lease_id):
                await asyncio.sleep(max(ttl / 3.0, 0.05))
        except asyncio.CancelledError:
            pass

    async def lease_keepalive(self, lease_id: int) -> bool:
        return await self.state.lease_keepalive(lease_id)

    async def lease_revoke(self, lease_id: int) -> None:
        task = self._keepalive_tasks.pop(lease_id, None)
        if task:
            task.cancel()
        await self.state.lease_revoke(lease_id)

    # pub/sub
    async def publish(self, subject, payload) -> None:
        from .shard import shard_metrics

        shard_metrics.note_publish("inproc", _payload_nbytes(payload))
        await self.state.publish(subject, payload)

    async def subscribe(self, pattern) -> Subscription:
        sid, q = await self.state.subscribe(pattern)

        async def cancel():
            await self.state.unsubscribe(sid)
            q.put_nowait(None)

        return Subscription(q, cancel)

    # queues
    async def q_push(self, queue, item) -> None:
        await self.state.q_push(queue, item)

    async def q_pop(self, queue) -> Tuple[Any, str]:
        qi = await self.state.q_pop(queue)
        return qi.item, qi.ack_token

    async def q_ack(self, token) -> bool:
        return await self.state.q_ack(token)

    async def q_nack(self, token) -> bool:
        return await self.state.q_nack(token)

    async def q_len(self, queue) -> int:
        return await self.state.q_len(queue)


# --------------------------------------------------------------------------
# TCP server
# --------------------------------------------------------------------------


class HubServer:
    """TCP front for HubState: newline-delimited JSON request/push protocol.

    Client → server: ``{"rid": n, "op": "...", ...}``
    Server → client: ``{"rid": n, "ok": true, ...}`` or pushes
    ``{"push": "watch"|"msg"|null, "id": sub_or_watch_id, ...}``.

    Per-connection bookkeeping mirrors broker session semantics: dropping the
    connection cancels its watches/subscriptions, requeues its unacked queue
    items, and stops keepalives for its leases (which then expire → liveness).
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        persist_path: Optional[str] = None,
        persist_interval_s: float = 2.0,
    ):
        self.host = host
        self.port = port
        self.state = HubState()
        self._server: Optional[asyncio.base_events.Server] = None
        # Restart-survival (reference: etcd raft log / NATS JetStream file
        # store): durable KV + queued work snapshot to disk; lease-bound
        # registrations intentionally NOT persisted (workers re-register).
        self.persist_path = persist_path
        self.persist_interval_s = persist_interval_s
        self._persist_task: Optional[asyncio.Task] = None
        # Live per-connection handler tasks.  asyncio's Server.close() does
        # NOT end established connections (and 3.12's wait_closed would wait
        # on them forever), so close() cancels these explicitly — no orphan
        # pump/handler tasks may survive a closed hub.
        self._conn_tasks: set = set()

    async def start(self) -> "HubServer":
        if self.persist_path and os.path.exists(self.persist_path):
            with open(self.persist_path) as f:
                self.state.restore(json.load(f))
        self.state.start_expiry_loop()
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        if self.persist_path:
            self._persist_task = asyncio.get_running_loop().create_task(
                self._persist_loop()
            )
        return self

    def _persist_now(self) -> None:
        if not self.persist_path:
            return
        tmp = self.persist_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.state.snapshot(), f)
        os.replace(tmp, self.persist_path)  # atomic swap

    async def _persist_loop(self) -> None:
        while True:
            await asyncio.sleep(self.persist_interval_s)
            try:
                self._persist_now()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("hub snapshot failed")

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    async def close(self) -> None:
        if self._persist_task is not None:
            self._persist_task.cancel()
            try:
                await self._persist_task
            except asyncio.CancelledError:
                pass
            self._persist_task = None
        try:
            self._persist_now()
        except asyncio.CancelledError:
            raise
        except Exception:
            logger.exception("final hub snapshot failed")
        if self._server is not None:
            self._server.close()
            for task in list(self._conn_tasks):
                task.cancel()
            await self._server.wait_closed()
            self._server = None
        await self.state.close()

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        conn_task = asyncio.current_task()
        self._conn_tasks.add(conn_task)
        session_watches: Dict[str, asyncio.Task] = {}
        session_subs: Dict[str, asyncio.Task] = {}
        session_unacked: Set[str] = set()
        session_pop_tasks: Set[asyncio.Task] = set()
        session_repl_taps: List[Callable[[Dict[str, Any]], None]] = []
        session_repl_tasks: Set[asyncio.Task] = set()
        write_lock = asyncio.Lock()

        async def send(obj: Any) -> None:
            async with write_lock:
                writer.write(json.dumps(obj).encode() + b"\n")
                await writer.drain()

        async def pump_watch(wid: str, q: asyncio.Queue):
            while True:
                ev = await q.get()
                await send(
                    {"push": "watch", "id": wid, "type": ev.type, "key": ev.key, "value": ev.value}
                )

        async def pump_sub(sid: str, q: asyncio.Queue):
            while True:
                subject, payload = await q.get()
                await send({"push": "msg", "id": sid, "subject": subject, "payload": payload})

        async def do_pop(rid: int, queue: str):
            qi = await self.state.q_pop(queue)
            session_unacked.add(qi.ack_token)
            await send({"rid": rid, "ok": True, "item": qi.item, "token": qi.ack_token})

        async def pump_oplog(q: asyncio.Queue):
            while True:
                entry = await q.get()
                await send({"push": "oplog", "entry": entry})

        try:
            while True:
                if faults.enabled and faults.is_armed("hub_outage"):
                    # Simulated hub outage: drop the connection without a
                    # goodbye (clients observe exactly what a dead hub
                    # looks like and enter their reconnect loops; the
                    # accept path below drops fresh dials the same way).
                    break
                line = await reader.readline()
                if not line:
                    break
                if faults.enabled and faults.is_armed("hub_outage"):
                    break
                try:
                    msg = json.loads(line)
                except json.JSONDecodeError:
                    await send({"rid": None, "ok": False, "error": "bad json"})
                    continue
                rid, op = msg.get("rid"), msg.get("op")
                try:
                    st = self.state
                    if op == "kv_put":
                        await st.kv_put(msg["key"], msg.get("value"), msg.get("lease"))
                        await send({"rid": rid, "ok": True})
                    elif op == "kv_get":
                        await send({"rid": rid, "ok": True, "value": await st.kv_get(msg["key"])})
                    elif op == "kv_get_prefix":
                        await send(
                            {"rid": rid, "ok": True, "kvs": await st.kv_get_prefix(msg["prefix"])}
                        )
                    elif op == "kv_delete":
                        await send({"rid": rid, "ok": True, "deleted": await st.kv_delete(msg["key"])})
                    elif op == "watch":
                        wid, q = await st.watch_create(msg["prefix"])
                        # respond before pumping: the client must map wid → queue
                        # before the first push (snapshot) hits the socket
                        await send({"rid": rid, "ok": True, "id": wid})
                        wt = asyncio.create_task(pump_watch(wid, q))
                        session_watches[wid] = wt
                        # A crashed pump must not linger as a live-looking
                        # entry (close() would "cancel" a dead task and
                        # leak the watch registration).
                        wt.add_done_callback(
                            lambda t, wid=wid: session_watches.pop(wid, None)
                            if session_watches.get(wid) is t
                            else None
                        )
                    elif op == "watch_cancel":
                        wid = msg["id"]
                        task = session_watches.pop(wid, None)
                        if task:
                            task.cancel()
                        await st.watch_cancel(wid)
                        await send({"rid": rid, "ok": True})
                    elif op == "lease_grant":
                        lid = await st.lease_grant(msg.get("ttl", 10.0))
                        await send({"rid": rid, "ok": True, "lease": lid})
                    elif op == "lease_keepalive":
                        ok = await st.lease_keepalive(msg["lease"])
                        await send({"rid": rid, "ok": ok})
                    elif op == "lease_revoke":
                        await st.lease_revoke(msg["lease"])
                        await send({"rid": rid, "ok": True})
                    elif op == "publish":
                        n = await st.publish(msg["subject"], msg.get("payload"))
                        await send({"rid": rid, "ok": True, "delivered": n})
                    elif op == "subscribe":
                        sid, q = await st.subscribe(msg["pattern"])
                        await send({"rid": rid, "ok": True, "id": sid})
                        st_task = asyncio.create_task(pump_sub(sid, q))
                        session_subs[sid] = st_task
                        st_task.add_done_callback(
                            lambda t, sid=sid: session_subs.pop(sid, None)
                            if session_subs.get(sid) is t
                            else None
                        )
                    elif op == "unsubscribe":
                        sid = msg["id"]
                        task = session_subs.pop(sid, None)
                        if task:
                            task.cancel()
                        await st.unsubscribe(sid)
                        await send({"rid": rid, "ok": True})
                    elif op == "q_push":
                        await st.q_push(msg["queue"], msg.get("item"))
                        await send({"rid": rid, "ok": True})
                    elif op == "q_pop":
                        t = asyncio.create_task(do_pop(rid, msg["queue"]))
                        session_pop_tasks.add(t)
                        t.add_done_callback(session_pop_tasks.discard)
                    elif op == "q_ack":
                        session_unacked.discard(msg["token"])
                        await send({"rid": rid, "ok": await st.q_ack(msg["token"])})
                    elif op == "q_nack":
                        session_unacked.discard(msg["token"])
                        await send({"rid": rid, "ok": await st.q_nack(msg["token"])})
                    elif op == "q_len":
                        await send({"rid": rid, "ok": True, "len": await st.q_len(msg["queue"])})
                    elif op == "replica_attach":
                        # Warm-standby replication: hand over a consistent
                        # snapshot, then stream every durable mutation as
                        # an op-log push.  Snapshot + tap registration are
                        # one synchronous step on the loop, so no delta
                        # can fall between them.
                        oq: asyncio.Queue = asyncio.Queue()
                        tap = oq.put_nowait
                        snap = self.state.snapshot()
                        self.state.add_replication_tap(tap)
                        session_repl_taps.append(tap)
                        await send({"rid": rid, "ok": True, "snapshot": snap})
                        ot = asyncio.create_task(pump_oplog(oq))
                        session_repl_tasks.add(ot)
                        ot.add_done_callback(session_repl_tasks.discard)
                    elif op == "ping":
                        await send({"rid": rid, "ok": True})
                    else:
                        await send({"rid": rid, "ok": False, "error": f"unknown op {op}"})
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001 — protocol surface
                    await send({"rid": rid, "ok": False, "error": str(e)})
        except (ConnectionResetError, asyncio.IncompleteReadError):
            pass
        finally:
            for tap in session_repl_taps:
                self.state.remove_replication_tap(tap)
            for task in list(session_watches.values()) + list(session_subs.values()):
                task.cancel()
            for task in list(session_repl_tasks):
                task.cancel()
            for task in session_pop_tasks:
                task.cancel()
            for wid in session_watches:
                await self.state.watch_cancel(wid)
            for sid in session_subs:
                await self.state.unsubscribe(sid)
            for token in list(session_unacked):
                await self.state.q_nack(token)
            writer.close()
            self._conn_tasks.discard(conn_task)


# --------------------------------------------------------------------------
# Warm standby (shard replication)
# --------------------------------------------------------------------------


class HubStandby:
    """Warm standby for one hub shard.

    Attaches to the primary's replication stream (``replica_attach``:
    snapshot handover, then one op-log push per durable mutation) and
    maintains a live copy of the primary's ``snapshot()`` — durable KV,
    queued + in-flight work, and the lease-id floor.  On primary death,
    ``promote()`` starts a fresh ``HubServer`` (by default on the dead
    primary's address) restored from that copy: clients observe exactly a
    hub restart — reconnect, re-arm watches with resync, leases re-grant —
    and the preserved floor guarantees the promoted shard never re-issues
    a lease id a pre-failover client still keeps alive.
    """

    def __init__(self, primary_address: str):
        self.primary_address = primary_address
        self._kv: Dict[str, Any] = {}
        self._queues: Dict[str, List[Any]] = {}
        self._inflight: List[List[Any]] = []  # [queue, item] pairs
        self._lease_floor = 1
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._task: Optional[asyncio.Task] = None
        # Set when the replication stream dies (primary gone) or on close.
        self.primary_lost = asyncio.Event()
        self.ops_applied = 0

    async def start(self) -> "HubStandby":
        host, port = self.primary_address.rsplit(":", 1)
        self._reader, self._writer = await asyncio.open_connection(
            host, int(port)
        )
        self._writer.write(
            json.dumps({"rid": 1, "op": "replica_attach"}).encode() + b"\n"
        )
        await self._writer.drain()
        line = await self._reader.readline()
        if not line:
            raise ConnectionError(
                f"hub {self.primary_address} closed during replica_attach"
            )
        resp = json.loads(line)
        if not resp.get("ok"):
            raise RuntimeError(f"replica_attach refused: {resp!r}")
        self._load_snapshot(resp.get("snapshot") or {})
        self._task = asyncio.get_running_loop().create_task(self._run())
        return self

    def _load_snapshot(self, snap: Dict[str, Any]) -> None:
        self._kv = dict(snap.get("kv") or {})
        self._queues = {
            name: list(items)
            for name, items in (snap.get("queues") or {}).items()
        }
        self._inflight = [list(e) for e in (snap.get("inflight") or ())]
        try:
            self._lease_floor = int(snap.get("lease_floor", 1))
        except (TypeError, ValueError):
            self._lease_floor = 1

    async def _run(self) -> None:
        assert self._reader is not None
        try:
            while True:
                line = await self._reader.readline()
                if not line:
                    break
                msg = json.loads(line)
                if msg.get("push") == "oplog":
                    self._apply(msg.get("entry") or {})
        except asyncio.CancelledError:
            raise
        except (ConnectionResetError, OSError, json.JSONDecodeError):
            pass
        finally:
            self.primary_lost.set()

    def _apply(self, entry: Dict[str, Any]) -> None:
        op = entry.get("op")
        if op == "kv_put":
            self._kv[entry["key"]] = entry.get("value")
        elif op == "kv_delete":
            self._kv.pop(entry["key"], None)
        elif op == "lease_floor":
            try:
                self._lease_floor = max(self._lease_floor, int(entry["floor"]))
            except (KeyError, TypeError, ValueError):
                pass
        elif op == "q_add":
            if entry.get("where") == "inflight":
                self._inflight.append([entry["queue"], entry.get("item")])
            else:
                self._queues.setdefault(entry["queue"], []).append(
                    entry.get("item")
                )
        elif op == "q_take":
            items = self._queues.get(entry["queue"])
            item = entry.get("item")
            if items and item in items:
                items.remove(item)
            self._inflight.append([entry["queue"], item])
        elif op == "q_settle":
            pair = [entry["queue"], entry.get("item")]
            if pair in self._inflight:
                self._inflight.remove(pair)
        self.ops_applied += 1

    def snapshot(self) -> Dict[str, Any]:
        """The shadow state in ``HubState.snapshot()`` schema."""
        return {
            "kv": dict(self._kv),
            "queues": {
                name: list(items)
                for name, items in self._queues.items()
                if items
            },
            "inflight": [list(e) for e in self._inflight],
            "lease_floor": self._lease_floor,
        }

    async def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        if self._writer is not None:
            self._writer.close()
            self._writer = None

    async def promote(
        self,
        host: Optional[str] = None,
        port: Optional[int] = None,
        persist_path: Optional[str] = None,
        persist_interval_s: float = 2.0,
    ) -> "HubServer":
        """Take over the shard: start a HubServer restored from the shadow
        state — on the dead primary's address unless told otherwise."""
        await self.close()
        p_host, p_port = self.primary_address.rsplit(":", 1)
        server = HubServer(
            host=host or p_host,
            port=int(port if port is not None else p_port),
            persist_path=persist_path,
            persist_interval_s=persist_interval_s,
        )
        server.state.restore(self.snapshot())
        await server.start()
        return server


# --------------------------------------------------------------------------
# TCP client
# --------------------------------------------------------------------------


class _SubSession:
    """A live client-side subscription: survives reconnects (the server-side
    sid is rebound; the local queue and its consumer never change)."""

    __slots__ = ("sid", "pattern", "queue")

    def __init__(self, sid: str, pattern: str, queue: asyncio.Queue):
        self.sid = sid
        self.pattern = pattern
        self.queue = queue


class _ParkedEntry:
    """One request parked on a down hub connection, with the bookkeeping
    the park-buffer cap needs to shed oldest-idempotent-first."""

    __slots__ = ("op", "size", "idempotent", "fut")

    def __init__(self, op: str, size: int, idempotent: bool,
                 fut: asyncio.Future):
        self.op = op
        self.size = size
        self.idempotent = idempotent
        self.fut = fut


class HubClient:
    """Asyncio client for HubServer; same interface as InprocHub.

    Leases granted through this client are kept alive automatically by a
    background task (ttl/3 cadence) until ``lease_revoke``/``close`` — the
    reference's etcd lease keep-alive loop (transports/etcd/lease.rs:51).

    Session resume (hub restart survival): a lost connection enters a
    full-jitter backoff reconnect loop instead of bricking the client.
    While down, ``_request`` parks callers for up to ``request_grace_s``
    (a hub crash pauses the fleet rather than killing it); on reconnect:

    - **subscriptions** re-arm transparently — the event plane is lossy by
      contract, so the same local queue is re-bound to a fresh server-side
      subscription and consumers never notice;
    - **watches** CANNOT resume transparently (deltas were missed and the
      snapshot-then-delta contract would be silently broken), so each live
      watcher raises ``HubSessionLost`` — every consumer in the tree
      already owns a re-arm+resync recovery path for exactly this;
    - **unacked queue items** are counted as requeued (the server's
      disconnect/restart handling re-enqueues them; at-least-once holds)
      and the ack tokens dropped.
    """

    RECONNECT_BACKOFF_INITIAL = 0.05
    # Park-buffer caps: a long outage must pause the fleet, not grow client
    # memory without bound.  When either cap is hit, the OLDEST IDEMPOTENT
    # parked request is shed with a ConnectionError (idempotent callers
    # already own retry paths; queue verbs are shed only as a last resort)
    # and counted on /metrics (hub_shard_parked_shed_total).
    PARK_MAX_REQUESTS = 512
    PARK_MAX_BYTES = 4 << 20

    def __init__(
        self,
        address: str,
        reconnect: bool = True,
        reconnect_max_s: float = 2.0,
        request_grace_s: float = 10.0,
    ):
        self.address = address
        self.reconnect = reconnect
        self.reconnect_max_s = reconnect_max_s
        self.request_grace_s = request_grace_s
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._rids = itertools.count(1)
        self._pending: Dict[int, asyncio.Future] = {}
        self._watch_queues: Dict[str, asyncio.Queue] = {}
        self._sub_queues: Dict[str, asyncio.Queue] = {}
        # sid → live subscription session (pattern + queue); reconnect
        # re-arms these server-side and rebinds the NEW sid to the session.
        self._sub_sessions: Dict[str, _SubSession] = {}
        # unacked q_pop tokens held by this client (requeued on conn loss)
        self._unacked: Set[str] = set()
        # pushes that arrive before the requesting coroutine registers its
        # queue (read_loop may outrun watch_prefix/subscribe resumption)
        self._early_pushes: Dict[str, List[Any]] = {}
        # ids whose watch/subscription was closed: drop late pushes instead of
        # buffering them forever
        self._closed_push_ids: set = set()
        self._reader_task: Optional[asyncio.Task] = None
        self._reconnect_task: Optional[asyncio.Task] = None
        self._keepalive_tasks: Dict[int, asyncio.Task] = {}
        self._write_lock = asyncio.Lock()
        self._connected = asyncio.Event()
        self._connected_at = 0.0
        self._closed = False
        # Bounded park buffer: park id → entry (insertion-ordered).
        self._parked: Dict[int, _ParkedEntry] = {}
        self._park_ids = itertools.count(1)
        self._park_bytes = 0

    @property
    def connected(self) -> bool:
        return self._connected.is_set()

    async def connect(self) -> "HubClient":
        host, port = self.address.rsplit(":", 1)
        self._reader, self._writer = await asyncio.open_connection(host, int(port))
        self._reader_task = asyncio.create_task(self._read_loop())
        self._connected.set()
        self._connected_at = time.monotonic()
        return self

    async def close(self) -> None:
        self._closed = True
        # Wake requests parked on the reconnect: they re-check _closed and
        # fail fast instead of sleeping out the grace budget.
        self._connected.set()
        for t in self._keepalive_tasks.values():
            t.cancel()
        if self._reader_task:
            self._reader_task.cancel()
        if self._reconnect_task:
            self._reconnect_task.cancel()
        if self._writer:
            self._writer.close()
        for q in self._watch_queues.values():
            q.put_nowait(None)
        for q in self._sub_queues.values():
            q.put_nowait(None)

    async def _read_loop(self) -> None:
        assert self._reader is not None
        try:
            while True:
                line = await self._reader.readline()
                if not line:
                    break
                msg = json.loads(line)
                push = msg.get("push")
                if push == "watch":
                    item = WatchEvent(msg["type"], msg["key"], msg.get("value"))
                    q = self._watch_queues.get(msg["id"])
                    if q:
                        q.put_nowait(item)
                    elif msg["id"] not in self._closed_push_ids:
                        self._early_pushes.setdefault(msg["id"], []).append(item)
                elif push == "msg":
                    item = (msg["subject"], msg.get("payload"))
                    q = self._sub_queues.get(msg["id"])
                    if q:
                        q.put_nowait(item)
                    elif msg["id"] not in self._closed_push_ids:
                        self._early_pushes.setdefault(msg["id"], []).append(item)
                else:
                    fut = self._pending.pop(msg.get("rid"), None)
                    if fut and not fut.done():
                        fut.set_result(msg)
        except asyncio.CancelledError:
            pass
        except (ConnectionResetError, OSError, json.JSONDecodeError):
            pass
        finally:
            self._connected.clear()
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionError("hub connection lost"))
            self._pending.clear()
            if not self._closed:
                self._on_connection_lost()

    def _on_connection_lost(self) -> None:
        """Connection died under us: account requeues, error live watches,
        and (when enabled) start the backoff reconnect loop."""
        from ..resilience import metrics

        if self._unacked:
            # The server requeues a disconnected session's unacked items
            # (and a restarted hub restores in-flight items from its
            # snapshot) — from this client's view they are requeued work.
            metrics.hub_requeued_items_total += len(self._unacked)
            self._unacked.clear()
        # Live watches are broken by contract (missed deltas): surface
        # HubSessionLost to their consumers, who re-arm + resync.
        for wid, q in list(self._watch_queues.items()):
            self._closed_push_ids.add(wid)
            q.put_nowait(_WATCH_LOST)
        self._watch_queues.clear()
        # Drop the dead server-side sub ids from push routing; the sessions
        # themselves survive and are re-bound after reconnect.
        for sid in list(self._sub_queues):
            self._sub_queues.pop(sid, None)
        if self.reconnect:
            # A connection that died young means the hub is accepting and
            # immediately dropping (mid-restart, outage fault): start the
            # backoff ladder higher so the retry loop doesn't spin.
            uptime = time.monotonic() - self._connected_at
            initial = (
                self.RECONNECT_BACKOFF_INITIAL
                if uptime >= 1.0
                else min(0.5, self.reconnect_max_s)
            )
            self._reconnect_task = asyncio.get_running_loop().create_task(
                self._reconnect_loop(initial)
            )

    async def _reconnect_loop(self, backoff: float) -> None:
        from ..resilience import metrics

        try:
            while not self._closed:
                # Full jitter BEFORE each dial: a fleet of clients orphaned
                # by one hub crash must not re-dial in lockstep.
                await asyncio.sleep(random.uniform(0.0, backoff))
                if self._closed:
                    return
                try:
                    host, port = self.address.rsplit(":", 1)
                    self._reader, self._writer = await asyncio.open_connection(
                        host, int(port)
                    )
                    break
                except OSError:
                    backoff = min(max(backoff, 0.05) * 2, self.reconnect_max_s)
            if self._closed:
                if self._writer is not None:
                    self._writer.close()
                return
            self._reader_task = asyncio.create_task(self._read_loop())
            self._connected.set()
            self._connected_at = time.monotonic()
            metrics.hub_reconnects_total += 1
            from .shard import shard_metrics
            shard_metrics.note_reconnect(self.address)
            logger.info("hub connection to %s re-established", self.address)
            # Re-arm subscriptions onto their existing local queues: the
            # pub/sub plane is lossy by contract, so consumers keep their
            # iterators and never observe the gap.
            for old_sid, sess in list(self._sub_sessions.items()):
                self._sub_sessions.pop(old_sid, None)
                try:
                    resp = await self._request("subscribe", pattern=sess.pattern)
                except (ConnectionError, RuntimeError):
                    # Hub flapped again mid-resume: the fresh read_loop's
                    # death restarts this whole loop; re-register the
                    # session so the next pass retries it.
                    self._sub_sessions[old_sid] = sess
                    continue
                new_sid = resp["id"]
                sess.sid = new_sid
                for item in self._early_pushes.pop(new_sid, []):
                    sess.queue.put_nowait(item)
                self._sub_queues[new_sid] = sess.queue
                self._sub_sessions[new_sid] = sess
                metrics.hub_sessions_resumed_total += 1
        except asyncio.CancelledError:
            raise

    # Ops safe to replay across a reconnect: a lost response cannot make a
    # replay observable (KV puts/gets/deletes are last-write-wins; a
    # half-registered watch/sub dies with its connection; an orphaned
    # lease_grant expires unkept; publish dupes are within the lossy-plane
    # contract).  Queue verbs are EXCLUDED — q_push would duplicate work
    # items beyond the at-least-once redelivery contract, and pop/ack
    # tokens are connection-scoped.
    _IDEMPOTENT_OPS = frozenset({
        "kv_put", "kv_get", "kv_get_prefix", "kv_delete", "lease_keepalive",
        "lease_grant", "lease_revoke", "q_len", "ping", "watch",
        "watch_cancel", "subscribe", "unsubscribe", "publish",
    })

    def _shed_parked(self, incoming_size: int) -> None:
        """Enforce the park-buffer caps before parking another request:
        shed the oldest idempotent parked entry (then oldest of any kind)
        until the incoming one fits."""
        from .shard import shard_metrics

        while self._parked and (
            len(self._parked) + 1 > self.PARK_MAX_REQUESTS
            or self._park_bytes + incoming_size > self.PARK_MAX_BYTES
        ):
            victim_id = None
            for pid, entry in self._parked.items():
                if entry.idempotent:
                    victim_id = pid
                    break
            if victim_id is None:
                victim_id = next(iter(self._parked))
            entry = self._parked.pop(victim_id)
            self._park_bytes -= entry.size
            if not entry.fut.done():
                entry.fut.set_exception(ConnectionError(
                    f"parked {entry.op} shed: hub {self.address} park "
                    f"buffer over cap ({self.PARK_MAX_REQUESTS} requests / "
                    f"{self.PARK_MAX_BYTES} bytes)"
                ))
            shard_metrics.note_shed(self.address)

    async def _park(self, op: str, size: int, budget: float) -> None:
        """Park one request until the reconnect loop restores the
        connection.  Raises ConnectionError if the park-buffer cap sheds
        this entry, TimeoutError when the budget runs out first."""
        from .shard import shard_metrics

        self._shed_parked(size)
        pid = next(self._park_ids)
        entry = _ParkedEntry(
            op=op,
            size=size,
            idempotent=op in self._IDEMPOTENT_OPS,
            fut=asyncio.get_running_loop().create_future(),
        )
        self._parked[pid] = entry
        self._park_bytes += size
        shard_metrics.note_parked(self.address)
        wait_task = asyncio.ensure_future(self._connected.wait())
        try:
            done, _ = await asyncio.wait(
                {wait_task, entry.fut},
                timeout=budget,
                return_when=asyncio.FIRST_COMPLETED,
            )
            if entry.fut in done:
                entry.fut.result()  # raises the shed ConnectionError
            if not done:
                raise asyncio.TimeoutError
        finally:
            wait_task.cancel()
            if not entry.fut.done():
                entry.fut.cancel()
            if self._parked.pop(pid, None) is not None:
                self._park_bytes -= entry.size

    async def _request(self, op: str, **kw) -> Dict[str, Any]:
        from .shard import shard_metrics

        retryable = self.reconnect and op in self._IDEMPOTENT_OPS
        deadline = time.monotonic() + self.request_grace_s
        last_exc: Optional[BaseException] = None
        first = True
        park_size = -1  # serialized lazily, only if this request parks
        replaying = False
        while first or (retryable and time.monotonic() < deadline):
            first = False
            if self._closed:
                raise ConnectionError("hub client closed")
            if self._writer is None:
                raise ConnectionError("not connected")
            if not self._connected.is_set():
                if not self.reconnect:
                    # No reconnect loop will ever set the event again —
                    # parking would just sleep out the grace for nothing.
                    raise ConnectionError("hub connection lost")
                # Hub down, reconnect in progress: park the caller so a hub
                # restart pauses traffic instead of failing it — within the
                # bounded park buffer.
                budget = deadline - time.monotonic()
                if budget <= 0:
                    break
                if park_size < 0:
                    park_size = len(json.dumps({"op": op, **kw}, default=str))
                try:
                    await self._park(op, park_size, budget)
                except asyncio.TimeoutError:
                    break
            if replaying:
                shard_metrics.note_replayed(self.address)
                replaying = False
            rid = next(self._rids)
            fut: asyncio.Future = asyncio.get_running_loop().create_future()
            self._pending[rid] = fut
            payload = {"rid": rid, "op": op, **kw}
            try:
                async with self._write_lock:
                    self._writer.write(json.dumps(payload).encode() + b"\n")
                    await self._writer.drain()
                msg = await fut
            except (ConnectionError, ConnectionResetError, BrokenPipeError,
                    OSError) as e:
                # Connection died under this request: idempotent ops keep
                # replaying until the grace budget runs out (a flapping hub
                # accepts and drops several times mid-restart); the rest
                # surface immediately.
                self._pending.pop(rid, None)
                last_exc = e
                if retryable:
                    replaying = True
                    await asyncio.sleep(random.uniform(0.02, 0.1))
                continue
            if not msg.get("ok") and op not in (
                "lease_keepalive", "q_ack", "q_nack"
            ):
                raise RuntimeError(msg.get("error", f"{op} failed"))
            return msg
        if isinstance(last_exc, ConnectionError):
            raise last_exc
        if last_exc is not None:
            raise ConnectionError(f"hub request failed: {last_exc}") from last_exc
        raise ConnectionError(
            f"hub {self.address} unreachable "
            f"(reconnect pending > {self.request_grace_s:g}s)"
        )

    # KV
    async def kv_put(self, key, value, lease_id=None):
        await self._request("kv_put", key=key, value=value, lease=lease_id)

    async def kv_get(self, key):
        return (await self._request("kv_get", key=key)).get("value")

    async def kv_get_prefix(self, prefix):
        return (await self._request("kv_get_prefix", prefix=prefix)).get("kvs", {})

    async def kv_delete(self, key):
        return (await self._request("kv_delete", key=key)).get("deleted", False)

    async def watch_prefix(self, prefix) -> Watcher:
        resp = await self._request("watch", prefix=prefix)
        wid = resp["id"]
        q: asyncio.Queue = asyncio.Queue()
        for item in self._early_pushes.pop(wid, []):
            q.put_nowait(item)
        self._watch_queues[wid] = q

        async def cancel():
            self._watch_queues.pop(wid, None)
            self._early_pushes.pop(wid, None)
            self._closed_push_ids.add(wid)
            if not self._closed:
                try:
                    await self._request("watch_cancel", id=wid)
                except (ConnectionError, RuntimeError):
                    pass
            q.put_nowait(None)

        return Watcher(q, cancel)

    # leases
    async def lease_grant(self, ttl: float = 10.0) -> int:
        lid = (await self._request("lease_grant", ttl=ttl))["lease"]
        self._keepalive_tasks[lid] = asyncio.create_task(self._keepalive_loop(lid, ttl))
        return lid

    async def _keepalive_loop(self, lease_id: int, ttl: float) -> None:
        try:
            while True:
                await asyncio.sleep(max(ttl / 3.0, 0.05))
                try:
                    ok = (
                        await self._request("lease_keepalive", lease=lease_id)
                    ).get("ok")
                except ConnectionError:
                    # Hub down/reconnecting: keep trying — a SHORT outage
                    # (connection blip, not a restart) leaves the lease
                    # alive server-side, and abandoning it here would
                    # deregister a perfectly healthy worker.
                    continue
                if not ok:
                    return  # lease truly gone; the owner re-grants
        except asyncio.CancelledError:
            pass

    async def lease_keepalive(self, lease_id: int) -> bool:
        return (await self._request("lease_keepalive", lease=lease_id)).get("ok", False)

    async def lease_revoke(self, lease_id: int) -> None:
        task = self._keepalive_tasks.pop(lease_id, None)
        if task:
            task.cancel()
        await self._request("lease_revoke", lease=lease_id)

    # pub/sub
    async def publish(self, subject, payload) -> None:
        from .shard import shard_metrics

        shard_metrics.note_publish(self.address, _payload_nbytes(payload))
        await self._request("publish", subject=subject, payload=payload)

    async def subscribe(self, pattern) -> Subscription:
        resp = await self._request("subscribe", pattern=pattern)
        sess = _SubSession(resp["id"], pattern, asyncio.Queue())
        for item in self._early_pushes.pop(sess.sid, []):
            sess.queue.put_nowait(item)
        self._sub_queues[sess.sid] = sess.queue
        self._sub_sessions[sess.sid] = sess

        async def cancel():
            # The session's sid moves on reconnect: always read it live.
            sid = sess.sid
            self._sub_queues.pop(sid, None)
            self._sub_sessions.pop(sid, None)
            self._early_pushes.pop(sid, None)
            self._closed_push_ids.add(sid)
            if not self._closed:
                try:
                    await self._request("unsubscribe", id=sid)
                except (ConnectionError, RuntimeError):
                    pass
            sess.queue.put_nowait(None)

        return Subscription(sess.queue, cancel)

    # queues
    async def q_push(self, queue, item) -> None:
        await self._request("q_push", queue=queue, item=item)

    async def q_pop(self, queue) -> Tuple[Any, str]:
        resp = await self._request("q_pop", queue=queue)
        self._unacked.add(resp["token"])
        return resp["item"], resp["token"]

    async def q_ack(self, token) -> bool:
        self._unacked.discard(token)
        return (await self._request("q_ack", token=token)).get("ok", False)

    async def q_nack(self, token) -> bool:
        self._unacked.discard(token)
        return (await self._request("q_nack", token=token)).get("ok", False)

    async def q_len(self, queue) -> int:
        return (await self._request("q_len", queue=queue))["len"]

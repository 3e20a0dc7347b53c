"""TCP service plane: serve AsyncEngines remotely, call them as AsyncEngines.

A copy of the JAX package's ``runtime/transports/service.py``.

Reference semantics: the request plane (NATS request → endpoint subject,
pipeline/network/egress/push.rs:88-158) + response plane (direct TCP callback
with prologue handshake and streamed frames, tcp/{server,client}.rs).  Here
both planes collapse onto MULTIPLEXED direct TCP connections: each client
process keeps ONE connection per worker address, and every request is a
stream id on it — header+data frames up, prologue+items down, CANCEL/KILL
up mid-stream.  (The reference gets multiplexing from NATS subjects +
registered response streams; a connection per request measured as pure
setup churn at high concurrency.)

Cancellation: CANCEL/KILL frames give remote ``stop_generating``/``kill``
the same semantics as in-process; a client disconnect cancels every stream
it owned (push_handler.rs:100-116 behaviour).
"""

from __future__ import annotations

import asyncio
import itertools
import logging
from typing import Any, AsyncIterator, Dict, Optional, Tuple

from ..engine import AsyncEngine, AsyncEngineContext, Context, ResponseStream
from ..faultinject import faults
from ..resilience import Deadline
from .codec import Frame, FrameType, read_frame, write_frame

logger = logging.getLogger(__name__)

_DONE = object()


class RemoteEngineError(RuntimeError):
    """Error raised by the remote engine (propagated through RESP_ERROR).

    ``retryable`` distinguishes transport/worker failures (connection refused,
    connection closed before the stream finished, injected worker faults) from
    application errors the engine raised for THIS request (bad sampling
    params, oversized prompt) — the Client's failover loop only ever retries
    the former; replaying a deterministic request error across every worker
    would just multiply the damage.

    ``kind`` echoes the server prologue's error kind ("request" /
    "internal" / an application tag like "model_not_found") so edges can
    map specific remote failures to specific HTTP statuses without parsing
    message text.
    """

    def __init__(
        self, message: str, retryable: bool = True, kind: Optional[str] = None
    ):
        super().__init__(message)
        self.retryable = retryable
        self.kind = kind


# Built-in liveness/readiness path every ServiceServer answers without
# registration (runtime/health.py probes it over the SAME transport real
# requests ride; no extra port or protocol).
HEALTH_ENDPOINT = "__health__"


class ServiceServer:
    """Hosts AsyncEngines at string paths over TCP (multiplexed streams)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self._endpoints: Dict[str, AsyncEngine] = {}
        self._server: Optional[asyncio.base_events.Server] = None
        self._conn_tasks: set = set()
        self._conn_writers: set = set()
        self.crashed = False
        # Optional harness hook fired by the ``worker_crash`` fault point:
        # the owning process finishes the death (revoke lease, close
        # runtime) the way a real SIGKILL would.
        self.on_crash = None
        self._crash_task: Optional[asyncio.Task] = None

    def register(self, path: str, engine: AsyncEngine) -> None:
        self._endpoints[path] = engine

    def unregister(self, path: str) -> None:
        self._endpoints.pop(path, None)

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    async def start(self) -> "ServiceServer":
        if self._server is None:
            server = await asyncio.start_server(self._handle, self.host, self.port)
            if self._server is not None:
                # Lost a concurrent-start race while awaiting the bind
                # the first starter owns the address;
                # close the duplicate listener instead of leaking it.
                server.close()
            else:
                self._server = server
                self.port = server.sockets[0].getsockname()[1]
        return self

    def crash(self) -> None:
        """Simulate sudden worker death (the ``worker_crash`` fault point):
        stop accepting, hard-abort every live connection (clients see a
        reset, exactly like a SIGKILL'd process), and fire ``on_crash`` so
        the owner can finish the job (lease revoke etc.)."""
        if self.crashed:
            return
        self.crashed = True
        if self._server is not None:
            self._server.close()
        for writer in list(self._conn_writers):
            try:
                writer.transport.abort()
            except Exception:  # noqa: BLE001 — already-dead transport
                pass
        if self.on_crash is not None:
            res = self.on_crash()
            if asyncio.iscoroutine(res):
                self._crash_task = asyncio.get_running_loop().create_task(res)

    async def close(self) -> None:
        if (
            self._crash_task is not None
            and self._crash_task is not asyncio.current_task()
        ):
            # (An on_crash hook that itself closes the runtime reaches here
            # FROM the crash task — awaiting yourself deadlocks.)
            try:
                await self._crash_task
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — harness hook best-effort
                logger.exception("on_crash hook failed")
            self._crash_task = None
        if self._server is not None:
            self._server.close()
            # Long-lived multiplexed connections never end on their own —
            # cancel the per-connection handlers BEFORE wait_closed() (which
            # waits for them since 3.12).
            for task in list(self._conn_tasks):
                task.cancel()
            await self._server.wait_closed()
            self._server = None

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        conn_task = asyncio.current_task()
        self._conn_tasks.add(conn_task)
        self._conn_writers.add(writer)
        wlock = asyncio.Lock()
        headers: Dict[int, Dict[str, Any]] = {}  # sid → REQ_HEADER awaiting data
        streams: Dict[int, Tuple[AsyncEngineContext, asyncio.Task]] = {}
        # Every spawned serve_stream keeps a strong ref here until done —
        # `streams` only covers tasks past their first registration line, so
        # a task cancelled (or GC'd) before its first step would otherwise
        # leak out of the finally-block sweep below.
        stream_tasks: set = set()

        async def send(ftype: FrameType, obj: Any = None, sid: int = 0) -> None:
            async with wlock:
                await write_frame(writer, ftype, obj, stream=sid)

        async def serve_stream(sid: int, header: Dict[str, Any], data: Any):
            endpoint_name = header.get("endpoint", "")
            ctx = AsyncEngineContext(header.get("id"))
            # Deadline propagation: the caller sends its REMAINING budget;
            # restart the clock here so queue/transit time already spent is
            # charged to the request (the edge decremented before sending).
            budget = header.get("deadline_s")
            if budget is not None:
                ctx.deadline = Deadline.after(float(budget))
            # Trace propagation (runtime/tracing.py): the caller ships its
            # TraceContext in the request header (omit-when-absent, like
            # deadline_s) so non-PreprocessedRequest payloads — KV exports,
            # control calls — join the request's trace too.
            tr = header.get("trace")
            if tr is not None:
                from ..tracing import parse_trace

                ctx.trace = parse_trace(tr)
            streams[sid] = (ctx, asyncio.current_task())
            try:
                if faults.enabled:
                    if faults.should("worker_crash", self.address):
                        self.crash()  # aborts this transport too
                        return
                    delay = faults.delay_for("delay", endpoint_name)
                    if delay > 0:
                        await asyncio.sleep(delay)
                    if faults.should("error_prologue", endpoint_name):
                        await send(
                            FrameType.RESP_PROLOGUE,
                            {"ok": False, "error": "[fault] injected prologue error",
                             "kind": "internal"},
                            sid,
                        )
                        return
                if endpoint_name == HEALTH_ENDPOINT:
                    # Liveness+readiness without registration: answering at
                    # all proves the transport; the endpoint count is the
                    # readiness signal (runtime/health.probe_address).
                    await send(FrameType.RESP_PROLOGUE, {"ok": True}, sid)
                    await send(
                        FrameType.RESP_ITEM,
                        {"ok": True, "endpoints": len(self._endpoints)},
                        sid,
                    )
                    await send(FrameType.RESP_COMPLETE, None, sid)
                    return
                engine = self._endpoints.get(endpoint_name)
                if engine is None:
                    await send(
                        FrameType.RESP_PROLOGUE,
                        {"ok": False,
                         "error": f"no such endpoint: {header.get('endpoint')}",
                         "kind": "endpoint"},
                        sid,
                    )
                    return
                try:
                    stream = await engine.generate(Context(data, ctx))
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001 — remote boundary
                    # Request-shape errors are the caller's fault — tag them
                    # non-retryable so failover doesn't replay them.  An
                    # exception carrying its own ``error_kind`` (e.g.
                    # ModelNotFoundError → "model_not_found") ships that tag
                    # verbatim so the HTTP edge can map it to a status.
                    kind = getattr(e, "error_kind", None) or (
                        "request"
                        if isinstance(e, (ValueError, TypeError, KeyError))
                        else "internal"
                    )
                    await send(
                        FrameType.RESP_PROLOGUE,
                        {"ok": False, "error": str(e), "kind": kind},
                        sid,
                    )
                    return
                await send(FrameType.RESP_PROLOGUE, {"ok": True}, sid)
                try:
                    async for item in stream:
                        if faults.enabled:
                            # Straggler simulation: stretch THIS worker's
                            # inter-token latency (watchdog outlier bait).
                            stall = faults.delay_for(
                                "slow_stream", self.address
                            )
                            if stall > 0:
                                await asyncio.sleep(stall)
                        await send(FrameType.RESP_ITEM, item, sid)
                        if faults.enabled and faults.should(
                            "drop_mid_stream", endpoint_name
                        ):
                            # Simulate the worker dying mid-stream: hard-abort
                            # the transport (no RESP_ERROR courtesy).
                            ctx.stop_generating()
                            writer.transport.abort()
                            return
                    await send(FrameType.RESP_COMPLETE, None, sid)
                except (ConnectionResetError, BrokenPipeError):
                    ctx.stop_generating()
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001 — stream error to client
                    try:
                        await send(FrameType.RESP_ERROR, {"error": str(e)}, sid)
                    except (ConnectionResetError, BrokenPipeError):
                        pass
            except asyncio.CancelledError:
                ctx.stop_generating()
                raise
            finally:
                streams.pop(sid, None)

        try:
            while True:
                frame = await read_frame(reader)
                sid = frame.stream
                if frame.type == FrameType.REQ_HEADER:
                    headers[sid] = frame.unpack()
                elif frame.type == FrameType.REQ_DATA:
                    header = headers.pop(sid, None)
                    if header is None:
                        continue  # protocol slip; drop
                    t = asyncio.create_task(
                        serve_stream(sid, header, frame.unpack())
                    )
                    stream_tasks.add(t)
                    t.add_done_callback(stream_tasks.discard)
                elif frame.type == FrameType.CANCEL:
                    if sid in streams:
                        streams[sid][0].stop_generating()
                elif frame.type == FrameType.KILL:
                    if sid in streams:
                        streams[sid][0].kill()
                # HEARTBEAT and unknown types: ignore
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass  # client went away: cancel everything it owned below
        finally:
            for ctx, task in list(streams.values()):
                ctx.stop_generating()
                task.cancel()
            # Catch stragglers not yet registered in `streams` too — after
            # close() the connection must own zero live tasks.
            for task in list(stream_tasks):
                task.cancel()
            writer.close()
            self._conn_writers.discard(writer)
            self._conn_tasks.discard(conn_task)


class MuxConnection:
    """One shared client connection per worker address; streams by id.

    ``get()`` returns the live connection for an address (dialing if
    needed); a broken connection errors all of its in-flight streams and the
    next ``get()`` dials fresh.
    """

    _by_address: Dict[str, "MuxConnection"] = {}
    _dial_locks: Dict[Tuple[int, str], asyncio.Lock] = {}
    # Per-stream receive buffer bound: items are small (one token chunk),
    # so this caps a stalled consumer's memory without blocking the shared
    # read loop (head-of-line).  Overflow terminates only that stream.
    STREAM_QUEUE_MAX = 8192

    def __init__(self, address: str):
        self.address = address
        self._loop = asyncio.get_running_loop()
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._wlock = asyncio.Lock()
        self._queues: Dict[int, asyncio.Queue] = {}
        self._sid = itertools.count(1)
        self._reader_task: Optional[asyncio.Task] = None
        self.closed = False

    @classmethod
    async def get(cls, address: str) -> "MuxConnection":
        # Serialize dialing per (loop, address) so two concurrent first
        # requests can't race into two connections (one would leak).
        lock_key = (id(asyncio.get_running_loop()), address)
        lock = cls._dial_locks.setdefault(lock_key, asyncio.Lock())
        async with lock:
            conn = cls._by_address.get(address)
            # A cached connection is only usable from the loop that created
            # it (its transport and reader task are loop-bound); a different
            # running loop means the old one is gone — dial fresh.
            if (
                conn is not None
                and conn._loop is not asyncio.get_running_loop()
            ):
                conn._close_transport()  # best effort on a dead loop
                conn = None
            if conn is None or conn.closed:
                conn = cls(address)
                await conn._connect()
                cls._by_address[address] = conn
            return conn

    async def _connect(self) -> None:
        if faults.enabled and faults.should("connect_error", self.address):
            self.closed = True
            raise ConnectionRefusedError(
                f"[fault] connect to {self.address} refused"
            )
        host, port = self.address.rsplit(":", 1)
        self._reader, self._writer = await asyncio.open_connection(host, int(port))
        self._reader_task = asyncio.create_task(self._read_loop())

    def _close_transport(self) -> None:
        self.closed = True
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:
                pass

    async def _read_loop(self) -> None:
        try:
            while True:
                frame = await read_frame(self._reader)
                queue = self._queues.get(frame.stream)
                if queue is None:
                    continue
                if queue.qsize() >= self.STREAM_QUEUE_MAX:
                    # Stalled consumer: kill this stream, not the connection.
                    queue.put_nowait(_DONE)
                    self._queues.pop(frame.stream, None)
                    continue
                queue.put_nowait(frame)
        except (asyncio.IncompleteReadError, ConnectionResetError, OSError):
            pass
        finally:
            self._close_transport()
            for q in self._queues.values():
                q.put_nowait(_DONE)

    async def open_stream(self, header: Dict[str, Any], data: Any) -> Tuple[int, asyncio.Queue]:
        sid = next(self._sid)
        queue: asyncio.Queue = asyncio.Queue()
        self._queues[sid] = queue
        try:
            async with self._wlock:
                await write_frame(self._writer, FrameType.REQ_HEADER, header, stream=sid)
                await write_frame(self._writer, FrameType.REQ_DATA, data, stream=sid)
        except (ConnectionResetError, BrokenPipeError, OSError) as e:
            self._close_transport()
            self._queues.pop(sid, None)
            raise RemoteEngineError(f"connection to {self.address} failed: {e}")
        return sid, queue

    async def send(self, ftype: FrameType, sid: int) -> None:
        if self.closed:
            return
        try:
            async with self._wlock:
                await write_frame(self._writer, ftype, None, stream=sid)
        except (ConnectionResetError, BrokenPipeError, OSError):
            self._close_transport()

    def release(self, sid: int) -> None:
        self._queues.pop(sid, None)


class RemoteEngine(AsyncEngine):
    """AsyncEngine proxy for an endpoint served by a remote ServiceServer."""

    def __init__(self, address: str, endpoint: str):
        self.address = address
        self.endpoint = endpoint

    async def generate(self, request: Context) -> ResponseStream:
        conn = await MuxConnection.get(self.address)
        header = {"id": request.id, "endpoint": self.endpoint}
        deadline = getattr(request.ctx, "deadline", None)
        if deadline is not None:
            # Ship the REMAINING budget; the server restarts its own clock.
            header["deadline_s"] = max(deadline.remaining(), 0.0)
        trace = getattr(request.ctx, "trace", None)
        if trace is not None and trace.sampled:
            # Omitted when absent: untraced requests (and pre-tracing
            # consumers) keep the established header shape.
            header["trace"] = trace.to_dict()
        sid, queue = await conn.open_stream(header, request.data)
        try:
            first = await queue.get()
            if first is _DONE:
                raise RemoteEngineError("remote connection closed")
            prologue = first.unpack()
            if not prologue.get("ok"):
                raise RemoteEngineError(
                    prologue.get("error", "remote engine error"),
                    # Application errors (bad request shape, unknown
                    # model/adapter) must not be replayed on other workers;
                    # transport/worker sickness may.
                    retryable=prologue.get("kind") in (None, "internal", "endpoint"),
                    kind=prologue.get("kind"),
                )
        except BaseException:
            conn.release(sid)
            raise

        ctx = request.ctx

        async def forward_cancel():
            try:
                await ctx.stopped()
                await conn.send(
                    FrameType.KILL if ctx.is_killed else FrameType.CANCEL, sid
                )
            except asyncio.CancelledError:
                # aclose() cancels this helper when the stream ends; ending
                # as a cancelled task (nobody awaits the result) is clean.
                raise

        cancel_task = asyncio.create_task(forward_cancel())
        return ResponseStream(
            _RemoteStreamIter(conn, sid, queue, cancel_task), ctx
        )


class _RemoteStreamIter:
    """Response-frame iterator whose aclose() always releases the stream.

    aclose() before completion also tells the worker to stop (CANCEL) —
    with a shared connection there is no socket close to signal abandonment.
    """

    def __init__(
        self,
        conn: MuxConnection,
        sid: int,
        queue: asyncio.Queue,
        cancel_task: asyncio.Task,
    ):
        self._conn = conn
        self._sid = sid
        self._queue = queue
        self._cancel_task = cancel_task
        self._done = False

    def __aiter__(self):
        return self

    async def __anext__(self):
        if self._done:
            raise StopAsyncIteration
        try:
            while True:
                frame = await self._queue.get()
                if frame is _DONE:
                    await self.aclose(notify=False)
                    raise RemoteEngineError("remote connection closed mid-stream")
                if frame.type == FrameType.RESP_ITEM:
                    return frame.unpack()
                if frame.type == FrameType.RESP_COMPLETE:
                    await self.aclose(notify=False)
                    raise StopAsyncIteration
                if frame.type == FrameType.RESP_ERROR:
                    err = frame.unpack().get("error", "remote error")
                    await self.aclose(notify=False)
                    # The engine raised for this request — not worker health.
                    raise RemoteEngineError(err, retryable=False)
                # ignore heartbeats/unknown frame types
        except BaseException:
            await self.aclose()
            raise

    async def aclose(self, notify: bool = True) -> None:
        if self._done:
            return
        self._done = True
        self._cancel_task.cancel()
        if notify:
            # Abandoned before completion: stop the remote generation.
            await self._conn.send(FrameType.CANCEL, self._sid)
        self._conn.release(self._sid)

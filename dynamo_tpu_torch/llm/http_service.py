"""OpenAI-compatible HTTP frontend on the standard library's asyncio streams.

Port of the JAX package's ``llm/http_service.py`` (which runs on aiohttp).
Reference semantics: lib/llm/src/http/service/{service_v2,openai}.rs —
routes ``/v1/chat/completions``, ``/v1/completions``, ``/v1/models``,
``/metrics``, ``/health``, ``/live``; every downstream engine streams,
``stream=false`` responses are aggregated at the edge (aggregator.rs); a
client disconnect mid-request calls ``stop_generating`` and records status
``client_drop``; Prometheus metrics via ``InflightGuard`` (metrics.rs:319).

The server speaks HTTP/1.1 (only): a request line, headers and a
``Content-Length`` body; connections are kept alive unless the client asks
otherwise; streamed responses are ``text/event-stream`` sent with chunked
transfer encoding.  Statuses and
error bodies are the JAX edge's.  Not ported yet: admission control,
deadlines, QoS, tracing (``/traces``) and hub health (ROADMAP queue 1).

The ``ModelManager`` maps model name → chat/completion pipelines
(http/service.rs:59-120).
"""

from __future__ import annotations

import asyncio
import functools
import json
import logging
import time
import uuid
from http import HTTPStatus
from typing import Any, Dict, Optional, Set

from ..labels import bounded_label
from ..runtime.engine import AsyncEngine, Context
from .metrics import Metrics, Status, engine_dispatch_metrics, spec_metrics
from .openai import SSE_DONE, aggregate_chunks, sse_encode
from .protocols import ModelNotFoundError

logger = logging.getLogger(__name__)

MAX_BODY_BYTES = 16 << 20
MAX_HEAD_BYTES = 64 << 10  # request line + headers


class ModelManager:
    """Model name → engine registry (chat + completion separately)."""

    def __init__(self):
        self._chat: Dict[str, AsyncEngine] = {}
        self._completion: Dict[str, AsyncEngine] = {}

    def add_chat_model(self, name: str, engine: AsyncEngine) -> None:
        self._chat[name] = engine

    def add_completion_model(self, name: str, engine: AsyncEngine) -> None:
        self._completion[name] = engine

    def chat_engine(self, name: str) -> Optional[AsyncEngine]:
        return self._chat.get(name)

    def completion_engine(self, name: str) -> Optional[AsyncEngine]:
        return self._completion.get(name)

    def model_names(self) -> list:
        return sorted(set(self._chat) | set(self._completion))


# -- HTTP/1.1 on asyncio streams -------------------------------------------------


class _BadRequest(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class _Request:
    __slots__ = ("method", "path", "headers", "body")

    def __init__(self, method, path, headers, body):
        self.method = method
        self.path = path
        self.headers: Dict[str, str] = headers  # lower-cased names
        self.body: bytes = body

    @property
    def keep_alive(self) -> bool:
        return self.headers.get("connection", "").lower() != "close"


class _Response:
    __slots__ = ("status", "body", "content_type", "headers")

    def __init__(self, status: int, body: bytes, content_type: str, headers=None):
        self.status = status
        self.body = body
        self.content_type = content_type
        self.headers: Dict[str, str] = headers or {}


def _json_response(obj: Any, status: int = 200, headers=None) -> _Response:
    return _Response(status, json.dumps(obj).encode(), "application/json; charset=utf-8", headers)


def _text_response(status: int, text: str, headers=None) -> _Response:
    return _Response(status, text.encode(), "text/plain; charset=utf-8", headers)


def _head(status: int, headers: Dict[str, str]) -> bytes:
    lines = [f"HTTP/1.1 {status} {HTTPStatus(status).phrase}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class _Connection:
    """One client connection: a read buffer over the stream reader (so the
    peer can be watched for EOF while a response runs, keeping anything it
    sends), and the response writers."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self._reader = reader
        self._writer = writer
        self._buf = bytearray()
        self._eof = False
        self.broken = False  # a write failed or the peer left: do not reuse

    async def _fill(self) -> bool:
        if self._eof:
            return False
        try:
            data = await self._reader.read(65536)
        except (ConnectionError, OSError):
            data = b""
        if not data:
            self._eof = True
            return False
        self._buf += data
        return True

    async def _line(self, limit: int) -> Optional[str]:
        while True:
            i = self._buf.find(b"\n")
            if i >= 0:
                line = bytes(self._buf[:i]).rstrip(b"\r")
                del self._buf[: i + 1]
                if b"\r" in line:
                    raise _BadRequest(400, "bare CR in request head")
                return line.decode("latin-1")
            if len(self._buf) > limit:
                raise _BadRequest(431, "request head too large")
            if not await self._fill():
                return None

    async def read_request(self) -> Optional[_Request]:
        """The next request, or None when the peer closed between requests."""
        line = await self._line(MAX_HEAD_BYTES)
        while line == "":  # stray CRLF between requests (RFC 9112 §2.2)
            line = await self._line(MAX_HEAD_BYTES)
        if line is None:
            return None
        parts = line.split(" ")
        if len(parts) != 3 or not parts[2].startswith("HTTP/"):
            raise _BadRequest(400, "malformed request line")
        method, target, version = parts
        if version != "HTTP/1.1":
            raise _BadRequest(505, "only HTTP/1.1 is served")
        headers: Dict[str, str] = {}
        size = len(line)
        while True:
            h = await self._line(MAX_HEAD_BYTES)
            if h is None:
                raise ConnectionError("connection closed inside the request head")
            if h == "":
                break
            size += len(h)
            if size > MAX_HEAD_BYTES:
                raise _BadRequest(431, "request head too large")
            name, sep, value = h.partition(":")
            if not sep or not name.strip():
                raise _BadRequest(400, "malformed header line")
            headers[name.strip().lower()] = value.strip()
        if "chunked" in headers.get("transfer-encoding", "").lower():
            raise _BadRequest(501, "chunked request bodies are not supported; send Content-Length")
        try:
            n = int(headers.get("content-length", "0"))
        except ValueError:
            raise _BadRequest(400, "malformed Content-Length") from None
        if n < 0:
            raise _BadRequest(400, "malformed Content-Length")
        if n > MAX_BODY_BYTES:
            raise _BadRequest(413, f"request body over {MAX_BODY_BYTES} bytes")
        while len(self._buf) < n:
            if not await self._fill():
                raise ConnectionError("connection closed inside the request body")
        body = bytes(self._buf[:n])
        del self._buf[:n]
        return _Request(method, target.partition("?")[0], headers, body)

    async def wait_peer_eof(self) -> None:
        """Return once the peer has closed its side (or sent more than a
        body's worth while a response runs, which drops it the same way)."""
        while len(self._buf) <= MAX_BODY_BYTES and await self._fill():
            pass

    async def _write(self, data: bytes) -> None:
        try:
            self._writer.write(data)
            await self._writer.drain()
        except (ConnectionError, OSError):
            self.broken = True
            raise ConnectionResetError("client connection lost") from None

    async def send(self, resp: _Response, keep_alive: bool) -> None:
        headers = {
            "Content-Type": resp.content_type,
            "Content-Length": str(len(resp.body)),
            **resp.headers,
        }
        if not keep_alive:
            headers["Connection"] = "close"
        await self._write(_head(resp.status, headers) + resp.body)

    async def start_stream(self, headers: Dict[str, str], keep_alive: bool) -> None:
        """Send a 200 head for a body sent in chunks."""
        headers = dict(headers, **{"Transfer-Encoding": "chunked",
                                   "Connection": "keep-alive" if keep_alive else "close"})
        await self._write(_head(200, headers))

    async def write_chunk(self, data: bytes) -> None:
        await self._write(b"%x\r\n%b\r\n" % (len(data), data))

    async def end_stream(self) -> None:
        await self._write(b"0\r\n\r\n")


class HttpService:
    """The OpenAI ingress service."""

    def __init__(
        self,
        host: str = "0.0.0.0",
        port: int = 8000,
        metrics_prefix: str = "dynamo_tpu",
        model_manager: Optional[ModelManager] = None,
    ):
        self.host = host
        self.port = port
        self.models = model_manager or ModelManager()
        self.metrics = Metrics(metrics_prefix)
        self._metrics_prefix = metrics_prefix
        self._server: Optional[asyncio.AbstractServer] = None
        self._connections: Set[asyncio.Task] = set()
        # path → (method, handler(conn, req) -> response, or None when the
        # handler wrote its own or the client left)
        self._routes = {
            "/v1/chat/completions": ("POST", functools.partial(self._watched_openai, chat=True)),
            "/v1/completions": ("POST", functools.partial(self._watched_openai, chat=False)),
            "/v1/models": ("GET", self._list_models),
            "/metrics": ("GET", self._metrics),
            "/health": ("GET", self._health),
            "/live": ("GET", self._health),
        }

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> "HttpService":
        self._server = await asyncio.start_server(self._on_connection, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]  # resolve port 0
        logger.info("HTTP service listening on %s:%s", self.host, self.port)
        return self

    async def close(self) -> None:
        if self._server is None:
            return
        self._server.close()
        conns = list(self._connections)
        for t in conns:
            t.cancel()
        await asyncio.gather(*conns, return_exceptions=True)
        await self._server.wait_closed()
        self._server = None

    async def run(self, shutdown: Optional[asyncio.Event] = None) -> None:
        await self.start()
        try:
            if shutdown is None:
                await asyncio.Event().wait()
            else:
                await shutdown.wait()
        finally:
            await self.close()

    # -- connections ----------------------------------------------------------

    async def _on_connection(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._connections.add(task)
        conn = _Connection(reader, writer)
        try:
            while True:
                try:
                    req = await conn.read_request()
                except _BadRequest as e:
                    await conn.send(_error_response(e.status, e.message), keep_alive=False)
                    break
                if req is None:
                    break
                await self._serve(conn, req)
                if conn.broken or not req.keep_alive:
                    break
        except (ConnectionError, OSError):
            pass  # the peer went away
        except Exception:  # noqa: BLE001 — connection boundary
            logger.exception("HTTP connection handler failed")
        finally:
            self._connections.discard(task)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _serve(self, conn: _Connection, req: _Request) -> None:
        route = self._routes.get(req.path)
        if route is None:
            resp = _text_response(404, "404: Not Found")
        elif req.method != route[0]:
            resp = _text_response(405, "405: Method Not Allowed", {"Allow": route[0]})
        else:
            resp = await route[1](conn, req)
        if resp is not None:
            await conn.send(resp, req.keep_alive)

    async def _watched_openai(self, conn: _Connection, req: _Request, chat: bool) -> Optional[_Response]:
        """Run a completions request while watching the peer: a client that
        closes its connection cancels the handler, which stops generation
        and records ``client_drop`` (aiohttp cancels the JAX edge's handler
        the same way)."""
        work = asyncio.ensure_future(self._handle_openai(conn, req, chat))
        peer = asyncio.ensure_future(conn.wait_peer_eof())
        try:
            await asyncio.wait({work, peer}, return_when=asyncio.FIRST_COMPLETED)
        finally:
            if not work.done():  # the client left first (or this task was cancelled)
                conn.broken = True
                work.cancel()
                await asyncio.wait({work})
            peer.cancel()
            await asyncio.wait({peer})
        if work.cancelled():
            return None
        return work.result()

    # -- handlers -----------------------------------------------------------

    async def _health(self, conn: _Connection, req: _Request) -> _Response:
        return _json_response({"status": "ok", "models": self.models.model_names()})

    async def _metrics(self, conn: _Connection, req: _Request) -> _Response:
        body = (
            self.metrics.render()
            + spec_metrics.render(self._metrics_prefix).encode()
            + engine_dispatch_metrics.render(self._metrics_prefix).encode()
        )
        return _Response(200, body, "text/plain; version=0.0.4; charset=utf-8")

    async def _list_models(self, conn: _Connection, req: _Request) -> _Response:
        now = int(time.time())
        return _json_response(
            {
                "object": "list",
                "data": [
                    {"id": name, "object": "model", "created": now, "owned_by": "dynamo_tpu"}
                    for name in self.models.model_names()
                ],
            }
        )

    async def _handle_openai(self, conn: _Connection, req: _Request, chat: bool) -> Optional[_Response]:
        endpoint = "chat_completions" if chat else "completions"
        try:
            body = json.loads(req.body.decode("utf-8"))
        except (json.JSONDecodeError, UnicodeDecodeError):
            return _error_response(400, "invalid JSON body")
        if not isinstance(body, dict):
            return _error_response(400, "invalid JSON body: expected an object")
        model = body.get("model")
        if not isinstance(model, str) or not model:
            return _error_response(400, "missing 'model'")
        engine = (
            self.models.chat_engine(model) if chat else self.models.completion_engine(model)
        )
        if engine is None:
            # Label with a CONSTANT, not the wire string: every junk model
            # name would otherwise mint a fresh label value.  The 404 body
            # still names the model.
            self.metrics.requests_total.labels(
                "unknown", endpoint, "stream", Status.REJECTED
            ).inc()
            return _model_not_found(model)
        # Past the served-model check the name is bounded (it resolved to
        # an engine) — not a cardinality hazard.
        model = bounded_label(model)
        stream_mode = bool(body.get("stream", False))
        guard = self.metrics.guard(model, endpoint, "stream" if stream_mode else "unary")
        # Request-id correlation: a caller-supplied x-request-id becomes the
        # PREFIX of the engine context id, uniquified with a server suffix —
        # request ids key the engine's response queues, so a client-chosen
        # id must never collide with a concurrent request's.  The full id
        # is echoed on every response from here on, success or error.
        rid = req.headers.get("x-request-id")
        ctx = Context.with_id(body, f"{rid}-{uuid.uuid4().hex[:8]}") if rid else Context(body)
        try:
            stream = await engine.generate(ctx)
        except ModelNotFoundError as e:
            guard.finish(Status.REJECTED)
            return _model_not_found(e.model, rid=ctx.id)
        except ValueError as e:
            # Request-shape errors (bad fields, oversize prompt) are the
            # client's fault: 400, not 500.
            guard.finish(Status.REJECTED)
            logger.warning("request rejected: %s", e, exc_info=True)
            return _error_response(400, str(e), rid=ctx.id)
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — edge boundary
            guard.finish(Status.ERROR)
            logger.exception("engine rejected request")
            return _error_response(500, str(e), rid=ctx.id)

        if stream_mode:
            await self._stream_response(conn, req, stream, ctx, guard)
            return None
        return await self._unary_response(stream, ctx, guard)

    async def _unary_response(self, stream, ctx: Context, guard) -> _Response:
        chunks = []
        try:
            async for chunk in stream:
                if "__annotations__" in chunk:
                    continue
                if chunk.get("choices") or chunk.get("usage"):
                    guard.on_token(0)
                chunks.append(chunk)
            full = aggregate_chunks(chunks)
        except asyncio.CancelledError:
            ctx.stop_generating()
            guard.finish(Status.CLIENT_DROP)
            raise
        except Exception as e:  # noqa: BLE001
            guard.finish(Status.ERROR)
            logger.exception("stream failed")
            return _error_response(500, str(e), rid=ctx.id)
        guard.finish(Status.SUCCESS)
        return _json_response(full, headers={"x-request-id": ctx.id})

    async def _stream_response(self, conn: _Connection, req: _Request, stream, ctx: Context, guard) -> None:
        headers = {
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "x-request-id": ctx.id,
        }
        status = Status.SUCCESS
        try:
            await conn.start_stream(headers, req.keep_alive)
            async for chunk in stream:
                if "__annotations__" in chunk:
                    await conn.write_chunk(
                        b"event: annotation\n" + sse_encode(chunk["__annotations__"])
                    )
                    continue
                guard.on_token()
                await conn.write_chunk(sse_encode(chunk))
            await conn.write_chunk(SSE_DONE)
            await conn.end_stream()
        except (ConnectionError, asyncio.CancelledError):
            # Client went away: a write failed, or the peer watch cancelled
            # this handler.  Deliberately absorbed — upstream generation must
            # be stopped and CLIENT_DROP recorded before the handler exits.
            ctx.stop_generating()
            conn.broken = True
            status = Status.CLIENT_DROP
        except Exception:  # noqa: BLE001
            status = Status.ERROR
            logger.exception("stream failed")
            try:
                await conn.write_chunk(b"event: error\n" + sse_encode({"error": "stream failed"}))
                await conn.end_stream()
            except ConnectionError:
                pass
        finally:
            guard.finish(status)
            await stream.aclose()


_ERROR_TYPES = {
    429: "overloaded_error",
    503: "overloaded_error",
    504: "timeout_error",
}


def _error_response(
    status: int,
    message: str,
    rid: Optional[str] = None,
    code: Optional[Any] = None,
    param: Optional[str] = None,
) -> _Response:
    headers = {}
    if rid:
        headers["x-request-id"] = rid
    error: Dict[str, Any] = {
        "message": message,
        "type": _ERROR_TYPES.get(status, "invalid_request_error"),
        # OpenAI uses string codes ("model_not_found"); the numeric status
        # stays the default for errors without one.
        "code": status if code is None else code,
    }
    if param is not None:
        error["param"] = param
    return _json_response({"error": error}, status=status, headers=headers)


def _model_not_found(model: str, rid: Optional[str] = None) -> _Response:
    """The OpenAI ``model_not_found`` 404 body: a request naming an
    unregistered model must fail loudly."""
    return _error_response(
        404,
        f"The model {model!r} does not exist or is not served here",
        rid=rid,
        code="model_not_found",
        param="model",
    )

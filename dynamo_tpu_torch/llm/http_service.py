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
transfer encoding.  Statuses, error bodies
and headers are the JAX edge's, the overload and observability plane
included: admission control (``max_inflight`` and a bounded wait queue;
429 on overflow, 503 on a wait timeout), per-request deadlines
(``x-deadline-s`` or body ``deadline_s``; the edge bounds every chunk
wait and answers 504 mid-generation, or an SSE error event mid-stream;
the 504 at dispatch answers an engine that raises
``DeadlineExceededError`` from ``generate``, which takes a hop that
enforces deadlines, the routed client of ROADMAP queue 1 item 10: the
colocated engine of ``run`` enforces none), QoS (per-tenant quotas, priority
classes and the brownout ladder, llm/qos.py) and request tracing
(``x-trace`` / ``nvext.trace``, ``GET /traces?recent=N`` and
``/traces/{id}``).  Not ported yet: hub health (``/health``'s
``hub_shards``), which needs the distributed runtime.

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

from urllib.parse import parse_qs, unquote

from ..labels import bounded_label
from ..runtime.engine import AsyncEngine, Context
from ..runtime.resilience import (
    AdmissionController,
    AdmissionRejected,
    Deadline,
    DeadlineExceededError,
)
from ..runtime.resilience import metrics as resilience_metrics
from ..runtime.tracing import tracing_metrics
from .metrics import (
    Metrics,
    Status,
    engine_dispatch_metrics,
    kv_integrity_metrics,
    kv_tier_metrics,
    objstore_metrics,
    qos_metrics,
    spec_metrics,
)
from .openai import SSE_DONE, aggregate_chunks, sse_encode
from .protocols import ModelNotFoundError
from .qos import (
    BATCH,
    RUNG_CAP_TOKENS,
    RUNG_SHED_INTERACTIVE,
    RUNG_SPEC_STANDDOWN,
    BrownoutSignals,
    QosController,
    QosShed,
    resolve_priority,
    resolve_tenant,
)
from .trace_service import EdgeRequestTrace

logger = logging.getLogger(__name__)

MAX_BODY_BYTES = 16 << 20
MAX_HEAD_BYTES = 64 << 10  # request line + headers


class _TracedGuard:
    """Metrics InflightGuard wrapper that mirrors token/finish callbacks to
    the request's EdgeRequestTrace — one wrapper covers every status path
    in the handlers without touching them individually."""

    __slots__ = ("_guard", "_ert")

    def __init__(self, guard, ert: EdgeRequestTrace):
        self._guard = guard
        self._ert = ert

    def on_token(self, *args, **kwargs) -> None:
        self._ert.on_first_token()
        self._guard.on_token(*args, **kwargs)

    def finish(self, status) -> None:
        self._guard.finish(status)
        self._ert.finish(str(status))


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
    __slots__ = ("method", "path", "query", "headers", "body")

    def __init__(self, method, path, query, headers, body):
        self.method = method
        self.path = path
        self.query: Dict[str, str] = query  # first value of each parameter
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
        path, _, qs = target.partition("?")
        query = {k: v[0] for k, v in parse_qs(qs, keep_blank_values=True).items()}
        return _Request(method, path, query, headers, body)

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
        max_inflight: Optional[int] = None,
        admission_queue: int = 0,
        admission_timeout_s: float = 1.0,
        default_deadline_s: Optional[float] = None,
        qos: Optional[QosController] = None,
        kv_usage_fn=None,
        tracing=None,
        trace_aggregator=None,
    ):
        self.host = host
        self.port = port
        self.models = model_manager or ModelManager()
        self.metrics = Metrics(metrics_prefix)
        self._metrics_prefix = metrics_prefix
        # Admission control (disabled unless max_inflight is set): beyond
        # the in-flight cap requests wait in a bounded FIFO; overflow sheds
        # 429, wait-timeout sheds 503 — latency stays bounded instead of
        # collapsing under burst.  Batch-class requests may only occupy the
        # front half of the queue (llm/qos.py priority classes).
        self.admission = AdmissionController(
            max_inflight=max_inflight,
            max_queue=admission_queue,
            queue_timeout_s=admission_timeout_s,
        )
        # QoS/overload control (llm/qos.py): per-tenant token buckets + the
        # brownout degradation ladder.  None = disabled (zero behaviour
        # change).  ``kv_usage_fn`` optionally feeds the ladder a KV-
        # pressure signal when an engine is colocated.
        self.qos = qos
        self._kv_usage_fn = kv_usage_fn
        self._qos_task: Optional[asyncio.Task] = None
        # Per-request wall-clock budget (None = unbounded); exhaustion maps
        # to 504 below.
        self.default_deadline_s = default_deadline_s
        # Request tracing (runtime/tracing.py): ``tracing`` is a
        # TraceSampler (None = the edge never samples, zero cost);
        # ``trace_aggregator`` serves assembled traces at /traces (wired by
        # the CLI as a direct exporter sink: the engine is colocated).
        self.tracing = tracing
        self.trace_aggregator = trace_aggregator
        self._server: Optional[asyncio.AbstractServer] = None
        self._connections: Set[asyncio.Task] = set()
        # path → (method, handler(conn, req) -> response, or None when the
        # handler wrote its own or the client left); ``/traces/{id}`` is
        # matched by prefix in _serve.
        self._routes = {
            "/v1/chat/completions": ("POST", functools.partial(self._watched_openai, chat=True)),
            "/v1/completions": ("POST", functools.partial(self._watched_openai, chat=False)),
            "/v1/models": ("GET", self._list_models),
            "/metrics": ("GET", self._metrics),
            "/health": ("GET", self._health),
            "/live": ("GET", self._health),
            "/traces": ("GET", self._traces_recent),
        }

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> "HttpService":
        self._server = await asyncio.start_server(self._on_connection, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]  # resolve port 0
        logger.info("HTTP service listening on %s:%s", self.host, self.port)
        if self.qos is not None and self.qos.ladder is not None:
            self._qos_task = asyncio.get_running_loop().create_task(self._qos_tick_loop())
        return self

    async def close(self) -> None:
        if self._qos_task is not None:
            self._qos_task.cancel()
            try:
                await self._qos_task
            except asyncio.CancelledError:
                pass
            self._qos_task = None
        if self._server is None:
            return
        self._server.close()
        conns = list(self._connections)
        for t in conns:
            t.cancel()
        await asyncio.gather(*conns, return_exceptions=True)
        await self._server.wait_closed()
        self._server = None

    async def _qos_tick_loop(self) -> None:
        """Drive the brownout ladder off live edge signals.  The ladder
        itself is pure (llm/qos.py BrownoutLadder.tick); this loop only
        samples queue depth, rolling TTFT and (optionally) KV usage on the
        configured interval and publishes the rung to metrics."""
        while True:
            await asyncio.sleep(self.qos.config.tick_s)
            self.qos_tick()

    def qos_tick(self) -> int:
        """One brownout tick on the live signals; returns the rung."""
        ladder = self.qos.ladder
        kv_usage = 0.0
        if self._kv_usage_fn is not None:
            try:
                kv_usage = float(self._kv_usage_fn())
            except Exception:  # noqa: BLE001 — signal source is optional
                logger.warning("qos kv_usage_fn failed", exc_info=True)
        # TTFT from the AGE-bounded window (None = no first token in the
        # last few seconds): a count-bounded window would hold a spike's
        # samples long after it ended — at zero traffic forever — and the
        # ladder could never recover.
        ttft_p95_ms = self.metrics.recent_ttft_p95_ms()
        before = ladder.rung
        ladder.tick(
            BrownoutSignals(
                queue_depth=float(self.admission.queued),
                kv_usage=kv_usage,
                ttft_p95_ms=ttft_p95_ms,
            )
        )
        qos_metrics.brownout_rung = ladder.rung
        if ladder.rung != before:
            qos_metrics.brownout_transitions_total += 1
            logger.warning(
                "brownout rung %d -> %d (queue=%d ttft_p95=%sms)",
                before, ladder.rung, self.admission.queued,
                "%.0f" % ttft_p95_ms if ttft_p95_ms is not None else "-",
            )
        return ladder.rung

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
        trace_id = req.path[len("/traces/"):] if req.path.startswith("/traces/") else ""
        if route is None and trace_id and "/" not in trace_id:
            route = ("GET", self._trace_get)
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
        body = {"status": "ok", "models": self.models.model_names()}
        if self.qos is not None and self.qos.ladder is not None:
            body["brownout"] = self.qos.ladder.state()
        return _json_response(body)

    async def _metrics(self, conn: _Connection, req: _Request) -> _Response:
        prefix = self._metrics_prefix
        body = (
            self.metrics.render()
            + resilience_metrics.render(prefix).encode()
            + tracing_metrics.render(prefix).encode()
            + spec_metrics.render(prefix).encode()
            + qos_metrics.render(prefix).encode()
            + engine_dispatch_metrics.render(prefix).encode()
            + kv_tier_metrics.render(prefix).encode()
            + kv_integrity_metrics.render(prefix).encode()
            + objstore_metrics.render(prefix).encode()
        )
        return _Response(200, body, "text/plain; version=0.0.4; charset=utf-8")

    async def _traces_recent(self, conn: _Connection, req: _Request) -> _Response:
        """``/traces?recent=N``: the aggregator's most recent assemblies."""
        if self.trace_aggregator is None:
            return _error_response(404, "tracing aggregator not configured")
        try:
            n = int(req.query.get("recent", 20))
        except (TypeError, ValueError):
            n = 20
        return _json_response({"traces": self.trace_aggregator.recent(n)})

    async def _trace_get(self, conn: _Connection, req: _Request) -> _Response:
        """``/traces/{id}``: one assembled trace + its per-hop rollup."""
        if self.trace_aggregator is None:
            return _error_response(404, "tracing aggregator not configured")
        tid = unquote(req.path[len("/traces/"):])
        trace = self.trace_aggregator.get(tid)
        if trace is None:
            return _error_response(404, f"trace {tid!r} not assembled here")
        return _json_response(trace)

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

        # Tracing (runtime/tracing.py): the sampling decision is made once
        # here — forced (x-trace / nvext.trace) beats the head rate — and
        # the handle shadows the request even when unsampled so tail-keep
        # can promote an error/SLO-violating request's edge spans later.
        ert = EdgeRequestTrace(self.tracing, req.headers, body)

        # QoS (llm/qos.py): resolve tenant + priority, charge the tenant's
        # quota, apply the brownout rung — all BEFORE a slot is consumed.
        priority = resolve_priority(req.headers, body)
        tenant: Optional[str] = None
        if self.qos is not None:
            tenant = resolve_tenant(req.headers, body)
            if self.qos.rung >= RUNG_SHED_INTERACTIVE and self.admission.saturated:
                # Rung 4: admission is saturated — shed instead of queueing
                # (never sheds below the in-flight cap).  Checked BEFORE
                # the quota charge: a shed request consumed no capacity
                # and must not drain the tenant's bucket.
                qos_metrics.interactive_shed_total += 1
                qos_metrics.shed_tenant(tenant)
                self.metrics.requests_total.labels(
                    model, endpoint, "stream", Status.REJECTED
                ).inc()
                ert.finish(Status.REJECTED, model=model, endpoint=endpoint)
                return _error_response(
                    503,
                    "server in brownout (interactive overflow)",
                    retry_after_s=self.admission.estimate_retry_after(),
                )
            try:
                self.qos.admit(tenant, priority, self.admission.estimate_retry_after())
            except QosShed as e:
                if e.reason == "quota":
                    qos_metrics.quota_shed_total += 1
                else:
                    qos_metrics.batch_shed_total += 1
                qos_metrics.shed_tenant(tenant)
                self.metrics.requests_total.labels(
                    model, endpoint, "stream", Status.REJECTED
                ).inc()
                ert.finish(Status.REJECTED, model=model, endpoint=endpoint)
                return _error_response(e.status, e.message, retry_after_s=e.retry_after_s)
            rung = self.qos.rung
            if rung >= RUNG_CAP_TOKENS:
                qos_metrics.capped_requests_total += 1
            if rung >= RUNG_SPEC_STANDDOWN:
                qos_metrics.spec_standdowns_total += 1
            if rung and ert.active:
                # Brownout rewrites are invisible in the response body —
                # record WHICH rung shaped this request on its trace.
                ert.event("brownout_rewrite", rung=rung)
            body = self.qos.shape(body)
            if tenant != model:
                # Thread the RESOLVED identity to the scheduler's WFQ
                # (preprocessor: nvext.tenant → annotations.tenant) — a
                # model-named tenant is the scheduler's own fallback, so
                # only header/credential identities need the stamp.
                nvext = body.get("nvext")
                if not isinstance(nvext, dict):
                    nvext = {}
                    body["nvext"] = nvext
                nvext["tenant"] = tenant
        if priority == BATCH or "x-priority" in req.headers:
            # Thread the resolved class to the scheduler (the preprocessor
            # reads nvext.priority into PreprocessedRequest.priority).
            # NOT setdefault: a client-sent ``"nvext": null`` would satisfy
            # it and the batch class would silently run as interactive.
            nvext = body.get("nvext")
            if not isinstance(nvext, dict):
                nvext = {}
                body["nvext"] = nvext
            nvext["priority"] = priority

        # Admission control guards everything that costs engine work; cheap
        # 400/404s above never consume a slot.  Batch-class requests only
        # queue in their reserved fraction (resilience.AdmissionController).
        ert.admission_started()
        try:
            await self.admission.acquire(priority)
        except AdmissionRejected as e:
            if self.qos is not None and tenant is not None:
                # The quota was charged above, but this request was shed
                # before consuming any capacity — credit it back.
                self.qos.quotas.refund(tenant)
            self.metrics.requests_total.labels(
                model, endpoint, "stream", Status.REJECTED
            ).inc()
            ert.finish(Status.REJECTED, model=model, endpoint=endpoint)
            # The drain-rate estimate says when a slot frees; a deepening
            # brownout says the estimate is optimistic — back clients off
            # harder the further down the ladder the edge already is.
            retry = e.retry_after_s
            if self.qos is not None and self.qos.rung:
                retry *= 1 + self.qos.rung
            return _error_response(e.status, e.message, retry_after_s=retry)
        except BaseException:
            # Handler cancelled (client gone) or failed while QUEUED: the
            # admission wait it died in is exactly the datum the trace
            # exists to capture — record before propagating.
            ert.finish(Status.ERROR, model=model, endpoint=endpoint)
            raise
        ert.admission_done()
        try:
            return await self._admitted_openai(conn, req, body, engine, model, endpoint, ert)
        finally:
            self.admission.release()
            # Belt for paths no guard.finish covered (handler cancellation,
            # unexpected escapes): finish is idempotent, so completed
            # requests — already closed by _TracedGuard — are untouched.
            ert.finish(Status.ERROR, model=model, endpoint=endpoint)

    async def _admitted_openai(
        self,
        conn: _Connection,
        req: _Request,
        body: Dict[str, Any],
        engine: AsyncEngine,
        model: str,
        endpoint: str,
        ert: EdgeRequestTrace,
    ) -> Optional[_Response]:
        stream_mode = bool(body.get("stream", False))
        guard = self.metrics.guard(model, endpoint, "stream" if stream_mode else "unary")
        # The caller made the ONE sampling decision for this request.
        ert.model, ert.endpoint = model, endpoint
        # Every guard.finish path (success, error, client drop) also closes
        # the edge trace — one wrapper instead of N call sites.
        guard = _TracedGuard(guard, ert)
        # Request-id correlation: a caller-supplied x-request-id becomes the
        # PREFIX of the engine context id, uniquified with a server suffix —
        # request ids key the engine's response queues, so a client-chosen
        # id must never collide with a concurrent request's.  The full id
        # is echoed on every response from here on, success or error.
        rid = req.headers.get("x-request-id")
        ctx = Context.with_id(body, f"{rid}-{uuid.uuid4().hex[:8]}") if rid else Context(body)
        # Per-request deadline: caller's x-deadline-s header (or body
        # "deadline_s") wins, else the service default; None = unbounded.
        deadline_s = _requested_deadline(req, body, self.default_deadline_s)
        if deadline_s is not None:
            ctx.ctx.deadline = Deadline.after(deadline_s)
        if ert.tc is not None:
            # Downstream propagation: the preprocessor stamps this onto
            # ``annotations.trace`` — one trace from edge to decode chunk.
            ctx.ctx.trace = ert.tc
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
        except (DeadlineExceededError, asyncio.TimeoutError) as e:
            guard.finish(Status.ERROR)
            logger.warning("request %s deadline exceeded at dispatch", ctx.id)
            return _error_response(504, str(e) or "deadline exceeded", rid=ctx.id)
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
        # The edge is the enforcement point of last resort for deadlines: a
        # local pipeline streams unbounded — bound every chunk wait here.
        deadline = getattr(ctx.ctx, "deadline", None)
        chunks = []
        try:
            it = stream.__aiter__()
            while True:
                try:
                    if deadline is not None:
                        chunk = await deadline.bound(it.__anext__(), "response")
                    else:
                        chunk = await it.__anext__()
                except StopAsyncIteration:
                    break
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
        except DeadlineExceededError as e:
            # Abandoning the request must also stop upstream generation —
            # otherwise the engine keeps burning batch slots on a response
            # nobody will read, exactly when the server is already slow.
            ctx.stop_generating()
            guard.finish(Status.ERROR)
            logger.warning("request %s deadline exceeded mid-generation", ctx.id)
            return _error_response(504, str(e) or "deadline exceeded", rid=ctx.id)
        except Exception as e:  # noqa: BLE001
            guard.finish(Status.ERROR)
            logger.exception("stream failed")
            return _error_response(500, str(e), rid=ctx.id)
        guard.finish(Status.SUCCESS)
        headers = {"x-request-id": ctx.id}
        trace = getattr(ctx.ctx, "trace", None)
        if trace is not None:
            headers["x-trace-id"] = trace.trace_id
        return _json_response(full, headers=headers)

    async def _stream_response(self, conn: _Connection, req: _Request, stream, ctx: Context, guard) -> None:
        headers = {
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "x-request-id": ctx.id,
        }
        trace = getattr(ctx.ctx, "trace", None)
        if trace is not None:
            # The trace id is the lookup key for /traces/{id}.  Omitted when
            # untraced — the response byte stream itself never changes.
            headers["x-trace-id"] = trace.trace_id
        deadline = getattr(ctx.ctx, "deadline", None)
        status = Status.SUCCESS
        try:
            await conn.start_stream(headers, req.keep_alive)
            it = stream.__aiter__()
            while True:
                try:
                    if deadline is not None:
                        chunk = await deadline.bound(it.__anext__(), "stream")
                    else:
                        chunk = await it.__anext__()
                except StopAsyncIteration:
                    break
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
        except DeadlineExceededError:
            # The 200 head is already on the wire: stop generation and end
            # the SSE stream with a typed error event.
            ctx.stop_generating()
            status = Status.ERROR
            await self._end_with_error(conn, {"error": "deadline exceeded", "code": 504})
        except Exception:  # noqa: BLE001
            status = Status.ERROR
            logger.exception("stream failed")
            await self._end_with_error(conn, {"error": "stream failed"})
        finally:
            guard.finish(status)
            await stream.aclose()

    @staticmethod
    async def _end_with_error(conn: _Connection, event: Dict[str, Any]) -> None:
        try:
            await conn.write_chunk(b"event: error\n" + sse_encode(event))
            await conn.end_stream()
        except ConnectionError:
            pass


def _requested_deadline(
    req: _Request, body: Dict[str, Any], default_s: Optional[float]
) -> Optional[float]:
    raw = req.headers.get("x-deadline-s") or body.get("deadline_s")
    if raw is not None:
        try:
            value = float(raw)
            if value > 0:
                return value
        except (TypeError, ValueError):
            pass
    return default_s


_ERROR_TYPES = {
    429: "overloaded_error",
    503: "overloaded_error",
    504: "timeout_error",
}


def _error_response(
    status: int,
    message: str,
    rid: Optional[str] = None,
    retry_after_s: Optional[float] = None,
    code: Optional[Any] = None,
    param: Optional[str] = None,
) -> _Response:
    headers = {}
    if rid:
        headers["x-request-id"] = rid
    if retry_after_s is not None:
        headers["Retry-After"] = str(max(1, int(retry_after_s)))
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

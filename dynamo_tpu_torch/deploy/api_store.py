"""Deployment-management REST API (the reference's api-store).

The port's copy of the JAX package's ``deploy/api_store.py``, served on the
standard library's asyncio streams (llm/http_service.py's connection
plumbing, as the planner's and the ``metrics`` servers are) in place of
aiohttp's ``web``: the same routes, statuses and JSON bodies, aiohttp's
404/405/500 texts for the rest.

Reference counterpart: the reference's deploy/dynamo/api-store/
ai_dynamo_store/api/* — a FastAPI CRUD surface over deployment records that
the operator consumes.  Here the records are DynamoTpuDeployment CR dicts
persisted in the hub KV (durable across hub restarts via its snapshot
layer), and the same Reconciler that serves the k8s controller can run
against this store's CRs — deployment management without a k8s control
plane, or as the source feeding one.

Routes (mirroring the reference's shape):
  POST   /api/v1/deployments          create (body = CR spec or full CR)
  GET    /api/v1/deployments          list
  GET    /api/v1/deployments/{name}   fetch (includes last status)
  DELETE /api/v1/deployments/{name}   delete
  GET    /api/v1/deployments/{name}/manifests   rendered children (preview)
"""

from __future__ import annotations

import asyncio
import hmac
import json
import logging
from typing import Any, Dict, Optional, Set

from ..labels import safe_key_component
from ..llm.http_service import (
    _close_server,
    _head,
    _json_response,
    _Response,
    _serve_connection,
    _text_response,
)
from ..runtime.transports.shard import hub_key
from .renderer import render

logger = logging.getLogger(__name__)

PREFIX = "deployments/"
COLLECTION = "/api/v1/deployments"


def deployment_key(name: str) -> str:
    """CR record key for one deployment name (shard-map routed: DYN401)."""
    return hub_key("deployments", name)


def _as_cr(name: str, body: Dict[str, Any]) -> Dict[str, Any]:
    """Accept either a full CR or a bare spec."""
    if "spec" in body:
        cr = dict(body)
        cr.setdefault("apiVersion", "dynamo.tpu.io/v1alpha1")
        cr.setdefault("kind", "DynamoTpuDeployment")
        cr.setdefault("metadata", {})["name"] = name
        return cr
    return {
        "apiVersion": "dynamo.tpu.io/v1alpha1",
        "kind": "DynamoTpuDeployment",
        "metadata": {"name": name},
        "spec": body,
    }


class ApiStore:
    """REST surface over hub-persisted deployment CRs.

    ``hub`` is anything with kv_put/kv_get/kv_get_prefix/kv_delete (the
    runtime hub client or InprocHub).  ``reconciler`` is optional: when
    given, create/delete trigger an immediate reconcile pass.
    """

    def __init__(
        self, hub, reconciler=None, host="127.0.0.1", port=7070, token=None
    ):
        self.hub = hub
        self.reconciler = reconciler
        self.host, self.port = host, port
        # Bearer-token gate: with --kube this API can create/delete k8s
        # objects, so default to loopback + optional token; None =
        # unauthenticated, for loopback/dev use.
        self.token = token
        self._server: Optional[asyncio.base_events.Server] = None
        self._connections: Set[asyncio.Task] = set()

    def _route(self, path: str):
        """(handler by method, the ``{name}`` path parameter) for ``path``,
        or (None, None): the JAX store's route table."""
        if path == COLLECTION:
            return {"POST": self._create, "GET": self._list}, None
        rest = path[len(COLLECTION) + 1:] if path.startswith(COLLECTION + "/") else ""
        name, _, tail = rest.partition("/")
        if name and "/" not in tail:
            if tail == "":
                return {"GET": self._get, "DELETE": self._delete}, name
            if tail == "manifests":
                return {"GET": self._manifests}, name
        return None, None

    async def _serve(self, conn, req) -> None:
        resp = await self._respond(req)
        if req.method != "HEAD":
            await conn.send(resp, req.keep_alive)
            return
        # HEAD: GET's head, no body (aiohttp registers HEAD with each GET).
        headers = {"Content-Type": resp.content_type, "Content-Length": str(len(resp.body)),
                   **resp.headers}
        if not req.keep_alive:
            headers["Connection"] = "close"
        await conn._write(_head(resp.status, headers))

    async def _respond(self, req) -> _Response:
        if self.token is not None:
            # bytes compare: compare_digest raises TypeError on non-ASCII
            # str (a 500 where a 401 belongs).
            got = req.headers.get("authorization", "").encode("latin-1")
            if not hmac.compare_digest(got, f"Bearer {self.token}".encode()):
                return _json_response({"error": "unauthorized"}, status=401)
        handlers, name = self._route(req.path)
        if handlers is None:
            return _text_response(404, "404: Not Found")
        methods = dict(handlers)
        if "GET" in methods:
            methods.setdefault("HEAD", methods["GET"])
        handler = methods.get(req.method)
        if handler is None:
            return _text_response(405, "405: Method Not Allowed",
                                  {"Allow": ",".join(sorted(methods))})
        try:
            return await (handler(req) if name is None else handler(req, name))
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — a request's boundary
            logger.exception("api-store handler failed")
            return _text_response(500, "500 Internal Server Error\n\nServer got itself in trouble")

    # ------------------------------------------------------------- handlers
    async def _create(self, req) -> _Response:
        try:
            body = json.loads(req.body)
        except ValueError:
            return _json_response({"error": "invalid JSON"}, status=400)
        name = (
            body.get("name")
            or (body.get("metadata") or {}).get("name")
        )
        if not name:
            return _json_response({"error": "missing deployment name"}, status=400)
        try:
            # Deployment names become hub-key components under PREFIX: a
            # name containing '/', whitespace or control chars could
            # escape the store's namespace and shadow another subsystem's
            # keys — reject at the edge, k8s-style.
            name = safe_key_component(name)
        except ValueError as e:
            return _json_response({"error": str(e)}, status=400)
        body.pop("name", None)
        cr = _as_cr(name, body)
        try:
            render(cr)  # validate: reject specs the renderer can't map
        except asyncio.CancelledError:
            raise
        except Exception as e:
            return _json_response({"error": f"invalid spec: {e}"}, status=400)
        existed = await self.hub.kv_get(deployment_key(name)) is not None
        await self.hub.kv_put(deployment_key(name), cr)
        if self.reconciler is not None:
            try:
                status = await self.reconciler.reconcile(cr)
                cr = dict(cr, status=status)
                await self.hub.kv_put(deployment_key(name), cr)
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("reconcile on create failed")
        return _json_response(cr, status=200 if existed else 201)

    async def _list(self, req) -> _Response:
        items = await self.hub.kv_get_prefix(PREFIX)
        return _json_response({"items": list(items.values())})

    async def _get(self, req, name: str) -> _Response:
        cr = await self.hub.kv_get(deployment_key(name))
        if cr is None:
            return _json_response({"error": "not found"}, status=404)
        return _json_response(cr)

    async def _delete(self, req, name: str) -> _Response:
        cr = await self.hub.kv_get(deployment_key(name))
        if cr is None:
            return _json_response({"error": "not found"}, status=404)
        await self.hub.kv_delete(deployment_key(name))
        if self.reconciler is not None:
            try:
                await self.reconciler.teardown(name)
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("teardown on delete failed")
        return _json_response({"deleted": name})

    async def _manifests(self, req, name: str) -> _Response:
        cr = await self.hub.kv_get(deployment_key(name))
        if cr is None:
            return _json_response({"error": "not found"}, status=404)
        return _json_response({"manifests": render(cr)})

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> "ApiStore":
        self._server = await asyncio.start_server(self._on_connection, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]  # resolve port 0
        logger.info("api-store on http://%s:%s", self.host, self.port)
        return self

    async def _on_connection(self, reader, writer) -> None:
        await _serve_connection(reader, writer, self._connections, self._serve)

    async def close(self) -> None:
        if self._server is not None:
            await _close_server(self._server, self._connections)
            self._server = None

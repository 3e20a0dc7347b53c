"""Operator controller: watches DynamoTpuDeployment CRs and reconciles the
cluster to `render(cr)`.  The port's copy of the JAX package's
``deploy/controller.py``, with ``KubeApi`` on the standard library (asyncio
streams and ``ssl``) in place of aiohttp.

Reference counterpart: the Go operator's reconcile loop
(deploy/dynamo/operator/internal/controller/
dynamonimdeployment_controller.go:1-2169) — fetch CR, generate child
resources, create/update/delete to match, write status.  controller-runtime
gives the Go version its watch/cache machinery; here the same loop is an
asyncio poll-or-watch over a minimal cluster client protocol, so the whole
reconcile path is unit-testable against an in-memory fake (the reference
tests the same way with controller-runtime's fake client).

Split of responsibilities (mirrors the reference):
- deploy/renderer.py — PURE mapping CR → desired children;
- Reconciler (here)  — diffing desired vs observed, ownership, drift
  repair, status writing;
- KubeApi (here)     — the only piece that talks to a real API server.
"""

from __future__ import annotations

import asyncio
import copy
import json
import logging
import os
import ssl
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import urlencode, urlsplit

from .renderer import render

logger = logging.getLogger(__name__)

GROUP = "dynamo.tpu.io"  # matches deploy/k8s/crd.yaml
OWNER_LABEL = f"{GROUP}/owner"
# Which control plane created a child ("operator" = the k8s CR controller,
# "api-store" = hub-CR REST store running with --kube).  The orphan sweep
# and teardown only ever touch children carrying their OWN manager value —
# without this, an operator sharing a namespace with an api-store would
# sweep away every api-store deployment within one poll (r4 advisory).
MANAGER_LABEL = f"{GROUP}/managed-by"
CR_PLURAL = "dynamotpudeployments"


def _kind_name(m: Dict[str, Any]) -> Tuple[str, str]:
    return m["kind"], m["metadata"]["name"]


def _subset(want: Any, have: Any) -> bool:
    """True when every field ``want`` sets matches ``have``.  The API
    server populates spec defaults the renderer omits (strategy,
    restartPolicy, dnsPolicy, ...), so EQUALITY against the observed
    object would re-apply every child on every poll forever; only the
    fields the controller actually owns may trigger an apply."""
    if isinstance(want, dict):
        if not isinstance(have, dict):
            return False
        return all(k in have and _subset(v, have[k]) for k, v in want.items())
    if isinstance(want, list):
        if not isinstance(have, list) or len(want) != len(have):
            return False
        return all(_subset(w, h) for w, h in zip(want, have))
    return want == have


def _spec_equal(desired: Dict[str, Any], observed: Dict[str, Any]) -> bool:
    """Drift check over the fields the controller owns (spec + labels +
    annotations — Ingress behavior is CONFIGURED via annotations, so a CR
    annotation edit must count as drift)."""
    return _subset(
        {
            "spec": desired.get("spec"),
            "labels": (desired.get("metadata") or {}).get("labels"),
            "annotations": (desired.get("metadata") or {}).get("annotations"),
        },
        {
            "spec": observed.get("spec"),
            "labels": (observed.get("metadata") or {}).get("labels"),
            "annotations": (observed.get("metadata") or {}).get("annotations"),
        },
    )


class FakeKube:
    """In-memory cluster for tests (the reference uses controller-runtime's
    fake client the same way).  Stores manifests by (kind, name); simulates
    readiness by echoing spec replicas into status when `auto_ready`."""

    def __init__(self, auto_ready: bool = True):
        self.objects: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self.auto_ready = auto_ready
        self.applied: List[Tuple[str, str]] = []  # audit trail
        self.deleted: List[Tuple[str, str]] = []

    async def list(
        self, kind: str, label: Optional[Tuple[str, str]] = None
    ) -> List[Dict[str, Any]]:
        out = []
        for (k, _), m in self.objects.items():
            if k != kind:
                continue
            if label is not None:
                labels = (m.get("metadata") or {}).get("labels") or {}
                if labels.get(label[0]) != label[1]:
                    continue
            out.append(copy.deepcopy(m))
        return out

    async def apply(self, manifest: Dict[str, Any]) -> None:
        key = _kind_name(manifest)
        m = copy.deepcopy(manifest)
        if self.auto_ready and m["kind"] in ("Deployment", "StatefulSet"):
            reps = (m.get("spec") or {}).get("replicas", 1)
            m["status"] = {"readyReplicas": reps, "replicas": reps}
        prev = self.objects.get(key)
        if prev is not None and "status" in prev and "status" not in m:
            m["status"] = prev["status"]
        self.objects[key] = m
        self.applied.append(key)

    async def delete(self, kind: str, name: str) -> bool:
        self.deleted.append((kind, name))
        return self.objects.pop((kind, name), None) is not None

    async def update_status(self, cr: Dict[str, Any], status: Dict[str, Any]) -> None:
        kind = cr.get("kind") or "DynamoTpuDeployment"
        key = (kind, cr["metadata"]["name"])
        if key in self.objects:
            self.objects[key]["status"] = copy.deepcopy(status)


class KubeApiError(RuntimeError):
    """An API-server answer outside 2xx where the caller needs success."""

    def __init__(self, status: int, method: str, url: str, body: bytes):
        super().__init__(f"{method} {url}: HTTP {status} {body[:200]!r}")
        self.status = status


class _Response:
    """One HTTP/1.1 response on an asyncio stream: the status and headers
    read, the body left on ``reader`` (``iter_chunks`` or ``read``)."""

    def __init__(self, status: int, headers: Dict[str, str], reader, writer):
        self.status = status
        self.headers = headers
        self._reader = reader
        self._writer = writer

    async def iter_chunks(self):
        """The body's bytes as they arrive (chunked or length-delimited or
        up to EOF)."""
        r = self._reader
        if "chunked" in self.headers.get("transfer-encoding", "").lower():
            while True:
                size = int((await r.readline()).split(b";", 1)[0].strip() or b"0", 16)
                if size == 0:
                    while (await r.readline()) not in (b"\r\n", b"\n", b""):
                        pass  # trailers
                    return
                data = await r.readexactly(size)
                await r.readline()  # the chunk's CRLF
                yield data
        elif "content-length" in self.headers:
            left = int(self.headers["content-length"])
            while left:
                data = await r.read(min(left, 1 << 16))
                if not data:
                    raise ConnectionError("connection closed inside the response body")
                left -= len(data)
                yield data
        else:
            while True:
                data = await r.read(1 << 16)
                if not data:
                    return
                yield data

    async def read(self) -> bytes:
        return b"".join([c async for c in self.iter_chunks()])

    async def json(self) -> Any:
        return json.loads(await self.read())

    async def close(self) -> None:
        self._writer.close()
        try:
            await self._writer.wait_closed()
        except (ConnectionError, OSError):
            pass


class KubeApi:
    """Minimal in-cluster API-server client on the standard library (the
    JAX package's is aiohttp): HTTP/1.1 over asyncio streams, TLS through
    ``ssl``, one connection per request.  Reads the standard
    serviceaccount token/CA; `apply` uses server-side apply so the loop is
    idempotent without resourceVersion bookkeeping."""

    SA = "/var/run/secrets/kubernetes.io/serviceaccount"

    _PATHS = {
        "Deployment": "/apis/apps/v1/namespaces/{ns}/deployments",
        "StatefulSet": "/apis/apps/v1/namespaces/{ns}/statefulsets",
        "Service": "/api/v1/namespaces/{ns}/services",
        "Ingress": "/apis/networking.k8s.io/v1/namespaces/{ns}/ingresses",
        "Job": "/apis/batch/v1/namespaces/{ns}/jobs",
        "DynamoTpuModelCache": (
            f"/apis/{GROUP}/v1alpha1/namespaces/{{ns}}/dynamotpumodelcaches"
        ),
        "DynamoTpuDeployment": (
            f"/apis/{GROUP}/v1alpha1/namespaces/{{ns}}/{CR_PLURAL}"
        ),
    }

    def __init__(self, namespace: str = "default", base: Optional[str] = None):
        self.namespace = namespace
        host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        self.base = base or f"https://{host}:{port}"
        self._token: Optional[str] = None
        self._ssl: Optional[ssl.SSLContext] = None
        self._open: set = set()  # responses being read (watch streams)

    def _tls(self) -> Optional[ssl.SSLContext]:
        if urlsplit(self.base).scheme != "https":
            return None
        if self._ssl is None:
            ca = os.path.join(self.SA, "ca.crt")
            self._ssl = ssl.create_default_context(cafile=ca if os.path.exists(ca) else None)
        return self._ssl

    def _refresh_token(self) -> None:
        # Projected serviceaccount tokens are time-bound and the kubelet
        # refreshes the FILE — re-read per request, or a long-running
        # operator goes permanently 401 after ~1h.
        tokf = os.path.join(self.SA, "token")
        if os.path.exists(tokf):
            with open(tokf) as f:
                self._token = f.read().strip()

    def _headers(self, content_type: Optional[str] = None) -> Dict[str, str]:
        h = {}
        if self._token:
            h["Authorization"] = f"Bearer {self._token}"
        if content_type:
            h["Content-Type"] = content_type
        return h

    def _path(self, kind: str, name: Optional[str] = None) -> str:
        p = self.base + self._PATHS[kind].format(ns=self.namespace)
        return f"{p}/{name}" if name else p

    async def _send(self, method: str, url: str, params: Optional[Dict[str, str]] = None,
                    body: Optional[bytes] = None,
                    content_type: Optional[str] = None) -> _Response:
        """Send one request; the response's head is read, its body not."""
        self._refresh_token()
        parts = urlsplit(url)
        tls = self._tls()
        port = parts.port or (443 if tls else 80)
        target = parts.path + (f"?{urlencode(params)}" if params else "")
        reader, writer = await asyncio.open_connection(
            parts.hostname, port, ssl=tls, limit=1 << 20)
        try:
            head = [f"{method} {target} HTTP/1.1", f"Host: {parts.hostname}:{port}",
                    "Accept: application/json", "Connection: close",
                    f"Content-Length: {len(body or b'')}"]
            head += [f"{k}: {v}" for k, v in self._headers(content_type).items()]
            writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + (body or b""))
            await writer.drain()
            status_line = await reader.readline()
            if not status_line:
                raise ConnectionError(f"{method} {url}: connection closed before a response")
            status = int(status_line.split()[1])
            headers: Dict[str, str] = {}
            while True:
                line = (await reader.readline()).decode("latin-1").strip()
                if not line:
                    break
                k, _, v = line.partition(":")
                headers[k.strip().lower()] = v.strip()
        except BaseException:
            writer.close()
            raise
        return _Response(status, headers, reader, writer)

    async def _call(self, method: str, url: str, params=None, body=None,
                    content_type=None) -> Tuple[int, bytes]:
        resp = await self._send(method, url, params, body, content_type)
        try:
            return resp.status, await resp.read()
        finally:
            await resp.close()

    @staticmethod
    def _raise_for_status(status: int, method: str, url: str, body: bytes) -> None:
        if status >= 400:
            raise KubeApiError(status, method, url, body)

    async def list(self, kind, label=None):
        params = {}
        if label is not None:
            params["labelSelector"] = f"{label[0]}={label[1]}"
        url = self._path(kind)
        status, body = await self._call("GET", url, params)
        self._raise_for_status(status, "GET", url, body)
        return json.loads(body).get("items", [])

    async def apply(self, manifest):
        kind, name = _kind_name(manifest)
        url = self._path(kind, name)
        status, body = await self._call(
            "PATCH", url,
            {"fieldManager": "dynamo-tpu-operator", "force": "true"},
            json.dumps(manifest).encode(), "application/apply-patch+yaml",
        )
        self._raise_for_status(status, "PATCH", url, body)

    async def delete(self, kind, name) -> bool:
        # Background propagation: a bare API delete of a Job ORPHANS its
        # pods (they keep running and writing); cascade everywhere — it is
        # the kubectl default for the other kinds anyway.
        status, _ = await self._call(
            "DELETE", self._path(kind, name), {"propagationPolicy": "Background"})
        return status < 300

    async def watch(self, kind: str):
        """Yield watch events for ``kind`` (k8s chunked-JSON watch stream).

        One LIST first captures resourceVersion so the watch starts from a
        consistent point; the stream then yields each event dict.  Server
        timeouts / 410 Gone end the generator — the caller's pump restarts
        it (Reconciler.run), and the periodic resync covers anything a
        restart gap missed.  Cancelling the consumer closes the stream's
        socket."""
        # rv-capture list: limit=1 — only metadata.resourceVersion matters
        # (k8s ends watches server-side every few minutes by design, so
        # this runs on every restart; never download the full collection).
        url = self._path(kind)
        status, body = await self._call("GET", url, {"limit": "1"})
        self._raise_for_status(status, "GET", url, body)
        rv = (json.loads(body).get("metadata") or {}).get("resourceVersion", "")
        params = {"watch": "1", "allowWatchBookmarks": "true"}
        if rv:
            params["resourceVersion"] = rv
        resp = await self._send("GET", url, params)
        self._open.add(resp)
        try:
            if resp.status >= 400:
                self._raise_for_status(resp.status, "GET", url, await resp.read())
            # Chunk-based line splitting: k8s objects (managedFields!)
            # routinely exceed any fixed line limit.
            buf = b""
            async for chunk in resp.iter_chunks():
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    line = line.strip()
                    if not line:
                        continue
                    event = json.loads(line)
                    if event.get("type") == "BOOKMARK":
                        continue
                    yield event
        finally:
            self._open.discard(resp)
            await resp.close()

    async def update_status(self, cr, status):
        name = cr["metadata"]["name"]
        kind = cr.get("kind") or "DynamoTpuDeployment"
        body = {
            "apiVersion": f"{GROUP}/v1alpha1",
            "kind": kind,
            "metadata": {"name": name},
            "status": status,
        }
        sub_status, _ = await self._call(
            "PATCH", self._path(kind, name) + "/status",
            {"fieldManager": "dynamo-tpu-operator", "force": "true"},
            json.dumps(body).encode(), "application/apply-patch+yaml",
        )
        if sub_status < 300:
            return
        attempted = "status subresource"
        if sub_status in (404, 405):
            # CRD registered without the status subresource: fall back to
            # patching status on the main resource (merge-patch).
            attempted = "subresource (HTTP %s) and merge-patch fallback" % sub_status
            sub_status, _ = await self._call(
                "PATCH", self._path(kind, name), None,
                json.dumps({"status": status}).encode(), "application/merge-patch+json",
            )
            if sub_status < 300:
                return
        # A silently-dropped status write hides reconcile results from
        # kubectl — surface it.
        logger.warning(
            "status write failed for %s: HTTP %s via %s",
            name, sub_status, attempted,
        )

    async def close(self):
        for resp in list(self._open):
            await resp.close()
        self._open.clear()


class Reconciler:
    """Drives one CR (or all CRs) to its rendered desired state."""

    CHILD_KINDS = ("Deployment", "StatefulSet", "Service", "Ingress")

    def __init__(self, kube, manager: str = "operator"):
        self.kube = kube
        # Control-plane identity stamped on children (MANAGER_LABEL); sweep
        # and teardown are scoped to it.
        self.manager = manager

    def _mine(self, m: Dict[str, Any]) -> bool:
        labels = m["metadata"].get("labels") or {}
        return labels.get(MANAGER_LABEL) == self.manager

    async def reconcile(self, cr: Dict[str, Any]) -> Dict[str, Any]:
        """One reconcile pass for ``cr``; returns the status written."""
        name = cr["metadata"]["name"]
        desired = []
        for m in render(cr):
            m = copy.deepcopy(m)
            labels = m["metadata"].setdefault("labels", {})
            labels[OWNER_LABEL] = name
            labels[MANAGER_LABEL] = self.manager
            desired.append(m)
        desired_keys = {_kind_name(m) for m in desired}

        observed: Dict[Tuple[str, str], Dict[str, Any]] = {}
        for kind in self.CHILD_KINDS:
            for m in await self.kube.list(kind, label=(OWNER_LABEL, name)):
                if self._mine(m):  # never adopt another plane's children
                    observed[_kind_name(m)] = m

        # Create missing / update drifted (covers spec drift AND manual
        # deletion — the apply re-creates).
        for m in desired:
            cur = observed.get(_kind_name(m))
            if cur is None or not _spec_equal(m, cur):
                await self.kube.apply(m)

        # Delete owned children no longer rendered (a service removed from
        # the CR takes its Deployment + Service with it).
        for key, _ in observed.items():
            if key not in desired_keys:
                await self.kube.delete(*key)

        status = await self._status(cr, desired)
        await self.kube.update_status(cr, status)
        return status

    async def teardown(self, name: str) -> int:
        """Delete every child THIS control plane owns for CR ``name``;
        returns count deleted.  Shared by the orphan sweep and the
        api-store's delete handler.  Children stamped by a DIFFERENT
        manager are left alone; unlabeled children (created before
        MANAGER_LABEL existed) are included — an explicit delete of this
        name must not leak pre-upgrade workloads.  (The background orphan
        sweep stays conservative and never touches unlabeled children;
        reconcile re-applies labels, so legacy children of live CRs adopt
        on the first pass.)"""
        count = 0
        for kind in self.CHILD_KINDS:
            for m in await self.kube.list(kind, label=(OWNER_LABEL, name)):
                mgr = (m["metadata"].get("labels") or {}).get(MANAGER_LABEL)
                if mgr is not None and mgr != self.manager:
                    continue
                await self.kube.delete(*_kind_name(m))
                count += 1
        return count

    async def _status(self, cr, desired) -> Dict[str, Any]:
        name = cr["metadata"]["name"]
        ready, total = 0, 0
        services = []
        observed = {}
        for kind in ("Deployment", "StatefulSet"):
            for m in await self.kube.list(kind, label=(OWNER_LABEL, name)):
                observed[_kind_name(m)] = m
        for m in desired:
            if m["kind"] not in ("Deployment", "StatefulSet"):
                continue
            total += 1
            cur = observed.get(_kind_name(m)) or {}
            want = (m.get("spec") or {}).get("replicas", 1)
            have = (cur.get("status") or {}).get("readyReplicas", 0)
            ok = have >= want
            ready += bool(ok)
            services.append(
                {"name": m["metadata"]["name"], "ready": have, "want": want}
            )
        return {
            "observedGeneration": cr["metadata"].get("generation", 0),
            "phase": "Ready" if ready == total else "Progressing",
            "readyServices": ready,
            "totalServices": total,
            "services": services,
        }

    CR_KIND = "DynamoTpuDeployment"

    async def run_pass(self) -> None:
        """One level-triggered pass: list CRs, reconcile each, sweep."""
        crs = await self.kube.list(self.CR_KIND)
        for cr in crs:
            try:
                await self.reconcile(cr)
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception(
                    "reconcile failed for %s", cr["metadata"]["name"]
                )
        await self.sweep_orphans({c["metadata"]["name"] for c in crs})

    async def run(self, poll_interval: float = 10.0) -> None:
        """Watch-triggered, level-driven loop (the controller-runtime
        shape): a pass runs immediately after any CR event, with
        ``poll_interval`` as the periodic resync (watches can silently go
        stale; the resync also drives child-drift repair, which CR events
        alone cannot see).  Clients without a watch (or when the watch
        errors — RBAC, old API server) degrade to pure polling."""
        watch = getattr(self.kube, "watch", None)
        wake = asyncio.Event()
        watcher: Optional[asyncio.Task] = None
        if watch is not None:

            async def pump() -> None:
                while True:
                    try:
                        async for _event in watch(self.CR_KIND):
                            wake.set()
                        # Clean end-of-stream (server-side watch timeout, or
                        # an intermediary that closes long responses): treat
                        # it as a resync point, NEVER a tight restart loop.
                        wake.set()
                        await asyncio.sleep(1.0)
                    except asyncio.CancelledError:
                        raise
                    except Exception as e:  # noqa: BLE001 — degrade to poll
                        logger.warning(
                            "%s watch unavailable (%s); relying on the "
                            "%.0fs resync", self.CR_KIND, e, poll_interval,
                        )
                        await asyncio.sleep(poll_interval)

            watcher = asyncio.ensure_future(pump())
        try:
            while True:
                # Clear BEFORE the pass: an event arriving mid-pass (which
                # the pass's own LIST may have missed) must trigger the
                # next pass, not wait out a full resync interval.
                wake.clear()
                try:
                    await self.run_pass()
                except asyncio.CancelledError:
                    raise
                except Exception:
                    logger.exception("controller pass failed")
                try:
                    await asyncio.wait_for(wake.wait(), poll_interval)
                except asyncio.TimeoutError:
                    pass  # periodic resync
        finally:
            if watcher is not None:
                watcher.cancel()

    async def sweep_orphans(self, live_names) -> int:
        """Tear down children whose owner CR is gone — scoped to children
        THIS manager created (MANAGER_LABEL); an api-store's deployments in
        the same namespace carry a different manager value and are never
        swept (r4 advisory).  Returns the number of children deleted."""
        orphaned = set()
        for kind in self.CHILD_KINDS:
            for m in await self.kube.list(
                kind, label=(MANAGER_LABEL, self.manager)
            ):
                owner = (m["metadata"].get("labels") or {}).get(OWNER_LABEL)
                if owner is not None and owner not in live_names:
                    orphaned.add(owner)
        count = 0
        for owner in orphaned:
            count += await self.teardown(owner)
        return count

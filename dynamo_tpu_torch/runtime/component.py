"""Distributed component model: Runtime → Namespace → Component → Endpoint.

A copy of the JAX package's ``runtime/component.py``.

Reference semantics: lib/runtime/src/component.rs:16-42 (naming hierarchy),
component/endpoint.rs:376-460 (endpoint registration under a lease),
lib/runtime/src/distributed.rs (DistributedRuntime = runtime + transports).

Registration scheme (hub KV): ``instances/{ns}/{comp}/{ep}/{worker_id}`` →
``{address, path, worker_id, metadata}`` attached to the worker's lease, so a
dead worker's registrations vanish when its lease expires and every watcher
(clients, HTTP frontend model list, KV indexer) observes the delete — the
reference's etcd-lease liveness design (SURVEY §5 failure detection).
"""

from __future__ import annotations

import asyncio
import logging
import uuid
from typing import Any, Callable, Dict, Optional

logger = logging.getLogger(__name__)

from .client import Client, RouterMode
from .engine import AsyncEngine, engine_from_generator
from .transports.hub import HubClient, InprocHub
from .transports.shard import ShardedHubClient, hub_key, hub_prefix, hub_subject
from .transports.service import ServiceServer

INSTANCE_PREFIX = "instances"


def instance_key(ns: str, comp: str, ep: str, worker_id: int) -> str:
    return hub_key(INSTANCE_PREFIX, ns, comp, ep, worker_id)


def instance_prefix(ns: str, comp: Optional[str] = None,
                    ep: Optional[str] = None) -> str:
    """Watch/query prefix under the discovery namespace, at any depth."""
    segments = [INSTANCE_PREFIX, ns]
    if comp is not None:
        segments.append(comp)
        if ep is not None:
            segments.append(ep)
    return hub_prefix(*segments)


def endpoint_path(ns: str, comp: str, ep: str) -> str:
    """The service-plane path an engine is served at (``dyn://ns.comp.ep``)."""
    return f"{ns}.{comp}.{ep}"


def parse_endpoint_path(path: str) -> tuple:
    """Parse ``dyn://ns.comp.ep`` or ``ns.comp.ep`` (reference protocols.rs:49)."""
    if path.startswith("dyn://"):
        path = path[len("dyn://") :]
    parts = path.split(".")
    if len(parts) != 3:
        raise ValueError(f"endpoint path must be ns.component.endpoint, got {path!r}")
    return parts[0], parts[1], parts[2]


class DistributedRuntime:
    """Per-process distributed runtime: hub connection + one service server.

    Construct via ``DistributedRuntime.detached()`` (in-process hub; the
    reference's static mode) or ``DistributedRuntime.connect(address)`` (TCP
    hub).  Every process gets a ``worker_id`` and a primary lease; all
    endpoint registrations default to that lease.
    """

    # 10s tolerates multi-second event-loop stalls (a worker's first
    # graph captures hold the GIL from its device thread); the lease monitor
    # below re-grants and re-registers if a stall still outlives the lease.
    DEFAULT_LEASE_TTL = 10.0

    def __init__(self, hub, host: str = "127.0.0.1", lease_ttl: Optional[float] = None):
        self.hub = hub
        self.worker_id: int = uuid.uuid4().int & ((1 << 63) - 1)
        self.primary_lease: Optional[int] = None
        self.lease_ttl = lease_ttl or self.DEFAULT_LEASE_TTL
        self._host = host
        self._service_server: Optional[ServiceServer] = None
        self._shutdown_event = asyncio.Event()
        # key → value for every primary-lease registration, so a lost lease
        # (event-loop stall > TTL, hub restart) self-heals: re-grant +
        # re-put everything.
        self._registrations: Dict[str, Any] = {}
        self._lease_monitor_task: Optional[asyncio.Task] = None

    @classmethod
    async def detached(cls) -> "DistributedRuntime":
        hub = await InprocHub().start()
        return await cls(hub)._init()

    @classmethod
    async def connect(
        cls,
        address: str,
        host: str = "127.0.0.1",
        lease_ttl: Optional[float] = None,
    ) -> "DistributedRuntime":
        """Connect to the hub control plane.

        ``address`` is one ``host:port`` (a plain ``HubClient`` — byte-
        compatible with every pre-sharding deployment) or a comma-separated
        shard map ``host:port,host:port,...`` (a ``ShardedHubClient``
        routing each key/subject to its owner shard).
        """
        if "," in address:
            hub = await ShardedHubClient(address).connect()
        else:
            hub = await HubClient(address).connect()
        return await cls(hub, host=host, lease_ttl=lease_ttl)._init()

    async def _init(self) -> "DistributedRuntime":
        self.primary_lease = await self.hub.lease_grant(self.lease_ttl)
        self._lease_monitor_task = asyncio.get_running_loop().create_task(
            self._lease_monitor()
        )
        return self

    async def register_key(self, key: str, value: Any) -> None:
        """kv_put under the primary lease, tracked for re-registration."""
        self._registrations[key] = value
        await self.hub.kv_put(key, value, self.primary_lease)

    async def unregister_key(self, key: str) -> None:
        self._registrations.pop(key, None)
        await self.hub.kv_delete(key)

    async def _lease_monitor(self) -> None:
        """Elastic recovery (SURVEY §5 failure detection): if the primary
        lease expired (e.g. a compile stalled the loop past the TTL, or the
        hub itself restarted and lost all lease state), grant a fresh one
        and restore every tracked registration — the worker re-appears to
        watchers instead of staying dead.

        A hub outage must NOT kill this monitor: it is the exact mechanism
        by which a worker rejoins a restarted hub, so connection errors are
        retried on a shortened cadence until shutdown."""
        interval = self.lease_ttl
        while not self._shutdown_event.is_set():
            await asyncio.sleep(interval)
            interval = self.lease_ttl
            if self.primary_lease is None:
                continue
            try:
                alive = await self.hub.lease_keepalive(self.primary_lease)
                if alive:
                    continue
                logger.warning("primary lease lost; re-registering %d keys",
                               len(self._registrations))
                self.primary_lease = await self.hub.lease_grant(self.lease_ttl)
                for key, value in list(self._registrations.items()):
                    await self.hub.kv_put(key, value, self.primary_lease)
            except asyncio.CancelledError:
                return
            except (ConnectionError, RuntimeError, OSError):
                # Hub unreachable or mid-restart: retry soon — the backoff
                # budget for fleet re-registration is this cadence plus the
                # HubClient's own reconnect backoff.
                interval = min(self.lease_ttl, max(self.lease_ttl / 5.0, 0.2))
                logger.warning(
                    "lease monitor: hub unreachable; retrying in %.1fs",
                    interval,
                )

    async def service_server(self) -> ServiceServer:
        if self._service_server is None:
            server = await ServiceServer(host=self._host).start()
            if self._service_server is None:  # re-check: bind awaited above
                self._service_server = server
            else:
                # Lost a concurrent lazy-init race while awaiting the bind:
                # endpoints registered on the duplicate
                # would be invisible to the advertised address — keep the
                # winner, close the spare.
                await server.close()
        return self._service_server

    def namespace(self, name: str) -> "Namespace":
        return Namespace(self, name)

    def shutdown(self) -> None:
        self._shutdown_event.set()

    async def wait_for_shutdown(self) -> None:
        await self._shutdown_event.wait()

    async def close(self) -> None:
        self.shutdown()
        if self._lease_monitor_task is not None:
            self._lease_monitor_task.cancel()
            self._lease_monitor_task = None
        if self._service_server is not None:
            await self._service_server.close()
        if self.primary_lease is not None:
            try:
                # Bounded: revoking against a down/reconnecting hub must not
                # park teardown for the client's whole grace budget — an
                # unrevoked lease just expires by TTL.
                await asyncio.wait_for(
                    self.hub.lease_revoke(self.primary_lease), 2.0
                )
            except (ConnectionError, RuntimeError, asyncio.TimeoutError):
                pass
        await self.hub.close()


class Namespace:
    def __init__(self, runtime: DistributedRuntime, name: str):
        self.runtime = runtime
        self.name = name

    def component(self, name: str) -> "Component":
        return Component(self, name)

    # Event plane scoped to the namespace (reference traits/events.rs:30-79)
    def subject(self, topic: str) -> str:
        return hub_subject(self.name, topic)

    async def publish(self, topic: str, payload: Any) -> None:
        await self.runtime.hub.publish(self.subject(topic), payload)

    async def subscribe(self, topic: str):
        return await self.runtime.hub.subscribe(self.subject(topic))


class Component:
    def __init__(self, namespace: Namespace, name: str):
        self.namespace = namespace
        self.name = name

    @property
    def runtime(self) -> DistributedRuntime:
        return self.namespace.runtime

    def endpoint(self, name: str) -> "Endpoint":
        return Endpoint(self, name)

    def subject(self, topic: str) -> str:
        return hub_subject(self.namespace.name, self.name, topic)

    async def publish(self, topic: str, payload: Any) -> None:
        await self.runtime.hub.publish(self.subject(topic), payload)

    async def subscribe(self, topic: str):
        return await self.runtime.hub.subscribe(self.subject(topic))


class Endpoint:
    def __init__(self, component: Component, name: str):
        self.component = component
        self.name = name

    @property
    def runtime(self) -> DistributedRuntime:
        return self.component.runtime

    @property
    def path(self) -> str:
        return endpoint_path(self.component.namespace.name, self.component.name, self.name)

    def instance_key(self, worker_id: int) -> str:
        return instance_key(
            self.component.namespace.name, self.component.name, self.name, worker_id
        )

    @property
    def instance_prefix(self) -> str:
        return instance_prefix(
            self.component.namespace.name, self.component.name, self.name
        )

    async def serve_endpoint(
        self,
        engine,
        lease: Optional[int] = None,
        metadata: Optional[Dict[str, Any]] = None,
    ) -> "ServedEndpoint":
        """Serve an AsyncEngine (or async-generator handler) at this endpoint.

        Registers the instance in the hub KV under a lease (defaults to the
        process primary lease) and on the process service server.  Reference:
        EndpointConfigBuilder::start, component/endpoint.rs:376-460.
        """
        runtime = self.runtime
        if not isinstance(engine, AsyncEngine):
            engine = engine_from_generator(engine)
        server = await runtime.service_server()
        server.register(self.path, engine)
        info = self._instance_info(server.address, metadata)
        key = self.instance_key(runtime.worker_id)
        if lease is None:
            await runtime.register_key(key, info)  # self-healing registration
        else:
            await runtime.hub.kv_put(key, info, lease)
        return ServedEndpoint(self, server)

    def _instance_info(
        self, address: str, metadata: Optional[Dict[str, Any]]
    ) -> Dict[str, Any]:
        return {
            "address": address,
            "path": self.path,
            "worker_id": self.runtime.worker_id,
            "metadata": metadata or {},
        }

    async def update_metadata(
        self, metadata: Optional[Dict[str, Any]] = None
    ) -> None:
        """Rewrite this worker's live instance registration with new
        metadata (e.g. de-advertising a capability mid-drain), keeping the
        record shape in one place."""
        runtime = self.runtime
        server = await runtime.service_server()
        await runtime.register_key(
            self.instance_key(runtime.worker_id),
            self._instance_info(server.address, metadata),
        )

    async def client(self, router_mode: RouterMode = RouterMode.ROUND_ROBIN) -> Client:
        client = Client(self.runtime.hub, self.instance_prefix, router_mode=router_mode)
        await client.start()
        return client


class ServedEndpoint:
    """Handle for a served endpoint: supports deregistration."""

    def __init__(self, endpoint: Endpoint, server: ServiceServer):
        self.endpoint = endpoint
        self._server = server

    async def stop(self) -> None:
        runtime = self.endpoint.runtime
        self._server.unregister(self.endpoint.path)
        await runtime.unregister_key(self.endpoint.instance_key(runtime.worker_id))

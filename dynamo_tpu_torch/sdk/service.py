"""@service / @dynamo_endpoint / depends() — the SDK's declaration surface.
A copy of the JAX package's ``sdk/service.py``.

Reference semantics: deploy/dynamo/sdk/src/dynamo/sdk/lib/{service,
decorators,dependency}.py — a service is a class whose decorated methods
become distributed endpoints; ``depends(Other)`` declares a graph edge and
resolves, inside a running worker, to a routed client on the dependency's
endpoint.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Type

from ..runtime.client import Client, RouterMode
from ..runtime.component import DistributedRuntime
from ..runtime.engine import Context, ResponseStream


@dataclass
class ServiceMeta:
    name: str
    namespace: str = "dynamo"
    workers: int = 1
    resources: Dict[str, Any] = field(default_factory=dict)  # e.g. {"gpu": 1}
    endpoints: List[str] = field(default_factory=list)
    on_start: List[str] = field(default_factory=list)
    config: Dict[str, Any] = field(default_factory=dict)  # merged YAML/env


def service(
    cls: Optional[Type] = None,
    *,
    namespace: str = "dynamo",
    workers: int = 1,
    resources: Optional[Dict[str, Any]] = None,
):
    """Class decorator: mark a class as a dynamo service."""

    def wrap(klass: Type) -> Type:
        endpoints = [
            name
            for name, member in inspect.getmembers(klass)
            if getattr(member, "_dynamo_endpoint", None)
        ]
        hooks = [
            name
            for name, member in inspect.getmembers(klass)
            if getattr(member, "_dynamo_on_start", False)
        ]
        klass._dynamo_meta = ServiceMeta(
            name=klass.__name__,
            namespace=namespace,
            workers=workers,
            resources=resources or {},
            endpoints=endpoints,
            on_start=hooks,
        )
        return klass

    return wrap(cls) if cls is not None else wrap


def dynamo_endpoint(fn: Optional[Callable] = None, *, name: Optional[str] = None):
    """Method decorator: expose an async-generator method as an endpoint."""

    def wrap(func: Callable) -> Callable:
        func._dynamo_endpoint = name or func.__name__
        return func

    return wrap(fn) if fn is not None else wrap


def async_on_start(fn: Callable) -> Callable:
    """Method decorator: run once after the worker's runtime is up."""
    fn._dynamo_on_start = True
    return fn


class Dependency:
    """A ``depends(Other)`` edge: descriptor that resolves to a client proxy.

    At class-definition time it records the edge (for graph discovery); at
    runtime (after ``resolve``) it proxies generate/direct/round_robin/random
    to a routed Client on the dependency's primary endpoint.
    """

    def __init__(self, target: Type, endpoint: Optional[str] = None):
        self.target = target
        meta: ServiceMeta = target._dynamo_meta
        self.endpoint_name = endpoint or (meta.endpoints[0] if meta.endpoints else "generate")
        self._client: Optional[Client] = None

    async def resolve(self, runtime: DistributedRuntime, router_mode=RouterMode.ROUND_ROBIN) -> None:
        meta: ServiceMeta = self.target._dynamo_meta
        ep = (
            runtime.namespace(meta.namespace)
            .component(meta.name)
            .endpoint(self.endpoint_name)
        )
        self._client = await ep.client(router_mode=router_mode)

    @property
    def client(self) -> Client:
        assert self._client is not None, "dependency not resolved (worker not started?)"
        return self._client

    # Proxy the client verbs (reference: sdk dependency __call__ surface).
    async def generate(self, request: Any, **kw) -> ResponseStream:
        req = request if isinstance(request, Context) else Context(request)
        return await self.client.generate(req, **kw)

    async def direct(self, request: Any, worker_id: int) -> ResponseStream:
        req = request if isinstance(request, Context) else Context(request)
        return await self.client.direct(req, worker_id)

    async def round_robin(self, request: Any) -> ResponseStream:
        req = request if isinstance(request, Context) else Context(request)
        return await self.client.round_robin(req)

    async def random(self, request: Any) -> ResponseStream:
        req = request if isinstance(request, Context) else Context(request)
        return await self.client.random(req)


def depends(target: Type, endpoint: Optional[str] = None) -> Dependency:
    return Dependency(target, endpoint)


class DynamoService:
    """Optional convenience base class giving services typed accessors."""

    _dynamo_meta: ServiceMeta

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        self.config = config or {}

    @classmethod
    def meta(cls) -> ServiceMeta:
        return cls._dynamo_meta


def collect_dependencies(cls: Type) -> Dict[str, Dependency]:
    """Class-level Dependency attributes, keyed by attribute name."""
    return {
        name: member
        for name, member in vars(cls).items()
        if isinstance(member, Dependency)
    }

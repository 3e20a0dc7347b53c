"""Serving SDK: declare component graphs in Python, run them supervised.
A copy of the JAX package's ``sdk/``, with CUDA devices in place of TPU
chips (allocator.py).

Reference semantics (not code): deploy/dynamo/sdk — ``@service`` classes with
``@dynamo_endpoint`` methods, ``depends()`` edges resolved to remote clients,
``link()`` graph composition, YAML per-service config, and a process
supervisor (circus there) that spawns one OS process per service worker and
registers each on the distributed runtime.  Here BentoML is a plain
dataclass service model and circus an asyncio subprocess supervisor.
"""

from .config import ServiceConfigStore, load_service_configs  # noqa: F401
from .graph import Graph, discover_services  # noqa: F401
from .service import (  # noqa: F401
    DynamoService,
    async_on_start,
    depends,
    dynamo_endpoint,
    service,
)

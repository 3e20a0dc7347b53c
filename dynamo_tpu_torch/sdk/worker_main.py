"""Worker entrypoint: one process serving one SDK service instance.  A copy
of the JAX package's ``sdk/worker_main.py``.

Reference semantics: deploy/dynamo/sdk cli/serve_dynamo.py:61-224 — connect
the DistributedRuntime, create the namespace/component, bind every
``@dynamo_endpoint`` method, run ``@async_on_start`` hooks, then serve until
signalled.  Spawned by the supervisor (runner.py) with config passed via the
DYN_SERVICE_CONFIG env var.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal
import sys
from typing import Any

from ..runtime.component import DistributedRuntime
from .config import load_service_configs
from .graph import load_target
from .service import ServiceMeta, collect_dependencies

logger = logging.getLogger(__name__)


async def run_worker(target_spec: str, hub: str) -> None:
    cls = load_target(target_spec)
    meta: ServiceMeta = cls._dynamo_meta
    configs = load_service_configs()
    svc_config = configs.for_service(meta.name)

    runtime = await DistributedRuntime.connect(hub)
    try:
        # Instantiate: pass config when the ctor accepts it.
        try:
            instance = cls(config=svc_config)
        except TypeError:
            instance = cls()
            instance.config = svc_config

        instance.runtime = runtime  # services may use it (queues, kv, ...)

        # Resolve depends() edges (class-level Dependency descriptors).
        for name, dep in collect_dependencies(cls).items():
            await dep.resolve(runtime)
        for name, member in vars(cls).items():
            if name.startswith("_linked_") and hasattr(member, "resolve"):
                await member.resolve(runtime)

        component = runtime.namespace(meta.namespace).component(meta.name)
        for ep_name in meta.endpoints:
            handler = getattr(instance, ep_name)
            await component.endpoint(
                getattr(handler, "_dynamo_endpoint", ep_name)
            ).serve_endpoint(handler)

        for hook_name in meta.on_start:
            await getattr(instance, hook_name)()

        print(f"service {meta.name} up ({len(meta.endpoints)} endpoints)", flush=True)

        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, stop.set)
            except NotImplementedError:
                pass
        await stop.wait()
    finally:
        await runtime.close()


def main(argv: Any = None) -> None:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(prog="python -m dynamo_tpu_torch.sdk.worker_main")
    parser.add_argument("target", help="module:ServiceClass")
    parser.add_argument("--hub", required=True)
    args = parser.parse_args(argv)
    try:
        asyncio.run(run_worker(args.target, args.hub))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    sys.exit(main())

"""Process supervisor: spawn + watch one subprocess per service worker.  A
copy of the JAX package's ``sdk/runner.py`` whose children run the port.

Reference semantics: deploy/dynamo/sdk cli/serving.py:209-330 — circus there
(arbiter + one watcher per service); here an asyncio supervisor with
exponential-backoff restarts, graceful SIGTERM fan-out, and per-worker env
from the GPU allocator.  Also launches the hub (unless --hub given) and,
optionally, the OpenAI HTTP frontend, so ``python -m
dynamo_tpu_torch.sdk.runner dynamo_tpu_torch.examples.llm.graphs:agg -f
cfg.yaml --http-port 8000`` is a one-command deployment like ``dynamo
serve``.
"""

from __future__ import annotations

import asyncio
import logging
import os
import signal
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .allocator import GpuAllocator
from .config import ENV_VAR, ServiceConfigStore
from .graph import discover_services, load_target
from .service import ServiceMeta

logger = logging.getLogger(__name__)


@dataclass
class WorkerProc:
    service: str
    index: int
    argv: List[str]
    env: Dict[str, str]
    proc: Optional[asyncio.subprocess.Process] = None
    restarts: int = 0


class Supervisor:
    MAX_RESTARTS = 5

    def __init__(self) -> None:
        self._workers: List[WorkerProc] = []
        self._stopping = False

    def add(self, service: str, index: int, argv: List[str], env: Dict[str, str]) -> None:
        self._workers.append(WorkerProc(service, index, argv, env))

    async def run(self) -> None:
        for w in self._workers:
            await self._spawn(w)
        watchers = [asyncio.create_task(self._watch(w)) for w in self._workers]

        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, stop.set)
            except NotImplementedError:
                pass
        await stop.wait()
        await self.shutdown()
        for t in watchers:
            t.cancel()

    async def _spawn(self, w: WorkerProc) -> None:
        env = dict(os.environ)
        env.update(w.env)
        w.proc = await asyncio.create_subprocess_exec(*w.argv, env=env)
        logger.info("spawned %s[%d] pid=%d", w.service, w.index, w.proc.pid)

    async def _watch(self, w: WorkerProc) -> None:
        try:
            while not self._stopping:
                assert w.proc is not None
                rc = await w.proc.wait()
                if self._stopping:
                    return
                w.restarts += 1
                if w.restarts > self.MAX_RESTARTS:
                    logger.error(
                        "%s[%d] exited rc=%s too many times; giving up",
                        w.service, w.index, rc,
                    )
                    return
                delay = min(30.0, 0.5 * (2 ** w.restarts))
                logger.warning(
                    "%s[%d] exited rc=%s; restart %d in %.1fs",
                    w.service, w.index, rc, w.restarts, delay,
                )
                await asyncio.sleep(delay)
                await self._spawn(w)
        except asyncio.CancelledError:
            pass

    async def shutdown(self, timeout: float = 10.0) -> None:
        self._stopping = True
        for w in self._workers:
            if w.proc and w.proc.returncode is None:
                w.proc.terminate()
        deadline = asyncio.get_running_loop().time() + timeout
        for w in self._workers:
            if w.proc is None:
                continue
            remaining = max(0.1, deadline - asyncio.get_running_loop().time())
            try:
                await asyncio.wait_for(w.proc.wait(), remaining)
            except asyncio.TimeoutError:
                w.proc.kill()  # reference exits 911 on shutdown timeout


async def _wait_listening(host: str, port: int, proc, timeout: float = 60.0) -> None:
    """Until ``proc`` (the hub) accepts connections on ``host:port``: its
    workers connect once, at start."""
    deadline = asyncio.get_running_loop().time() + timeout
    while True:
        try:
            _, writer = await asyncio.open_connection(host, port)
        except OSError:
            if proc.returncode is not None:
                raise RuntimeError(f"the hub exited with code {proc.returncode}") from None
            if asyncio.get_running_loop().time() > deadline:
                raise RuntimeError(f"the hub is not listening on {host}:{port}") from None
            await asyncio.sleep(0.1)
            continue
        writer.close()
        await writer.wait_closed()
        return


async def serve_graph(
    target_spec: str,
    hub: Optional[str],
    config_file: Optional[str],
    http_port: Optional[int],
    router: str = "round_robin",
) -> None:
    entry = load_target(target_spec)
    services = discover_services(entry)
    configs = ServiceConfigStore.load(config_file)

    hub_proc: Optional[asyncio.subprocess.Process] = None
    if hub is None:
        hub = "127.0.0.1:6650"
        hub_proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "dynamo_tpu_torch.cli", "hub",
            "--host", "127.0.0.1", "--port", "6650",
        )
    try:
        if hub_proc is not None:
            await _wait_listening("127.0.0.1", 6650, hub_proc)
        sup = _plan(services, configs, hub, http_port, router)
        print(
            f"serving graph {target_spec}: "
            + ", ".join(c._dynamo_meta.name for c in services)
            + (f" + OpenAI frontend :{http_port}" if http_port else ""),
            flush=True,
        )
        await sup.run()
    finally:
        if hub_proc is not None and hub_proc.returncode is None:
            hub_proc.terminate()
            await hub_proc.wait()


def _plan(services, configs: ServiceConfigStore, hub: str, http_port: Optional[int],
          router: str) -> Supervisor:
    """One supervised child per service worker (devices from the
    allocator, the merged config in ``DYN_SERVICE_CONFIG``), plus the HTTP
    edge when ``http_port`` is given."""
    allocator = GpuAllocator()
    sup = Supervisor()
    for cls in services:
        meta: ServiceMeta = cls._dynamo_meta
        svc_cfg = configs.for_service(meta.name)
        workers = int(svc_cfg.get("workers", meta.workers))
        module = cls.__module__
        for idx in range(workers):
            alloc = allocator.assign(meta.resources)
            env = dict(alloc.env)
            env[ENV_VAR] = configs.to_env()
            sup.add(
                meta.name,
                idx,
                [
                    sys.executable,
                    "-m",
                    "dynamo_tpu_torch.sdk.worker_main",
                    f"{module}:{cls.__name__}",
                    "--hub",
                    hub,
                ],
                env,
            )

    if http_port is not None:
        sup.add(
            "http-frontend",
            0,
            [
                sys.executable, "-m", "dynamo_tpu_torch.cli", "http",
                "--hub", hub, "--port", str(http_port), "--router", router,
            ],
            {"CUDA_VISIBLE_DEVICES": ""},
        )
    return sup


def main(argv=None) -> None:
    import argparse

    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(prog="python -m dynamo_tpu_torch.sdk.runner")
    parser.add_argument("target", help="module:ServiceClassOrGraph")
    parser.add_argument("-f", "--config", default=None, help="service config YAML")
    parser.add_argument("--hub", default=None, help="existing hub (default: spawn one)")
    parser.add_argument("--http-port", type=int, default=None, help="also run the OpenAI frontend")
    parser.add_argument("--router", default="round_robin", choices=["random", "round_robin", "kv"])
    args = parser.parse_args(argv)
    try:
        asyncio.run(serve_graph(args.target, args.hub, args.config, args.http_port, args.router))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()

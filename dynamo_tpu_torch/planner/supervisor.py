"""Hub-native supervisor: enacts ``planner/targets/*`` for non-kube fleets.  A
copy of the JAX package's ``planner/supervisor.py``.

The planner's ``LocalActuator`` records desired per-pool replica counts in
the hub KV; on Kubernetes the CR reconciler drives pods to match, but a
bare-metal / dev-box deployment had nothing watching those keys (ROADMAP
leftover from PR 3).  ``Supervisor`` closes the loop: it watches
``planner/targets/{pool}``, keeps a ledger of the worker handles it owns
per pool, and calls pluggable ``spawn(pool)`` / ``stop(pool, handle,
drain)`` callables until the ledger matches the target.

Scale-down honours the actuator's ``drain`` hint ("migrate" by default):
``ProcessWorkerPool`` stops a worker with SIGTERM, and a cli worker's own
shutdown path (cli.py ``WorkerRoles.stop_decode``) migrates its live
sequences to a peer before exiting — so shrink cost is KV-transfer time,
not longest-sequence time.  Custom ``stop`` callables can instead drive
``llm.migration.request_migrate_out`` remotely before hard-killing.

Reconciliation is level-triggered (the watch only schedules a pass), so a
burst of target updates converges to the LAST value and a missed event is
repaired by the next poll resync.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Awaitable, Callable, Dict, List, Optional

from .actuate import TARGET_PREFIX

logger = logging.getLogger(__name__)

SpawnFn = Callable[[str], Awaitable[Any]]
StopFn = Callable[[str, Any, str], Awaitable[None]]


class Supervisor:
    def __init__(
        self,
        hub,
        spawn: SpawnFn,
        stop: StopFn,
        pools: Optional[List[str]] = None,
        resync_s: float = 5.0,
    ):
        self.hub = hub
        self._spawn = spawn
        self._stop = stop
        # None = supervise whatever pools appear under planner/targets/.
        self.pools = list(pools) if pools is not None else None
        self.resync_s = resync_s
        self.desired: Dict[str, int] = {}
        self.drain_hint: Dict[str, str] = {}
        self.handles: Dict[str, List[Any]] = {}
        self.spawned = 0
        self.stopped = 0
        self.crashed = 0
        self._dirty = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._watcher = None

    def owned(self, pool: str) -> int:
        return len(self.handles.get(pool, []))

    async def start(self) -> "Supervisor":
        self._watcher = await self.hub.watch_prefix(TARGET_PREFIX)
        self._task = asyncio.get_running_loop().create_task(self._run())
        await self._watcher.synced.wait()
        self._dirty.set()
        return self

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        if self._watcher is not None:
            await self._watcher.aclose()
            self._watcher = None

    async def shutdown_workers(self) -> None:
        """Stop every owned worker (process exit path)."""
        for pool in list(self.handles):
            while self.handles[pool]:
                await self._stop_one(pool)

    # ------------------------------------------------------------- internals

    def _accept(self, pool: str, value: Any) -> None:
        if self.pools is not None and pool not in self.pools:
            return
        if not isinstance(value, dict):
            return
        try:
            self.desired[pool] = max(0, int(value.get("replicas", 0)))
        except (TypeError, ValueError):
            return
        self.drain_hint[pool] = str(value.get("drain", "migrate"))
        self._dirty.set()

    async def _run(self) -> None:
        try:
            consume = asyncio.ensure_future(self._consume_watch())
            while True:
                try:
                    await asyncio.wait_for(
                        self._dirty.wait(), timeout=self.resync_s
                    )
                except asyncio.TimeoutError:
                    # Periodic resync repairs missed/garbled watch events.
                    await self._resync()
                self._dirty.clear()
                try:
                    await self._reconcile()
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 — keep supervising
                    logger.exception("supervisor reconcile failed")
        except asyncio.CancelledError:
            consume.cancel()
            raise

    async def _consume_watch(self) -> None:
        try:
            async for event in self._watcher:
                if event.type != "put":
                    continue
                pool = event.key[len(TARGET_PREFIX):]
                self._accept(pool, event.value)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — resync poll takes over
            logger.exception("supervisor target watch died; relying on resync")

    async def _resync(self) -> None:
        try:
            snapshot = await self.hub.kv_get_prefix(TARGET_PREFIX)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — hub unreachable; retry next tick
            return
        for key, value in snapshot.items():
            self._accept(key[len(TARGET_PREFIX):], value)

    @staticmethod
    def _handle_alive(handle) -> bool:
        """Liveness for process-like handles (Popen needs a poll() to
        refresh returncode); opaque handles count as alive."""
        poll = getattr(handle, "poll", None)
        if callable(poll):
            return poll() is None
        return getattr(handle, "returncode", None) is None

    async def _reconcile(self) -> None:
        for pool, want in sorted(self.desired.items()):
            handles = self.handles.setdefault(pool, [])
            # Crash repair: a worker that exited on its own (OOM, crash)
            # must not keep occupying a ledger slot, or the pool silently
            # runs below target forever.  The periodic resync tick drives
            # this even with no target changes.
            dead = [h for h in handles if not self._handle_alive(h)]
            if dead:
                handles[:] = [h for h in handles if self._handle_alive(h)]
                self.crashed += len(dead)
                logger.warning(
                    "supervisor: %d %s worker(s) died; respawning to %d",
                    len(dead), pool, want,
                )
            while len(handles) < want:
                handle = await self._spawn(pool)
                handles.append(handle)
                self.spawned += 1
                logger.info(
                    "supervisor: spawned %s worker (%d/%d)",
                    pool, len(handles), want,
                )
            while len(handles) > want:
                await self._stop_one(pool)

    async def _stop_one(self, pool: str) -> None:
        handle = self.handles[pool].pop()  # LIFO: newest worker goes first
        drain = self.drain_hint.get(pool, "migrate")
        try:
            await self._stop(pool, handle, drain)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — a stuck worker must not wedge us
            logger.exception("supervisor: stop of a %s worker failed", pool)
        self.stopped += 1
        logger.info(
            "supervisor: stopped %s worker (%d left, drain=%s)",
            pool, len(self.handles[pool]), drain,
        )


class ProcessWorkerPool:
    """Subprocess adapters for the supervisor: one shell command template
    per pool (e.g. ``python -m dynamo_tpu_torch.cli run in=dyn://d.w.g
    out=torch --hub H:P --disagg decode``).  Stop sends SIGTERM and waits — cli
    workers migrate their live sequences out in their own shutdown path —
    then falls back to SIGKILL after ``term_grace_s``."""

    def __init__(self, cmd_templates: Dict[str, str], term_grace_s: float = 15.0):
        self.cmd_templates = dict(cmd_templates)
        self.term_grace_s = term_grace_s

    async def spawn(self, pool: str):
        cmd = self.cmd_templates.get(pool)
        if not cmd:
            raise ValueError(f"no spawn command configured for pool {pool!r}")
        proc = await asyncio.create_subprocess_shell(cmd)
        logger.info("spawned %s worker pid %s: %s", pool, proc.pid, cmd)
        return proc

    async def stop(self, pool: str, proc, drain: str) -> None:
        if proc.returncode is not None:
            return
        proc.terminate()  # worker's own shutdown drains (via migration)
        try:
            await asyncio.wait_for(proc.wait(), timeout=self.term_grace_s)
        except asyncio.TimeoutError:
            logger.warning(
                "%s worker pid %s ignored SIGTERM; killing", pool, proc.pid
            )
            proc.kill()
            await proc.wait()

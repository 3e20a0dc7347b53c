"""Migration coordination: target discovery + drain-via-migration (a copy
of the JAX package's llm/migration/coordinator.py).

The planner (or an operator, or the hub-native supervisor) decides a worker
should shrink away or flip roles; this module turns that decision into a
cheap action.  ``pick_migration_target`` reads the endpoint's instance
registrations from the hub and returns a peer that advertises the
``migrate`` capability in its metadata (cli worker mode writes it);
``drain_via_migration`` moves every live sequence there, falling back to
the classic wait-out drain only when no peer exists.

Scale-down cost therefore becomes O(KV transfer) instead of O(longest
sequence) — the Llumnix argument — and the planner's actuation latency is
bounded by the control loop again.

``request_migrate_out`` is the remote flavour: given a source worker's
instance record it invokes that worker's ``migrate_out`` control endpoint
over the service plane (used by the supervisor before stopping a process
it does not share memory with).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Dict, List, Optional

from ...runtime.client import Client
from ...runtime.engine import Context

logger = logging.getLogger(__name__)


def target_from_instance(info: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Build a migrate-out target record from an instance registration.

    Requires the instance to advertise ``metadata.migrate`` (import/control
    paths) — workers without the migration endpoints cannot receive."""
    meta = info.get("metadata") or {}
    mig = meta.get("migrate")
    if not isinstance(mig, dict) or not info.get("address"):
        return None
    return {
        "worker_id": info.get("worker_id"),
        "address": info["address"],
        "import_path": mig.get("import_path"),
        "generate_path": mig.get("generate_path") or info.get("path"),
        "out_path": mig.get("out_path"),
    }


async def pick_migration_target(
    hub,
    instance_prefix: str,
    self_worker_id: int,
    exclude: frozenset = frozenset(),
) -> Optional[Dict[str, Any]]:
    """A live migration-capable peer under ``instance_prefix`` (lowest
    worker id wins — deterministic, so concurrent drains converge on the
    same receiver and its prefix cache warms fastest).

    Draining workers de-advertise ``metadata.migrate`` before calling this
    (cli WorkerRoles.stop_decode), so concurrent drains do not pick each
    other.  A hub snapshot read before a peer's de-advertise propagates
    can still name it — but the capability is RE-CHECKED AT ACCEPT TIME:
    a draining target's ``MigratableWorker.accepting`` gate refuses the
    migrate-in, the migration aborts or rolls back harmlessly (the source
    stays authoritative), and the next round picks a live receiver."""
    try:
        snapshot = await hub.kv_get_prefix(instance_prefix)
    except asyncio.CancelledError:
        raise
    except Exception:  # noqa: BLE001 — hub unreachable: no target, not fatal
        logger.warning("migration target discovery failed", exc_info=True)
        return None
    candidates: List[Dict[str, Any]] = []
    for info in snapshot.values():
        if not isinstance(info, dict):
            continue
        wid = info.get("worker_id")
        if wid == self_worker_id or wid in exclude:
            continue
        target = target_from_instance(info)
        if target is not None and target.get("import_path"):
            candidates.append(target)
    if not candidates:
        return None
    return min(candidates, key=lambda t: t.get("worker_id") or 0)


async def drain_via_migration(
    worker,
    hub,
    instance_prefix: str,
    self_worker_id: int,
) -> List[str]:
    """Move every live sequence off ``worker`` (a MigratableWorker) onto a
    discovered peer.  Returns the migrated request ids; sequences that
    could not move (no peer, rollback) stay live — the caller's ordinary
    drain covers them, so nothing is ever dropped."""
    target = await pick_migration_target(hub, instance_prefix, self_worker_id)
    if target is None:
        logger.info("drain: no migration-capable peer; falling back to wait-out")
        return []
    moved = await worker.migrate_all(target)
    logger.info(
        "drain: migrated %d sequence(s) to worker %s",
        len(moved), target.get("worker_id"),
    )
    return moved


async def request_migrate_out(
    info: Dict[str, Any],
    target: Dict[str, Any],
    request_id: Optional[str] = None,
) -> Dict[str, Any]:
    """Invoke a remote worker's ``migrate_out`` control endpoint (its
    instance record must advertise ``metadata.migrate.out_path``)."""
    src = target_from_instance(info)
    if src is None or not src.get("out_path"):
        return {"ok": False, "error": "source is not migration-capable"}
    client = Client.static(info["address"], src["out_path"])
    stream = await client.generate(
        Context({"request_id": request_id, "target": target})
    )
    resp: Dict[str, Any] = {"ok": False, "error": "empty migrate_out reply"}
    async for item in stream:
        resp = item
    return resp

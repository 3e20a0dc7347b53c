"""Planner actuation: decisions → cluster mutations.  A copy of the JAX
package's ``planner/actuate.py``.

Two actuators behind one protocol:

- ``KubeActuator`` — patches ``DynamoTpuDeployment`` CR replica counts
  through a duck-typed ``kube`` object (the ``deploy/controller.py``
  ``KubeApi`` / ``FakeKube`` surface: ``list`` and ``apply``); the reconciler then drives the fleet to the new count.
  The planner never touches child Deployments/StatefulSets directly — the CR
  stays the single source of truth, exactly like a human running
  ``kubectl patch``.
- ``LocalActuator`` — for hub-native (non-k8s) deployments: records
  per-pool replica targets in the hub KV (``planner/targets/{pool}``, for
  a process supervisor to enact) and drives role flips by writing
  ``planner/roles/{worker_id}``; a ``RoleFlipWatcher`` running inside the
  worker process watches its own key, drains the current role, and
  switches.

``Planner`` (service.py) owns dry-run: with ``--dry-run`` decisions are
logged and counted but ``apply`` is never called — the decision stream is
byte-identical to a live run over the same signals (the acceptance
property the sim verifies).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Awaitable, Callable, Dict, List, Optional

from ..deploy.controller import GROUP
from ..runtime.transports.shard import hub_key, hub_prefix
from .policy import DECODE, PREFILL, Decision

logger = logging.getLogger(__name__)

ROLE_PREFIX = hub_prefix("planner", "roles")
TARGET_PREFIX = hub_prefix("planner", "targets")
DIRECTIVE_PREFIX = hub_prefix("planner", "directives")
CR_KIND = "DynamoTpuDeployment"


def target_key(pool: str) -> str:
    """Pool replica-target key (shard-map routed: DYN401)."""
    return hub_key("planner", "targets", pool)


def role_key(worker_id: int) -> str:
    """Per-worker role-flip key (shard-map routed: DYN401)."""
    return hub_key("planner", "roles", worker_id)


def directive_key(kind: str) -> str:
    """Autopilot directive slot, one per directive kind — last-writer-wins
    (the autopilot's per-policy cooldowns guarantee a consumer sees each
    directive for many ticks before it can be overwritten).  Shard-map
    routed: DYN401."""
    return hub_key("planner", "directives", kind)


class Actuator:
    """Protocol: apply one decision's actions to the world."""

    async def apply(self, decision: Decision) -> None:
        raise NotImplementedError


class RecordingActuator(Actuator):
    """Test/dry-run double: remembers every applied decision."""

    def __init__(self):
        self.applied: List[Decision] = []

    async def apply(self, decision: Decision) -> None:
        self.applied.append(decision)


# ------------------------------------------------------------------- kube


class KubeActuator(Actuator):
    """Patch CR ``spec.services[*].replicas`` via the KubeApi surface.

    ``service_names`` maps policy pool → CR service name (defaults to the
    renderer's conventional ``prefill``/``decode`` services).  A flip is
    expressed in k8s terms as a replica shuffle: −1 on the donor pool,
    +1 on the receiver — pods are cattle there; the hub-native drain/flip
    path is the LocalActuator's job.
    """

    def __init__(
        self,
        kube,
        cr_name: str,
        service_names: Optional[Dict[str, str]] = None,
    ):
        self.kube = kube
        self.cr_name = cr_name
        self.service_names = service_names or {
            PREFILL: "prefill",
            DECODE: "decode",
        }

    async def _get_cr(self) -> Optional[Dict[str, Any]]:
        for cr in await self.kube.list(CR_KIND):
            if cr["metadata"]["name"] == self.cr_name:
                return cr
        return None

    async def apply(self, decision: Decision) -> None:
        deltas: Dict[str, int] = {}
        targets: Dict[str, int] = {}
        for action in decision.actions:
            if action.kind in ("scale_prefill", "scale_decode"):
                targets[action.pool] = action.target
            elif action.kind == "flip_role":
                donor = DECODE if action.pool == PREFILL else PREFILL
                deltas[action.pool] = deltas.get(action.pool, 0) + 1
                deltas[donor] = deltas.get(donor, 0) - 1
        if not targets and not deltas:
            return
        cr = await self._get_cr()
        if cr is None:
            logger.warning("KubeActuator: CR %s not found", self.cr_name)
            return
        services = cr.setdefault("spec", {}).setdefault("services", {})
        changed = False
        for pool, target in targets.items():
            svc = self.service_names.get(pool, pool)
            if svc not in services:
                logger.warning(
                    "KubeActuator: CR %s has no service %r", self.cr_name, svc
                )
                continue
            if int(services[svc].get("replicas", 1)) != target:
                services[svc]["replicas"] = target
                changed = True
        for pool, delta in deltas.items():
            svc = self.service_names.get(pool, pool)
            if svc not in services:
                continue
            new = max(0, int(services[svc].get("replicas", 1)) + delta)
            services[svc]["replicas"] = new
            changed = True
        if not changed:
            return
        manifest = {
            "apiVersion": f"{GROUP}/v1alpha1",
            "kind": CR_KIND,
            "metadata": {"name": self.cr_name},
            "spec": cr["spec"],
        }
        # FakeKube stores whole manifests by (kind, name); KubeApi uses
        # server-side apply — both are idempotent under this patch shape.
        if cr["metadata"].get("namespace"):
            manifest["metadata"]["namespace"] = cr["metadata"]["namespace"]
        await self.kube.apply(manifest)
        logger.info(
            "KubeActuator: patched CR %s replicas (tick %d): %s",
            self.cr_name,
            decision.tick,
            {**targets, **{f"{k}{d:+d}": "" for k, d in deltas.items()}},
        )


# ------------------------------------------------------------------ local


class LocalActuator(Actuator):
    """Hub-native actuation: targets to KV, role flips to per-worker keys."""

    def __init__(self, hub):
        self.hub = hub

    async def apply(self, decision: Decision) -> None:
        for action in decision.actions:
            if action.kind in ("scale_prefill", "scale_decode"):
                await self.hub.kv_put(
                    target_key(action.pool),
                    {
                        "replicas": action.target,
                        "tick": decision.tick,
                        "reason": action.reason,
                        # Scale-down actuation hint for the supervisor
                        # (planner/supervisor.py): migrate live sequences
                        # off the victim before stopping it, so shrink cost
                        # is KV-transfer time, not sequence time
                        # (llm/migration; Llumnix).
                        "drain": "migrate",
                    },
                )
            elif action.kind == "flip_role":
                await self.hub.kv_put(
                    role_key(action.worker_id),
                    {
                        "role": action.pool,
                        "tick": decision.tick,
                        "reason": action.reason,
                    },
                )
            elif action.kind in (
                "kv_prefetch",
                "set_tier_weights",
                "migrate_out",
                "tune_decode",
            ):
                # Autopilot directives (planner/autopilot.py).  The
                # router's PlannerDirectiveWatcher enacts kv_prefetch and
                # set_tier_weights; migrate_out names a victim for the
                # supervisor/operator; tune_decode is a sweep
                # recommendation (also on the planner's /state surface).
                body: Dict[str, Any] = {
                    "kind": action.kind,
                    "tick": decision.tick,
                    "reason": action.reason,
                    "params": dict(action.params or {}),
                }
                if action.worker_id is not None:
                    body["worker_id"] = action.worker_id
                await self.hub.kv_put(directive_key(action.kind), body)


class RoleFlipWatcher:
    """Worker-side half of the flip protocol.

    Watches ``planner/roles/{worker_id}``; on a put naming a role other
    than the current one, runs the drain hook for the current role, then
    the switch hook for the new one, then acks by rewriting the key with
    ``acked: true`` (the planner and operators can observe completion).

    Hooks are plain async callables so the worker process decides what a
    flip means for it (cli.py wires decode→prefill: stop serving the
    decode endpoint, drain pending transfers, start a PrefillWorkerLoop).
    """

    def __init__(
        self,
        hub,
        worker_id: int,
        current_role: str,
        drain: Dict[str, Callable[[], Awaitable[None]]],
        switch: Dict[str, Callable[[], Awaitable[None]]],
    ):
        self.hub = hub
        self.worker_id = worker_id
        self.role = current_role
        self._drain = drain
        self._switch = switch
        self.flips = 0
        self._task: Optional[asyncio.Task] = None
        self._watcher = None

    @property
    def key(self) -> str:
        return role_key(self.worker_id)

    async def start(self) -> "RoleFlipWatcher":
        self._watcher = await self.hub.watch_prefix(self.key)
        self._task = asyncio.get_running_loop().create_task(self._run())
        await self._watcher.synced.wait()
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

    async def _run(self) -> None:
        try:
            async for event in self._watcher:
                if event.type != "put" or not isinstance(event.value, dict):
                    continue
                want = event.value.get("role")
                if not want or want == self.role or event.value.get("acked"):
                    continue
                await self._flip(want, event.value)
        except asyncio.CancelledError:
            pass

    async def _flip(self, want: str, request: Dict[str, Any]) -> None:
        old = self.role
        switch = self._switch.get(want)
        if switch is None:
            # No way to BECOME the requested role: refuse (no state
            # change, no ack) rather than lie about having flipped — the
            # planner keeps seeing the old role and can re-plan.
            logger.warning(
                "worker %d cannot flip %s→%s: no switch hook",
                self.worker_id, old, want,
            )
            return
        try:
            drain = self._drain.get(old)
            if drain is not None:
                await drain()
            await switch()
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — failed flip must not kill worker
            logger.exception(
                "role flip %s→%s failed on worker %d", old, want, self.worker_id
            )
            return
        self.role = want
        self.flips += 1
        logger.info("worker %d flipped %s→%s", self.worker_id, old, want)
        try:
            await self.hub.kv_put(
                self.key, {**request, "acked": True, "from": old}
            )
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — ack is best-effort
            logger.warning("role flip ack write failed")

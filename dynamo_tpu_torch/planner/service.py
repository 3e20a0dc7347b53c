"""The Planner runtime component: collector → policy → actuator tick loop.  A
copy of the JAX package's ``planner/service.py`` that serves ``/metrics``
and ``/state`` on the standard library's asyncio streams
(llm/http_service.py ``RouteServer``) instead of aiohttp, with the same
bodies.

``Planner`` glues a ``SignalCollector`` to a ``DecisionEngine`` and an
``Actuator`` on a fixed tick interval, exposes its decisions/state on a
``/metrics`` + ``/state`` HTTP endpoint, and owns the ``--dry-run``
switch: in dry-run every decision is computed, logged, and counted
exactly as live — the actuator is simply never invoked.

Run it as a standalone component (``python -m dynamo_tpu_torch.planner
run --hub …``), or embed it.
"""

from __future__ import annotations

import asyncio
import logging
from typing import List, Optional

from .actuate import Actuator
from .pmetrics import autopilot_metrics
from .pmetrics import metrics as planner_metrics
from .policy import Decision, DecisionEngine
from .signals import SignalCollector

logger = logging.getLogger(__name__)


class Planner:
    """Tick loop: snapshot → decide → (maybe) actuate.

    ``engine`` is anything with ``decide(snapshot) -> Decision`` and
    ``state() -> dict`` — a bare ``DecisionEngine`` or an ``Autopilot``
    (planner/autopilot.py) wrapping one."""

    def __init__(
        self,
        collector: SignalCollector,
        engine: DecisionEngine,
        actuator: Optional[Actuator] = None,
        interval_s: float = 2.0,
        dry_run: bool = False,
        history: int = 256,
    ):
        self.collector = collector
        self.engine = engine
        self.actuator = actuator
        self.interval_s = interval_s
        self.dry_run = dry_run
        self.decisions: List[Decision] = []
        self._history = history
        self._task: Optional[asyncio.Task] = None

    async def tick(self) -> Decision:
        snap = await self.collector.snapshot()
        decision = self.engine.decide(snap)
        self.decisions.append(decision)
        if len(self.decisions) > self._history:
            del self.decisions[: -self._history]
        planner_metrics.record_decision(decision)
        if decision.is_noop:
            return decision
        logger.info(
            "planner tick %d: %s (pressures %s)%s",
            decision.tick,
            [a.to_dict() for a in decision.actions],
            {k: round(v, 3) for k, v in decision.pressures.items()},
            " [dry-run: not actuated]" if self.dry_run else "",
        )
        if self.dry_run:
            planner_metrics.dry_run_suppressed_total += len(decision.actions)
        elif self.actuator is not None:
            try:
                await self.actuator.apply(decision)
                planner_metrics.actuations_total += 1
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — actuation failure must not kill the loop
                logger.exception("actuation failed for tick %d", decision.tick)
        return decision

    async def start(self) -> "Planner":
        self._task = asyncio.get_running_loop().create_task(self._run())
        return self

    async def _run(self) -> None:
        try:
            while True:
                await self.tick()
                await asyncio.sleep(self.interval_s)
        except asyncio.CancelledError:
            pass
        except Exception:  # noqa: BLE001 — crash visible, loop ends
            logger.exception("planner loop crashed")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None


class PlannerHttp:
    """Planner decisions/state appended to a /metrics endpoint (plus a
    JSON /state view) — same exposition style as the metrics aggregator."""

    def __init__(self, planner: Planner, host: str = "0.0.0.0", port: int = 9092):
        self.planner = planner
        self.host = host
        self.port = port
        self._server = None

    async def start(self) -> "PlannerHttp":
        from ..llm.http_service import RouteServer

        self._server = await RouteServer(
            {"/metrics": self._metrics, "/state": self._state}, self.host, self.port
        ).start()
        self.port = self._server.port  # resolve port 0
        return self

    async def stop(self) -> None:
        if self._server is not None:
            await self._server.close()
            self._server = None

    def _metrics(self):
        from ..llm.http_service import _text_response

        return _text_response(200, planner_metrics.render() + autopilot_metrics.render())

    def _state(self):
        from ..llm.http_service import _json_response

        state = planner_metrics.state()
        state["engine"] = self.planner.engine.state()
        state["dry_run"] = self.planner.dry_run
        return _json_response(state)

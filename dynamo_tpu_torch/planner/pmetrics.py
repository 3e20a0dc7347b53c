"""Planner observability: decisions/state as Prometheus text.  A copy of the
JAX package's ``planner/pmetrics.py``.

Module-level singleton in the style of ``runtime/resilience.py`` — any
``/metrics`` endpoint in the same process (HTTP edge, the planner's own
server) appends ``metrics.render()`` to its exposition output, so planner
decisions and pool targets are scrapeable wherever the planner runs.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

from ..labels import escape_label


class PlannerMetrics:
    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.ticks_total = 0
        self.decisions_total: Dict[str, int] = {}
        self.actuations_total = 0
        self.dry_run_suppressed_total = 0
        self.pool_targets: Dict[str, int] = {}
        self.pressures: Dict[str, float] = {}
        self.last_decision: Optional[Dict[str, Any]] = None

    def record_decision(self, decision) -> None:
        self.ticks_total += 1
        for action in decision.actions:
            self.decisions_total[action.kind] = (
                self.decisions_total.get(action.kind, 0) + 1
            )
            if action.kind in ("scale_prefill", "scale_decode"):
                self.pool_targets[action.pool] = action.target
        self.pressures = dict(decision.pressures)
        self.last_decision = decision.to_dict()

    def render(self, prefix: str = "dynamo_tpu") -> str:
        ns = f"{prefix}_planner"
        lines = []

        def emit(name: str, help_: str, kind: str) -> None:
            lines.append(f"# HELP {ns}_{name} {help_}")
            lines.append(f"# TYPE {ns}_{name} {kind}")

        emit("ticks_total", "Planner ticks evaluated", "counter")
        lines.append(f"{ns}_ticks_total {self.ticks_total}")
        emit("decisions_total", "Decisions by action kind", "counter")
        for kind, n in sorted(self.decisions_total.items()):
            lines.append(f'{ns}_decisions_total{{kind="{escape_label(kind)}"}} {n}')
        emit("actuations_total", "Actuator calls issued", "counter")
        lines.append(f"{ns}_actuations_total {self.actuations_total}")
        emit(
            "dry_run_suppressed_total",
            "Actions logged but not actuated (dry-run)",
            "counter",
        )
        lines.append(
            f"{ns}_dry_run_suppressed_total {self.dry_run_suppressed_total}"
        )
        emit("pool_target", "Most recent per-pool replica target", "gauge")
        for pool, target in sorted(self.pool_targets.items()):
            lines.append(f'{ns}_pool_target{{pool="{escape_label(pool)}"}} {target}')
        emit("pressure", "Per-pool pressure ratio (1.0 = at SLO)", "gauge")
        for pool, p in sorted(self.pressures.items()):
            lines.append(f'{ns}_pressure{{pool="{escape_label(pool)}"}} {p:.4f}')
        return "\n".join(lines) + "\n"

    def state(self) -> Dict[str, Any]:
        return {
            "ticks": self.ticks_total,
            "decisions": dict(self.decisions_total),
            "actuations": self.actuations_total,
            "pool_targets": dict(self.pool_targets),
            "pressures": dict(self.pressures),
            "last_decision": self.last_decision,
        }

    def state_json(self) -> str:
        return json.dumps(self.state())


metrics = PlannerMetrics()


class AutopilotMetrics:
    """Autopilot policy observability (planner/autopilot.py): per-policy
    decision/suppression/cooldown-skip counters — same module-singleton
    pattern as ``PlannerMetrics``, rendered as ``dynamo_tpu_autopilot_*``
    and appended to the planner's ``/metrics``."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        # policy name → count; policies register lazily on first event so
        # the label set stays exactly the autopilot's policy catalog.
        self.decisions_total: Dict[str, int] = {}
        self.suppressions_total: Dict[str, int] = {}
        self.cooldown_skips_total: Dict[str, int] = {}

    def record_decision(self, policy: str) -> None:
        self.decisions_total[policy] = self.decisions_total.get(policy, 0) + 1

    def record_suppression(self, policy: str) -> None:
        self.suppressions_total[policy] = (
            self.suppressions_total.get(policy, 0) + 1
        )

    def record_cooldown_skip(self, policy: str) -> None:
        self.cooldown_skips_total[policy] = (
            self.cooldown_skips_total.get(policy, 0) + 1
        )

    def render(self, prefix: str = "dynamo_tpu") -> str:
        ns = f"{prefix}_autopilot"
        lines = []

        def emit(name: str, help_: str, values: Dict[str, int]) -> None:
            lines.append(f"# HELP {ns}_{name} {help_}")
            lines.append(f"# TYPE {ns}_{name} counter")
            for policy, n in sorted(values.items()):
                lines.append(
                    f'{ns}_{name}{{policy="{escape_label(policy)}"}} {n}'
                )

        emit("decisions_total",
             "Autopilot actions emitted, by policy", self.decisions_total)
        emit("suppressions_total",
             "Engine actions deferred/suppressed by a policy (e.g. decode "
             "scale-up held during prefix warming)", self.suppressions_total)
        emit("cooldown_skips_total",
             "Confirmed policy triggers skipped because the policy was "
             "cooling down", self.cooldown_skips_total)
        return "\n".join(lines) + "\n"

    def state(self) -> Dict[str, Any]:
        return {
            "decisions": dict(self.decisions_total),
            "suppressions": dict(self.suppressions_total),
            "cooldown_skips": dict(self.cooldown_skips_total),
        }


autopilot_metrics = AutopilotMetrics()

"""SLA-driven planner: autoscaling & prefill/decode rebalancing.  A copy of
the JAX package's ``planner/``.

Four parts (docs/planner.md):
- signals  — ``SignalCollector``: windowed, per-pool views of the
             metrics/hit-rate/edge-SLO topics with staleness eviction.
- policy   — ``DecisionEngine``: pure, deterministic mapping from signal
             windows + SLO targets to scale/flip actions with hysteresis
             bands, cooldowns, and min/max bounds.
- actuate  — ``KubeActuator`` (CR replica patches through the existing
             reconciler path) and ``LocalActuator`` (+``RoleFlipWatcher``)
             for hub-native drain/role-flip; both behind ``--dry-run``.
- sim      — a deterministic discrete-time fleet simulator driven by
             seedable arrival traces; every policy is unit-testable and a
             sim smoke runs in tier-1 with no accelerator.

Runnable: ``python -m dynamo_tpu_torch.planner run --hub …`` / ``… sim``.
"""

from .actuate import KubeActuator, LocalActuator, RecordingActuator, RoleFlipWatcher
from .pmetrics import metrics as planner_metrics
from .policy import (
    Action,
    Decision,
    DecisionEngine,
    PolicyConfig,
    SloTargets,
)
from .service import Planner, PlannerHttp
from .signals import (
    EdgeSloPublisher,
    PoolStats,
    SignalCollector,
    SignalSnapshot,
    StalenessTracker,
)

__all__ = [
    "Action",
    "Decision",
    "DecisionEngine",
    "EdgeSloPublisher",
    "KubeActuator",
    "LocalActuator",
    "Planner",
    "PlannerHttp",
    "PolicyConfig",
    "PoolStats",
    "RecordingActuator",
    "RoleFlipWatcher",
    "SignalCollector",
    "SignalSnapshot",
    "SloTargets",
    "StalenessTracker",
    "planner_metrics",
]

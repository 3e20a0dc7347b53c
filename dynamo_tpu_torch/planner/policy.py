"""Planner policy: signal windows + SLO targets → scaling actions.  A copy of
the JAX package's ``planner/policy.py``.

Reference semantics: the Dynamo Planner closes the loop between the metrics
plane and the worker fleet — watching queue depth and KV pressure and
rescaling the prefill vs decode pools.  The policy core here follows
DistServe (OSDI'24): goodput under TTFT/TPOT SLOs hinges on the
prefill:decode resource ratio tracking load, and Llumnix (OSDI'24):
reactive rescheduling needs hysteresis bands + cooldowns or the controller
oscillates.

``DecisionEngine`` is PURE and deterministic: it consumes a sequence of
``SignalSnapshot``s (planner/signals.py) and emits ``Decision``s.  All
state is explicit (breach streaks, cooldown counters), there is no clock
and no I/O — the same snapshot sequence always yields the same decision
sequence, which is what makes the sim harness (planner/sim.py) able to
unit-test every policy path with no accelerator and no wall time.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .signals import PoolStats, SignalSnapshot

PREFILL = "prefill"
DECODE = "decode"


@dataclass(frozen=True)
class SloTargets:
    """The operator's service-level objectives (config section ``planner``)."""

    ttft_p95_ms: float = 2000.0
    itl_p95_ms: float = 100.0
    # Fraction of decode-pool KV that must stay free; usage beyond
    # (1 - headroom) is scale-up pressure even when latency still holds
    # (KV exhaustion hits as preemption storms, after it is too late).
    kv_headroom: float = 0.15

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SloTargets":
        return cls(
            ttft_p95_ms=float(d.get("ttft_p95_ms", cls.ttft_p95_ms)),
            itl_p95_ms=float(d.get("itl_p95_ms", cls.itl_p95_ms)),
            kv_headroom=float(d.get("kv_headroom", cls.kv_headroom)),
        )


@dataclass(frozen=True)
class PolicyConfig:
    """Bounds + hysteresis shape (Llumnix: bands and cooldowns, not a
    bang-bang threshold)."""

    min_prefill: int = 1
    max_prefill: int = 8
    min_decode: int = 1
    max_decode: int = 8
    scale_step: int = 1
    # Hysteresis band around pressure 1.0 (= exactly at target): act only
    # above 1 + band_up / below 1 - band_down.  band_down is deliberately
    # wider — scaling down too eagerly is the classic oscillation driver.
    band_up: float = 0.15
    band_down: float = 0.40
    # Consecutive breaching ticks required before acting (debounce).
    confirm_up_ticks: int = 2
    confirm_down_ticks: int = 5
    # Ticks a pool stays quiet after any action on it.
    cooldown_ticks: int = 5
    # Prefill queue depth per prefill worker considered "at target".
    queue_high_per_worker: float = 4.0
    # Scale-down guard: latency signals are binary (SLO met / violated),
    # so a well-provisioned pool ALWAYS reads "cold" — shrinking on that
    # alone re-violates the SLO and oscillates.  A pool only shrinks when
    # the remaining workers would still sit under this utilization.
    down_util_guard: float = 0.85
    # Allow role flips when one pool is at its bound and the other is cold.
    flip_enabled: bool = True

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PolicyConfig":
        kw = {f: d[f] for f in cls.__dataclass_fields__ if f in d}
        return cls(**kw)


# ---------------------------------------------------------------- actions


@dataclass(frozen=True)
class Action:
    kind: str  # scale_prefill | scale_decode | flip_role | noop
    # ... plus the autopilot kinds (planner/autopilot.py): kv_prefetch |
    # set_tier_weights | migrate_out | tune_decode
    pool: str = ""
    delta: int = 0
    target: int = 0
    worker_id: Optional[int] = None  # flip_role / migrate_out
    reason: str = ""
    # Kind-specific payload for the autopilot kinds (warming top-N, the
    # measured tier-weight table, the retune sweep recommendation) —
    # omitted from the wire when absent, like every optional wire field.
    params: Optional[Dict[str, Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        d = {"kind": self.kind, "reason": self.reason}
        if self.kind in ("scale_prefill", "scale_decode"):
            d.update(pool=self.pool, delta=self.delta, target=self.target)
        if self.kind == "flip_role":
            d.update(worker_id=self.worker_id, to_pool=self.pool)
        if self.kind == "migrate_out":
            d.update(worker_id=self.worker_id)
        if self.params is not None:
            d["params"] = dict(self.params)
        return d


def scale_prefill(delta: int, target: int, reason: str = "") -> Action:
    return Action("scale_prefill", PREFILL, delta, target, reason=reason)


def scale_decode(delta: int, target: int, reason: str = "") -> Action:
    return Action("scale_decode", DECODE, delta, target, reason=reason)


def flip_role(worker_id: int, to_pool: str, reason: str = "") -> Action:
    return Action("flip_role", to_pool, worker_id=worker_id, reason=reason)


def noop(reason: str = "") -> Action:
    return Action("noop", reason=reason)


@dataclass
class Decision:
    """One planner tick's output: the actions plus why (for /metrics,
    logs, and the dry-run transcript)."""

    tick: int
    actions: List[Action]
    pressures: Dict[str, float]
    signals: Dict[str, Any] = field(default_factory=dict)

    @property
    def is_noop(self) -> bool:
        return all(a.kind == "noop" for a in self.actions)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "tick": self.tick,
            "actions": [a.to_dict() for a in self.actions],
            "pressures": {k: round(v, 4) for k, v in self.pressures.items()},
            "signals": self.signals,
        }


# ---------------------------------------------------------------- engine


class DecisionEngine:
    """Maps signal windows + SLO targets to actions, with hysteresis.

    Per pool, pressure is a dimensionless ratio (1.0 = exactly at target):

      prefill:  max( ttft_p95 / slo.ttft_p95,
                     queue_depth / (queue_high_per_worker * n_prefill) )
      decode:   max( itl_p95 / slo.itl_p95,
                     kv_usage / (1 - slo.kv_headroom),
                     waiting / (queue_high_per_worker * n_decode) )

    An action fires only when pressure stays outside the hysteresis band
    for ``confirm_*_ticks`` consecutive ticks AND the pool's cooldown has
    expired; inside the band both streaks reset — a signal oscillating
    within the band produces zero actions by construction.
    """

    def __init__(
        self,
        slo: Optional[SloTargets] = None,
        config: Optional[PolicyConfig] = None,
    ):
        self.slo = slo or SloTargets()
        self.config = config or PolicyConfig()
        self.tick = 0
        self._up_streak: Dict[str, int] = {PREFILL: 0, DECODE: 0}
        self._down_streak: Dict[str, int] = {PREFILL: 0, DECODE: 0}
        self._cooldown: Dict[str, int] = {PREFILL: 0, DECODE: 0}

    # -- pressures ---------------------------------------------------------

    def prefill_pressure(self, snap: SignalSnapshot) -> float:
        pool = snap.pool(PREFILL)
        n = max(1, pool.size)
        ratios = [
            snap.prefill_queue_depth / (self.config.queue_high_per_worker * n)
        ]
        if snap.ttft_p95_ms is not None and self.slo.ttft_p95_ms > 0:
            ratios.append(snap.ttft_p95_ms / self.slo.ttft_p95_ms)
        return max(ratios)

    def decode_pressure(self, snap: SignalSnapshot) -> float:
        pool = snap.pool(DECODE)
        n = max(1, pool.size)
        ratios = [
            pool.kv_usage / max(1e-9, 1.0 - self.slo.kv_headroom),
            pool.queue_depth / (self.config.queue_high_per_worker * n),
        ]
        if snap.itl_p95_ms is not None and self.slo.itl_p95_ms > 0:
            ratios.append(snap.itl_p95_ms / self.slo.itl_p95_ms)
        return max(ratios)

    # -- decision ----------------------------------------------------------

    def decide(self, snap: SignalSnapshot) -> Decision:
        self.tick += 1
        cfg = self.config
        pressures = {
            PREFILL: self.prefill_pressure(snap),
            DECODE: self.decode_pressure(snap),
        }
        wants: Dict[str, int] = {}  # pool → +1 (up) / -1 (down) / 0
        for pool_name in (PREFILL, DECODE):
            if self._cooldown[pool_name] > 0:
                self._cooldown[pool_name] -= 1
            wants[pool_name] = self._update_streaks(
                pool_name, pressures[pool_name]
            )

        actions: List[Action] = []
        for pool_name in (PREFILL, DECODE):
            want = wants[pool_name]
            if want == 0:
                continue
            if self._cooldown[pool_name] > 0:
                continue  # confirmed breach, but the pool is in cooldown
            action = self._act(pool_name, want, snap, pressures)
            if action is not None:
                actions.append(action)
                # Any action (including a flip) quiets BOTH affected pools.
                self._cooldown[pool_name] = cfg.cooldown_ticks
                self._up_streak[pool_name] = 0
                self._down_streak[pool_name] = 0
                if action.kind == "flip_role":
                    other = DECODE if pool_name == PREFILL else PREFILL
                    self._cooldown[other] = cfg.cooldown_ticks
                    self._up_streak[other] = 0
                    self._down_streak[other] = 0

        if not actions:
            reason = "in-band" if max(pressures.values()) <= 1 + cfg.band_up \
                else "cooldown-or-unconfirmed"
            actions = [noop(reason)]
        return Decision(
            tick=self.tick,
            actions=actions,
            pressures=pressures,
            signals={
                "prefill_workers": snap.pool(PREFILL).size,
                "decode_workers": snap.pool(DECODE).size,
                "prefill_queue": snap.prefill_queue_depth,
                "ttft_p95_ms": snap.ttft_p95_ms,
                "itl_p95_ms": snap.itl_p95_ms,
                "kv_usage": round(snap.pool(DECODE).kv_usage, 4),
            },
        )

    def _update_streaks(self, pool: str, pressure: float) -> int:
        """Advance hysteresis streaks; returns the CONFIRMED direction."""
        cfg = self.config
        if pressure >= 1.0 + cfg.band_up:
            self._up_streak[pool] += 1
            self._down_streak[pool] = 0
        elif pressure <= 1.0 - cfg.band_down:
            self._down_streak[pool] += 1
            self._up_streak[pool] = 0
        else:  # inside the band: full reset — oscillation absorbed here
            self._up_streak[pool] = 0
            self._down_streak[pool] = 0
        if self._up_streak[pool] >= cfg.confirm_up_ticks:
            return +1
        if self._down_streak[pool] >= cfg.confirm_down_ticks:
            return -1
        return 0

    def _bounds(self, pool: str) -> Tuple[int, int]:
        cfg = self.config
        return (
            (cfg.min_prefill, cfg.max_prefill)
            if pool == PREFILL
            else (cfg.min_decode, cfg.max_decode)
        )

    def _act(
        self,
        pool: str,
        want: int,
        snap: SignalSnapshot,
        pressures: Dict[str, float],
    ) -> Optional[Action]:
        cfg = self.config
        lo, hi = self._bounds(pool)
        stats = snap.pool(pool)
        size = stats.size
        if want < 0 and size > lo and stats.total_slots > 0:
            util = stats.active_slots / stats.total_slots
            survivors = max(1, size - cfg.scale_step)
            if util * size / survivors > cfg.down_util_guard:
                return None  # remaining pool couldn't absorb current load
        target = max(lo, min(hi, size + want * cfg.scale_step))
        maker = scale_prefill if pool == PREFILL else scale_decode
        # The emitted action must AGREE with the confirmed direction: a
        # pool sitting above max (a flip pushed it there) with up-pressure
        # must not "clamp down" to the bound — that would shrink an
        # overloaded pool and oscillate forever against the next flip.
        if (want > 0 and target > size) or (want < 0 and target < size):
            return maker(
                target - size,
                target,
                reason=f"{pool} pressure {pressures[pool]:.2f} "
                f"{'above' if want > 0 else 'below'} band",
            )
        # At a bound.  Scale-up blocked at max: steal a worker from the
        # other pool when it is provably cold (DistServe ratio rebalance).
        if want > 0 and cfg.flip_enabled:
            other = DECODE if pool == PREFILL else PREFILL
            other_lo, _ = self._bounds(other)
            other_pool = snap.pool(other)
            if (
                other_pool.size > other_lo
                and pressures[other] <= 1.0 - cfg.band_down
                # Donor untouched this tick: a decision must never carry
                # both a scale action and a flip on the same pool (the
                # actuators would compound them differently).
                and self._cooldown[other] == 0
            ):
                victim = other_pool.coldest_worker()
                if victim is not None:
                    return flip_role(
                        victim,
                        pool,
                        reason=f"{pool} at max ({hi}) and {other} cold "
                        f"({pressures[other]:.2f})",
                    )
        return None

    # -- introspection -----------------------------------------------------

    def state(self) -> Dict[str, Any]:
        return {
            "tick": self.tick,
            "up_streak": dict(self._up_streak),
            "down_streak": dict(self._down_streak),
            "cooldown": dict(self._cooldown),
        }


__all__ = [
    "Action",
    "Decision",
    "DecisionEngine",
    "PolicyConfig",
    "PoolStats",
    "SloTargets",
    "flip_role",
    "noop",
    "scale_decode",
    "scale_prefill",
]

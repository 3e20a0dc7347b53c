"""SLO autopilot: trace-informed policies layered above the DecisionEngine.
A copy of the JAX package's ``planner/autopilot.py``.

The ``DecisionEngine`` (planner/policy.py) answers one question — how many
replicas per pool — from aggregate pressure ratios.  The autopilot adds
four policies that act on the RICHER signal planes the fleet already
publishes (docs/autopilot.md has the catalog and the signal→action table):

1. **Prefix warming before scaling** (``prefix_warming``): a sagging
   ``fleet_prefix_hit_rate`` means TTFT/KV pressure is cold-prefix
   pressure, not compute pressure.  Issue a ``kv_prefetch`` directive
   (promote + persist the hottest chains) and HOLD decode scale-ups for a
   grace window — warming is cheaper than a replica, and scaling first
   both wastes the replica and delays the warm.
2. **Measured-latency routing** (``measured_routing``): replace the static
   ``DEFAULT_TIER_WEIGHTS`` cost table in the KV router with weights
   derived from EWMA-smoothed measured restore/pull percentiles
   (``SignalSnapshot.restore_pct``), emitted as a ``set_tier_weights``
   directive.  The static table remains the cold-start fallback.
3. **Trace-identified migration victims** (``victim_migration``): pick
   ``migrate_out`` candidates from SUSTAINED per-worker p95 outliers in
   the per-hop latency view, instead of coldest-id.
4. **Drift-triggered retune** (``drift_retune``): when the fused-decode
   host-gap fraction (``SignalSnapshot.host_gap``) drifts out of band for
   N windows, emit a ``tune_decode`` sweep recommendation on the planner
   state surface.

Every policy is hysteresis/cooldown-damped (the Llumnix discipline the
DecisionEngine already follows: confirm streaks before acting, then go
quiet) and PURE — all state is explicit counters/EWMAs, no clock, no I/O —
so the same snapshot sequence always yields the same decision sequence and
the sim harness (planner/sim.py ``autopilot_smoke``) replays it exactly.

``Autopilot`` wraps a ``DecisionEngine`` and exposes the same
``decide(snapshot) -> Decision`` surface, so ``Planner``/``run_sim`` drive
either interchangeably.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from .policy import Action, Decision, DecisionEngine, noop
from .signals import SignalSnapshot

# Policy names — the metrics label set and the state() keys.
PREFIX_WARMING = "prefix_warming"
MEASURED_ROUTING = "measured_routing"
VICTIM_MIGRATION = "victim_migration"
DRIFT_RETUNE = "drift_retune"

POLICIES = (PREFIX_WARMING, MEASURED_ROUTING, VICTIM_MIGRATION, DRIFT_RETUNE)

# The cold-start fallback the measured weights are shaped against
# (llm/kv_router/indexer.py) — imported lazily in consumers to keep the
# planner importable without the llm stack; mirrored here as the canonical
# SHAPE (relative tier ratios) measured scaling preserves.
_STATIC_SHAPE = {"hbm": 1.0, "host": 0.75, "disk": 0.45, "objstore": 0.25}


@dataclass(frozen=True)
class AutopilotConfig:
    """Per-policy thresholds + damping (Llumnix discipline: every policy
    confirms over a streak, then cools down — a flapping signal produces
    zero directives by construction)."""

    # -- prefix warming ---------------------------------------------------
    # Fleet hit rate below this is cold-prefix pressure.
    warm_hit_rate_floor: float = 0.5
    warm_confirm_ticks: int = 2
    warm_cooldown_ticks: int = 12
    # Hottest chains to promote+persist per directive.
    warm_top_chains: int = 8
    # Decode scale-ups are deferred for this many ticks after a warming
    # directive — the window in which warming should absorb the pressure.
    warm_grace_ticks: int = 6

    # -- measured-latency routing ----------------------------------------
    # EWMA smoothing for the measured percentiles.
    route_ewma_alpha: float = 0.3
    # Restore p95 (ms) at which the host tier's weight halves — the scale
    # that turns a latency into a restore-cost discount.
    route_halving_ms: float = 50.0
    # Re-emit only when some weight moved by more than this fraction
    # relative to the last emitted table (drift gate, not a timer).
    route_retune_frac: float = 0.25
    route_cooldown_ticks: int = 10

    # -- victim migration -------------------------------------------------
    # A worker is an outlier when its p95 exceeds ratio × fleet median.
    outlier_ratio: float = 2.0
    outlier_confirm_ticks: int = 3
    # Minimum samples behind a worker's percentile row to trust it.
    outlier_min_samples: int = 8
    migrate_cooldown_ticks: int = 20

    # -- drift retune -----------------------------------------------------
    # Acceptable fused-decode host-gap band; sustained drift outside it
    # (either direction) triggers the sweep recommendation.
    gap_band_lo: float = 0.10
    gap_band_hi: float = 0.60
    gap_confirm_ticks: int = 4
    retune_cooldown_ticks: int = 30

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AutopilotConfig":
        kw = {f: d[f] for f in cls.__dataclass_fields__ if f in d}
        return cls(**kw)


def kv_prefetch(top_n: int, persist: bool, reason: str = "") -> Action:
    return Action(
        "kv_prefetch",
        params={"top_n": top_n, "persist": persist},
        reason=reason,
    )


def set_tier_weights(weights: Dict[str, float], reason: str = "") -> Action:
    return Action(
        "set_tier_weights",
        params={"weights": {t: round(w, 4) for t, w in weights.items()}},
        reason=reason,
    )


def migrate_out(worker_id: int, reason: str = "", **extra: Any) -> Action:
    return Action(
        "migrate_out", worker_id=worker_id, params=dict(extra) or None,
        reason=reason,
    )


def tune_decode(sweep: Dict[str, Any], reason: str = "") -> Action:
    return Action("tune_decode", params={"sweep": sweep}, reason=reason)


class Autopilot:
    """Deterministic policy layer above (and around) a ``DecisionEngine``.

    ``decide(snapshot)`` runs the wrapped engine, post-filters its actions
    (the warming policy may defer decode scale-ups), evaluates the four
    autopilot policies in a FIXED order, and returns one merged
    ``Decision`` — so every existing consumer (``Planner.tick``,
    ``run_sim``, the dry-run transcript) works unchanged.

    ``worker_view`` feeds the victim-migration policy: a callable
    returning ``{worker_id: {"ttft_p95_ms": .., "itl_p95_ms": .., "n": ..}}``
    (production: ``SignalCollector.worker_slo_view``; sim/tests: a
    synthetic provider).  None disables that policy.
    """

    def __init__(
        self,
        engine: Optional[DecisionEngine] = None,
        config: Optional[AutopilotConfig] = None,
        worker_view: Optional[Callable[[], Dict[int, Dict[str, Any]]]] = None,
    ):
        self.engine = engine or DecisionEngine()
        self.config = config or AutopilotConfig()
        self.worker_view = worker_view
        # Per-policy damping state — explicit, replayable.
        self._streak: Dict[str, int] = {p: 0 for p in POLICIES}
        self._cooldown: Dict[str, int] = {p: 0 for p in POLICIES}
        # Warming grace window: >0 defers decode scale-ups.
        self._warm_grace = 0
        # Measured-routing EWMAs + the last emitted weight table.
        self._ewma: Dict[str, float] = {}
        self._last_weights: Optional[Dict[str, float]] = None
        # Victim migration per-worker outlier streaks.
        self._outlier_streak: Dict[int, int] = {}
        # Drift retune: EWMA'd gap.
        self._gap_ewma: Optional[float] = None

    # -- shared damping helpers -------------------------------------------

    def _tick_cooldowns(self) -> None:
        for p in POLICIES:
            if self._cooldown[p] > 0:
                self._cooldown[p] -= 1
        if self._warm_grace > 0:
            self._warm_grace -= 1

    def _fire(self, policy: str, cooldown: int) -> bool:
        """A policy's confirmed trigger: True when it may act (and arms
        the cooldown); False (counted) when it is cooling down."""
        from .pmetrics import autopilot_metrics

        if self._cooldown[policy] > 0:
            autopilot_metrics.record_cooldown_skip(policy)
            return False
        self._cooldown[policy] = cooldown
        self._streak[policy] = 0
        autopilot_metrics.record_decision(policy)
        return True

    # -- policy 1: prefix warming -----------------------------------------

    def _warming(self, snap: SignalSnapshot) -> Optional[Action]:
        cfg = self.config
        rate = snap.fleet_prefix_hit_rate
        if rate is None or rate >= cfg.warm_hit_rate_floor:
            self._streak[PREFIX_WARMING] = 0
            return None
        self._streak[PREFIX_WARMING] += 1
        if self._streak[PREFIX_WARMING] < cfg.warm_confirm_ticks:
            return None
        if not self._fire(PREFIX_WARMING, cfg.warm_cooldown_ticks):
            return None
        self._warm_grace = cfg.warm_grace_ticks
        return kv_prefetch(
            cfg.warm_top_chains,
            persist=True,
            reason=f"fleet prefix hit rate {rate:.2f} < "
            f"{cfg.warm_hit_rate_floor:.2f} for "
            f"{cfg.warm_confirm_ticks} ticks: warm before scaling",
        )

    # -- policy 2: measured-latency routing --------------------------------

    def _measured_weights(self) -> Dict[str, float]:
        """Shape-preserving measured table: the static relative tier
        ratios scaled by the measured restore cost.  ``hbm`` is pinned at
        1.0 (a live block is free); the host weight decays with measured
        restore p95 (halving at ``route_halving_ms``), and the colder
        tiers keep their static ratio to host."""
        cfg = self.config
        r = self._ewma.get("restore_p95_ms", 0.0)
        # H/(H+r): 1.0 at zero measured latency (the static table), half
        # at route_halving_ms — bounded, monotone, never negative.
        scale = cfg.route_halving_ms / (cfg.route_halving_ms + max(0.0, r))
        host = _STATIC_SHAPE["host"] * scale
        return {
            "hbm": 1.0,
            "host": host,
            "disk": _STATIC_SHAPE["disk"] * scale,
            "objstore": _STATIC_SHAPE["objstore"] * scale,
        }

    def _routing(self, snap: SignalSnapshot) -> Optional[Action]:
        cfg = self.config
        pct = snap.restore_pct
        if not pct:
            return None  # cold start: the static table stays authoritative
        for key in ("restore_p95_ms", "pull_p95_ms"):
            v = pct.get(key)
            if isinstance(v, (int, float)):
                prev = self._ewma.get(key)
                self._ewma[key] = (
                    float(v)
                    if prev is None
                    else prev + cfg.route_ewma_alpha * (float(v) - prev)
                )
        if "restore_p95_ms" not in self._ewma:
            return None
        weights = self._measured_weights()
        last = self._last_weights
        if last is not None:
            drift = max(
                abs(weights[t] - last.get(t, 0.0)) / max(1e-9, last.get(t, 1.0))
                for t in weights
            )
            if drift <= cfg.route_retune_frac:
                return None  # inside the drift gate: keep the live table
        if not self._fire(MEASURED_ROUTING, cfg.route_cooldown_ticks):
            return None
        self._last_weights = dict(weights)
        return set_tier_weights(
            weights,
            reason="measured restore p95 "
            f"{self._ewma['restore_p95_ms']:.1f}ms -> live tier weights "
            "(static table is cold-start fallback)",
        )

    # -- policy 3: trace-identified migration victims ----------------------

    def _victims(self, snap: SignalSnapshot) -> Optional[Action]:
        cfg = self.config
        if self.worker_view is None:
            return None
        view = self.worker_view() or {}
        rows = {
            wid: row
            for wid, row in view.items()
            if isinstance(row.get("itl_p95_ms"), (int, float))
            and row.get("n", 0) >= cfg.outlier_min_samples
        }
        if len(rows) < 2:
            self._outlier_streak.clear()
            return None
        p95s = sorted(row["itl_p95_ms"] for row in rows.values())
        median = p95s[len(p95s) // 2]
        if median <= 0:
            return None
        outliers = {
            wid
            for wid, row in rows.items()
            if row["itl_p95_ms"] > cfg.outlier_ratio * median
        }
        # advance per-worker streaks; non-outliers (and vanished workers)
        # reset so a transient spike never accumulates across gaps
        for wid in list(self._outlier_streak):
            if wid not in outliers:
                del self._outlier_streak[wid]
        for wid in outliers:
            self._outlier_streak[wid] = self._outlier_streak.get(wid, 0) + 1
        sustained = [
            wid
            for wid, n in self._outlier_streak.items()
            if n >= cfg.outlier_confirm_ticks
        ]
        if not sustained:
            return None
        # worst sustained outlier; ties to lowest id (determinism)
        victim = max(sustained, key=lambda w: (rows[w]["itl_p95_ms"], -w))
        if not self._fire(VICTIM_MIGRATION, cfg.migrate_cooldown_ticks):
            return None
        self._outlier_streak.pop(victim, None)
        return migrate_out(
            victim,
            p95_ms=round(float(rows[victim]["itl_p95_ms"]), 3),
            fleet_median_ms=round(float(median), 3),
            reason=f"worker {victim} itl p95 "
            f"{rows[victim]['itl_p95_ms']:.0f}ms > {cfg.outlier_ratio}x "
            f"fleet median {median:.0f}ms for "
            f"{cfg.outlier_confirm_ticks} ticks",
        )

    # -- policy 4: drift-triggered retune ----------------------------------

    def _retune(self, snap: SignalSnapshot) -> Optional[Action]:
        cfg = self.config
        gap = snap.host_gap
        if gap is None:
            return None
        self._gap_ewma = (
            float(gap)
            if self._gap_ewma is None
            else self._gap_ewma
            + cfg.route_ewma_alpha * (float(gap) - self._gap_ewma)
        )
        g = self._gap_ewma
        if cfg.gap_band_lo <= g <= cfg.gap_band_hi:
            self._streak[DRIFT_RETUNE] = 0
            return None
        self._streak[DRIFT_RETUNE] += 1
        if self._streak[DRIFT_RETUNE] < cfg.gap_confirm_ticks:
            return None
        if not self._fire(DRIFT_RETUNE, cfg.retune_cooldown_ticks):
            return None
        host_bound = g > cfg.gap_band_hi
        # The sweep recommendation: which knobs to re-sweep and in which
        # direction — a tune_decode-style surface for the operator (or a
        # future closed-loop tuner), not an actuation.
        sweep = {
            "knob": "decode_burst" if host_bound else "prefill_chunk",
            "direction": "up" if host_bound else "down",
            "host_gap": round(g, 4),
            "band": [cfg.gap_band_lo, cfg.gap_band_hi],
        }
        return tune_decode(
            sweep,
            reason=f"host gap {g:.2f} outside "
            f"[{cfg.gap_band_lo:.2f}, {cfg.gap_band_hi:.2f}] for "
            f"{cfg.gap_confirm_ticks} windows: recommend "
            f"{sweep['knob']} sweep ({sweep['direction']})",
        )

    # -- the merged decision ----------------------------------------------

    def decide(self, snap: SignalSnapshot) -> Decision:
        from .pmetrics import autopilot_metrics

        self._tick_cooldowns()
        base = self.engine.decide(snap)
        # Post-filter: while a warming directive is in flight, decode
        # scale-UPS are deferred — warming is the cheaper remedy for
        # cold-prefix pressure, and the grace window is how the policy
        # proves it (scale-downs and prefill actions pass through).
        actions: List[Action] = []
        for a in base.actions:
            if (
                self._warm_grace > 0
                and a.kind == "scale_decode"
                and a.delta > 0
            ):
                autopilot_metrics.record_suppression(PREFIX_WARMING)
                actions.append(
                    noop(
                        "deferred: prefix warming in flight "
                        f"({self._warm_grace} ticks left)"
                    )
                )
                continue
            actions.append(a)
        # Policies in FIXED order (determinism), each self-damped.
        for policy_fn in (
            self._warming, self._routing, self._victims, self._retune
        ):
            action = policy_fn(snap)
            if action is not None:
                actions.append(action)
        # Collapse redundant noops when real actions exist.
        real = [a for a in actions if a.kind != "noop"]
        if real:
            actions = real
        else:
            actions = actions[:1] or [noop("in-band")]
        signals = dict(base.signals)
        if snap.fleet_prefix_hit_rate is not None:
            signals["fleet_prefix_hit_rate"] = round(
                snap.fleet_prefix_hit_rate, 4
            )
        if snap.host_gap is not None:
            signals["host_gap"] = round(snap.host_gap, 4)
        return Decision(
            tick=base.tick,
            actions=actions,
            pressures=base.pressures,
            signals=signals,
        )

    # -- introspection -----------------------------------------------------

    def state(self) -> Dict[str, Any]:
        """The planner /state surface's ``autopilot`` section — including
        the latest tune_decode-style recommendation inputs."""
        from .pmetrics import autopilot_metrics

        return {
            "engine": self.engine.state(),
            "streaks": dict(self._streak),
            "cooldowns": dict(self._cooldown),
            "warm_grace": self._warm_grace,
            "ewma": {k: round(v, 3) for k, v in self._ewma.items()},
            "gap_ewma": (
                round(self._gap_ewma, 4) if self._gap_ewma is not None else None
            ),
            "live_tier_weights": (
                dict(self._last_weights) if self._last_weights else None
            ),
            "metrics": autopilot_metrics.state(),
        }


__all__ = [
    "Autopilot",
    "AutopilotConfig",
    "DRIFT_RETUNE",
    "MEASURED_ROUTING",
    "POLICIES",
    "PREFIX_WARMING",
    "VICTIM_MIGRATION",
    "kv_prefetch",
    "migrate_out",
    "set_tier_weights",
    "tune_decode",
]

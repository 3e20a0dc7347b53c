"""Deterministic discrete-time simulator for planner policies.  A copy of the
JAX package's ``planner/sim.py``.

A queueing model of a disaggregated fleet — a prefill pool (token
throughput per worker, FIFO) feeding a decode pool (slot-shared token
rate, KV occupancy) — driven by seedable arrival traces, ticked in lock
step with a ``DecisionEngine``.  No wall clock, no accelerator, no asyncio: a
policy change is unit-testable in milliseconds, and the tier-1 smoke
(``python -m dynamo_tpu_torch.planner sim --smoke``) proves the closed loop
(spike → scale-up → SLO restored → scale-down, zero flip-flops) on every
CI run.

Trace format (shared with ``benchmarks/loadgen.py --trace``): JSONL, one
arrival per line — ``{"t": seconds, "isl": prompt_tokens, "osl":
output_tokens}`` — so a bench trace replays in the simulator and a sim
trace drives a real deployment.
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

from .policy import DECODE, PREFILL, Decision, DecisionEngine
from .signals import PoolStats, SignalSnapshot
from .signals import percentile as _pct

TRACE_SHAPES = ("poisson", "burst", "ramp")


@dataclass(frozen=True)
class Arrival:
    t: float
    isl: int = 3000
    osl: int = 150
    # Multi-tenant replay (llm/tenancy): route this request to a LoRA
    # adapter (the OpenAI ``model`` field) and/or constrain it with a JSON
    # schema (``response_format``).  Optional — single-tenant traces and
    # pre-tenancy consumers never see the keys.
    adapter: Optional[str] = None
    schema: Optional[Dict[str, Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"t": round(self.t, 6), "isl": self.isl, "osl": self.osl}
        if self.adapter is not None:
            out["adapter"] = self.adapter
        if self.schema is not None:
            out["schema"] = self.schema
        return out


def gen_trace(
    shape: str,
    *,
    rate: float,
    duration_s: float,
    seed: int = 0,
    isl: int = 3000,
    osl: int = 150,
    spike_mult: float = 3.0,
    spike_start_s: Optional[float] = None,
    spike_end_s: Optional[float] = None,
) -> List[Arrival]:
    """Seedable arrival traces.

    - ``poisson``: constant-rate Poisson process (exp inter-arrivals).
    - ``burst``:   Poisson at ``rate``, but ``spike_mult``× inside
                   [spike_start, spike_end) (defaults: middle third) —
                   the planner acceptance scenario.
    - ``ramp``:    rate climbs linearly from ``rate`` to
                   ``spike_mult * rate`` across the trace.
    """
    if shape not in TRACE_SHAPES:
        raise ValueError(f"unknown trace shape {shape!r} (want {TRACE_SHAPES})")
    rng = random.Random(seed)
    lo = duration_s / 3.0 if spike_start_s is None else spike_start_s
    hi = 2.0 * duration_s / 3.0 if spike_end_s is None else spike_end_s
    out: List[Arrival] = []
    t = 0.0
    while True:
        if shape == "poisson":
            r = rate
        elif shape == "burst":
            r = rate * spike_mult if lo <= t < hi else rate
        else:  # ramp
            r = rate * (1.0 + (spike_mult - 1.0) * min(1.0, t / duration_s))
        t += rng.expovariate(r)
        if t >= duration_s:
            return out
        out.append(Arrival(t=t, isl=isl, osl=osl))


def write_trace(path: str, arrivals: Iterable[Arrival]) -> int:
    n = 0
    with open(path, "w") as f:
        for a in arrivals:
            f.write(json.dumps(a.to_dict()) + "\n")
            n += 1
    return n


def read_trace(path: str) -> List[Arrival]:
    out: List[Arrival] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            out.append(
                Arrival(
                    t=float(d["t"]),
                    isl=int(d.get("isl", 3000)),
                    osl=int(d.get("osl", 150)),
                    adapter=d.get("adapter"),
                    schema=d.get("schema"),
                )
            )
    out.sort(key=lambda a: a.t)
    return out


# ------------------------------------------------------------------ model


@dataclass(frozen=True)
class SimConfig:
    tick_s: float = 1.0
    # Capacity model (deliberately round numbers: the policy only sees
    # ratios, and tests assert behaviour, not absolute throughput).
    prefill_tokens_per_s: float = 6000.0  # per prefill worker
    decode_slots: int = 8  # per decode worker
    decode_tok_s_per_slot: float = 40.0
    kv_tokens_per_worker: int = 120_000
    # Scale actions take this many ticks to become capacity (pod spin-up);
    # flips are faster (the worker already holds weights).
    provision_ticks: int = 3
    flip_ticks: int = 1
    # Percentile window over recent TTFT/ITL samples.
    window_ticks: int = 10
    n_prefill: int = 1
    n_decode: int = 1
    # ---- optional prefix-population model (None disables — the default
    # keeps every pre-autopilot scenario byte-identical).  When enabled,
    # the fleet prefix-cache hit rate is a first-class state variable:
    # prefill work per request is isl x (1 - hit at admission), and each
    # decoding request's KV residency shrinks by its hit (the shared hot
    # base is counted once as ``hot_prefix_tokens``).  A hot-prefix SURGE
    # (a new population arriving at ``surge_start_s``) drops the hit rate
    # to ``surge_hit_rate``; it then recovers by ``natural_ramp_per_tick``
    # (caches refill from misses) — or by ``warm_ramp_per_tick`` once a
    # ``kv_prefetch`` warming directive lands (after ``warm_lag_ticks``).
    base_hit_rate: Optional[float] = None
    surge_hit_rate: float = 0.1
    surge_start_s: Optional[float] = None
    natural_ramp_per_tick: float = 0.01
    warm_ramp_per_tick: float = 0.15
    warm_lag_ticks: int = 2
    hot_prefix_tokens: int = 6000


@dataclass
class _Req:
    arrival: float
    isl: int
    osl: int
    prefill_left: float = 0.0
    decoded: int = 0
    ttft_s: Optional[float] = None
    # Prefix-cache hit fraction at admission (prefix model only): scales
    # both the prefill work and the request's private KV residency.
    hit: float = 0.0

    def __post_init__(self):
        self.prefill_left = float(self.isl) * (1.0 - self.hit)


class SimCluster:
    """The fleet + workload state machine; ``step()`` advances one tick."""

    def __init__(self, trace: List[Arrival], cfg: SimConfig):
        self.cfg = cfg
        self.trace = sorted(trace, key=lambda a: a.t)
        self._next_arrival = 0
        self.now = 0.0
        self.n_prefill = cfg.n_prefill
        self.n_decode = cfg.n_decode
        self.prefill_q: List[_Req] = []  # FIFO, head in service
        self.decoding: List[_Req] = []
        self.done: List[_Req] = []
        # (effective_at_tick, pool, delta)
        self._pending_scale: List[Tuple[int, str, int]] = []
        self.tick = 0
        # rolling (tick, value) samples for windowed percentiles
        self._ttft_samples: List[Tuple[int, float]] = []
        self._itl_samples: List[Tuple[int, float]] = []
        self._last_itl_ms = 0.0
        # prefix model state (inert when base_hit_rate is None)
        self.hit_rate: Optional[float] = cfg.base_hit_rate
        self._surged = False
        self._warm_at: Optional[int] = None  # tick a warming directive lands

    # -- capacity mutation (what actuation means in the sim) ---------------

    def schedule_scale(self, pool: str, target: int, *, flip: bool = False) -> None:
        cur = self.n_prefill if pool == PREFILL else self.n_decode
        pending = sum(
            d for _, p, d in self._pending_scale if p == pool
        )
        delta = target - (cur + pending)
        if delta == 0:
            return
        lag = self.cfg.flip_ticks if flip else self.cfg.provision_ticks
        self._pending_scale.append((self.tick + lag, pool, delta))

    def apply_actions(self, decision: Decision) -> None:
        for action in decision.actions:
            if action.kind in ("scale_prefill", "scale_decode"):
                self.schedule_scale(action.pool, action.target)
            elif action.kind == "kv_prefetch" and self.hit_rate is not None:
                # Warming directive: the promoted chains start landing
                # after a short lag, then the hit rate ramps fast.
                if self._warm_at is None:
                    self._warm_at = self.tick + self.cfg.warm_lag_ticks
            elif action.kind == "flip_role":
                donor = DECODE if action.pool == PREFILL else PREFILL
                donor_n = self.n_prefill if donor == PREFILL else self.n_decode
                recv_n = self.n_prefill if action.pool == PREFILL else self.n_decode
                self.schedule_scale(donor, donor_n - 1, flip=True)
                self.schedule_scale(action.pool, recv_n + 1, flip=True)

    def _apply_pending(self) -> None:
        due = [e for e in self._pending_scale if e[0] <= self.tick]
        self._pending_scale = [e for e in self._pending_scale if e[0] > self.tick]
        for _, pool, delta in due:
            if pool == PREFILL:
                self.n_prefill = max(0, self.n_prefill + delta)
            else:
                self.n_decode = max(0, self.n_decode + delta)

    # -- one tick ----------------------------------------------------------

    def step(self) -> None:
        cfg = self.cfg
        self.tick += 1
        self.now += cfg.tick_s
        self._apply_pending()
        # prefix-population dynamics (inert without the model)
        if self.hit_rate is not None:
            if (
                not self._surged
                and cfg.surge_start_s is not None
                and self.now >= cfg.surge_start_s
            ):
                # a NEW hot-prefix population arrives: caches run cold
                self.hit_rate = cfg.surge_hit_rate
                self._surged = True
            elif self.hit_rate < (cfg.base_hit_rate or 0.0):
                warmed = self._warm_at is not None and self.tick >= self._warm_at
                ramp = (
                    cfg.warm_ramp_per_tick
                    if warmed
                    else cfg.natural_ramp_per_tick
                )
                self.hit_rate = min(cfg.base_hit_rate, self.hit_rate + ramp)
        # arrivals up to now
        while (
            self._next_arrival < len(self.trace)
            and self.trace[self._next_arrival].t <= self.now
        ):
            a = self.trace[self._next_arrival]
            self.prefill_q.append(
                _Req(a.t, a.isl, a.osl, hit=self.hit_rate or 0.0)
            )
            self._next_arrival += 1
        # prefill: pooled token throughput, FIFO
        budget = self.n_prefill * cfg.prefill_tokens_per_s * cfg.tick_s
        budget0 = budget
        while self.prefill_q and budget > 0:
            head = self.prefill_q[0]
            use = min(budget, head.prefill_left)
            head.prefill_left -= use
            budget -= use
            if head.prefill_left <= 1e-9:
                self.prefill_q.pop(0)
                head.ttft_s = self.now - head.arrival
                self._ttft_samples.append((self.tick, head.ttft_s))
                self.decoding.append(head)
        # busy worker-equivalents this tick (the pool's true utilization —
        # feeds the policy's scale-down guard)
        per_worker = cfg.prefill_tokens_per_s * cfg.tick_s
        self._prefill_busy = (budget0 - budget) / per_worker if per_worker else 0.0
        # decode: total capacity shared across active sequences; per-seq
        # rate caps at the per-slot rate (underload ≠ faster than hardware)
        if self.decoding:
            total = self.n_decode * cfg.decode_slots * cfg.decode_tok_s_per_slot
            per_seq = min(
                cfg.decode_tok_s_per_slot,
                total / len(self.decoding) if total > 0 else 0.0,
            )
            self._last_itl_ms = 1000.0 / per_seq if per_seq > 0 else float("inf")
            if per_seq > 0:
                self._itl_samples.append((self.tick, self._last_itl_ms))
            made = int(per_seq * cfg.tick_s)
            still: List[_Req] = []
            for req in self.decoding:
                req.decoded += made
                (self.done if req.decoded >= req.osl else still).append(req)
            self.decoding = still
        # trim sample windows
        floor = self.tick - cfg.window_ticks
        self._ttft_samples = [s for s in self._ttft_samples if s[0] > floor]
        self._itl_samples = [s for s in self._itl_samples if s[0] > floor]

    # -- signal view -------------------------------------------------------

    def snapshot(self) -> SignalSnapshot:
        cfg = self.cfg
        kv_cap = max(1, self.n_decode * cfg.kv_tokens_per_worker)
        if self.hit_rate is None:
            kv_used = sum(r.isl + r.decoded for r in self.decoding)
        else:
            # Prefix model: each request's PRIVATE residency is the part
            # it computed itself; the shared hot base is counted once.
            kv_used = cfg.hot_prefix_tokens + sum(
                r.isl * (1.0 - r.hit) + r.decoded for r in self.decoding
            )
        slots = self.n_decode * cfg.decode_slots
        ttfts = [v for _, v in self._ttft_samples]
        itls = [v for _, v in self._itl_samples]
        # Slot counts are scaled ×1000 so fractional busy-worker
        # utilization survives PoolStats' integer fields.
        busy = getattr(self, "_prefill_busy", 0.0)
        prefill_pool = PoolStats(
            workers=tuple(range(self.n_prefill)),
            queue_depth=len(self.prefill_q),
            active_slots=int(busy * 1000),
            total_slots=self.n_prefill * 1000,
            per_worker_load={w: 0.0 for w in range(self.n_prefill)},
        )
        decode_pool = PoolStats(
            workers=tuple(range(1000, 1000 + self.n_decode)),
            queue_depth=max(0, len(self.decoding) - slots),
            active_slots=min(len(self.decoding), slots),
            total_slots=slots,
            kv_usage=min(1.0, kv_used / kv_cap),
            per_worker_load={
                w: min(1.0, len(self.decoding) / max(1, slots))
                for w in range(1000, 1000 + self.n_decode)
            },
        )
        return SignalSnapshot(
            t=self.now,
            pools={PREFILL: prefill_pool, DECODE: decode_pool},
            ttft_p95_ms=_pct(ttfts, 0.95) * 1e3 if ttfts else None,
            ttft_p50_ms=_pct(ttfts, 0.5) * 1e3 if ttfts else None,
            itl_p95_ms=_pct(itls, 0.95) if itls else None,
            itl_p50_ms=_pct(itls, 0.5) if itls else None,
            prefill_queue_depth=len(self.prefill_q),
            fleet_prefix_hit_rate=(
                round(self.hit_rate, 4) if self.hit_rate is not None else None
            ),
        )


# ------------------------------------------------------------------ runner


@dataclass
class SimReport:
    ticks: List[Dict[str, Any]] = field(default_factory=list)
    decisions: List[Decision] = field(default_factory=list)
    actuation_calls: int = 0
    completed: int = 0

    def scale_actions(self, pool: Optional[str] = None) -> List[Any]:
        out = []
        for d in self.decisions:
            for a in d.actions:
                if a.kind in ("scale_prefill", "scale_decode") and (
                    pool is None or a.pool == pool
                ):
                    out.append(a)
        return out

    def flip_flops(self, within_ticks: int = 10) -> int:
        """Opposite-direction scale actions on the same pool closer than
        ``within_ticks`` apart — the oscillation the hysteresis band must
        eliminate."""
        last: Dict[str, Tuple[int, int]] = {}  # pool → (tick, direction)
        count = 0
        for d in self.decisions:
            for a in d.actions:
                if a.kind not in ("scale_prefill", "scale_decode"):
                    continue
                direction = 1 if a.delta > 0 else -1
                prev = last.get(a.pool)
                if (
                    prev is not None
                    and prev[1] != direction
                    and d.tick - prev[0] < within_ticks
                ):
                    count += 1
                last[a.pool] = (d.tick, direction)
        return count

    def decision_dicts(self) -> List[Dict[str, Any]]:
        return [d.to_dict() for d in self.decisions]


def run_sim(
    trace: List[Arrival],
    engine: DecisionEngine,
    cfg: Optional[SimConfig] = None,
    *,
    ticks: Optional[int] = None,
    dry_run: bool = False,
    on_actuate=None,
) -> SimReport:
    """Tick the cluster + policy loop to trace end (+ drain margin).

    Live mode counts an actuation (and calls ``on_actuate(decision)`` if
    given) for every non-noop decision AND applies it to the model.
    Dry-run applies the SAME actions to the model (the scenario under
    evaluation is identical) but never actuates — so a dry-run must
    reproduce the live decision stream exactly, with
    ``actuation_calls == 0``.
    """
    cfg = cfg or SimConfig()
    cluster = SimCluster(trace, cfg)
    report = SimReport()
    horizon = ticks
    if horizon is None:
        last_t = trace[-1].t if trace else 0.0
        horizon = int(last_t / cfg.tick_s) + 4 * cfg.window_ticks
    for _ in range(horizon):
        cluster.step()
        snap = cluster.snapshot()
        decision = engine.decide(snap)
        report.decisions.append(decision)
        if not decision.is_noop:
            if not dry_run:
                if on_actuate is not None:
                    on_actuate(decision)
                report.actuation_calls += 1
            cluster.apply_actions(decision)
        report.ticks.append(
            {
                "tick": cluster.tick,
                "t": round(cluster.now, 3),
                "n_prefill": cluster.n_prefill,
                "n_decode": cluster.n_decode,
                "prefill_queue": len(cluster.prefill_q),
                "decoding": len(cluster.decoding),
                "ttft_p95_ms": snap.ttft_p95_ms,
                "itl_p95_ms": snap.itl_p95_ms,
                "actions": [a.to_dict() for a in decision.actions],
            }
        )
    report.completed = len(cluster.done)
    return report


# ------------------------------------------------------------------ smoke


def smoke(verbose: bool = False) -> Tuple[bool, str]:
    """The acceptance scenario at smoke scale: a seeded 3× spike must
    scale prefill up within a bounded number of ticks, restore TTFT p95
    under the SLO, scale back down afterwards, with zero flip-flops, and
    dry-run must emit the identical decision stream with no actuation."""
    from .policy import PolicyConfig, SloTargets

    # Baseline 1.2 req/s × 2000 prompt tokens = 2400 tok/s: comfortably
    # inside one prefill worker — the spike (3×) is the only pressure
    # event, so any reversal in the decision stream is a genuine policy
    # oscillation, not a cold-start transient.
    trace = gen_trace("burst", rate=1.2, duration_s=120.0, seed=7, isl=2000, osl=60)
    slo = SloTargets(ttft_p95_ms=2500.0, itl_p95_ms=200.0)
    # queue_high_per_worker=8: baseline Poisson clumping (a few queued
    # requests) stays inside the hysteresis band; only the spike's
    # sustained queue growth breaches it.
    cfg = PolicyConfig(
        max_prefill=6, max_decode=6, confirm_down_ticks=8,
        queue_high_per_worker=8.0,
    )
    sim_cfg = SimConfig(n_prefill=1, n_decode=2)

    live = run_sim(trace, DecisionEngine(slo, cfg), sim_cfg)
    dry = run_sim(trace, DecisionEngine(slo, cfg), sim_cfg, dry_run=True)

    ups = [a for a in live.scale_actions(PREFILL) if a.delta > 0]
    downs = [a for a in live.scale_actions(PREFILL) if a.delta < 0]
    spike_tick = int(120.0 / 3.0)  # burst default: spike starts at t/3
    checks = [
        (bool(ups), "planner never scaled prefill up during the spike"),
        (
            bool(ups) and min(d.tick for d in live.decisions
                              for a in d.actions if a.kind == "scale_prefill"
                              and a.delta > 0) <= spike_tick + 20,
            "scale-up not within 20 ticks of spike onset",
        ),
        (bool(downs), "planner never scaled back down after the spike"),
        (live.flip_flops() == 0, "flip-flop decisions inside hysteresis band"),
        (
            _recovered(live, slo.ttft_p95_ms),
            "TTFT p95 not restored below SLO after scale-up",
        ),
        (
            live.decision_dicts() == dry.decision_dicts(),
            "dry-run decisions diverged from live decisions",
        ),
        (dry.actuation_calls == 0, "dry-run issued actuation calls"),
    ]
    failures = [msg for ok, msg in checks if not ok]
    if verbose or failures:
        tail = live.ticks[-1]
        summary = (
            f"sim smoke: {len(live.decisions)} ticks, completed="
            f"{live.completed}, scale_ups={len(ups)} scale_downs={len(downs)} "
            f"flip_flops={live.flip_flops()} final_pools="
            f"(p={tail['n_prefill']}, d={tail['n_decode']})"
        )
    else:
        summary = "sim smoke ok"
    if failures:
        return False, summary + "; FAILED: " + "; ".join(failures)
    return True, summary


def autopilot_smoke(verbose: bool = False) -> Tuple[bool, str]:
    """The autopilot acceptance scenario (docs/autopilot.md): a seeded
    hot-prefix SURGE (a new prefix population at t=40s runs the fleet's
    caches cold) must trigger the warming policy — which restores TTFT p95
    while spending at least one FEWER decode scale-up than the
    pressure-only control engine — with zero flip-flops, and the decision
    stream must be deterministic across replays and identical in dry-run."""
    from .autopilot import Autopilot, AutopilotConfig
    from .policy import PolicyConfig, SloTargets

    # Steady 4 req/s x 2000-token prompts at 80% prefix hit = 1600 tok/s
    # of real prefill (a quarter of one worker).  The surge quadruples the
    # effective prefill AND inflates per-request decode KV residency 4.5x
    # — the pressure-only control reads that as "decode pool too small"
    # and buys replicas; the autopilot warms the prefixes instead.
    trace = gen_trace(
        "poisson", rate=4.0, duration_s=120.0, seed=11, isl=2000, osl=60
    )
    slo = SloTargets(ttft_p95_ms=2500.0, itl_p95_ms=200.0)
    cfg = PolicyConfig(
        max_prefill=6, max_decode=6, confirm_down_ticks=8,
        queue_high_per_worker=8.0,
    )
    sim_cfg = SimConfig(
        n_prefill=1, n_decode=2, kv_tokens_per_worker=12_000,
        base_hit_rate=0.8, surge_start_s=40.0,
    )

    def pilot() -> Autopilot:
        return Autopilot(DecisionEngine(slo, cfg), AutopilotConfig())

    control = run_sim(trace, DecisionEngine(slo, cfg), sim_cfg)
    live = run_sim(trace, pilot(), sim_cfg)
    replay = run_sim(trace, pilot(), sim_cfg)
    dry = run_sim(trace, pilot(), sim_cfg, dry_run=True)

    control_ups = [a for a in control.scale_actions(DECODE) if a.delta > 0]
    live_ups = [a for a in live.scale_actions(DECODE) if a.delta > 0]
    warmed = any(
        a.kind == "kv_prefetch" for d in live.decisions for a in d.actions
    )
    # Last windows with traffic still in them — the trailing drain ticks
    # report no TTFT at all, so index by observation rather than by tick.
    observed = [
        r["ttft_p95_ms"] for r in live.ticks if r["ttft_p95_ms"] is not None
    ]
    tail = observed[-10:]
    checks = [
        (warmed, "autopilot never issued a warming directive"),
        (
            bool(control_ups),
            "control never scaled decode (scenario exerts no pressure)",
        ),
        (
            len(control_ups) >= len(live_ups) + 1,
            f"warming saved no decode scale-up "
            f"(control={len(control_ups)}, autopilot={len(live_ups)})",
        ),
        (live.flip_flops() == 0, "flip-flop decisions under the autopilot"),
        (
            bool(tail) and max(tail) < slo.ttft_p95_ms,
            "TTFT p95 not restored under SLO after the surge",
        ),
        (
            live.decision_dicts() == replay.decision_dicts(),
            "decision stream diverged across seeded replays",
        ),
        (
            live.decision_dicts() == dry.decision_dicts(),
            "dry-run decisions diverged from live decisions",
        ),
        (dry.actuation_calls == 0, "dry-run issued actuation calls"),
    ]
    failures = [msg for ok, msg in checks if not ok]
    summary = (
        f"autopilot smoke: decode_ups control={len(control_ups)} "
        f"autopilot={len(live_ups)}, warmed={warmed}, "
        f"flip_flops={live.flip_flops()}, completed={live.completed}"
    )
    if failures:
        return False, summary + "; FAILED: " + "; ".join(failures)
    return True, summary if verbose else "autopilot smoke ok"


def _recovered(report: SimReport, ttft_slo_ms: float) -> bool:
    """After the last prefill scale-up, TTFT p95 must come back under SLO."""
    up_ticks = [
        d.tick
        for d in report.decisions
        for a in d.actions
        if a.kind == "scale_prefill" and a.delta > 0
    ]
    if not up_ticks:
        return False
    after = [
        row
        for row in report.ticks
        if row["tick"] > max(up_ticks) and row["ttft_p95_ms"] is not None
    ]
    return bool(after) and min(row["ttft_p95_ms"] for row in after) < ttft_slo_ms

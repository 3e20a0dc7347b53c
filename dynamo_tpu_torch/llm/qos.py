"""QoS under overload: per-tenant quotas, priority classes, brownout ladder.

A copy of the JAX package's ``llm/qos.py``: the HTTP edge
(llm/http_service.py) charges quotas, stamps tenant and priority, and
drives the ladder; the scheduler's weighted fair queue is
engine/scheduler.py's.

The resilience stack survives *crashes* (runtime/resilience.py, hub
failover); this module makes the fleet survive *sustained overload* without
failing indiscriminately:

- ``TenantQuotas``   — token-bucket rate limits keyed on tenant identity
  (API key header / OpenAI ``model`` field / adapter), enforced at the HTTP
  edge before a request costs any engine work.  One flooding tenant burns
  its own bucket, not the fleet.
- priority classes  — ``interactive`` (default) vs ``batch``, carried as
  ``x-priority`` header or ``nvext.priority`` and threaded through
  ``PreprocessedRequest.priority`` down to the scheduler, where batch rows
  are the first preemption victims and interactive admission is protected
  (engine/scheduler.py WfqQueue).
- ``BrownoutLadder`` — a deterministic, hysteresis-gated degradation state
  machine (same confirm-streak/cooldown idiom as the planner
  ``DecisionEngine``) driven by the edge's queue-depth / TTFT / KV-pressure
  signals.  Instead of today's cliff (healthy → 429/503 for everyone) the
  edge degrades in defined rungs and recovers monotonically:

  ====  =====================================================================
  rung  behaviour (each rung includes all lower rungs' measures)
  ====  =====================================================================
  0     normal service
  1     cap ``max_tokens`` at ``max_tokens_cap`` (bound per-request cost)
  2     stand down speculative-decode drafts (``nvext.spec_decode=false``
        on admitted requests — verify bursts stop competing for batch rows)
  3     shed the ``batch`` class with 429 + drain-rate ``Retry-After``
  4     503 *overflow* interactive requests (admission saturated → shed
        instead of queueing; never sheds below the in-flight cap)
  ====  =====================================================================

The ladder is PURE: ``tick(signals) -> rung`` with no clock and no I/O —
the same signal sequence always yields the same rung sequence (the
determinism gate in tests/test_qos.py).  The HTTP edge owns a small task
that samples signals on an interval and applies the current rung
(llm/http_service.py).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

INTERACTIVE = "interactive"
BATCH = "batch"
PRIORITIES = (INTERACTIVE, BATCH)


def normalize_priority(value: Any, default: str = INTERACTIVE) -> str:
    """Clamp any wire value to a known class (unknown → default, never an
    error: priority is a hint, not a schema)."""
    if isinstance(value, str) and value.lower() in PRIORITIES:
        return value.lower()
    return default


def resolve_priority(headers: Mapping[str, str], body: Mapping[str, Any]) -> str:
    """Request priority: ``x-priority`` header wins, else ``nvext.priority``,
    else interactive (protecting latency-sensitive traffic by default)."""
    raw = headers.get("x-priority")
    if raw is None and isinstance(body.get("nvext"), Mapping):
        raw = body["nvext"].get("priority")
    return normalize_priority(raw)


def _credential_tenant(secret: str) -> str:
    """Stable non-secret tenant id for a credential: the raw API key /
    bearer token must never become the tenant string — tenant ids reach
    logs, /metrics labels and scheduler annotations, none of which may
    carry a secret.  One shared derivation (labels.py) so every
    layer agrees on the digest."""
    from ..labels import hash_credential

    return hash_credential(secret)


def resolve_tenant(headers: Mapping[str, str], body: Mapping[str, Any]) -> str:
    """Tenant identity for quota/fairness accounting, in resolution order:
    explicit ``x-tenant`` header, API key (``x-api-key`` / bearer token —
    HASHED, see ``_credential_tenant``), ``nvext.tenant``, then the OpenAI
    ``model`` field (adapters ARE model names under llm/tenancy, so
    per-adapter isolation falls out)."""
    raw = headers.get("x-tenant")
    if raw:
        return raw.strip()
    key = headers.get("x-api-key")
    if key:
        return _credential_tenant(key.strip())
    auth = headers.get("authorization", "")
    if auth.lower().startswith("bearer ") and auth[7:].strip():
        return _credential_tenant(auth[7:].strip())
    nvext = body.get("nvext")
    if isinstance(nvext, Mapping) and nvext.get("tenant"):
        return str(nvext["tenant"])
    model = body.get("model")
    return str(model) if model else "anonymous"


# --------------------------------------------------------------------------
# Per-tenant token buckets
# --------------------------------------------------------------------------


@dataclass
class _Bucket:
    rate: float  # tokens per second
    burst: float  # bucket capacity
    level: float  # current tokens
    t_last: float  # last refill timestamp


class TenantQuotas:
    """Token-bucket rate limiting keyed on tenant identity.

    ``rate`` is requests/second sustained, ``burst`` the instantaneous
    allowance.  ``rate=None`` disables quotas entirely (default: zero
    behaviour change for embedded/test services).  Per-tenant overrides
    (``tenants={"gold": {"rate": 50, "burst": 100}}``) let operators sell
    tiers.  The clock is injectable so tests replay deterministically.
    """

    def __init__(
        self,
        rate: Optional[float] = None,
        burst: Optional[float] = None,
        tenants: Optional[Mapping[str, Mapping[str, float]]] = None,
        clock=time.monotonic,
        max_tenants: int = 4096,
    ):
        self.rate = rate
        self.burst = burst if burst is not None else (rate or 0.0) * 2
        self.tenants = dict(tenants or {})
        self._clock = clock
        self._buckets: Dict[str, _Bucket] = {}
        # Bounded: tenant ids arrive from the wire (API keys churn), so the
        # bucket table must not grow without limit.  Eviction picks the
        # fullest bucket — the tenant least likely to notice a refill reset.
        self.max_tenants = max_tenants

    @property
    def enabled(self) -> bool:
        return self.rate is not None

    def _bucket(self, tenant: str) -> _Bucket:
        bucket = self._buckets.get(tenant)
        if bucket is None:
            over = self.tenants.get(tenant) or {}
            rate = float(over.get("rate", self.rate or 0.0))
            burst = float(over.get("burst", over.get("rate", self.burst)))
            bucket = _Bucket(
                rate=max(rate, 1e-9),
                burst=max(burst, 1.0),
                level=max(burst, 1.0),
                t_last=self._clock(),
            )
            if len(self._buckets) >= self.max_tenants:
                victim = max(self._buckets, key=lambda k: self._buckets[k].level)
                del self._buckets[victim]
            self._buckets[tenant] = bucket
        return bucket

    def try_acquire(self, tenant: str, cost: float = 1.0) -> Tuple[bool, float]:
        """Charge ``cost`` against the tenant's bucket.  Returns
        ``(admitted, retry_after_s)`` — retry_after is the refill time until
        the bucket holds ``cost`` again (0.0 when admitted)."""
        if not self.enabled:
            return True, 0.0
        bucket = self._bucket(tenant)
        now = self._clock()
        bucket.level = min(
            bucket.burst, bucket.level + (now - bucket.t_last) * bucket.rate
        )
        bucket.t_last = now
        if bucket.level >= cost:
            bucket.level -= cost
            return True, 0.0
        return False, (cost - bucket.level) / bucket.rate

    def refund(self, tenant: str, cost: float = 1.0) -> None:
        """Credit back a charge for a request that was shed downstream
        (admission queue full / rung-4 overflow) — shed work consumed no
        capacity and must not drain the tenant's budget."""
        if not self.enabled:
            return
        bucket = self._bucket(tenant)
        bucket.level = min(bucket.burst, bucket.level + cost)

    def level(self, tenant: str) -> float:
        return self._bucket(tenant).level if self.enabled else float("inf")


# --------------------------------------------------------------------------
# Brownout ladder
# --------------------------------------------------------------------------

RUNG_NORMAL = 0
RUNG_CAP_TOKENS = 1
RUNG_SPEC_STANDDOWN = 2
RUNG_SHED_BATCH = 3
RUNG_SHED_INTERACTIVE = 4

RUNG_NAMES = {
    RUNG_NORMAL: "normal",
    RUNG_CAP_TOKENS: "cap-max-tokens",
    RUNG_SPEC_STANDDOWN: "spec-standdown",
    RUNG_SHED_BATCH: "shed-batch",
    RUNG_SHED_INTERACTIVE: "shed-interactive-overflow",
}


@dataclass(frozen=True)
class BrownoutConfig:
    """Thresholds (pressure 1.0 = exactly at target) + hysteresis shape.

    ``band_down`` is deliberately wider than ``band_up`` and recovery takes
    more confirm ticks — stepping down too eagerly re-enters overload and
    flaps, the classic cause of oscillation (Llumnix; planner/policy.py uses
    the same asymmetry)."""

    # Admission queue depth considered "at target" (pressure 1.0).
    queue_high: float = 16.0
    # KV usage fraction considered "at target" (signal optional).
    kv_high: float = 0.90
    # TTFT p95 SLO in ms (None = ignore the latency signal).
    ttft_p95_ms: Optional[float] = None
    band_up: float = 0.10
    band_down: float = 0.40
    confirm_up: int = 2
    confirm_down: int = 4
    cooldown: int = 3
    max_rung: int = RUNG_SHED_INTERACTIVE
    # Rung 1: admitted requests' max_tokens are capped here.
    max_tokens_cap: int = 256

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "BrownoutConfig":
        kw = {f: d[f] for f in cls.__dataclass_fields__ if f in d}
        return cls(**kw)


@dataclass(frozen=True)
class BrownoutSignals:
    """One tick's pressure inputs (all optional signals default benign)."""

    queue_depth: float = 0.0
    kv_usage: float = 0.0
    ttft_p95_ms: Optional[float] = None


class BrownoutLadder:
    """Deterministic hysteresis-gated rung selector.

    Escalation moves ONE rung per confirmed breach (``confirm_up``
    consecutive ticks above ``1 + band_up``); recovery moves ONE rung per
    confirmed calm (``confirm_down`` ticks below ``1 - band_down``); either
    move starts a ``cooldown`` during which the ladder holds its rung, and
    inside the band both streaks reset — a signal oscillating within the
    band produces zero transitions by construction.  Recovery is therefore
    monotonic: 4 → 3 → 2 → 1 → 0, one cooldown apart, with no flip-flop
    unless pressure genuinely re-breaches.
    """

    def __init__(self, config: Optional[BrownoutConfig] = None):
        self.config = config or BrownoutConfig()
        self.rung = RUNG_NORMAL
        self.tick_count = 0
        self._up_streak = 0
        self._down_streak = 0
        self._cooldown = 0
        # (tick, from_rung, to_rung, pressure) — the determinism gate's
        # comparison artifact, bounded like step_trace.
        self.transitions: List[Tuple[int, int, int, float]] = []

    # -- pressure ----------------------------------------------------------

    def pressure(self, sig: BrownoutSignals) -> float:
        cfg = self.config
        ratios = [0.0]
        if cfg.queue_high > 0:
            ratios.append(sig.queue_depth / cfg.queue_high)
        if cfg.kv_high > 0:
            ratios.append(sig.kv_usage / cfg.kv_high)
        if sig.ttft_p95_ms is not None and cfg.ttft_p95_ms:
            ratios.append(sig.ttft_p95_ms / cfg.ttft_p95_ms)
        return max(ratios)

    # -- tick --------------------------------------------------------------

    def tick(self, sig: BrownoutSignals) -> int:
        cfg = self.config
        self.tick_count += 1
        p = self.pressure(sig)
        if self._cooldown > 0:
            self._cooldown -= 1
        if p >= 1.0 + cfg.band_up:
            self._up_streak += 1
            self._down_streak = 0
        elif p <= 1.0 - cfg.band_down:
            self._down_streak += 1
            self._up_streak = 0
        else:  # inside the hysteresis band: full reset — oscillation absorbed
            self._up_streak = 0
            self._down_streak = 0
        if (
            self._up_streak >= cfg.confirm_up
            and self._cooldown == 0
            and self.rung < cfg.max_rung
        ):
            self._move(self.rung + 1, p)
        elif (
            self._down_streak >= cfg.confirm_down
            and self._cooldown == 0
            and self.rung > RUNG_NORMAL
        ):
            self._move(self.rung - 1, p)
        return self.rung

    def _move(self, to: int, pressure: float) -> None:
        self.transitions.append((self.tick_count, self.rung, to, pressure))
        if len(self.transitions) > 4096:
            del self.transitions[:2048]
        self.rung = to
        self._cooldown = self.config.cooldown
        self._up_streak = 0
        self._down_streak = 0

    # -- introspection -----------------------------------------------------

    def state(self) -> Dict[str, Any]:
        return {
            "rung": self.rung,
            "name": RUNG_NAMES.get(self.rung, str(self.rung)),
            "tick": self.tick_count,
            "up_streak": self._up_streak,
            "down_streak": self._down_streak,
            "cooldown": self._cooldown,
            "transitions": len(self.transitions),
        }


# --------------------------------------------------------------------------
# Edge controller (quota check + rung enforcement in one object)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class QosConfig:
    """The edge's ``qos`` config section (runtime/config.py; CLI --qos-*).

    ``rate=None`` disables quotas; ``brownout=None`` disables the ladder —
    both default off so embedded/test services see zero behaviour change.
    """

    rate: Optional[float] = None
    burst: Optional[float] = None
    tenants: Dict[str, Dict[str, float]] = field(default_factory=dict)
    brownout: Optional[BrownoutConfig] = None
    tick_s: float = 0.5

    @classmethod
    def from_dict(cls, d: Optional[Mapping[str, Any]]) -> "QosConfig":
        d = d or {}
        brownout = d.get("brownout")
        if isinstance(brownout, Mapping):
            brownout = BrownoutConfig.from_dict(brownout)
        elif brownout:  # truthy scalar: enable with defaults
            brownout = BrownoutConfig()
        else:
            brownout = None
        rate = d.get("rate")
        return cls(
            rate=float(rate) if rate not in (None, "", 0) else None,
            burst=float(d["burst"]) if d.get("burst") else None,
            tenants=dict(d.get("tenants") or {}),
            brownout=brownout,
            tick_s=float(d.get("tick_s", 0.5)),
        )


class QosShed(Exception):
    """A QoS decision shed this request (maps to 429/503 at the edge)."""

    def __init__(
        self,
        status: int,
        message: str,
        retry_after_s: float,
        reason: str = "quota",
    ):
        super().__init__(message)
        self.status = status
        self.message = message
        self.retry_after_s = retry_after_s
        self.reason = reason  # "quota" | "batch_shed"


class QosController:
    """Bundles quotas + ladder for the HTTP edge.

    ``admit(tenant, priority)`` makes the cheap pre-admission decisions
    (quota charge, rung-3 batch shed); ``shape(body)`` applies the current
    rung's request rewrites (max_tokens cap, spec stand-down) to an
    admitted request.  Rung-4 interactive overflow is decided by the edge
    itself, which can see admission-controller saturation.
    """

    def __init__(self, config: Optional[QosConfig] = None, clock=time.monotonic):
        self.config = config or QosConfig()
        self.quotas = TenantQuotas(
            rate=self.config.rate,
            burst=self.config.burst,
            tenants=self.config.tenants,
            clock=clock,
        )
        self.ladder = (
            BrownoutLadder(self.config.brownout)
            if self.config.brownout is not None
            else None
        )

    @property
    def rung(self) -> int:
        return self.ladder.rung if self.ladder is not None else RUNG_NORMAL

    def admit(
        self,
        tenant: str,
        priority: str,
        drain_retry_after_s: Optional[float] = None,
    ) -> None:
        """Raise QosShed if quota or the brownout rung rejects the request.

        ``drain_retry_after_s`` is the edge's queue-drain estimate
        (AdmissionController.estimate_retry_after); shed responses back
        clients off proportionally to REAL pressure, scaled up with the
        rung (deeper brownout → longer back-off)."""
        # Rung check FIRST: a request the brownout sheds consumed no
        # capacity, so it must not drain the tenant's bucket — otherwise a
        # well-behaved batch tenant exits the brownout already quota-broke
        # for work that was never served.
        if self.rung >= RUNG_SHED_BATCH and priority == BATCH:
            base = drain_retry_after_s if drain_retry_after_s else 1.0
            raise QosShed(
                429,
                f"brownout rung {self.rung} "
                f"({RUNG_NAMES[self.rung]}): batch class shed",
                base * (1 + self.rung - RUNG_SHED_BATCH),
                reason="batch_shed",
            )
        ok, refill_s = self.quotas.try_acquire(tenant)
        if not ok:
            # Quota Retry-After is the tenant's own refill time — never the
            # fleet's drain rate; the tenant is the bottleneck, not us.
            raise QosShed(
                429,
                f"tenant {tenant!r} over its request quota",
                max(refill_s, 0.05),
                reason="quota",
            )

    def shape(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """Apply the current rung's degradations to an ADMITTED request
        body (returns the same dict, mutated — the edge owns it by now)."""
        rung = self.rung
        if rung >= RUNG_CAP_TOKENS:
            cap = self.config.brownout.max_tokens_cap if self.config.brownout else 256
            for key in ("max_tokens", "max_completion_tokens"):
                req = body.get(key)
                if req is None and key == "max_tokens":
                    body[key] = cap
                elif isinstance(req, int) and req > cap:
                    body[key] = cap
        if rung >= RUNG_SPEC_STANDDOWN:
            # NOT setdefault: a client-sent ``"nvext": null`` would satisfy
            # setdefault and silently skip the stand-down.
            nvext = body.get("nvext")
            if not isinstance(nvext, dict):
                nvext = {}
                body["nvext"] = nvext
            nvext["spec_decode"] = False
        return body


__all__ = [
    "BATCH",
    "BrownoutConfig",
    "BrownoutLadder",
    "BrownoutSignals",
    "INTERACTIVE",
    "QosConfig",
    "QosController",
    "QosShed",
    "RUNG_NAMES",
    "TenantQuotas",
    "normalize_priority",
    "resolve_priority",
    "resolve_tenant",
]

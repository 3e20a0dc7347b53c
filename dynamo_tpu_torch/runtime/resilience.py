"""Request-resilience primitives of the HTTP edge: deadlines, admission.

The part of the JAX package's ``runtime/resilience.py`` that the edge
uses: ``Deadline``, ``AdmissionController`` and ``ResilienceMetrics``.
``RetryPolicy``, ``CircuitBreaker`` and the config-built admission
controller come with their reader, the routed client (ROADMAP queue 1
item 10).

- ``Deadline``        — a wall-clock budget carried on the request context and
  decremented across hops (client pick → connect → first token → disagg
  transfer wait); the HTTP edge maps exhaustion to 504.
- ``AdmissionController`` — HTTP-edge load shedding: an in-flight cap plus a
  bounded FIFO wait queue.  Queue overflow sheds immediately with 429; a
  queued request that cannot get a slot within the wait budget sheds with
  503.  Both carry ``Retry-After`` (lib/llm http service returns 429 on
  model-busy; the cap here is service-wide).
- ``ResilienceMetrics`` — process-global counters rendered as Prometheus
  text and appended to the existing ``/metrics`` exposition
  (llm/http_service.py), so shed counts are observable without a new
  scrape target.

Everything here is pure host-side asyncio/stdlib — no device work, no new deps.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque

from ..labels import escape_label
from typing import Callable, Dict, Optional


# --------------------------------------------------------------------------
# Deadlines
# --------------------------------------------------------------------------


class DeadlineExceededError(TimeoutError):
    """The request's deadline budget is exhausted (HTTP edge → 504)."""


class Deadline:
    """A monotonic-clock budget threaded through Context across hops."""

    __slots__ = ("expires_at",)

    def __init__(self, expires_at: float):
        self.expires_at = expires_at

    @classmethod
    def after(cls, seconds: float) -> "Deadline":
        return cls(time.monotonic() + seconds)

    def remaining(self) -> float:
        return self.expires_at - time.monotonic()

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0

    def check(self, what: str = "request") -> None:
        if self.expired:
            raise DeadlineExceededError(f"deadline exceeded ({what})")

    async def bound(self, awaitable, what: str = "request"):
        """Await with the remaining budget; timeout → DeadlineExceededError."""
        try:
            return await asyncio.wait_for(awaitable, max(self.remaining(), 0.0))
        except asyncio.TimeoutError:
            raise DeadlineExceededError(f"deadline exceeded ({what})") from None


def deadline_of(ctx) -> Optional[Deadline]:
    """The Deadline attached to an AsyncEngineContext (or None)."""
    return getattr(ctx, "deadline", None)


# --------------------------------------------------------------------------
# HTTP admission control
# --------------------------------------------------------------------------


class AdmissionRejected(Exception):
    """Load shed at the HTTP edge (429 queue-full / 503 wait-timeout)."""

    def __init__(self, status: int, message: str, retry_after_s: float):
        super().__init__(message)
        self.status = status
        self.message = message
        self.retry_after_s = retry_after_s


class AdmissionController:
    """In-flight cap + bounded FIFO wait queue with a wait budget.

    ``max_inflight=None`` disables admission control entirely (the default:
    zero behaviour change for embedded/test services).

    QoS extensions (llm/qos.py):

    - ``acquire(priority)`` — ``batch``-class requests may only occupy the
      FRONT fraction of the wait queue (``batch_queue_frac``); the rest is
      reserved headroom for interactive arrivals, so a batch burst cannot
      queue interactive traffic out under pressure.
    - ``estimate_retry_after`` — Retry-After computed from the measured
      queue DRAIN RATE (recent slot releases per second) instead of a fixed
      constant, so shed clients back off proportionally to real pressure.
    """

    # Releases sampled for the drain-rate estimate (~the last few seconds
    # of churn at any realistic service rate).
    DRAIN_WINDOW = 64

    def __init__(
        self,
        max_inflight: Optional[int] = None,
        max_queue: int = 0,
        queue_timeout_s: float = 1.0,
        batch_queue_frac: float = 0.5,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.max_inflight = max_inflight
        self.max_queue = max(0, max_queue)
        self.queue_timeout_s = queue_timeout_s
        self.batch_queue_frac = min(max(batch_queue_frac, 0.0), 1.0)
        self._clock = clock
        self._inflight = 0
        self._waiters: deque = deque()  # FIFO of futures awaiting a slot
        self._releases: deque = deque(maxlen=self.DRAIN_WINDOW)

    @property
    def inflight(self) -> int:
        return self._inflight

    @property
    def queued(self) -> int:
        return len(self._waiters)

    @property
    def saturated(self) -> bool:
        """Admission would queue (or shed) right now — the brownout
        ladder's rung-4 'interactive overflow' predicate."""
        return self.max_inflight is not None and self._inflight >= self.max_inflight

    def drain_rate(self) -> float:
        """Recent slot releases per second (0.0 until enough samples)."""
        if len(self._releases) < 2:
            return 0.0
        span = self._releases[-1] - self._releases[0]
        if span <= 0:
            return 0.0
        return (len(self._releases) - 1) / span

    def estimate_retry_after(self, ahead: Optional[int] = None) -> float:
        """Seconds until roughly ``ahead`` queued requests drain (default:
        the current queue plus one — where a new arrival would land).
        Falls back to the wait budget before any drain history exists."""
        ahead = len(self._waiters) + 1 if ahead is None else max(ahead, 1)
        rate = self.drain_rate()
        if rate <= 0:
            return max(1.0, self.queue_timeout_s)
        return min(max(ahead / rate, 0.05), 60.0)

    def _retry_after(self) -> float:
        return self.estimate_retry_after()

    async def acquire(self, priority: str = "interactive") -> None:
        if self.max_inflight is None:
            return
        if self._inflight < self.max_inflight:
            self._inflight += 1
            return
        # Queue reservation: batch requests only occupy the front
        # batch_queue_frac of the wait queue; the remainder stays free for
        # interactive arrivals (protected admission under pressure).
        limit = (
            int(self.max_queue * self.batch_queue_frac)
            if priority == "batch"
            else self.max_queue
        )
        if len(self._waiters) >= limit:
            metrics.admission_shed["429"] = metrics.admission_shed.get("429", 0) + 1
            raise AdmissionRejected(
                429, "server overloaded (admission queue full)", self._retry_after()
            )
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._waiters.append(fut)
        try:
            await asyncio.wait_for(fut, self.queue_timeout_s)
        except asyncio.TimeoutError:
            if fut.done() and not fut.cancelled():
                # release() handed the slot over in the same tick the timer
                # fired — keep it, or the transferred slot leaks forever.
                return
            self._discard(fut)
            metrics.admission_shed["503"] = metrics.admission_shed.get("503", 0) + 1
            raise AdmissionRejected(
                503, "server overloaded (admission wait timed out)", self._retry_after()
            ) from None
        except asyncio.CancelledError:
            if fut.done() and not fut.cancelled():
                self.release()  # slot was handed over as we were cancelled
            else:
                self._discard(fut)
            raise
        # fut resolved: the releasing request handed its slot to us
        # (inflight count was transferred, not decremented).

    def release(self) -> None:
        if self.max_inflight is None:
            return
        self._releases.append(self._clock())
        while self._waiters:
            fut = self._waiters.popleft()
            if not fut.done():
                fut.set_result(None)  # hand the slot over; _inflight unchanged
                return
        self._inflight = max(0, self._inflight - 1)

    def _discard(self, fut: asyncio.Future) -> None:
        try:
            self._waiters.remove(fut)
        except ValueError:
            pass


# --------------------------------------------------------------------------
# Metrics (appended to the existing Prometheus exposition)
# --------------------------------------------------------------------------


class ResilienceMetrics:
    """Process-global resilience counters.

    Rendered as Prometheus text by ``render()`` and appended to the HTTP
    service's ``/metrics`` body — plain ints, no prometheus_client registry,
    so the runtime layer stays dependency-free.
    """

    def __init__(self):
        self.retries_total = 0
        self.failovers_total = 0
        self.retries_exhausted_total = 0
        self.deadline_exceeded_total = 0
        self.watch_restarts_total = 0
        self.degraded_prefills_total = 0
        # Live-migration stream splices (client consumed a ``migrated``
        # marker and re-dispatched to the target worker).
        self.migration_splices_total = 0
        # Mid-stream crash recoveries: a seeded request's stream was
        # reconstructed from delivered tokens and resumed elsewhere.
        self.stream_resumes_total = 0
        # Hub session resume (transports/hub.py HubClient): reconnects to a
        # restarted/recovered hub, subscriptions re-armed onto their live
        # consumers, and unacked queue items returned to the queue.
        self.hub_reconnects_total = 0
        self.hub_sessions_resumed_total = 0
        self.hub_requeued_items_total = 0
        self.admission_shed: Dict[str, int] = {}

    def reset(self) -> None:
        self.__init__()

    def render(self, prefix: str = "dynamo_tpu") -> str:
        ns = f"{prefix}_resilience"
        lines = []

        def counter(name: str, help_: str, value: int) -> None:
            lines.append(f"# HELP {ns}_{name} {help_}")
            lines.append(f"# TYPE {ns}_{name} counter")
            lines.append(f"{ns}_{name} {value}")

        counter("retries_total", "Connect/prologue retries", self.retries_total)
        counter("failovers_total", "Requests failed over to another worker",
                self.failovers_total)
        counter("retries_exhausted_total",
                "Requests that exhausted their retry budget",
                self.retries_exhausted_total)
        counter("deadline_exceeded_total", "Requests past their deadline",
                self.deadline_exceeded_total)
        counter("watch_restarts_total", "Instance-watch loops re-established",
                self.watch_restarts_total)
        counter("degraded_prefills_total",
                "Disagg remote prefills degraded to local",
                self.degraded_prefills_total)
        counter("migration_splices_total",
                "Streams spliced to a migration target mid-flight",
                self.migration_splices_total)
        counter("stream_resumes_total",
                "Seeded streams resumed on another worker after a "
                "mid-stream crash",
                self.stream_resumes_total)
        counter("hub_reconnects_total",
                "Hub connections re-established after loss",
                self.hub_reconnects_total)
        counter("hub_sessions_resumed_total",
                "Hub subscriptions re-armed across a reconnect",
                self.hub_sessions_resumed_total)
        counter("hub_requeued_items_total",
                "Unacked queue items returned to the hub queue on "
                "connection loss",
                self.hub_requeued_items_total)
        lines.append(f"# HELP {ns}_admission_shed_total Requests shed at admission")
        lines.append(f"# TYPE {ns}_admission_shed_total counter")
        for code, n in sorted(self.admission_shed.items()):
            lines.append(f'{ns}_admission_shed_total{{status="{escape_label(code)}"}} {n}')
        # The breaker families, empty until the routed client registers
        # breakers (ROADMAP queue 1 item 10); kept so the exposition is the
        # JAX edge's line for line.
        lines.append(f"# HELP {ns}_breaker_state Circuit state (0=closed 1=half-open 2=open)")
        lines.append(f"# TYPE {ns}_breaker_state gauge")
        lines.append(f"# HELP {ns}_breaker_transitions_total Breaker state transitions")
        lines.append(f"# TYPE {ns}_breaker_transitions_total counter")
        return "\n".join(lines) + "\n"


metrics = ResilienceMetrics()

"""HTTP-edge Prometheus metrics.

Copy of the HTTP-service part of the JAX package's ``llm/metrics.py``:
``Status``, ``Metrics`` with its families and rolling-window percentile
gauges, and ``InflightGuard``.  Reference semantics:
lib/llm/src/http/service/metrics.rs:57-128,319 —
``{prefix}_http_service_{requests_total, inflight_requests,
request_duration_seconds, time_to_first_token_seconds,
inter_token_latency_seconds}`` with status labels
``success | client_drop | rejected | error``, and a RAII ``InflightGuard``
that records duration + status when dropped.

``prometheus_client`` is not used: the small ``Counter``, ``Gauge`` and
``Histogram`` below render the same exposition text (names, label names,
buckets, value format) minus the optional ``_created`` series, so one
scraper reads both packages.  ``EngineDispatchMetrics`` is the colocated
engine's dispatch-health group, ``SpecDecodeMetrics`` its speculative
decoding group and ``QosMetrics`` the edge's quota and brownout group; the
resilience and tracing groups live beside their producers
(runtime/resilience.py, runtime/tracing.py).  ``KvTierMetrics``,
``KvIntegrityMetrics`` and ``ObjstoreMetrics`` are the KV memory tiers'
groups (engine/offload.py, the tier stores and the cross-worker prefix
pull, llm/kv_router/pull.py), ``MigrationMetrics`` live migration's
(llm/migration), ``BulkMetrics`` the bulk data plane's
(runtime/transports/bulk.py and its three consumers).  The health
watchdog's group lives beside it (runtime/health.py ``health_metrics``).
The planner's group lives beside it (planner/pmetrics.py).
``TenancyMetrics`` is the tenancy group: structured output's counters
(llm/tenancy/grammar.py, the preprocessor's compile cache and hash-first
wire, the engine's mask rows) and multi-LoRA's (llm/tenancy/lora.py).
``Metrics.edge_slo_snapshot`` and ``EngineDispatchMetrics.host_gap_frac``
feed the edge's ``slo_metrics`` publication (planner/signals.py
``EdgeSloPublisher``).
"""

from __future__ import annotations

import math
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from ..labels import escape_label

REQUEST_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
TOKEN_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5)


class Status:
    SUCCESS = "success"
    CLIENT_DROP = "client_drop"
    REJECTED = "rejected"
    ERROR = "error"


# -- a minimal Prometheus client ------------------------------------------------


def _fmt(v: float) -> str:
    """A sample value as prometheus_client writes it (Go float syntax)."""
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    return repr(float(v))


def _labels(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    return "{" + ",".join(f'{n}="{escape_label(v)}"' for n, v in zip(names, values)) + "}"


class _Value:
    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount

    def set(self, value: float) -> None:
        self.value = float(value)


class _HistogramValue:
    def __init__(self, buckets: Sequence[float]):
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        for i, upper in enumerate(self.buckets):
            if value <= upper:
                self.counts[i] += 1
        self.count += 1
        self.sum += value


class _Family:
    """A labelled metric family; ``labels(*values)`` returns its child."""

    kind = ""

    def __init__(self, name: str, doc: str, labelnames: Sequence[str]):
        self.name = name
        self.doc = doc
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], object] = {}

    def _child(self):
        return _Value()

    def labels(self, *values: object):
        if len(values) != len(self.labelnames):
            raise ValueError(f"{self.name}: expected labels {self.labelnames}")
        key = tuple(str(v) for v in values)
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = self._child()
        return child

    def samples(self) -> List[str]:
        return [
            f"{self.name}{_labels(self.labelnames, key)} {_fmt(child.value)}"
            for key, child in self._children.items()
        ]

    def render(self) -> List[str]:
        doc = self.doc.replace("\\", r"\\").replace("\n", r"\n")
        return [f"# HELP {self.name} {doc}", f"# TYPE {self.name} {self.kind}", *self.samples()]


class Counter(_Family):
    kind = "counter"


class Gauge(_Family):
    kind = "gauge"


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name: str, doc: str, labelnames: Sequence[str], buckets: Sequence[float]):
        super().__init__(name, doc, labelnames)
        self.buckets = tuple(float(b) for b in buckets) + (math.inf,)

    def _child(self):
        return _HistogramValue(self.buckets)

    def samples(self) -> List[str]:
        out = []
        names = ("le", *self.labelnames)
        for key, child in self._children.items():
            for upper, n in zip(self.buckets, child.counts):
                out.append(f"{self.name}_bucket{_labels(names, (_fmt(upper), *key))} {_fmt(n)}")
            out.append(f"{self.name}_count{_labels(self.labelnames, key)} {_fmt(child.count)}")
            out.append(f"{self.name}_sum{_labels(self.labelnames, key)} {_fmt(child.sum)}")
        return out


# -- the edge's metrics -----------------------------------------------------------


class RollingWindow:
    """Bounded rolling sample window with percentile queries.

    Histograms answer "distribution since process start"; the percentile
    gauges answer "distribution right now" — a window of the most recent
    observations, cheap to query at scrape time."""

    def __init__(self, maxlen: int = 2048):
        self._xs: Deque[float] = deque(maxlen=maxlen)

    def observe(self, x: float) -> None:
        self._xs.append(x)

    def percentile(self, p: float) -> float:
        if not self._xs:
            return 0.0
        xs = sorted(self._xs)
        return xs[min(len(xs) - 1, int(len(xs) * p))]

    def __len__(self) -> int:
        return len(self._xs)


class TimedWindow:
    """Sample window bounded by AGE, not count — the brownout ladder's
    latency input (llm/qos.py).  A count-bounded window (RollingWindow)
    holds a spike's samples until enough NEW traffic pushes them out: at
    zero traffic it never drains, so pressure reads high forever and the
    ladder can never recover.  Here samples expire after ``max_age_s``
    regardless of traffic, so "the spike ended" is observable."""

    def __init__(self, max_age_s: float = 10.0, maxlen: int = 4096,
                 clock=time.monotonic):
        self.max_age_s = max_age_s
        self._clock = clock
        self._xs: Deque[Tuple[float, float]] = deque(maxlen=maxlen)

    def observe(self, x: float) -> None:
        self._xs.append((self._clock(), x))

    def _prune(self) -> None:
        horizon = self._clock() - self.max_age_s
        while self._xs and self._xs[0][0] < horizon:
            self._xs.popleft()

    def percentile(self, p: float) -> Optional[float]:
        """p-quantile of the live samples, or None when the window is
        empty (signal absent — distinct from 'fast')."""
        self._prune()
        if not self._xs:
            return None
        xs = sorted(x for _, x in self._xs)
        return xs[min(len(xs) - 1, int(len(xs) * p))]

    def __len__(self) -> int:
        self._prune()
        return len(self._xs)


class Metrics:
    def __init__(self, prefix: str = "dynamo_tpu"):
        ns = f"{prefix}_http_service"
        me = ["model", "endpoint"]
        self.requests_total = Counter(
            f"{ns}_requests_total",
            "Total requests by model/endpoint/status",
            ["model", "endpoint", "request_type", "status"],
        )
        self.inflight = Gauge(f"{ns}_inflight_requests", "Currently in-flight requests", me)
        self.request_duration = Histogram(
            f"{ns}_request_duration_seconds", "End-to-end request duration", me, REQUEST_BUCKETS
        )
        self.ttft = Histogram(
            f"{ns}_time_to_first_token_seconds", "Time to first token (streaming)", me,
            REQUEST_BUCKETS,
        )
        self.itl = Histogram(
            f"{ns}_inter_token_latency_seconds", "Inter-token latency (streaming)", me,
            TOKEN_BUCKETS,
        )
        self.output_tokens = Counter(f"{ns}_output_tokens_total", "Total output tokens produced", me)
        # Rolling-window percentile gauges: the histograms above accumulate
        # since start; these answer "now".
        self.ttft_p50_gauge = Gauge(f"{ns}_ttft_p50_seconds", "Rolling-window TTFT p50", me)
        self.ttft_p95_gauge = Gauge(f"{ns}_ttft_p95_seconds", "Rolling-window TTFT p95", me)
        self.itl_p50_gauge = Gauge(
            f"{ns}_itl_p50_seconds", "Rolling-window inter-token-latency p50", me
        )
        self.itl_p95_gauge = Gauge(
            f"{ns}_itl_p95_seconds", "Rolling-window inter-token-latency p95", me
        )
        self._families = [
            self.requests_total, self.inflight, self.request_duration, self.ttft, self.itl,
            self.output_tokens, self.ttft_p50_gauge, self.ttft_p95_gauge, self.itl_p50_gauge,
            self.itl_p95_gauge,
        ]
        # (model, endpoint) → (ttft window, itl window)
        self._windows: Dict[Tuple[str, str], Tuple[RollingWindow, RollingWindow]] = {}
        # Age-bounded TTFT window across all models: the brownout ladder's
        # latency signal (llm/qos.py) — must DRAIN when the spike ends,
        # which the count-bounded windows above deliberately do not.
        self.ttft_recent = TimedWindow(max_age_s=10.0)

    def recent_ttft_p95_ms(self) -> Optional[float]:
        """p95 TTFT over the last ``ttft_recent.max_age_s`` seconds, or
        None when no request produced a first token in that span."""
        p = self.ttft_recent.percentile(0.95)
        return None if p is None else p * 1e3

    def window(self, model: str, endpoint: str) -> Tuple[RollingWindow, RollingWindow]:
        key = (model, endpoint)
        if key not in self._windows:
            self._windows[key] = (RollingWindow(), RollingWindow())
        return self._windows[key]

    def guard(self, model: str, endpoint: str, request_type: str) -> "InflightGuard":
        return InflightGuard(self, model, endpoint, request_type)

    def _update_quantile_gauges(self) -> None:
        for (model, endpoint), (ttft_w, itl_w) in self._windows.items():
            self.ttft_p50_gauge.labels(model, endpoint).set(ttft_w.percentile(0.5))
            self.ttft_p95_gauge.labels(model, endpoint).set(ttft_w.percentile(0.95))
            self.itl_p50_gauge.labels(model, endpoint).set(itl_w.percentile(0.5))
            self.itl_p95_gauge.labels(model, endpoint).set(itl_w.percentile(0.95))

    def edge_slo_snapshot(self) -> Dict[str, float]:
        """Merged-over-models rolling percentiles in ms (what the edge
        publishes to the planner on the ``slo_metrics`` subject)."""
        ttft_all = RollingWindow(maxlen=4096)
        itl_all = RollingWindow(maxlen=4096)
        for ttft_w, itl_w in self._windows.values():
            for x in ttft_w._xs:
                ttft_all.observe(x)
            for x in itl_w._xs:
                itl_all.observe(x)
        return {
            "ttft_p50_ms": ttft_all.percentile(0.5) * 1e3,
            "ttft_p95_ms": ttft_all.percentile(0.95) * 1e3,
            "itl_p50_ms": itl_all.percentile(0.5) * 1e3,
            "itl_p95_ms": itl_all.percentile(0.95) * 1e3,
            "ttft_samples": float(len(ttft_all)),
            "itl_samples": float(len(itl_all)),
        }

    def render(self) -> bytes:
        self._update_quantile_gauges()
        lines = [line for fam in self._families for line in fam.render()]
        return ("\n".join(lines) + "\n").encode()


class InflightGuard:
    """Tracks one request: inflight gauge, duration, TTFT, ITL, final status.

    Must be closed with ``finish(status)``; a guard dropped without an explicit
    status records ``error`` (the reference's RAII Drop behaviour).
    """

    def __init__(self, metrics: Metrics, model: str, endpoint: str, request_type: str):
        self._m = metrics
        self.model = model
        self.endpoint = endpoint
        self.request_type = request_type
        self._start = time.monotonic()
        self._last_token_t: Optional[float] = None
        self._finished = False
        metrics.inflight.labels(model, endpoint).inc()

    def on_token(self, n_tokens: int = 1) -> None:
        now = time.monotonic()
        ttft_w, itl_w = self._m.window(self.model, self.endpoint)
        if self._last_token_t is None:
            self._m.ttft.labels(self.model, self.endpoint).observe(now - self._start)
            ttft_w.observe(now - self._start)
            self._m.ttft_recent.observe(now - self._start)
        else:
            self._m.itl.labels(self.model, self.endpoint).observe(now - self._last_token_t)
            itl_w.observe(now - self._last_token_t)
        self._last_token_t = now
        self._m.output_tokens.labels(self.model, self.endpoint).inc(n_tokens)

    def finish(self, status: str) -> None:
        if self._finished:
            return
        self._finished = True
        self._m.inflight.labels(self.model, self.endpoint).dec()
        self._m.request_duration.labels(self.model, self.endpoint).observe(
            time.monotonic() - self._start
        )
        self._m.requests_total.labels(
            self.model, self.endpoint, self.request_type, status
        ).inc()

    def __del__(self):
        if not self._finished:
            try:
                self.finish(Status.ERROR)
            except Exception:  # noqa: BLE001 — interpreter teardown
                pass


# -- QoS at the edge ------------------------------------------------------------


class QosMetrics:
    """QoS/overload-control counters (llm/qos.py): per-tenant quota sheds,
    brownout rung + transitions, priority sheds.  Module-level singleton
    rendered as Prometheus text and appended to ``/metrics`` (same pattern
    as ``spec_metrics``)."""

    def __init__(self):
        self.brownout_rung = 0  # gauge: current ladder rung
        self.brownout_transitions_total = 0
        self.quota_shed_total = 0       # 429s from tenant token buckets
        self.batch_shed_total = 0       # rung-3 batch-class sheds
        self.interactive_shed_total = 0  # rung-4 interactive overflow 503s
        self.capped_requests_total = 0  # rung-1 max_tokens caps applied
        self.spec_standdowns_total = 0  # rung-2 spec-decode opt-outs applied
        # tenant → sheds (bounded: the render sorts and truncates)
        self.shed_by_tenant: Dict[str, int] = {}

    def shed_tenant(self, tenant: str) -> None:
        if len(self.shed_by_tenant) < 256 or tenant in self.shed_by_tenant:
            self.shed_by_tenant[tenant] = self.shed_by_tenant.get(tenant, 0) + 1

    def reset(self) -> None:
        self.__init__()

    def snapshot(self) -> Dict[str, float]:
        return {
            k: float(v) for k, v in vars(self).items() if isinstance(v, (int, float))
        }

    def render(self, prefix: str = "dynamo_tpu") -> str:
        ns = f"{prefix}_qos"
        lines = []

        def emit(name: str, kind: str, help_: str, value) -> None:
            lines.append(f"# HELP {ns}_{name} {help_}")
            lines.append(f"# TYPE {ns}_{name} {kind}")
            lines.append(f"{ns}_{name} {value}")

        emit("brownout_rung", "gauge",
             "Current brownout ladder rung (0=normal .. 4=shed-interactive)",
             self.brownout_rung)
        emit("brownout_transitions_total", "counter",
             "Brownout rung transitions", self.brownout_transitions_total)
        emit("quota_shed_total", "counter",
             "Requests shed by tenant token buckets (429)",
             self.quota_shed_total)
        emit("batch_shed_total", "counter",
             "Batch-class requests shed by brownout rung >= 3",
             self.batch_shed_total)
        emit("interactive_shed_total", "counter",
             "Interactive requests shed at rung 4 (admission saturated)",
             self.interactive_shed_total)
        emit("capped_requests_total", "counter",
             "Requests with max_tokens capped by brownout rung >= 1",
             self.capped_requests_total)
        emit("spec_standdowns_total", "counter",
             "Requests with spec-decode stood down by brownout rung >= 2",
             self.spec_standdowns_total)
        lines.append(f"# HELP {ns}_shed_by_tenant_total Sheds per tenant")
        lines.append(f"# TYPE {ns}_shed_by_tenant_total counter")
        for tenant, n in sorted(self.shed_by_tenant.items()):
            # Tenant ids come off the wire (x-tenant header): escape the
            # Prometheus label syntax so a crafted id cannot inject rows
            # into the exposition.  (Credential-sourced ids are already
            # hashed at resolution — llm/qos.py resolve_tenant.)
            safe = escape_label(tenant)
            lines.append(f'{ns}_shed_by_tenant_total{{tenant="{safe}"}} {n}')
        return "\n".join(lines) + "\n"


qos_metrics = QosMetrics()


# -- the colocated engine's dispatch health ---------------------------------------


class EngineDispatchMetrics:
    """Decode-pipeline dispatch health (engine/pipeline.py), copied from the
    JAX package's ``llm/metrics.py``: per-kind dispatch counts/wall/
    percentiles from the engine's step_trace, plus the continuous-batching
    session gauges (sessions, rebuilds, in-loop admissions/retirements,
    fused-loop host-gap fraction).

    Holds a SOURCE callable (``engine.dispatch_summary``) wired by whoever
    colocates an engine with the HTTP edge (``cli run in=http out=torch``);
    rendered as Prometheus text and appended to ``/metrics``.  Without a
    source it renders nothing."""

    def __init__(self):
        self._source = None

    def set_source(self, source) -> None:
        """``source() -> engine.dispatch_summary()`` dict, or None to
        detach."""
        self._source = source

    def host_gap_frac(self) -> Optional[float]:
        """The colocated engine's fused-decode host-gap fraction, or None
        without a wired source (remote-engine edge) — the planner-side
        drift signal (EdgeSloPublisher ``host_gap``)."""
        if self._source is None:
            return None
        try:
            s = self._source()
        except Exception:  # noqa: BLE001 — engine mid-teardown
            return None
        gap = (s.get("pipeline") or {}).get("host_gap_frac")
        return float(gap) if isinstance(gap, (int, float)) else None

    def render(self, prefix: str = "dynamo_tpu") -> str:
        if self._source is None:
            return ""
        try:
            s = self._source()
        except Exception:  # engine mid-teardown: drop this scrape's section
            return ""
        ns = f"{prefix}_engine_dispatch"
        # Per-kind stats come from the engine's BOUNDED step_trace window:
        # gauges, never counters.
        lines = [
            f"# HELP {ns}_window_dispatches Device dispatches per step "
            "kind over the bounded trace window",
            f"# TYPE {ns}_window_dispatches gauge",
        ]
        kinds = sorted(s.get("kinds", {}).items())
        for kind, v in kinds:
            lines.append(f'{ns}_window_dispatches{{kind="{escape_label(kind)}"}} '
                         f'{v["dispatches"]}')
        lines.append(f"# HELP {ns}_window_wall_seconds Wall per step kind "
                     "over the bounded trace window")
        lines.append(f"# TYPE {ns}_window_wall_seconds gauge")
        for kind, v in kinds:
            lines.append(f'{ns}_window_wall_seconds{{kind="{escape_label(kind)}"}} {v["wall_s"]}')
        for q in ("p50", "p99"):
            lines.append(f"# HELP {ns}_{q}_ms {q} dispatch latency per "
                         "step kind (over the bounded trace window)")
            lines.append(f"# TYPE {ns}_{q}_ms gauge")
            for kind, v in kinds:
                lines.append(f'{ns}_{q}_ms{{kind="{escape_label(kind)}"}} {v[f"{q}_ms"]}')
        pipe = s.get("pipeline", {})

        def emit(name: str, kind: str, help_: str, value) -> None:
            lines.append(f"# HELP {ns}_{name} {help_}")
            lines.append(f"# TYPE {ns}_{name} {kind}")
            lines.append(f"{ns}_{name} {value}")

        emit("pipeline_sessions_total", "counter",
             "Fused decode pipeline sessions begun", pipe.get("sessions", 0))
        emit("pipeline_rebuilds_total", "counter",
             "Sessions drained by a rebuild event (incompatible change)",
             pipe.get("rebuilds", 0))
        emit("continuous_admissions_total", "counter",
             "Sequences admitted into a live fused session (no drain)",
             pipe.get("continuous_admissions", 0))
        emit("continuous_retired_total", "counter",
             "Rows retired from a live fused session (no drain)",
             pipe.get("continuous_retired", 0))
        emit("pipeline_wall_seconds_total", "counter",
             "Cumulative fused-session wall time", pipe.get("wall_s", 0.0))
        emit("host_gap_frac", "gauge",
             "Fraction of fused-session wall not covered by decode "
             "dispatch/wait device work", pipe.get("host_gap_frac", 0.0))
        # Decode-stall watchdog, outside the _dispatch namespace: alert
        # rules key on this exact name.
        lines.append(f"# HELP {prefix}_engine_stall_total Token fetches "
                     "that exceeded the decode-stall threshold")
        lines.append(f"# TYPE {prefix}_engine_stall_total counter")
        lines.append(f"{prefix}_engine_stall_total {pipe.get('stalls', 0)}")
        kern = s.get("decode_kernel", "")
        if kern:
            lines.append(f"# HELP {ns}_decode_kernel_info Active decode "
                         "attention kernel (DYN_DECODE_KERNEL)")
            lines.append(f"# TYPE {ns}_decode_kernel_info gauge")
            lines.append(f'{ns}_decode_kernel_info{{kernel="{escape_label(kern)}"}} 1')
        pkern = s.get("prefill_kernel", "")
        if pkern:
            lines.append(f"# HELP {ns}_prefill_kernel_info Active prefill "
                         "attention kernel (DYN_PREFILL_KERNEL)")
            lines.append(f"# TYPE {ns}_prefill_kernel_info gauge")
            lines.append(f'{ns}_prefill_kernel_info{{kernel="{escape_label(pkern)}"}} 1')
        # Prefill-chunk latency summary: cumulative _sum/_count, quantiles
        # over the bounded per-chunk trace window.
        pf = s.get("prefill", {})
        if pf:
            pn = f"{prefix}_prefill_chunk_seconds"
            lines.append(f"# HELP {pn} Prefill chunk dispatch wall time")
            lines.append(f"# TYPE {pn} summary")
            for q, key in (("0.5", "p50_ms"), ("0.99", "p99_ms")):
                lines.append(f'{pn}{{quantile="{escape_label(q)}"}} {pf.get(key, 0.0) / 1e3}')
            lines.append(f"{pn}_sum {pf.get('wall_s', 0.0)}")
            lines.append(f"{pn}_count {pf.get('chunks', 0)}")
            lines.append(f"# HELP {prefix}_prefill_tokens_total Prompt tokens "
                         "computed by prefill chunks")
            lines.append(f"# TYPE {prefix}_prefill_tokens_total counter")
            lines.append(f"{prefix}_prefill_tokens_total {pf.get('prompt_tokens', 0)}")
        return "\n".join(lines) + "\n"


engine_dispatch_metrics = EngineDispatchMetrics()


class SpecDecodeMetrics:
    """Speculative-decoding counters and derived gauges (engine/spec.py),
    copied from the JAX package's ``llm/metrics.py``: a module-level
    singleton that the engine updates and ``/metrics`` appends."""

    def __init__(self):
        self.drafted_total = 0  # draft tokens submitted for verification
        self.accepted_total = 0  # draft tokens accepted
        self.emitted_total = 0  # tokens committed by spec dispatches (incl. bonus)
        self.dispatches_total = 0  # unified verification dispatches
        self.fallback_total = 0  # plans where spec stood down for the fused pipeline

    @property
    def acceptance_rate(self) -> float:
        return self.accepted_total / self.drafted_total if self.drafted_total else 0.0

    @property
    def tokens_per_dispatch(self) -> float:
        return self.emitted_total / self.dispatches_total if self.dispatches_total else 0.0

    def reset(self) -> None:
        self.__init__()

    def snapshot(self) -> Dict[str, float]:
        return {
            "drafted_total": float(self.drafted_total),
            "accepted_total": float(self.accepted_total),
            "emitted_total": float(self.emitted_total),
            "dispatches_total": float(self.dispatches_total),
            "fallback_total": float(self.fallback_total),
            "acceptance_rate": self.acceptance_rate,
            "tokens_per_dispatch": self.tokens_per_dispatch,
        }

    def render(self, prefix: str = "dynamo_tpu") -> str:
        ns = f"{prefix}_spec_decode"
        lines = []

        def emit(name: str, kind: str, help_: str, value) -> None:
            lines.append(f"# HELP {ns}_{name} {help_}")
            lines.append(f"# TYPE {ns}_{name} {kind}")
            lines.append(f"{ns}_{name} {value}")

        emit("drafted_tokens_total", "counter",
             "Draft tokens submitted for in-step verification", self.drafted_total)
        emit("accepted_tokens_total", "counter",
             "Draft tokens accepted (sampled-stream match)", self.accepted_total)
        emit("emitted_tokens_total", "counter",
             "Tokens committed by speculative dispatches (incl. the bonus sample)",
             self.emitted_total)
        emit("dispatches_total", "counter", "Unified verification dispatches",
             self.dispatches_total)
        emit("fallback_total", "counter",
             "Plans where speculation stood down for the fused pipeline", self.fallback_total)
        emit("acceptance_rate", "gauge", "accepted/drafted since start",
             round(self.acceptance_rate, 6))
        emit("tokens_per_dispatch", "gauge", "Committed tokens per verification dispatch",
             round(self.tokens_per_dispatch, 6))
        return "\n".join(lines) + "\n"


spec_metrics = SpecDecodeMetrics()


class MigrationMetrics:
    """Live-sequence-migration counters (llm/migration).

    Module-level singleton rendered as Prometheus text and appended to the
    ``/metrics`` exposition (same pattern as ``spec_metrics``): the worker
    process updates plain attributes; no registry dependency."""

    def __init__(self):
        self.started_total = 0       # migrate_out attempts begun
        self.completed_total = 0     # cutovers that landed
        self.rolled_back_total = 0   # phase-2 failures (source kept authority)
        self.aborted_total = 0       # phase-1 aborts (seq finished / target cold)
        self.migrated_in_total = 0   # commits accepted on the target side
        self.blocks_total = 0        # KV blocks pushed (phase 1 + final delta)
        self.bytes_total = 0         # payload bytes pushed
        self.cutover_pause_ms = RollingWindow(maxlen=512)  # freeze→cutover wall

    def reset(self) -> None:
        self.__init__()

    def snapshot(self) -> Dict[str, float]:
        return {
            "started_total": float(self.started_total),
            "completed_total": float(self.completed_total),
            "rolled_back_total": float(self.rolled_back_total),
            "aborted_total": float(self.aborted_total),
            "migrated_in_total": float(self.migrated_in_total),
            "blocks_total": float(self.blocks_total),
            "bytes_total": float(self.bytes_total),
            "cutover_pause_ms_p50": self.cutover_pause_ms.percentile(0.5),
            "cutover_pause_ms_p95": self.cutover_pause_ms.percentile(0.95),
        }

    def render(self, prefix: str = "dynamo_tpu") -> str:
        ns = f"{prefix}_migration"
        lines = []

        def emit(name: str, kind: str, help_: str, value) -> None:
            lines.append(f"# HELP {ns}_{name} {help_}")
            lines.append(f"# TYPE {ns}_{name} {kind}")
            lines.append(f"{ns}_{name} {value}")

        emit("started_total", "counter",
             "Live migrations begun (source side)", self.started_total)
        emit("completed_total", "counter",
             "Live migrations cut over successfully", self.completed_total)
        emit("rolled_back_total", "counter",
             "Migrations rolled back in the final-delta phase "
             "(source stayed authoritative)", self.rolled_back_total)
        emit("aborted_total", "counter",
             "Migrations abandoned in the copy phase", self.aborted_total)
        emit("migrated_in_total", "counter",
             "Migration commits accepted (target side)",
             self.migrated_in_total)
        emit("kv_blocks_total", "counter",
             "KV blocks pushed by migrations", self.blocks_total)
        emit("kv_bytes_total", "counter",
             "KV payload bytes pushed by migrations", self.bytes_total)
        emit("cutover_pause_ms_p50", "gauge",
             "Rolling p50 of the freeze-to-cutover pause",
             round(self.cutover_pause_ms.percentile(0.5), 3))
        emit("cutover_pause_ms_p95", "gauge",
             "Rolling p95 of the freeze-to-cutover pause",
             round(self.cutover_pause_ms.percentile(0.95), 3))
        return "\n".join(lines) + "\n"


migration_metrics = MigrationMetrics()


class TenancyMetrics:
    """The JAX package's tenancy group (llm/tenancy): grammar-constrained
    decoding + batched multi-LoRA, rendered under the same names."""

    def __init__(self):
        # structured output
        self.grammar_requests_total = 0   # requests carrying a constraint
        self.grammar_compiles_total = 0   # automaton compiles (cache misses)
        self.grammar_cache_hits_total = 0
        self.grammar_masked_rows_total = 0  # device rows sampled under a mask
        self.grammar_violations_total = 0   # defensive: inadmissible accepts
        # hash-first wire protocol (engine content-hash LRU)
        self.grammar_hash_hits_total = 0    # stubs resolved with zero bytes
        self.grammar_hash_misses_total = 0  # stubs that forced a full resend
        self.grammar_full_resends_total = 0  # preprocessor-side fallbacks
        self.grammar_stub_dispatches_total = 0  # stubs accepted first try
        # multi-LoRA
        self.adapters_registered = 0      # gauge: host-pool size
        self.adapter_promotions = 0       # host→device slot writes
        self.adapter_evictions = 0        # resident slots reclaimed
        self.adapter_requests_total = 0   # requests routed to an adapter
        self.adapter_not_found_total = 0  # unknown-model rejections

    def reset(self) -> None:
        self.__init__()

    def snapshot(self) -> Dict[str, float]:
        return {k: float(v) for k, v in vars(self).items()}

    def render(self, prefix: str = "dynamo_tpu") -> str:
        ns = f"{prefix}_tenancy"
        lines = []

        def emit(name: str, kind: str, help_: str, value) -> None:
            lines.append(f"# HELP {ns}_{name} {help_}")
            lines.append(f"# TYPE {ns}_{name} {kind}")
            lines.append(f"{ns}_{name} {value}")

        emit("grammar_requests_total", "counter",
             "Requests with a structured-output constraint",
             self.grammar_requests_total)
        emit("grammar_compiles_total", "counter",
             "Token-mask automaton compiles (cache misses)",
             self.grammar_compiles_total)
        emit("grammar_cache_hits_total", "counter",
             "Constraint compile-cache hits", self.grammar_cache_hits_total)
        emit("grammar_masked_rows_total", "counter",
             "Device rows sampled under a grammar mask",
             self.grammar_masked_rows_total)
        emit("grammar_violations_total", "counter",
             "Accepted tokens the mask should have forbidden (defensive; "
             "always 0)", self.grammar_violations_total)
        emit("grammar_hash_hits_total", "counter",
             "Hash-only grammar stubs resolved from the engine LRU",
             self.grammar_hash_hits_total)
        emit("grammar_hash_misses_total", "counter",
             "Hash-only grammar stubs that forced a full-table resend",
             self.grammar_hash_misses_total)
        emit("grammar_full_resends_total", "counter",
             "Constrained dispatches that fell back to the full edge table",
             self.grammar_full_resends_total)
        emit("grammar_stub_dispatches_total", "counter",
             "Constrained dispatches served hash-only end to end",
             self.grammar_stub_dispatches_total)
        emit("lora_adapters_registered", "gauge",
             "Adapters in the host pool", self.adapters_registered)
        emit("lora_promotions_total", "counter",
             "Adapter host-to-device slot promotions", self.adapter_promotions)
        emit("lora_evictions_total", "counter",
             "Resident adapter slots reclaimed", self.adapter_evictions)
        emit("lora_requests_total", "counter",
             "Requests served through a LoRA adapter",
             self.adapter_requests_total)
        emit("lora_model_not_found_total", "counter",
             "Requests naming an unregistered model/adapter",
             self.adapter_not_found_total)
        return "\n".join(lines) + "\n"


tenancy_metrics = TenancyMetrics()


class KvTierMetrics:
    """Tiered-KV-cache counters + gauges: per-tier bytes/blocks,
    restore/demote/promote/pull activity, restore + pull latency
    percentiles.  Module-level singleton rendered as Prometheus
    text and appended to ``/metrics`` (same pattern as ``spec_metrics``).

    Counters are updated inline by the engine (the pull counters by the
    cross-worker puller, llm/kv_router/pull.py); the per-tier
    bytes/blocks GAUGES come from a source callable
    (``engine.kv_tier_summary`` — wired like EngineDispatchMetrics by
    whoever colocates an engine with the HTTP edge), so remote-engine
    edges render counters only."""

    def __init__(self):
        self._source = None
        # restore path (host/disk → HBM ahead of admission)
        self.restore_hits_total = 0      # requests that restored ≥1 block
        self.restore_misses_total = 0    # tiered restore attempts, 0 blocks
        self.restored_blocks_total = 0   # host→HBM scatters
        self.promoted_blocks_total = 0   # disk→host promotions
        self.prefetched_blocks_total = 0  # promotions driven by kv_prefetch
        # cross-worker pull (the JAX package's llm/kv_router/pull.py)
        self.pulls_started_total = 0
        self.pulls_completed_total = 0
        self.pulls_failed_total = 0      # any degraded-to-local outcome
        self.pulled_blocks_total = 0
        self.pulled_bytes_total = 0
        self.restore_latency_ms = RollingWindow(maxlen=1024)
        self.pull_latency_ms = RollingWindow(maxlen=512)

    def set_source(self, source) -> None:
        """``source() -> engine.kv_tier_summary()`` dict, or None."""
        self._source = source

    def reset(self) -> None:
        self.__init__()

    def tier_summary(self) -> Dict[str, object]:
        """The engine's per-tier gauges ({} without a wired source) —
        shared by render() and the edge SLO publication."""
        if self._source is None:
            return {}
        try:
            return self._source() or {}
        except Exception:  # noqa: BLE001 — engine mid-teardown
            return {}

    def snapshot(self) -> Dict[str, float]:
        out = {
            k: float(v) for k, v in vars(self).items() if isinstance(v, (int, float))
        }
        out["restore_latency_ms_p50"] = self.restore_latency_ms.percentile(0.5)
        out["restore_latency_ms_p99"] = self.restore_latency_ms.percentile(0.99)
        out["pull_latency_ms_p50"] = self.pull_latency_ms.percentile(0.5)
        out["pull_latency_ms_p99"] = self.pull_latency_ms.percentile(0.99)
        return out

    def render(self, prefix: str = "dynamo_tpu") -> str:
        ns = f"{prefix}_kv_tier"
        lines = []

        def emit(name: str, kind: str, help_: str, value) -> None:
            lines.append(f"# HELP {ns}_{name} {help_}")
            lines.append(f"# TYPE {ns}_{name} {kind}")
            lines.append(f"{ns}_{name} {value}")

        summary = self.tier_summary()
        tiers = [t for t in ("hbm", "host", "disk", "objstore") if t in summary]
        if tiers:
            lines.append(f"# HELP {ns}_blocks Sealed KV blocks per tier")
            lines.append(f"# TYPE {ns}_blocks gauge")
            for t in tiers:  # bounded constant label set
                lines.append(
                    f'{ns}_blocks{{tier="{escape_label(t)}"}} '
                    f'{summary[t]["blocks"]}'
                )
            lines.append(f"# HELP {ns}_bytes KV bytes per tier")
            lines.append(f"# TYPE {ns}_bytes gauge")
            for t in tiers:
                lines.append(
                    f'{ns}_bytes{{tier="{escape_label(t)}"}} '
                    f'{summary[t]["bytes"]}'
                )
            emit("prefix_hit_rate", "gauge",
                 "Engine prefix-cache hit rate (matched/looked-up blocks)",
                 round(float(summary.get("prefix_hit_rate", 0.0)), 6))
        emit("restore_hits_total", "counter",
             "Requests that restored >=1 prefix block from a lower tier",
             self.restore_hits_total)
        emit("restore_misses_total", "counter",
             "Tiered restore attempts that found nothing restorable",
             self.restore_misses_total)
        emit("restored_blocks_total", "counter",
             "Blocks scattered host->HBM ahead of admission",
             self.restored_blocks_total)
        emit("promoted_blocks_total", "counter",
             "Blocks promoted disk->host", self.promoted_blocks_total)
        emit("prefetched_blocks_total", "counter",
             "disk->host promotions driven by the kv_prefetch plane",
             self.prefetched_blocks_total)
        emit("pulls_started_total", "counter",
             "Cross-worker prefix pulls attempted", self.pulls_started_total)
        emit("pulls_completed_total", "counter",
             "Cross-worker prefix pulls that landed blocks",
             self.pulls_completed_total)
        emit("pulls_failed_total", "counter",
             "Pulls degraded to local prefill (timeout/refusal/error)",
             self.pulls_failed_total)
        emit("pulled_blocks_total", "counter",
             "Blocks imported by cross-worker pulls", self.pulled_blocks_total)
        emit("pulled_bytes_total", "counter",
             "Bytes imported by cross-worker pulls", self.pulled_bytes_total)
        emit("restore_latency_ms_p50", "gauge",
             "Rolling p50 of tier-restore latency",
             round(self.restore_latency_ms.percentile(0.5), 3))
        emit("restore_latency_ms_p99", "gauge",
             "Rolling p99 of tier-restore latency",
             round(self.restore_latency_ms.percentile(0.99), 3))
        emit("pull_latency_ms_p50", "gauge",
             "Rolling p50 of cross-worker pull latency",
             round(self.pull_latency_ms.percentile(0.5), 3))
        emit("pull_latency_ms_p99", "gauge",
             "Rolling p99 of cross-worker pull latency",
             round(self.pull_latency_ms.percentile(0.99), 3))
        return "\n".join(lines) + "\n"


kv_tier_metrics = KvTierMetrics()

# The integrity plane's verification boundaries (engine/integrity.py):
# ``disk`` = .kvblk envelope reads, ``host`` = host-tier entries verified
# before the HBM scatter (plus demotion-time re-verification), ``wire`` =
# transfer-plane payloads verified before sealing (disaggregated imports,
# prefix pulls, migration pushes), ``objstore`` = durable-object envelope
# reads (engine/object_store.py).
INTEGRITY_PLANES = ("disk", "host", "wire", "objstore")


class KvIntegrityMetrics:
    """KV integrity-plane counters: per-plane verified/corrupt, plus the
    quarantine machinery's activity — negative-cache hits, chained-descendant drops, recompute fallbacks,
    and corruption-attributed worker quarantines.  Module-level singleton
    rendered as Prometheus text and appended to ``/metrics``."""

    def __init__(self):
        self.verified_total: Dict[str, int] = {p: 0 for p in INTEGRITY_PLANES}
        self.corrupt_total: Dict[str, int] = {p: 0 for p in INTEGRITY_PLANES}
        # blocks dropped from the tiers because their chain passes through
        # a corrupt block (the corrupt block itself is not counted here)
        self.descendants_dropped_total = 0
        # restore/promotion/pull attempts skipped on a negative-cached hash
        self.negative_cache_hits_total = 0
        # corruption events that degraded a live request to recompute
        # (the disagg degraded-mode shape — never a drop, never a wrong token)
        self.recomputed_total = 0
        # watchdog quarantines attributed to repeated KV corruption
        self.quarantined_total = 0

    def reset(self) -> None:
        self.__init__()

    def corrupt_sum(self) -> int:
        return sum(self.corrupt_total.values())

    def verified_sum(self) -> int:
        return sum(self.verified_total.values())

    def snapshot(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for p in INTEGRITY_PLANES:
            out[f"verified_{p}_total"] = float(self.verified_total[p])
            out[f"corrupt_{p}_total"] = float(self.corrupt_total[p])
        out["descendants_dropped_total"] = float(self.descendants_dropped_total)
        out["negative_cache_hits_total"] = float(self.negative_cache_hits_total)
        out["recomputed_total"] = float(self.recomputed_total)
        out["quarantined_total"] = float(self.quarantined_total)
        return out

    def render(self, prefix: str = "dynamo_tpu") -> str:
        ns = f"{prefix}_kv_integrity"
        lines = []

        def per_plane(name: str, help_: str, values: Dict[str, int]) -> None:
            lines.append(f"# HELP {ns}_{name} {help_}")
            lines.append(f"# TYPE {ns}_{name} counter")
            for p in INTEGRITY_PLANES:  # bounded constant label set
                lines.append(
                    f'{ns}_{name}{{plane="{escape_label(p)}"}} {values[p]}'
                )

        def emit(name: str, help_: str, value: int) -> None:
            lines.append(f"# HELP {ns}_{name} {help_}")
            lines.append(f"# TYPE {ns}_{name} counter")
            lines.append(f"{ns}_{name} {value}")

        per_plane("verified_total",
                  "KV blocks whose checksum verified at this plane's boundary",
                  self.verified_total)
        per_plane("corrupt_total",
                  "KV blocks that FAILED checksum verification at this plane",
                  self.corrupt_total)
        emit("descendants_dropped_total",
             "Tier blocks dropped because their chain passes through a "
             "corrupt block", self.descendants_dropped_total)
        emit("negative_cache_hits_total",
             "Restore/promotion/pull attempts skipped on a negative-cached "
             "(recently corrupt) hash", self.negative_cache_hits_total)
        emit("recomputed_total",
             "Corruption events degraded to local recompute (streams stay "
             "byte-identical)", self.recomputed_total)
        emit("quarantined_total",
             "Worker quarantines attributed to repeated KV corruption",
             self.quarantined_total)
        return "\n".join(lines) + "\n"


kv_integrity_metrics = KvIntegrityMetrics()


class BulkMetrics:
    """Bulk data-plane counters (runtime/transports/bulk.py): bytes and
    transfers moved peer-to-peer (off the hub control plane), resumes after
    peer connection drops, and fallbacks onto the hub path.  Module-level
    singleton rendered as Prometheus text and appended to ``/metrics``."""

    def __init__(self):
        self.bytes_total = 0
        self.transfers_total = 0
        # bulk attempts that fell back to the hub path (dead peer, expired
        # ticket, rendezvous outage) — the stream survives either way
        self.fallbacks_total = 0
        # reconnects that continued from the last verified chunk
        self.resumes_total = 0

    def reset(self) -> None:
        self.__init__()

    def snapshot(self) -> Dict[str, float]:
        return {
            "bytes_total": float(self.bytes_total),
            "transfers_total": float(self.transfers_total),
            "fallbacks_total": float(self.fallbacks_total),
            "resumes_total": float(self.resumes_total),
        }

    def render(self, prefix: str = "dynamo_tpu") -> str:
        ns = f"{prefix}_bulk"
        lines = []

        def emit(name: str, help_: str, value: int) -> None:
            lines.append(f"# HELP {ns}_{name} {help_}")
            lines.append(f"# TYPE {ns}_{name} counter")
            lines.append(f"{ns}_{name} {value}")

        emit("bytes_total",
             "Payload bytes moved over the peer-to-peer bulk plane "
             "(KV pulls, migration copies, span batches)", self.bytes_total)
        emit("transfers_total",
             "Completed bulk transfers (fetch + push)", self.transfers_total)
        emit("fallbacks_total",
             "Bulk attempts that fell back to the hub path (stream "
             "survives; bytes ride the control plane)", self.fallbacks_total)
        emit("resumes_total",
             "Transfers resumed from the last verified chunk after a peer "
             "connection drop", self.resumes_total)
        return "\n".join(lines) + "\n"


bulk_metrics = BulkMetrics()


class ObjstoreMetrics:
    """Durable object-store tier counters (engine/object_store.py): put/get
    traffic in blocks and bytes plus byte-budgeted GC evictions.  Module-level
    singleton rendered as Prometheus text and appended to ``/metrics``."""

    def __init__(self):
        self.puts_total = 0
        self.put_bytes_total = 0
        self.gets_total = 0
        self.get_bytes_total = 0
        # objects evicted by the byte-budgeted GC (coldest-first); corrupt
        # drops are counted on the integrity plane, not here
        self.gc_evictions_total = 0

    def reset(self) -> None:
        self.__init__()

    def snapshot(self) -> Dict[str, float]:
        return {
            "puts_total": float(self.puts_total),
            "put_bytes_total": float(self.put_bytes_total),
            "gets_total": float(self.gets_total),
            "get_bytes_total": float(self.get_bytes_total),
            "gc_evictions_total": float(self.gc_evictions_total),
        }

    def render(self, prefix: str = "dynamo_tpu") -> str:
        ns = f"{prefix}_objstore"
        lines = []

        def emit(name: str, help_: str, value: int) -> None:
            lines.append(f"# HELP {ns}_{name} {help_}")
            lines.append(f"# TYPE {ns}_{name} counter")
            lines.append(f"{ns}_{name} {value}")

        emit("puts_total",
             "Objects published to the durable store (demotions + explicit "
             "persists)", self.puts_total)
        emit("put_bytes_total",
             "Envelope bytes published to the durable store",
             self.put_bytes_total)
        emit("gets_total",
             "Objects read back from the durable store (restores + "
             "promotions)", self.gets_total)
        emit("get_bytes_total",
             "Envelope bytes read back from the durable store",
             self.get_bytes_total)
        emit("gc_evictions_total",
             "Objects evicted by the byte-budgeted GC (coldest-first)",
             self.gc_evictions_total)
        return "\n".join(lines) + "\n"


objstore_metrics = ObjstoreMetrics()

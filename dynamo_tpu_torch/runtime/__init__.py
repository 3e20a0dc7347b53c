"""AsyncEngine, Context, ResponseStream.

The health plane is exported here as the JAX package's runtime exports it
(``runtime/health.py``); the other modules are imported by path.
"""

from .health import (
    HealthConfig,
    HealthWatchdog,
    WorkerLatencyTracker,
    health_metrics,
    probe_address,
    worker_latency,
)

__all__ = [
    "HealthConfig",
    "HealthWatchdog",
    "WorkerLatencyTracker",
    "health_metrics",
    "probe_address",
    "worker_latency",
]

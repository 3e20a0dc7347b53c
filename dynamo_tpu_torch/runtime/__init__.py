"""AsyncEngine, Context, ResponseStream.

The health plane and the logging setup are exported here as the JAX
package's runtime exports them (``runtime/health.py``,
``runtime/logging_config.py``); the other modules are imported by path.
"""

from .health import (
    HealthConfig,
    HealthWatchdog,
    WorkerLatencyTracker,
    health_metrics,
    probe_address,
    worker_latency,
)
from .logging_config import JsonlFormatter, parse_filter, setup_logging  # noqa: F401

__all__ = [
    "JsonlFormatter",
    "parse_filter",
    "setup_logging",
    "HealthConfig",
    "HealthWatchdog",
    "WorkerLatencyTracker",
    "health_metrics",
    "probe_address",
    "worker_latency",
]

"""Layered runtime configuration: defaults < config file < environment.

A trimmed copy of the JAX package's ``runtime/config.py``, as far as the
keys something in this package reads: ``namespace`` (the event-plane
namespace of the ``http`` edge's trace subscription and the worker's span
export, cli.py), ``resilience`` (the routed client and the ``http``
command), ``spec_decode`` (engine/__init__.py), ``qos`` (the scheduler
half in engine/__init__.py, the edge half in cli.py) and ``tracing``
(cli.py).  ``RuntimeConfig.from_layers()`` merges an optional JSON file
named by ``DYN_RUNTIME_CONFIG`` and then ``DYN_*`` environment variables,
later layers winning per key; every other key is ignored.

Env mapping: ``DYN_<FIELD>`` (case-insensitive) sets a top-level field;
double underscores nest (``DYN_SPEC_DECODE__K=8`` → ``spec_decode.k``).
Values parse as JSON when possible ("8" → int, "true" → bool), else string.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional

ENV_PREFIX = "DYN_"
CONFIG_PATH_ENV = "DYN_RUNTIME_CONFIG"


def _parse_env_value(raw: str) -> Any:
    try:
        return json.loads(raw)
    except (ValueError, TypeError):
        return raw


def _deep_merge(base: Dict[str, Any], over: Mapping[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, Mapping) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _load_file(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.loads(f.read() or "{}")


def env_overrides(
    environ: Optional[Mapping[str, str]] = None, prefix: str = ENV_PREFIX
) -> Dict[str, Any]:
    """``DYN_A__B=v`` → {"a": {"b": v}} (reserved names excluded)."""
    environ = os.environ if environ is None else environ
    reserved = {CONFIG_PATH_ENV, "DYN_LOG", "DYN_LOG_FORMAT", "DYN_LOG_FILE"}
    out: Dict[str, Any] = {}
    for key, raw in environ.items():
        if not key.startswith(prefix) or key in reserved:
            continue
        path = key[len(prefix):].lower().split("__")
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = _parse_env_value(raw)
    return out


@dataclass
class RuntimeConfig:
    """The layered keys this package reads so far."""

    namespace: str = "dynamo"
    # request-resilience knobs (runtime/resilience.py): retry_max_attempts,
    # retry_base_delay_s, retry_max_delay_s, breaker_failure_threshold,
    # breaker_reset_s, http_max_inflight, http_admission_queue,
    # http_admission_timeout_s, request_deadline_s.  Nested env works:
    # ``DYN_RESILIENCE__RETRY_MAX_ATTEMPTS=5``.
    resilience: Dict[str, Any] = field(default_factory=dict)

    # Draft-free speculative decoding defaults (engine/config.py
    # SpecDecodeConfig keys).  build_torch_engine (out=torch) merges this section
    # under any explicit --spec-* flags; nested env works:
    # ``DYN_SPEC_DECODE__ENABLE=true``, ``DYN_SPEC_DECODE__K=8``.
    spec_decode: Dict[str, Any] = field(default_factory=dict)
    # QoS/overload-control section (llm/qos.py QosConfig keys at the edge:
    # rate, burst, tenants, brownout{queue_high,kv_high,ttft_p95_ms,
    # band_up,band_down,confirm_up,confirm_down,cooldown,max_tokens_cap},
    # tick_s; engine/config.py QosSchedConfig keys for the scheduler:
    # tenant_weights, default_weight, batch_every).  Nested env works:
    # ``DYN_QOS__RATE=20``, ``DYN_QOS__BROWNOUT__QUEUE_HIGH=32``.
    qos: Dict[str, Any] = field(default_factory=dict)
    # Request tracing (runtime/tracing.py TracingConfig keys: enabled,
    # sample, ring, export_interval_s, ttl_s, tail_keep, tail_slo_ttft_ms).
    # Nested env works: ``DYN_TRACING__SAMPLE=0.1``.
    tracing: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_layers(
        cls,
        file_path: Optional[str] = None,
        environ: Optional[Mapping[str, str]] = None,
    ) -> "RuntimeConfig":
        """defaults < file (arg or $DYN_RUNTIME_CONFIG) < DYN_* env."""
        environ = os.environ if environ is None else environ
        merged: Dict[str, Any] = {}
        path = file_path or environ.get(CONFIG_PATH_ENV)
        if path:
            merged = _deep_merge(merged, _load_file(path))
        merged = _deep_merge(merged, env_overrides(environ))
        sections = {f: dict(merged.get(f) or {}) for f in cls.__dataclass_fields__ if f != "namespace"}
        return cls(namespace=str(merged.get("namespace") or cls.namespace), **sections)

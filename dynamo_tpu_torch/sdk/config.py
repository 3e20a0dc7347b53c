"""Per-service configuration: YAML file + env JSON, merged per service.
A copy of the JAX package's ``sdk/config.py``.

Reference semantics: deploy/dynamo/sdk lib/config.py + cli/serving.py:228-243
— a ``-f config.yaml`` keyed by service name, distributed to worker
subprocesses through one env var (there DYNAMO_SERVICE_CONFIG, here
DYN_SERVICE_CONFIG) so every worker sees the same merged view.

YAML parsing: PyYAML when available, else a built-in reader for the strict
subset used by service configs (nested maps + scalars + flat lists).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

ENV_VAR = "DYN_SERVICE_CONFIG"


def _parse_scalar(text: str) -> Any:
    t = text.strip()
    if not t or t == "null" or t == "~":
        return None
    if t in ("true", "True"):
        return True
    if t in ("false", "False"):
        return False
    try:
        return int(t)
    except ValueError:
        pass
    try:
        return float(t)
    except ValueError:
        pass
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "\"'":
        return t[1:-1]
    if t.startswith("[") and t.endswith("]"):
        inner = t[1:-1].strip()
        return [_parse_scalar(p) for p in inner.split(",")] if inner else []
    return t


def _parse_simple_yaml(text: str) -> Dict[str, Any]:
    """Indentation-based nested maps; enough for service config files."""
    root: Dict[str, Any] = {}
    stack = [(-1, root)]
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip())
        key, sep, value = line.strip().partition(":")
        if not sep:
            continue
        while stack and indent <= stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        if value.strip():
            parent[key.strip()] = _parse_scalar(value)
        else:
            child: Dict[str, Any] = {}
            parent[key.strip()] = child
            stack.append((indent, child))
    return root


def _load_yaml(path: str) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    try:
        import yaml  # type: ignore

        return yaml.safe_load(text) or {}
    except ImportError:
        return _parse_simple_yaml(text)


class ServiceConfigStore:
    """Merged per-service config: file < env < explicit overrides."""

    def __init__(self, data: Optional[Dict[str, Dict[str, Any]]] = None):
        self._data: Dict[str, Dict[str, Any]] = data or {}

    @classmethod
    def load(cls, path: Optional[str] = None) -> "ServiceConfigStore":
        data: Dict[str, Dict[str, Any]] = {}
        if path:
            for svc, cfg in (_load_yaml(path) or {}).items():
                data.setdefault(svc, {}).update(cfg or {})
        env = os.environ.get(ENV_VAR)
        if env:
            for svc, cfg in json.loads(env).items():
                data.setdefault(svc, {}).update(cfg or {})
        return cls(data)

    def for_service(self, name: str) -> Dict[str, Any]:
        return dict(self._data.get(name, {}))

    def set(self, service: str, key: str, value: Any) -> None:
        self._data.setdefault(service, {})[key] = value

    def to_env(self) -> str:
        return json.dumps(self._data)

    def as_dict(self) -> Dict[str, Dict[str, Any]]:
        return {k: dict(v) for k, v in self._data.items()}


def load_service_configs(path: Optional[str] = None) -> ServiceConfigStore:
    return ServiceConfigStore.load(path)

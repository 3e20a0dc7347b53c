"""Logging subsystem: DYN_LOG level filters + JSONL structured output.
A copy of the JAX package's ``runtime/logging_config.py``.

Reference semantics: lib/runtime/src/logging.rs:16-100 — ``DYN_LOG`` is an
env-filter string ("info", "warn,dynamo_tpu_torch.engine=debug", ...) selecting a
default level plus per-module overrides; ``DYN_LOG_FORMAT=jsonl`` switches to
one JSON object per line (time/level/target/message + extra fields), the
shape their log pipeline ships to collectors.  ``DYN_LOG_FILE`` tees to a
file.  ``setup_logging()`` is idempotent and called by every CLI entrypoint.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Dict, Optional, Tuple

_LEVELS = {
    "trace": logging.DEBUG,  # python has no TRACE; map down
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}


def parse_filter(spec: str) -> Tuple[int, Dict[str, int]]:
    """"warn,dynamo_tpu_torch.engine=debug" → (WARNING, {module: DEBUG})."""
    default = logging.INFO
    per_module: Dict[str, int] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            mod, _, lvl = part.partition("=")
            per_module[mod.strip()] = _LEVELS.get(lvl.strip().lower(), logging.INFO)
        else:
            default = _LEVELS.get(part.lower(), logging.INFO)
    return default, per_module


class JsonlFormatter(logging.Formatter):
    """One JSON object per line (reference logging.rs JSONL shape)."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "time": time.strftime(
                "%Y-%m-%dT%H:%M:%S", time.gmtime(record.created)
            )
            + f".{int(record.msecs):03d}Z",
            "level": record.levelname,
            "target": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info:
            out["exception"] = self.formatException(record.exc_info)
        for key, val in getattr(record, "fields", {}).items():
            out.setdefault(key, val)
        return json.dumps(out, separators=(",", ":"))


def setup_logging(
    spec: Optional[str] = None,
    fmt: Optional[str] = None,
    log_file: Optional[str] = None,
) -> None:
    """Install handlers per DYN_LOG / DYN_LOG_FORMAT / DYN_LOG_FILE.

    Idempotent: replaces handlers this module installed, leaves foreign
    handlers (pytest's caplog etc.) alone.
    """
    spec = spec if spec is not None else os.environ.get("DYN_LOG", "info")
    fmt = fmt if fmt is not None else os.environ.get("DYN_LOG_FORMAT", "text")
    log_file = (
        log_file if log_file is not None else os.environ.get("DYN_LOG_FILE")
    )
    default, per_module = parse_filter(spec)

    root = logging.getLogger()
    root.setLevel(default)
    for mod, lvl in per_module.items():
        logging.getLogger(mod).setLevel(lvl)

    if fmt.lower() in ("jsonl", "json"):
        formatter: logging.Formatter = JsonlFormatter()
    else:
        formatter = logging.Formatter(
            "%(asctime)s %(levelname).1s %(name)s: %(message)s",
            datefmt="%H:%M:%S",
        )
    for h in list(root.handlers):
        if getattr(h, "_dyn_installed", False):
            root.removeHandler(h)
    handler: logging.Handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(formatter)
    handler._dyn_installed = True  # type: ignore[attr-defined]
    root.addHandler(handler)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(JsonlFormatter())  # files always structured
        fh._dyn_installed = True  # type: ignore[attr-defined]
        root.addHandler(fh)

"""Prometheus label hygiene for the port's ``/metrics``.

Copy of ``bounded_label``, ``escape_label``, ``hash_credential`` and
``safe_key_component`` from the JAX package's ``labels.py``.
Wire-controlled values (the OpenAI ``model`` field, HTTP headers) pass
through one of the first two before they reach a label; credentials become
tenant ids only through the third; wire-controlled hub-key components (the
api-store's deployment names) through the fourth.
"""

from __future__ import annotations

import hashlib
import re

# Prometheus exposition label values escape exactly three characters:
# backslash, double-quote, and newline (in that order — the escape
# character must be escaped first).  NOT idempotent: escape exactly ONCE,
# at the final render site, never in helpers that feed a render.
_LABEL_ESCAPES = (("\\", r"\\"), ('"', r"\""), ("\n", r"\n"))


def escape_label(value: object) -> str:
    """Prometheus-escape a label value (any type; always returns str).

    For clean strings it is the identity.  Every interpolated label value
    goes through here exactly ONCE, at the render site."""
    out = str(value)
    for raw, esc in _LABEL_ESCAPES:
        out = out.replace(raw, esc)
    return out


def bounded_label(value: str) -> str:
    """Identity marker: the caller has JUST verified ``value`` against a
    closed server-side set (e.g. the served-model registry), so it is not
    a cardinality hazard.  No escaping happens here on purpose: the metric
    families (llm/metrics.py) escape at exposition, and pre-escaping would
    double-escape and split the series."""
    return value


def hash_credential(secret: str, prefix: str = "key") -> str:
    """Stable non-secret identity for a credential: ``key:<sha256[:12]>``.

    Raw API keys / bearer tokens must never become tenant strings — tenant
    ids reach logs, ``/metrics`` labels and scheduler annotations, none of
    which may carry a secret.  The digest keys quota buckets and fairness
    flows just as well, and 12 hex chars keep collision odds negligible at
    fleet scale (2^48)."""
    return f"{prefix}:{hashlib.sha256(secret.encode()).hexdigest()[:12]}"


# One hub-key path component: no '/', whitespace or control characters.
_KEY_COMPONENT_RE = re.compile(r"^[A-Za-z0-9]([A-Za-z0-9._-]{0,253})$")


def safe_key_component(value: str) -> str:
    """Validate a wire-controlled string for use as ONE hub-key path
    component.  Returns the value unchanged or raises ``ValueError`` —
    callers map the error to their 400/reject path.

    Hub keys are a shared namespace (``instances/…``, ``planner/…``,
    ``health/quarantine/…``); a crafted id containing ``/`` or whitespace
    could escape its prefix and shadow another subsystem's keys."""
    if not isinstance(value, str) or not _KEY_COMPONENT_RE.match(value):
        raise ValueError(
            f"invalid key component {value!r}: must match "
            "[A-Za-z0-9][A-Za-z0-9._-]{0,253}"
        )
    return value

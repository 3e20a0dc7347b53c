"""Deterministic fault injection, a copy of the JAX package's
``runtime/faultinject.py`` registry.

The port hooks one point so far, ``kv_corrupt``, a *data* fault: it flips
one payload byte past the structural checks' vantage point, and the system
under test is the KV integrity plane (engine/integrity.py) — detection
before any scatter, descendant drop and negative cache, and a recompute
that gives the same stream.  ``match`` names the plane: ``disk`` =
``DiskKvStore.read`` after the OS read, ``objstore`` =
``ObjectKvStore.read`` after the read, ``host`` = ``_restore_pass`` before
the host→device copy.  Arm one plane (``kv_corrupt:disk``) or
``kv_corrupt`` for all.

Arming: programmatic (``faults.arm("kv_corrupt", match="disk", count=1)``)
or from the environment — ``DYN_FAULTS`` is a comma-separated list of
``point[:match][@level][#count]`` specs (``*`` matches everything; no
``#count`` = until disarmed).  A ``count``-armed fault expires after
firing ``count`` times.  ``faults.enabled`` is the single hot-path guard:
every hook site reads it first, so nothing armed costs one attribute load.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

ENV_VAR = "DYN_FAULTS"


@dataclass
class _Fault:
    point: str
    match: str = "*"
    count: Optional[int] = None  # None = until disarmed
    fired: int = field(default=0)

    def matches(self, key: str) -> bool:
        return self.match == "*" or self.match in key

    @property
    def exhausted(self) -> bool:
        return self.count is not None and self.fired >= self.count


class FaultInjector:
    """Process-global registry of armed fault points.

    ``enabled`` is the single hot-path guard: every hook site reads it first
    (``if faults.enabled and faults.should(...)``) so production traffic with
    nothing armed pays one attribute load.
    """

    def __init__(self):
        self.enabled = False
        self._points: Dict[str, List[_Fault]] = {}

    # -- arming -------------------------------------------------------------

    def arm(
        self,
        point: str,
        match: str = "*",
        count: Optional[int] = None,
    ) -> _Fault:
        fault = _Fault(point=point, match=match, count=count)
        self._points.setdefault(point, []).append(fault)
        self.enabled = True
        logger.warning("fault armed: %s match=%r count=%s", point, match, count)
        return fault

    def disarm(self, point: Optional[str] = None, match: Optional[str] = None) -> None:
        if point is None:
            self._points.clear()
        elif match is None:
            self._points.pop(point, None)
        else:
            kept = [f for f in self._points.get(point, []) if f.match != match]
            if kept:
                self._points[point] = kept
            else:
                self._points.pop(point, None)
        self.enabled = any(self._points.values())

    def reset(self) -> None:
        self.disarm()

    # -- hook-site queries ---------------------------------------------------

    def _find(self, point: str, key: str) -> Optional[_Fault]:
        for fault in self._points.get(point, []):
            if not fault.exhausted and fault.matches(key):
                return fault
        return None

    def should(self, point: str, key: str = "") -> bool:
        """Consuming check: counts one firing against a count-limited fault."""
        fault = self._find(point, key)
        if fault is None:
            return False
        fault.fired += 1
        if fault.exhausted:
            self._prune(point)
        logger.warning("fault fired: %s key=%r (%d)", point, key, fault.fired)
        return True

    def _prune(self, point: str) -> None:
        kept = [f for f in self._points.get(point, []) if not f.exhausted]
        if kept:
            self._points[point] = kept
        else:
            self._points.pop(point, None)
        self.enabled = any(self._points.values())

    # -- env ----------------------------------------------------------------

    def load_env(self, raw: Optional[str] = None) -> None:
        """Parse ``DYN_FAULTS`` (``point[:match][@level][#count]`` list; a
        level, the JAX package's magnitude for its transport points, is
        parsed off and unused here)."""
        raw = os.environ.get(ENV_VAR, "") if raw is None else raw
        for spec in filter(None, (s.strip() for s in raw.split(","))):
            count: Optional[int] = None
            # '#' separates the count so a match may contain ':' (host:port)
            if "#" in spec:
                spec, _, count_s = spec.rpartition("#")
                if count_s.isdigit():
                    count = int(count_s)
            if "@" in spec:
                head, _, level_s = spec.rpartition("@")
                try:
                    float(level_s)
                    spec = head
                except ValueError:
                    pass  # not a level: part of the match
            point, _, match = spec.partition(":")
            self.arm(point, match=match or "*", count=count)


faults = FaultInjector()
if os.environ.get(ENV_VAR):
    faults.load_env()

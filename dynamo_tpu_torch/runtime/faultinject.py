"""Deterministic fault injection, a copy of the JAX package's
``runtime/faultinject.py`` registry with the hooks the port has so far.

Fault points (hooked where the failure would really occur, behind
``faults.enabled`` so the disabled path costs one attribute read):

=================  =========================================  ==============
point              hooked in                                  simulates
=================  =========================================  ==============
``connect_error``  ``transports/service.MuxConnection``       dead worker /
                                                              refused dial
``delay``          ``transports/service.ServiceServer``       slow worker
                   (before the response prologue)             (stalls TTFB)
``error_prologue`` ``transports/service.ServiceServer``       worker sick at
                                                              stream setup
``drop_mid_stream`` ``transports/service.ServiceServer``      worker killed
                   (connection aborted after an item)         after 1st token
``watch_stall``    ``transports/hub.HubState._notify``        hub partition:
                                                              watchers stale
``watch_error``    ``transports/hub.Watcher``                 watch stream
                                                              crash
``worker_crash``   ``transports/service.ServiceServer``       whole worker
                   (aborts EVERY connection + stops           dies mid-step
                   accepting; fires ``on_crash``)
``hub_outage``     ``transports/hub.HubServer``               control plane
                   (drops new + established connections       down
                   while armed; disarm = hub back up)
``slow_stream``    ``transports/service.ServiceServer``       straggler: ITL
                   (``delay_s`` sleep before each item)       outlier worker
``kv_pressure``    ``engine/scheduler`` free-block view       KV pool squeeze
                   (``delay_s`` = fraction withheld)          → preemptions
``kv_corrupt``     the KV integrity boundaries (``match``     KV payload
                   names the plane): ``disk`` =               bit-rot on the
                   ``DiskKvStore.read`` after the OS read,    named medium;
                   ``objstore`` = ``ObjectKvStore.read``,     the checksum
                   ``host`` = ``_restore_pass`` before the    plane must
                   host→device copy                           detect it
``bulk_conn_drop`` ``transports/bulk.BulkServer``             bulk peer dies
                   (aborts the peer connection between        mid-transfer;
                   chunks; cached transfer state survives     the client
                   for resume)                                resumes, else
                                                              falls back
``bulk_slow_peer`` ``transports/bulk.BulkServer``             straggler bulk
                   (``delay_s`` stall before each chunk)      peer stalls
                                                              each chunk
=================  =========================================  ==============

``kv_corrupt`` is a *data* fault: it flips one payload byte past the
structural checks' vantage point, and the system under test is the KV
integrity plane (engine/integrity.py) — detection before any scatter,
descendant drop and negative cache, and a recompute that gives the same
stream.  The JAX package's other points (``tenant_flood``,
``hub_shard_kill``) come with the code they hook.

``bulk_conn_drop`` / ``bulk_slow_peer`` are *bulk data-plane* faults
(transports/bulk.py): hook keys are ``<bulk address>/<source>``, so a
fault can target one peer's KV export stream (``bulk_conn_drop:kv_export``)
or every bulk transfer (``*``).  ``bulk_conn_drop`` aborts the TCP
connection between chunks while the server's live transfer state
survives — the system under test is resume-from-last-verified-chunk plus
the fallback ladder (service-plane path, then local recompute): streams
stay byte-identical and none drop.  ``bulk_slow_peer`` stalls ``delay_s``
before each chunk (a straggling peer NIC); the client's per-attempt
timeout converts a hopeless straggler into a service-plane fallback
instead of a hung pull.

Arming: programmatic (``faults.arm("connect_error", match=addr, count=2)``)
or env-driven for subprocess workers — ``DYN_FAULTS`` is a comma-separated
list of ``point[:match][@level][#count]`` specs (``match`` substring-matches
the hook's key, and may itself contain ``:`` as in ``host:port``; ``*``
matches everything; no ``#count`` = until disarmed), e.g.
``DYN_FAULTS='connect_error:127.0.0.1:9001#2,delay:*'``.  A ``count``-armed
fault expires after firing ``count`` times, so a test can kill exactly the
first N dials and then watch recovery.
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
    delay_s: float = 0.05  # only meaningful for the "delay" point
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
        delay_s: float = 0.05,
    ) -> _Fault:
        fault = _Fault(point=point, match=match, count=count, delay_s=delay_s)
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

    def is_armed(self, point: str, key: str = "") -> bool:
        """Non-consuming check (for faults that hold, e.g. watch_stall)."""
        return self._find(point, key) is not None

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

    def delay_for(self, point: str, key: str = "") -> float:
        """Consuming delay lookup: seconds to stall, or 0.0 if not armed."""
        fault = self._find(point, key)
        if fault is None:
            return 0.0
        fault.fired += 1
        if fault.exhausted:
            self._prune(point)
        return fault.delay_s

    def level_for(self, point: str, key: str = "") -> float:
        """Non-consuming magnitude lookup: the armed fault's ``delay_s``
        reinterpreted as a level (e.g. ``kv_pressure`` = fraction of the
        free-block pool withheld), or 0.0 when not armed.  Holding faults
        read this every pass, so it never counts against ``count``."""
        fault = self._find(point, key)
        return 0.0 if fault is None else fault.delay_s

    def _prune(self, point: str) -> None:
        kept = [f for f in self._points.get(point, []) if not f.exhausted]
        if kept:
            self._points[point] = kept
        else:
            self._points.pop(point, None)
        self.enabled = any(self._points.values())

    # -- env ----------------------------------------------------------------

    def load_env(self, raw: Optional[str] = None) -> None:
        """Parse ``DYN_FAULTS`` (``point[:match][@level][#count]`` list)."""
        raw = os.environ.get(ENV_VAR, "") if raw is None else raw
        for spec in filter(None, (s.strip() for s in raw.split(","))):
            count: Optional[int] = None
            # '#' separates the count so a match may contain ':' (host:port)
            if "#" in spec:
                spec, _, count_s = spec.rpartition("#")
                if count_s.isdigit():
                    count = int(count_s)
            delay_s = 0.05
            if "@" in spec:
                spec, _, level_s = spec.rpartition("@")
                try:
                    delay_s = float(level_s)
                except ValueError:
                    spec = f"{spec}@{level_s}"  # not a level; restore
            point, _, match = spec.partition(":")
            self.arm(point, match=match or "*", count=count, delay_s=delay_s)


faults = FaultInjector()
if os.environ.get(ENV_VAR):
    faults.load_env()

"""Hub sharding: static shard map, canonical key builders, sharded client.

A copy of the JAX package's ``runtime/transports/shard.py``.

The single hub process (transports/hub.py) stands in for the reference's
etcd + NATS layer and was the fleet's control-plane SPOF and scaling
ceiling.  This module splits that plane across N independent hub shards
behind a small **static shard map**:

- ``ShardMap``        — parses a ``host:port[,host:port...]`` spec and maps
  every key/prefix/subject/queue to its owner shard by a stable hash of
  the **routing token** (the first ``/``-segment of a key, the first
  ``.``-token of a subject).  Routing by the leading segment keeps every
  watch prefix in the tree wholly on one shard — a prefix watch never has
  to merge deltas across shards.
- ``hub_key`` / ``hub_prefix`` / ``hub_subject`` — the canonical builders
  every hub key/subject construction routes through: ad-hoc f-strings
  at hub call sites would bypass the routing contract.
- ``ShardedHubClient`` — same async interface as ``HubClient``/
  ``InprocHub``; owns one ``HubClient`` per shard so the park/replay +
  session-resume semantics hold **per shard**: one shard's outage parks
  only the traffic it owns, and never stalls keys owned by its siblings.
  Leases are composite (granted on every shard; ``kv_put`` translates to
  the owner shard's lease id) so a single primary lease keeps liveness
  semantics across the whole map.
- ``HubShardMetrics`` — per-shard connect/reconnect/failover/park/replay
  counters plus the routed client's degraded-mode cache hits/staleness,
  rendered onto the edge ``/metrics`` next to the resilience block.

A one-address spec degrades to a single shard that accepts every key —
wire- and byte-compatible with today's hub (``DistributedRuntime.connect``
keeps handing out a plain ``HubClient`` for single addresses).
"""

from __future__ import annotations

import itertools
import logging
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

from ...labels import escape_label
from .hub import HubClient, Subscription, Watcher

logger = logging.getLogger(__name__)


# --------------------------------------------------------------------------
# Canonical key/subject builders
# --------------------------------------------------------------------------


def hub_key(*segments: Any) -> str:
    """Join path segments into a hub KV key (``a/b/c``).

    The first segment is the **routing token**: every key built from the
    same leading segment lands on the same shard, so code that needs two
    keys co-located must give them the same leading segment.
    """
    parts = [str(s) for s in segments]
    if not parts or not parts[0]:
        raise ValueError("hub_key needs a non-empty leading segment")
    return "/".join(parts)


def hub_prefix(*segments: Any) -> str:
    """A watchable/queryable prefix: ``hub_key(...) + "/"``.

    Always ends in ``/`` so the leading routing token is complete — a
    prefix like ``"inst"`` would match keys with different routing tokens
    and cannot be owned by one shard.
    """
    return hub_key(*segments) + "/"


def hub_subject(*tokens: Any) -> str:
    """Join tokens into a pub/sub subject (``ns.topic``); the first token
    routes the subject to its shard."""
    parts = [str(t) for t in tokens]
    if not parts or not parts[0]:
        raise ValueError("hub_subject needs a non-empty leading token")
    return ".".join(parts)


def route_token(key: str) -> str:
    """The shard-routing token of a KV key / queue name: the first
    ``/``-segment."""
    if not key:
        raise ValueError("cannot route an empty hub key")
    return key.split("/", 1)[0]


def prefix_route_token(prefix: str) -> Optional[str]:
    """Routing token of a prefix, or None when the prefix does not pin one
    (no ``/`` yet — it could match keys with different leading segments)."""
    if "/" in prefix:
        return prefix.split("/", 1)[0]
    return None


def subject_route_token(pattern: str) -> Optional[str]:
    """Routing token of a subject/pattern, or None when the leading token
    is a wildcard (the pattern spans shards)."""
    if not pattern:
        raise ValueError("cannot route an empty subject")
    head = pattern.split(".", 1)[0]
    if head in ("*", ">"):
        return None
    return head


class CrossShardError(ValueError):
    """A prefix/pattern spans hub shards: the shard map cannot route it to
    one owner, and merging watch deltas across shards is not supported.
    Pin the leading routing token (``hub_prefix``) or run one shard."""


class ShardMap:
    """Static shard map: an ordered list of hub addresses; routing is a
    stable hash (crc32) of the routing token, so the same key routes to
    the same shard in every process with the same spec."""

    def __init__(self, addresses: List[str]):
        if not addresses:
            raise ValueError("shard map needs at least one address")
        self.addresses = list(addresses)

    @classmethod
    def parse(cls, spec: str) -> "ShardMap":
        """``host:port`` or ``host:port,host:port,...`` (order matters: it
        is part of the map identity — every client must use the same)."""
        addrs = [a.strip() for a in spec.split(",") if a.strip()]
        return cls(addrs)

    @property
    def spec(self) -> str:
        return ",".join(self.addresses)

    def __len__(self) -> int:
        return len(self.addresses)

    def shard_of_token(self, token: str) -> int:
        if len(self.addresses) == 1:
            return 0
        return zlib.crc32(token.encode()) % len(self.addresses)

    def shard_for_key(self, key: str) -> int:
        return self.shard_of_token(route_token(key))

    def shard_for_prefix(self, prefix: str) -> int:
        if len(self.addresses) == 1:
            return 0
        token = prefix_route_token(prefix)
        if token is None:
            raise CrossShardError(
                f"prefix {prefix!r} does not pin a routing token and would "
                f"span {len(self.addresses)} hub shards; use hub_prefix() "
                "to build a single-shard prefix"
            )
        return self.shard_of_token(token)

    def shard_for_subject(self, pattern: str) -> int:
        if len(self.addresses) == 1:
            return 0
        token = subject_route_token(pattern)
        if token is None:
            raise CrossShardError(
                f"subject pattern {pattern!r} starts with a wildcard and "
                f"would span {len(self.addresses)} hub shards; lead with a "
                "concrete token (hub_subject)"
            )
        return self.shard_of_token(token)


# --------------------------------------------------------------------------
# Metrics
# --------------------------------------------------------------------------


class HubShardMetrics:
    """Process-global hub-shard counters (``dynamo_tpu_hub_shard_*``).

    Per-shard series are keyed by the shard address; the routing-cache
    counters come from the routed ``Client``'s degraded-mode cache
    (runtime/client.py) — picks served from the local instance table,
    including through a shard failover window, with the staleness bound
    surfaced as a gauge.
    """

    def __init__(self):
        self.connects: Dict[str, int] = {}
        self.reconnects: Dict[str, int] = {}
        self.failovers: Dict[str, int] = {}
        self.parked: Dict[str, int] = {}
        self.replayed: Dict[str, int] = {}
        self.parked_shed: Dict[str, int] = {}
        # Control-plane publish volume per shard: the bulk plane's proof
        # metric — with DYN_BULK_PLANE on, KV pulls / migration copies /
        # span batches leave this series for dynamo_tpu_bulk_bytes_total.
        self.publishes: Dict[str, int] = {}
        self.publish_bytes: Dict[str, int] = {}
        self.routing_cache_hits_total = 0
        self.routing_cache_stale_hits_total = 0
        # owner id → monotonic stamp of when that routed client's watch
        # died; the staleness gauge is the worst live entry.
        self._stale_since: Dict[int, float] = {}

    def _bump(self, table: Dict[str, int], shard: str, n: int = 1) -> None:
        table[shard] = table.get(shard, 0) + n

    def note_connect(self, shard: str) -> None:
        self._bump(self.connects, shard)

    def note_reconnect(self, shard: str) -> None:
        self._bump(self.reconnects, shard)

    def note_failover(self, shard: str) -> None:
        self._bump(self.failovers, shard)

    def note_parked(self, shard: str) -> None:
        self._bump(self.parked, shard)

    def note_replayed(self, shard: str) -> None:
        self._bump(self.replayed, shard)

    def note_shed(self, shard: str, n: int = 1) -> None:
        self._bump(self.parked_shed, shard, n)

    def note_publish(self, shard: str, nbytes: int) -> None:
        self._bump(self.publishes, shard)
        self._bump(self.publish_bytes, shard, max(0, int(nbytes)))

    def note_cache_stale(self, owner: int, since: float) -> None:
        self._stale_since[owner] = since

    def note_cache_fresh(self, owner: int) -> None:
        self._stale_since.pop(owner, None)

    @property
    def routing_cache_staleness_s(self) -> float:
        """Worst current staleness of any routed client's instance cache
        (seconds since its watch died; 0 = every cache synced)."""
        if not self._stale_since:
            return 0.0
        now = time.monotonic()
        return max(0.0, now - min(self._stale_since.values()))

    def render(self, prefix: str = "dynamo_tpu") -> str:
        ns = f"{prefix}_hub_shard"
        lines: List[str] = []

        def per_shard(name: str, help_: str, table: Dict[str, int]) -> None:
            lines.append(f"# HELP {ns}_{name} {help_}")
            lines.append(f"# TYPE {ns}_{name} counter")
            if not table:
                lines.append(f"{ns}_{name} 0")
                return
            for shard, n in sorted(table.items()):
                lines.append(
                    f'{ns}_{name}{{shard="{escape_label(shard)}"}} {n}'
                )

        per_shard("connects_total", "Initial connects per hub shard.",
                  self.connects)
        per_shard("reconnects_total", "Reconnects per hub shard.",
                  self.reconnects)
        per_shard("failovers_total",
                  "Standby promotions observed per hub shard.",
                  self.failovers)
        per_shard("parked_requests_total",
                  "Requests parked awaiting a shard reconnect.",
                  self.parked)
        per_shard("replayed_requests_total",
                  "Idempotent requests replayed after a shard reconnect.",
                  self.replayed)
        per_shard("parked_shed_total",
                  "Parked requests shed by the park-buffer cap "
                  "(oldest-idempotent-first).",
                  self.parked_shed)
        per_shard("publishes_total",
                  "Pub/sub publishes sent through this hub shard.",
                  self.publishes)
        per_shard("publish_bytes_total",
                  "Approximate payload bytes published through this hub "
                  "shard (bulk payloads leave this series under "
                  "DYN_BULK_PLANE — docs/bulk_plane.md).",
                  self.publish_bytes)
        lines.append(f"# HELP {ns}_routing_cache_hits_total Instance picks "
                     "served from the local routing cache (never blocks on "
                     "hub RTT).")
        lines.append(f"# TYPE {ns}_routing_cache_hits_total counter")
        lines.append(f"{ns}_routing_cache_hits_total "
                     f"{self.routing_cache_hits_total}")
        lines.append(f"# HELP {ns}_routing_cache_stale_hits_total Picks "
                     "served while the cache's watch was down (degraded "
                     "mode).")
        lines.append(f"# TYPE {ns}_routing_cache_stale_hits_total counter")
        lines.append(f"{ns}_routing_cache_stale_hits_total "
                     f"{self.routing_cache_stale_hits_total}")
        lines.append(f"# HELP {ns}_routing_cache_staleness_seconds Worst "
                     "current staleness of any routed client's instance "
                     "cache (0 = synced).")
        lines.append(f"# TYPE {ns}_routing_cache_staleness_seconds gauge")
        lines.append(f"{ns}_routing_cache_staleness_seconds "
                     f"{self.routing_cache_staleness_s:.3f}")
        return "\n".join(lines) + "\n"


# One per process, like runtime.resilience.metrics.
shard_metrics = HubShardMetrics()


# --------------------------------------------------------------------------
# Sharded client
# --------------------------------------------------------------------------


class ShardedHubClient:
    """Shard-aware hub client: one ``HubClient`` per shard, routed by the
    shard map.  Same async interface as ``HubClient``/``InprocHub``.

    Each per-shard client keeps its own reconnect loop, park/replay buffer
    and session-resume machinery, so a dead shard parks only the requests
    it owns.  Composite leases: ``lease_grant`` grants one lease per shard
    and hands back a local id; key-bound puts translate to the owner
    shard's lease id, and a keepalive is only truthy when **every** shard
    still honours its half (one shard losing lease state must trigger the
    owner's re-grant + re-register path, exactly like a hub restart).
    """

    def __init__(
        self,
        spec: str,
        reconnect: bool = True,
        reconnect_max_s: float = 2.0,
        request_grace_s: float = 10.0,
    ):
        self.shard_map = ShardMap.parse(spec) if isinstance(spec, str) else spec
        self.reconnect = reconnect
        self.reconnect_max_s = reconnect_max_s
        self.request_grace_s = request_grace_s
        self.clients: List[HubClient] = []
        self._lease_ids = itertools.count(1)
        # local composite lease id → {shard index: remote lease id}
        self._leases: Dict[int, Dict[int, int]] = {}
        self._closed = False

    @property
    def address(self) -> str:
        return self.shard_map.spec

    async def connect(self) -> "ShardedHubClient":
        for addr in self.shard_map.addresses:
            client = HubClient(
                addr,
                reconnect=self.reconnect,
                reconnect_max_s=self.reconnect_max_s,
                request_grace_s=self.request_grace_s,
            )
            await client.connect()
            self.clients.append(client)
            shard_metrics.note_connect(addr)
        return self

    async def close(self) -> None:
        self._closed = True
        for client in self.clients:
            await client.close()

    # -- routing -------------------------------------------------------------

    def client_for_key(self, key: str) -> HubClient:
        return self.clients[self.shard_map.shard_for_key(key)]

    def client_for_prefix(self, prefix: str) -> HubClient:
        return self.clients[self.shard_map.shard_for_prefix(prefix)]

    def client_for_subject(self, pattern: str) -> HubClient:
        return self.clients[self.shard_map.shard_for_subject(pattern)]

    def shard_health(self) -> List[Dict[str, Any]]:
        """Per-shard connectivity snapshot for the edge ``/health``."""
        return [
            {"shard": c.address, "connected": c.connected}
            for c in self.clients
        ]

    # -- KV -------------------------------------------------------------------

    def _owner_lease(self, client_idx: int, lease_id: Optional[int]) -> Optional[int]:
        if lease_id is None:
            return None
        per_shard = self._leases.get(lease_id)
        if per_shard is None:
            # Not a composite id (e.g. a raw lease from a sibling plane):
            # pass through untranslated — single-shard maps behave exactly
            # like a bare HubClient.
            return lease_id
        remote = per_shard.get(client_idx)
        if remote is None:
            raise KeyError(
                f"composite lease {lease_id} has no grant on shard "
                f"{self.shard_map.addresses[client_idx]}"
            )
        return remote

    async def kv_put(self, key, value, lease_id=None):
        idx = self.shard_map.shard_for_key(key)
        await self.clients[idx].kv_put(
            key, value, self._owner_lease(idx, lease_id)
        )

    async def kv_get(self, key):
        return await self.client_for_key(key).kv_get(key)

    async def kv_get_prefix(self, prefix):
        return await self.client_for_prefix(prefix).kv_get_prefix(prefix)

    async def kv_delete(self, key):
        return await self.client_for_key(key).kv_delete(key)

    async def watch_prefix(self, prefix) -> Watcher:
        return await self.client_for_prefix(prefix).watch_prefix(prefix)

    # -- leases ---------------------------------------------------------------

    async def lease_grant(self, ttl: float = 10.0) -> int:
        per_shard: Dict[int, int] = {}
        for idx, client in enumerate(self.clients):
            per_shard[idx] = await client.lease_grant(ttl)
        local = next(self._lease_ids)
        self._leases[local] = per_shard
        return local

    async def lease_keepalive(self, lease_id: int) -> bool:
        per_shard = self._leases.get(lease_id)
        if per_shard is None:
            return False
        alive = True
        for idx, remote in list(per_shard.items()):
            if not await self.clients[idx].lease_keepalive(remote):
                alive = False
        if not alive:
            # One shard lost its half (restart/failover past the TTL):
            # the composite is broken — revoke the surviving halves so the
            # owner's re-grant path (lease monitor) starts clean instead
            # of leaving orphan leases ticking on healthy shards.
            await self.lease_revoke(lease_id)
        return alive

    async def lease_revoke(self, lease_id: int) -> None:
        per_shard = self._leases.pop(lease_id, None)
        if per_shard is None:
            return
        for idx, remote in per_shard.items():
            try:
                await self.clients[idx].lease_revoke(remote)
            except (ConnectionError, RuntimeError):
                # Unreachable shard: its lease half expires by TTL.
                pass

    # -- pub/sub ---------------------------------------------------------------

    async def publish(self, subject, payload) -> None:
        await self.client_for_subject(subject).publish(subject, payload)

    async def subscribe(self, pattern) -> Subscription:
        return await self.client_for_subject(pattern).subscribe(pattern)

    # -- queues ----------------------------------------------------------------
    # Ack tokens are shard-scoped: wrap them with the owning shard index so
    # ack/nack route back without the caller knowing about shards.

    async def q_push(self, queue, item) -> None:
        await self.client_for_key(queue).q_push(queue, item)

    async def q_pop(self, queue) -> Tuple[Any, str]:
        idx = self.shard_map.shard_for_key(queue)
        item, token = await self.clients[idx].q_pop(queue)
        return item, f"{idx}:{token}"

    def _unwrap_token(self, token: str) -> Tuple[HubClient, str]:
        idx_s, _, raw = token.partition(":")
        try:
            return self.clients[int(idx_s)], raw
        except (ValueError, IndexError):
            raise ValueError(f"not a sharded ack token: {token!r}") from None

    async def q_ack(self, token) -> bool:
        client, raw = self._unwrap_token(token)
        return await client.q_ack(raw)

    async def q_nack(self, token) -> bool:
        client, raw = self._unwrap_token(token)
        return await client.q_nack(raw)

    async def q_len(self, queue) -> int:
        return await self.client_for_key(queue).q_len(queue)

"""KV event + worker metrics protocol types.

Reference semantics: lib/llm/src/kv_router/protocols.rs — ``KvCacheEvent``
(Stored{parent_hash, blocks[{block_hash, tokens_hash}]} / Removed{block_hashes}
/ Cleared) and ``ForwardPassMetrics``.  Hashes are the chained sequence hashes
from this package's tokens module, so the router's radix index mirrors engine cache state
exactly (store/evict order included — SURVEY.md §7 hard part (e)).

Wire form is plain dicts (event plane JSON); dataclasses here are the typed
construction/parse helpers.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass(frozen=True)
class KvCacheStoredBlockData:
    block_hash: int  # chained sequence hash — the router index key
    tokens_hash: int  # local hash of the block's tokens

    def to_dict(self) -> Dict[str, Any]:
        return {"block_hash": self.block_hash, "tokens_hash": self.tokens_hash}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "KvCacheStoredBlockData":
        return cls(block_hash=d["block_hash"], tokens_hash=d["tokens_hash"])


@dataclass(frozen=True)
class KvCacheStoreData:
    parent_hash: Optional[int]
    blocks: List[KvCacheStoredBlockData] = field(default_factory=list)


@dataclass(frozen=True)
class KvCacheRemoveData:
    block_hashes: List[int] = field(default_factory=list)


# KV tier names, best (cheapest restore) first.  These label tier-tagged
# cache events and the indexer's discounted overlap weights.
TIER_HBM = "hbm"
TIER_HOST = "host"
TIER_DISK = "disk"
KV_TIERS = (TIER_HBM, TIER_HOST, TIER_DISK)


@dataclass(frozen=True)
class KvCacheTierData:
    """Blocks DEMOTED to (or promoted back up to) a lower tier but still
    restorable — the router keeps them matchable, discounted by restore
    cost, instead of forgetting them as Removed.  ``tier`` names where the
    cheapest surviving copy now lives."""

    tier: str  # one of KV_TIERS (never "hbm": Stored covers that)
    block_hashes: List[int] = field(default_factory=list)


@dataclass(frozen=True)
class KvCacheEvent:
    """One cache mutation; ``data`` is Store, Remove, TierChange, or None
    (= cleared)."""

    event_id: int
    data: Any  # KvCacheStoreData | KvCacheRemoveData | KvCacheTierData | None

    def to_dict(self) -> Dict[str, Any]:
        if isinstance(self.data, KvCacheStoreData):
            payload = {
                "stored": {
                    "parent_hash": self.data.parent_hash,
                    "blocks": [b.to_dict() for b in self.data.blocks],
                }
            }
        elif isinstance(self.data, KvCacheRemoveData):
            payload = {"removed": {"block_hashes": list(self.data.block_hashes)}}
        elif isinstance(self.data, KvCacheTierData):
            payload = {
                "tiered": {
                    "tier": self.data.tier,
                    "block_hashes": list(self.data.block_hashes),
                }
            }
        else:
            payload = {"cleared": {}}
        return {"event_id": self.event_id, "data": payload}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "KvCacheEvent":
        payload = d["data"]
        if "stored" in payload:
            s = payload["stored"]
            data: Any = KvCacheStoreData(
                parent_hash=s.get("parent_hash"),
                blocks=[KvCacheStoredBlockData.from_dict(b) for b in s["blocks"]],
            )
        elif "removed" in payload:
            data = KvCacheRemoveData(block_hashes=list(payload["removed"]["block_hashes"]))
        elif "tiered" in payload:
            t = payload["tiered"]
            data = KvCacheTierData(
                tier=t["tier"], block_hashes=list(t["block_hashes"])
            )
        else:
            data = None
        return cls(event_id=d["event_id"], data=data)

    @classmethod
    def stored(
        cls,
        event_id: int,
        parent_hash: Optional[int],
        blocks: List[KvCacheStoredBlockData],
    ) -> "KvCacheEvent":
        return cls(event_id, KvCacheStoreData(parent_hash, blocks))

    @classmethod
    def removed(cls, event_id: int, block_hashes: List[int]) -> "KvCacheEvent":
        return cls(event_id, KvCacheRemoveData(block_hashes))

    @classmethod
    def tiered(
        cls, event_id: int, tier: str, block_hashes: List[int]
    ) -> "KvCacheEvent":
        return cls(event_id, KvCacheTierData(tier, block_hashes))


@dataclass
class ForwardPassMetrics:
    """Per-worker load snapshot (kv_router/protocols.rs:42-54), published via
    the stats endpoint + event plane; the router's cost function reads it."""

    request_active_slots: int = 0
    request_total_slots: int = 0
    kv_active_blocks: int = 0
    kv_total_blocks: int = 0
    num_requests_waiting: int = 0
    gpu_cache_usage_perc: float = 0.0  # name kept for wire compat
    gpu_prefix_cache_hit_rate: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "request_active_slots": self.request_active_slots,
            "request_total_slots": self.request_total_slots,
            "kv_active_blocks": self.kv_active_blocks,
            "kv_total_blocks": self.kv_total_blocks,
            "num_requests_waiting": self.num_requests_waiting,
            "gpu_cache_usage_perc": self.gpu_cache_usage_perc,
            "gpu_prefix_cache_hit_rate": self.gpu_prefix_cache_hit_rate,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ForwardPassMetrics":
        return cls(**{k: d.get(k, 0) for k in cls().to_dict()})

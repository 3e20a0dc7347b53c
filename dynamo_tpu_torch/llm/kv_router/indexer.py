"""Global KV prefix index: which worker holds which cached blocks, and in
which memory tier.  A copy of the JAX package's ``llm/kv_router/indexer.py``.

Reference semantics (not code): lib/llm/src/kv_router/indexer.rs — a radix
structure over *chained* block hashes with a per-node worker set;
``apply_event`` ingests per-worker ``KvCacheEvent``s (Stored/Removed/Cleared)
and ``find_matches`` walks a request's block-hash chain, returning per-worker
overlap counts (how many leading blocks each worker already holds).

Tiered extension (docs/kv_tiering.md): engines with a host/disk tier emit
TIER-TAGGED events on demotion (HBM eviction of a block the host tier
retains publishes ``tiered{host}`` instead of ``Removed``; host→disk
demotion publishes ``tiered{disk}``) so the index keeps the block matchable
— discounted by restore cost.  ``find_matches`` therefore returns BOTH the
raw per-worker overlap (block counts, what a cross-worker pull compares)
and a DISCOUNTED overlap (each block weighted by its tier: hbm 1.0 > host >
disk) that the scheduler's cost function scores with, so a deep-but-cold
prefix loses to a shallow-but-hot one deterministically.

Because block hashes are chained (tokens.py), one hash already
identifies its whole prefix, so lookup is a flat dict walk rather than an
explicit trie descent; parent links are kept for pruning and diagnostics.
The reference runs this on a dedicated thread fed by channels — here apply/
match are O(blocks) dict ops on the event loop; ``KvIndexerSharded`` spreads
very large indexes over hash shards (indexer.rs:499-796).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Sequence, Set

from ...tokens import fast_sequence_hashes
from .protocols import (
    TIER_HBM,
    KvCacheEvent,
    KvCacheRemoveData,
    KvCacheStoreData,
    KvCacheTierData,
)

WorkerId = int

# Restore-cost discount per tier: one block's contribution to the
# discounted overlap score.  HBM is free (the block is live), host costs
# one scatter, disk costs a file read + promotion + scatter, the durable
# object store costs a multipart object read on top of that.  Unknown
# tier names (forward compat) score like disk — matchable but expensive.
# These are the COLD-START weights: once the autopilot's measured-latency
# policy has real per-hop restore percentiles it overrides them live via
# ``RadixIndex.set_tier_weights`` (docs/autopilot.md).
DEFAULT_TIER_WEIGHTS: Dict[str, float] = {
    "hbm": 1.0,
    "host": 0.75,
    "disk": 0.45,
    "objstore": 0.25,
}


@dataclass
class OverlapScores:
    """worker → number of leading request blocks it already caches.

    ``scores`` is the RAW block count (prefix depth — what a cross-worker
    pull compares and KVHitRateEvents report); ``discounted`` weights each
    block by its tier's restore cost (what the scheduler scores with)."""

    scores: Dict[WorkerId, int] = field(default_factory=dict)
    discounted: Dict[WorkerId, float] = field(default_factory=dict)

    def discounted_for(self, worker: WorkerId) -> float:
        """Tier-discounted overlap; falls back to the raw count for
        overlap sources that never tagged tiers (pre-tier publishers)."""
        got = self.discounted.get(worker)
        return float(self.scores.get(worker, 0)) if got is None else got

    def best(self) -> Optional[WorkerId]:
        if not self.scores:
            return None
        return max(
            self.scores,
            key=lambda w: (self.discounted_for(w), self.scores[w], -w),
        )

    def deepest(self) -> Optional[WorkerId]:
        """Worker with the longest RAW prefix (ties → lowest id,
        deterministic) — the cross-worker pull's donor candidate."""
        if not self.scores:
            return None
        return max(self.scores, key=lambda w: (self.scores[w], -w))


@dataclass
class _Node:
    # worker → tier name currently holding this block ("hbm"/"host"/"disk").
    workers: Dict[WorkerId, str] = field(default_factory=dict)
    parent_hash: Optional[int] = None


class RadixIndex:
    """Hash → worker/tier index with per-worker reverse map for removal."""

    def __init__(self, tier_weights: Optional[Mapping[str, float]] = None):
        self._nodes: Dict[int, _Node] = {}
        self._by_worker: Dict[WorkerId, Set[int]] = {}
        self.tier_weights = dict(tier_weights or DEFAULT_TIER_WEIGHTS)

    def __len__(self) -> int:
        return len(self._nodes)

    def _weight(self, tier: str) -> float:
        return self.tier_weights.get(tier, self.tier_weights.get("disk", 0.45))

    def set_tier_weights(self, weights: Mapping[str, float]) -> None:
        """Live retune from the autopilot's measured-latency routing policy
        (``set_tier_weights`` directives): replaces the static cold-start
        table wholesale.  Takes effect on the next ``find_matches``."""
        self.tier_weights = dict(weights)

    def add_block(
        self,
        worker: WorkerId,
        seq_hash: int,
        parent_hash: Optional[int],
        tier: str = TIER_HBM,
    ) -> None:
        node = self._nodes.get(seq_hash)
        if node is None:
            node = self._nodes[seq_hash] = _Node(parent_hash=parent_hash)
        node.workers[worker] = tier
        self._by_worker.setdefault(worker, set()).add(seq_hash)

    def set_tier(self, worker: WorkerId, seq_hash: int, tier: str) -> None:
        """Apply a tier-tagged event: the block is still restorable on
        ``worker``, now from ``tier``.  Unknown blocks are ADDED — a tier
        event for a block the index missed (e.g. an index started after
        the Stored) still recovers matchable state."""
        self.add_block(worker, seq_hash, None, tier=tier)

    def remove_block(self, worker: WorkerId, seq_hash: int) -> None:
        node = self._nodes.get(seq_hash)
        if node is None:
            return
        node.workers.pop(worker, None)
        owned = self._by_worker.get(worker)
        if owned is not None:
            owned.discard(seq_hash)
        if not node.workers:
            del self._nodes[seq_hash]

    def remove_worker(self, worker: WorkerId) -> None:
        for seq_hash in self._by_worker.pop(worker, set()):
            node = self._nodes.get(seq_hash)
            if node is not None:
                node.workers.pop(worker, None)
                if not node.workers:
                    del self._nodes[seq_hash]

    def workers_for(self, seq_hash: int) -> Dict[WorkerId, str]:
        """worker → tier for one block (empty when unknown)."""
        node = self._nodes.get(seq_hash)
        return node.workers if node is not None else {}

    def find_matches(self, seq_hashes: Sequence[int]) -> OverlapScores:
        """Per-worker count of leading blocks present (a worker's count stops
        at its first missing block — prefix semantics) plus the
        tier-discounted sum over the same run."""
        scores: Dict[WorkerId, int] = {}
        discounted: Dict[WorkerId, float] = {}
        active: Optional[Set[WorkerId]] = None
        for i, h in enumerate(seq_hashes):
            holders = self.workers_for(h)
            active = (
                set(holders) if active is None else active & set(holders)
            )
            if not active:
                break
            for w in active:
                scores[w] = i + 1
                discounted[w] = discounted.get(w, 0.0) + self._weight(
                    holders[w]
                )
        return OverlapScores(scores, discounted)


class KvIndexer:
    """Event-driven index over one worker fleet (one model endpoint)."""

    def __init__(
        self,
        block_size: int,
        tier_weights: Optional[Mapping[str, float]] = None,
    ):
        self.block_size = block_size
        self._index = RadixIndex(tier_weights)
        self.events_applied = 0

    def apply_event(self, worker: WorkerId, event: KvCacheEvent) -> None:
        data = event.data
        if isinstance(data, KvCacheStoreData):
            # Chain within the event: the first block parents on the event's
            # parent_hash, each subsequent block on its predecessor.
            parent = data.parent_hash
            for blk in data.blocks:
                self._index.add_block(worker, blk.block_hash, parent)
                parent = blk.block_hash
        elif isinstance(data, KvCacheRemoveData):
            for h in data.block_hashes:
                self._index.remove_block(worker, h)
        elif isinstance(data, KvCacheTierData):
            for h in data.block_hashes:
                self._index.set_tier(worker, h, data.tier)
        else:  # cleared
            self._index.remove_worker(worker)
        self.events_applied += 1

    def remove_worker(self, worker: WorkerId) -> None:
        self._index.remove_worker(worker)

    def find_matches(
        self, token_ids: Sequence[int], salt: Optional[str] = None
    ) -> OverlapScores:
        """``salt`` is the requesting tenant's KV salt (llm/tenancy —
        ``annotations.kv_salt``): engines seal tenant blocks under salted
        chained hashes, so an unsalted lookup for a tenant request (or vice
        versa) scores structurally zero overlap — exactly the isolation the
        salt exists to provide."""
        return self.find_matches_for_hashes(
            fast_sequence_hashes(token_ids, self.block_size, salt)
        )

    def find_matches_for_hashes(self, seq_hashes: Sequence[int]) -> OverlapScores:
        return self._index.find_matches(seq_hashes)

    def set_tier_weights(self, weights: Mapping[str, float]) -> None:
        self._index.set_tier_weights(weights)

    def __len__(self) -> int:
        return len(self._index)


class KvIndexerSharded:
    """Hash-sharded variant for very large fleets (indexer.rs:499-796): each
    shard owns hashes where ``hash % num_shards == shard_id``.  Matching
    queries every shard per block (cheap dict hits) — the win is bounded
    per-shard memory and, later, per-shard threads/processes."""

    def __init__(
        self,
        block_size: int,
        num_shards: int = 4,
        tier_weights: Optional[Mapping[str, float]] = None,
    ):
        self.block_size = block_size
        self.num_shards = num_shards
        self._shards = [
            KvIndexer(block_size, tier_weights) for _ in range(num_shards)
        ]

    def _shard_for(self, seq_hash: int) -> KvIndexer:
        return self._shards[seq_hash % self.num_shards]

    def apply_event(self, worker: WorkerId, event: KvCacheEvent) -> None:
        data = event.data
        if isinstance(data, KvCacheStoreData):
            for blk in data.blocks:
                self._shard_for(blk.block_hash)._index.add_block(
                    worker, blk.block_hash, data.parent_hash
                )
        elif isinstance(data, KvCacheRemoveData):
            for h in data.block_hashes:
                self._shard_for(h)._index.remove_block(worker, h)
        elif isinstance(data, KvCacheTierData):
            for h in data.block_hashes:
                self._shard_for(h)._index.set_tier(worker, h, data.tier)
        else:
            for shard in self._shards:
                shard.remove_worker(worker)

    def remove_worker(self, worker: WorkerId) -> None:
        for shard in self._shards:
            shard.remove_worker(worker)

    def set_tier_weights(self, weights: Mapping[str, float]) -> None:
        for shard in self._shards:
            shard.set_tier_weights(weights)

    def find_matches(
        self, token_ids: Sequence[int], salt: Optional[str] = None
    ) -> OverlapScores:
        return self.find_matches_for_hashes(
            fast_sequence_hashes(token_ids, self.block_size, salt)
        )

    def find_matches_for_hashes(self, seq_hashes: Sequence[int]) -> OverlapScores:
        scores: Dict[WorkerId, int] = {}
        discounted: Dict[WorkerId, float] = {}
        active: Optional[Set[WorkerId]] = None
        for i, h in enumerate(seq_hashes):
            shard = self._shard_for(h)._index
            holders = shard.workers_for(h)
            active = set(holders) if active is None else active & set(holders)
            if not active:
                break
            for w in active:
                scores[w] = i + 1
                discounted[w] = discounted.get(w, 0.0) + shard._weight(
                    holders[w]
                )
        return OverlapScores(scores, discounted)

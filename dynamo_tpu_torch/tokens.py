"""Token block sequences with chained hashing — the KV-reuse identity scheme.

Reference semantics (not code): lib/tokens/src/lib.rs:44-369 and
lib/llm/src/tokens.rs:30-173 — prompts are split into fixed-size blocks; each
block has a *local* hash (hash of its token ids alone) and a *sequence* hash
chained from the parent block's sequence hash, so a sequence hash uniquely
identifies "these tokens after that exact prefix".  The router's radix index,
the engine's prefix-reuse pool, and KV events all speak these hashes, which is
what lets the KV-aware router mirror engine cache state exactly.

An optional ``salt`` mixes tenant/LoRA identity into the root so equal token
streams from different tenants never share cache entries.

Hashing is pure host-side bookkeeping (never runs on the device).  The
algorithm is XXH64 seed 1337, the same function the JAX package and its
native C++ runtime components use, so hashes agree across one deployment.
blake2b-64 is the fallback only when the xxhash module is missing — mixing
fallback and XXH64 hashing in one fleet would break routing.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Sequence, Tuple

HASH_SEED = 1337

try:
    import xxhash

    def _hash_bytes(data: bytes) -> int:
        return xxhash.xxh64_intdigest(data, seed=HASH_SEED)

except ImportError:  # machines without xxhash (e.g. the GPU host)
    import hashlib

    def _hash_bytes(data: bytes) -> int:
        h = hashlib.blake2b(data, digest_size=8, salt=b"dyn1337\x00")
        return int.from_bytes(h.digest(), "little")


def _pack_tokens(tokens: Sequence[int]) -> bytes:
    return struct.pack(f"<{len(tokens)}I", *tokens)


def compute_block_hash(tokens: Sequence[int]) -> int:
    """Local hash of one block's token ids (order-sensitive, prefix-free)."""
    return _hash_bytes(_pack_tokens(tokens))


def chain_hash(parent: Optional[int], local_hash: int) -> int:
    """Sequence hash = H(parent_seq_hash || local_hash); root chains from salt."""
    parent_bytes = struct.pack("<Q", parent if parent is not None else 0)
    return _hash_bytes(parent_bytes + struct.pack("<Q", local_hash))


def salt_hash(salt: Optional[str]) -> Optional[int]:
    if not salt:
        return None
    return _hash_bytes(salt.encode("utf-8"))


@dataclass(frozen=True)
class TokenBlock:
    """One full block of tokens with its local + chained sequence hash."""

    tokens: Tuple[int, ...]
    block_hash: int  # local: hash of this block's tokens only
    sequence_hash: int  # chained: identifies tokens *and* their prefix
    parent_hash: Optional[int]  # previous block's sequence hash (None = root)


class TokenBlockSequence:
    """Splits a growing token stream into hashed fixed-size blocks.

    Only *complete* blocks are hashed/published; the partial tail is kept as
    plain tokens.  ``extend`` is incremental so the engine can hash during
    decode without rehashing the prompt each step.
    """

    def __init__(
        self,
        tokens: Iterable[int] = (),
        block_size: int = 16,
        salt: Optional[str] = None,
    ):
        if block_size <= 0:
            raise ValueError("block_size must be positive")
        self.block_size = block_size
        self._salt_hash = salt_hash(salt)
        self._blocks: List[TokenBlock] = []
        self._tail: List[int] = []
        self.extend(tokens)

    @property
    def blocks(self) -> List[TokenBlock]:
        return self._blocks

    @property
    def tail_tokens(self) -> List[int]:
        return list(self._tail)

    @property
    def total_tokens(self) -> int:
        return len(self._blocks) * self.block_size + len(self._tail)

    @property
    def last_sequence_hash(self) -> Optional[int]:
        if not self._blocks:
            return self._salt_hash
        return self._blocks[-1].sequence_hash

    def append(self, token: int) -> Optional[TokenBlock]:
        """Add one token; returns the newly completed block, if any."""
        self._tail.append(token)
        if len(self._tail) == self.block_size:
            return self._seal_tail()
        return None

    def extend(self, tokens: Iterable[int]) -> List[TokenBlock]:
        """Add many tokens; returns all blocks completed by this call."""
        new_blocks: List[TokenBlock] = []
        for tok in tokens:
            blk = self.append(tok)
            if blk is not None:
                new_blocks.append(blk)
        return new_blocks

    def _seal_tail(self) -> TokenBlock:
        parent = self.last_sequence_hash
        local = compute_block_hash(self._tail)
        block = TokenBlock(
            tokens=tuple(self._tail),
            block_hash=local,
            sequence_hash=chain_hash(parent, local),
            parent_hash=parent,
        )
        self._blocks.append(block)
        self._tail = []
        return block

    def sequence_hashes(self) -> List[int]:
        return [b.sequence_hash for b in self._blocks]

    def block_hashes(self) -> List[int]:
        return [b.block_hash for b in self._blocks]


def hash_token_blocks(
    tokens: Sequence[int], block_size: int, salt: Optional[str] = None
) -> List[TokenBlock]:
    """One-shot helper: hash all complete blocks of ``tokens``."""
    return TokenBlockSequence(tokens, block_size, salt).blocks

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
Where the xxhash module is missing, ``xxh64`` below computes the same
function in pure Python: the hashes never depend on what is installed.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

HASH_SEED = 1337

_M64 = 0xFFFFFFFFFFFFFFFF
_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data`` (the xxHash specification), as an unsigned int."""
    n, i = len(data), 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed & _M64, (seed - _P1) & _M64]
        while i + 32 <= n:  # four lanes over each 32-byte stripe
            lanes = struct.unpack_from("<4Q", data, i)
            v = [_round(a, lane) for a, lane in zip(v, lanes)]
            i += 32
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _M64
        for a in v:
            h = ((h ^ _round(0, a)) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        h ^= _round(0, struct.unpack_from("<Q", data, i)[0])
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        h ^= (struct.unpack_from("<I", data, i)[0] * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        i += 4
    for b in data[i:]:
        h ^= (b * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


try:
    import xxhash

    USING_XXHASH = True

    def _hash_bytes(data: bytes) -> int:
        return xxhash.xxh64_intdigest(data, seed=HASH_SEED)

except ImportError:  # the same function, in Python
    USING_XXHASH = False

    def _hash_bytes(data: bytes) -> int:
        return xxh64(data, HASH_SEED)


# -- XXH64 over many equal-length blocks at once (numpy uint64 lanes) --------

_U = np.uint64


def _rotl_np(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U(r)) | (x >> _U(64 - r))


def _round_np(acc: np.ndarray, lane: np.ndarray) -> np.ndarray:
    return _rotl_np(acc + lane * _U(_P2), 31) * _U(_P1)


def block_hashes_np(tokens: Sequence[int], block_size: int) -> List[int]:
    """Local hashes of every complete ``block_size`` block of ``tokens``:
    ``compute_block_hash`` of each block, computed for all blocks at once
    with one uint64 lane per block (uint64 arithmetic wraps mod 2**64, as
    XXH64's does)."""
    nb = len(tokens) // block_size
    if nb == 0:
        return []
    toks = np.asarray(tokens[: nb * block_size], dtype="<u4").reshape(nb, block_size)
    n = 4 * block_size
    words = np.ascontiguousarray(toks[:, : 2 * (block_size // 2)]).view("<u8")
    seed = _U(HASH_SEED)
    with np.errstate(over="ignore"):
        i = 0  # next 8-byte word
        if n >= 32:
            v = [np.full(nb, (HASH_SEED + _P1 + _P2) & _M64, dtype=_U),
                 np.full(nb, (HASH_SEED + _P2) & _M64, dtype=_U),
                 np.full(nb, seed, dtype=_U),
                 np.full(nb, (HASH_SEED - _P1) & _M64, dtype=_U)]
            while 8 * i + 32 <= n:
                v = [_round_np(v[k], words[:, i + k]) for k in range(4)]
                i += 4
            h = _rotl_np(v[0], 1) + _rotl_np(v[1], 7) + _rotl_np(v[2], 12) + _rotl_np(v[3], 18)
            for a in v:
                h = (h ^ _round_np(_U(0), a)) * _U(_P1) + _U(_P4)
        else:
            h = np.full(nb, (HASH_SEED + _P5) & _M64, dtype=_U)
        h = h + _U(n)
        while 8 * i + 8 <= n:
            h ^= _round_np(_U(0), words[:, i])
            h = _rotl_np(h, 27) * _U(_P1) + _U(_P4)
            i += 1
        if 8 * i + 4 <= n:  # an odd block size leaves one token
            h ^= toks[:, -1].astype(_U) * _U(_P1)
            h = _rotl_np(h, 23) * _U(_P2) + _U(_P3)
        h ^= h >> _U(33)
        h = h * _U(_P2)
        h ^= h >> _U(29)
        h = h * _U(_P3)
        h ^= h >> _U(32)
    return h.tolist()


_CHAIN_INIT = (HASH_SEED + _P5 + 16) & _M64


def _chain16(parent: int, local: int) -> int:
    """``chain_hash`` in Python: XXH64 of the 16 bytes parent || local."""
    h = _CHAIN_INIT
    for lane in (parent, local):  # _round and _rotl, inlined
        lane = (lane * _P2) & _M64
        h ^= ((((lane << 31) | (lane >> 33)) & _M64) * _P1) & _M64
        h = ((((h << 27) | (h >> 37)) & _M64) * _P1 + _P4) & _M64
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


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


def fast_sequence_hashes(
    tokens: Sequence[int], block_size: int, salt: Optional[str] = None
) -> List[int]:
    """Chained sequence hashes of all complete blocks — the router's hot path
    (one call per routed request over the full prompt), bit-identical to
    ``hash_token_blocks``.  Uses the native C++ library
    (csrc/native/dyn_tokens.cc, the same XXH64 chain; native.py) once it is
    loaded.  Otherwise, without xxhash the blocks' local hashes are
    computed at once in numpy lanes (``block_hashes_np``) and the chain
    step, which is sequential, runs the 16-byte XXH64 in Python."""
    from . import native

    parent = salt_hash(salt)
    pairs = native.hash_blocks(list(tokens), block_size, parent or 0)
    if pairs is not None:
        return [seq for _local, seq in pairs]
    out: List[int] = []
    if USING_XXHASH:
        for local in (compute_block_hash(tokens[i:i + block_size])
                      for i in range(0, len(tokens) - block_size + 1, block_size)):
            parent = chain_hash(parent, local)
            out.append(parent)
        return out
    for local in block_hashes_np(tokens, block_size):
        parent = _chain16(parent or 0, local)
        out.append(parent)
    return out

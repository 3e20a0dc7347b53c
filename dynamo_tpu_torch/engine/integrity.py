"""KV integrity plane: content checksums at every tier boundary.

A copy of the JAX package's ``engine/integrity.py`` for the local tiers
(the wire plane's per-block payload stamps come with the KV transfer
plane).  The verification points:

- ``host``: stamped by ``HostKvStore.put`` (offload commit), verified by
  ``_restore_pass`` before the scatter;
- ``disk``: the host stamp carried into the ``.kvblk`` envelope header
  (``_demote_to_disk``), verified by ``DiskKvStore.read`` before a
  promotion;
- ``objstore``: the disk stamp carried into the ``.obj`` envelope
  (``ingest_kvblk``), verified by ``ObjectKvStore.read`` before a
  promotion.

The checksum is CRC-32 (zlib) over a block's raw bytes, byte for byte the
JAX package's: a bf16 block is hashed through a same-width integer view,
never cast, so a stamp minted by either package verifies in the other.
Host and disk share one stamp per block, computed once at offload and
carried down and back up the tier chain, so host-RAM rot between offload
and demotion is caught at the disk write instead of laundered into a valid
file.

A verification failure is never a crash or a wrong token: the block and
its chained descendants leave the tiers (``Removed`` events), the hash is
negative-cached (``CorruptionCache``) so restore loops cannot thrash on
it, and the stream falls back to recompute.
"""

from __future__ import annotations

import threading
import time
import zlib
from concurrent.futures import Executor
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch


def raw_bytes(block: torch.Tensor) -> np.ndarray:
    """A CPU tensor's bytes as a flat uint8 array through its ``uint8``
    view (any dtype, bf16 and fp8 included, never cast), without a copy
    when the tensor is contiguous."""
    return block.contiguous().reshape(-1).view(torch.uint8).numpy()


def block_checksum(block: torch.Tensor) -> int:
    """CRC-32 of one combined KV block's bytes ([L, ps, 2KV, hd]) — the
    identity stamped at offload and carried host → disk → host."""
    return zlib.crc32(raw_bytes(block)) & 0xFFFFFFFF


def bytes_checksum(payload) -> int:
    """CRC-32 of raw payload bytes (the envelope check).  For a block this
    equals ``block_checksum`` because the envelope payload is its bytes."""
    return zlib.crc32(payload) & 0xFFFFFFFF


def block_checksums(blocks: Sequence, executor: Optional[Executor] = None) -> List[int]:
    """``block_checksum`` of each block, spread over ``executor``'s threads
    when given: zlib releases the GIL on large buffers, so the threads hash
    in parallel (a llama-3.1-8b block is 2 MiB, a 128-block prefix 256
    MiB)."""
    if executor is None or len(blocks) <= 1:
        return [block_checksum(b) for b in blocks]
    return list(executor.map(block_checksum, blocks))


def flip_array_byte(block: torch.Tensor) -> torch.Tensor:
    """Fault-injection helper (``kv_corrupt``): copy ``block`` and flip one
    byte in the middle — a deterministic stand-in for media/DMA rot.  The
    copy matters: the source buffer (a host-tier entry) must stay pristine
    so the fault models corruption in flight."""
    a = block.clone()
    flat = raw_bytes(a)
    flat[flat.size // 2] ^= 0xFF
    return a


def flip_blob_byte(blob, offset: int) -> bytearray:
    """Flip one payload byte of a serialized envelope at/after ``offset``
    (keeps the header intact so structural validation still passes — the
    checksum is what must catch it)."""
    b = bytearray(blob)
    i = offset + max(0, (len(b) - offset) // 2)
    i = min(i, len(b) - 1)
    b[i] ^= 0xFF
    return b


class CorruptionCache:
    """TTL negative cache of checksum-failed block hashes.

    Restore and promotion consult it before touching a hash, so a flaky
    medium cannot thrash promote→corrupt→drop loops.  Entries expire after
    ``ttl_s`` so a healthy copy (a rewritten tier) becomes reachable again.
    Bounded (the entry expiring soonest is evicted first) and
    clock-injectable.  Mutations take a lock: callers mix the event loop
    with ``asyncio.to_thread`` contexts.
    """

    def __init__(
        self,
        ttl_s: float = 30.0,
        max_entries: int = 4096,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.ttl_s = ttl_s
        self.max_entries = max_entries
        self._clock = clock
        self._lock = threading.Lock()
        self._banned: Dict[int, float] = {}  # hash → ban deadline

    def __len__(self) -> int:
        return len(self._banned)

    def ban(self, seq_hash: int) -> None:
        with self._lock:
            if len(self._banned) >= self.max_entries and seq_hash not in self._banned:
                # Evict the entry expiring soonest; the newest ban is the
                # one actively guarding a live thrash loop.
                oldest = min(self._banned, key=self._banned.__getitem__)
                self._banned.pop(oldest, None)
            self._banned[seq_hash] = self._clock() + self.ttl_s

    def banned(self, seq_hash: int) -> bool:
        deadline = self._banned.get(seq_hash)  # GIL-atomic read
        if deadline is None:
            return False
        if self._clock() >= deadline:
            with self._lock:
                # Re-check under the lock: a concurrent ban() may have
                # refreshed the deadline since the read above.
                if (d := self._banned.get(seq_hash)) is not None and self._clock() >= d:
                    self._banned.pop(seq_hash, None)
                return False if d is None else self._clock() < d
        return True

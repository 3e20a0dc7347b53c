"""KV integrity plane: content checksums at every tier and wire boundary.

A copy of the JAX package's ``engine/integrity.py``.  The verification
points:

- ``host``: stamped by ``HostKvStore.put`` (offload commit), verified by
  ``_restore_pass`` before the scatter;
- ``disk``: the host stamp carried into the ``.kvblk`` envelope header
  (``_demote_to_disk``), verified by ``DiskKvStore.read`` before a
  promotion;
- ``objstore``: the disk stamp carried into the ``.obj`` envelope
  (``ingest_kvblk``), verified by ``ObjectKvStore.read`` before a
  promotion;
- ``wire``: stamped per block by ``export_prompt_blocks`` from a fresh
  device gather (engine/transfer.py), verified by ``inject_blocks`` before
  anything is allocated or sealed — the disaggregated prefill transfer.

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


def payload_block_checksums(k, v, executor: Optional[Executor] = None) -> List[int]:
    """Per-block wire checksums over a transfer payload's split K/V
    arrays (``[L, n, ps, KV, hd]`` each, CPU tensors or numpy arrays of
    any dtype): block i's CRC chains K then V over the bytes of
    ``k[:, i]`` and ``v[:, i]`` in C order — the JAX function's integers
    for the same pages.  Each block's K and V are L strided runs; the CRC
    chains over them in place instead of copying them together.  Per block
    (not per payload) so the importer can seal the verified prefix.
    Blocks spread over ``executor``'s threads when given (zlib releases the
    GIL)."""
    kb, vb = _byte_view(k), _byte_view(v)

    def one(i: int) -> int:
        c = 0
        for arr in (kb, vb):
            for layer in arr[:, i]:
                c = zlib.crc32(layer, c)
        return c & 0xFFFFFFFF

    n = kb.shape[1]
    if executor is None or n <= 1:
        return [one(i) for i in range(n)]
    return list(executor.map(one, range(n)))


def _byte_view(a) -> np.ndarray:
    """``a`` (a CPU tensor or a numpy array) as C-ordered uint8 with one
    more trailing axis of the itemsize — its bytes, never cast."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        return a.view(torch.uint8).numpy().reshape(*a.shape, a.element_size())
    a = np.ascontiguousarray(a)
    return a.view(np.uint8).reshape(*a.shape, a.itemsize)


def flip_array_byte(block):
    """Fault-injection helper (``kv_corrupt``): copy ``block`` (a CPU
    tensor or a numpy array) and flip one byte in the middle — a
    deterministic stand-in for media/DMA rot.  The copy matters: the
    source buffer (a host-tier entry, a wire view) must stay pristine so
    the fault models corruption in flight."""
    if isinstance(block, torch.Tensor):
        a = block.clone()
        flat = raw_bytes(a)
    else:
        a = np.ascontiguousarray(block).copy()
        flat = a.reshape(-1).view(np.uint8)
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

    def any_banned(self, seq_hashes: Sequence[int]) -> Optional[int]:
        """First banned hash in ``seq_hashes``, or None."""
        for h in seq_hashes:
            if self.banned(h):
                return h
        return None

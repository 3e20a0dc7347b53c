"""Host (CPU RAM) KV offload tier: evicted device blocks keep their contents.

The JAX package's ``engine/host_cache.py`` on torch tensors.  Sealed blocks
are write-behind copied to host as soon as they are published (one batched
device gather and one device→host copy a pump cycle, engine/offload.py), so
device eviction never loses reusable contents; a prompt whose prefix fell
out of device memory restores it with one in-place scatter instead of
recomputing prefill.  On a CUDA engine every block is a pinned CPU tensor,
so host→device restores copy asynchronously; on the CPU a plain one.

Keyed by chained sequence hash (tokens.py), LRU-bounded by bytes.
"""

from __future__ import annotations

import logging
import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .integrity import block_checksum

logger = logging.getLogger(__name__)


class HostKvStore:
    """hash → one block's pages ``[L, page_size, 2*kv_heads, head_dim]``.

    With a disk tier configured (engine/disk_cache.py) LRU eviction DEMOTES
    instead of dropping: ``on_evict(hash, block) -> bool`` is the engine's
    demotion hook; a True return means the next tier took the block.  Every
    eviction is recorded in ``_transitions`` — ("demote", h) or ("drop", h)
    — for the engine's event flush (tier-tagged KvCacheEvents are
    published from the event loop, and eviction often happens inside
    ``asyncio.to_thread``)."""

    def __init__(
        self,
        capacity_bytes: int,
        on_evict: Optional[Callable[[int, torch.Tensor], bool]] = None,
    ):
        self.capacity_bytes = capacity_bytes
        self.on_evict = on_evict
        self._data: "OrderedDict[int, torch.Tensor]" = OrderedDict()
        self._bytes = 0
        # Mutations come from worker threads (offload commit, disk→host
        # promotion) that can overlap, so every mutation is serialized.
        # Reads (contains/peek/len) stay lock-free (GIL-atomic dict ops; a
        # stale answer degrades to a recompute) because the event loop
        # calls them on hot paths while the main lock may be held across an
        # on_evict disk write.  Transitions have their own tiny lock for the
        # same reason.
        self._lock = threading.Lock()
        self._tlock = threading.Lock()
        # Integrity stamps (engine/integrity.py): hash → CRC-32 of the
        # block's bytes, computed once at offload (put) and carried to the
        # disk envelope on demotion and back on promotion.
        self._sums: Dict[int, Optional[int]] = {}
        # counters (metrics / tests)
        self.stored_blocks = 0
        self.restored_blocks = 0
        self.evicted_blocks = 0
        self.demoted_blocks = 0
        self.corrupt_blocks = 0
        self._transitions: List[Tuple[str, int]] = []

    def __len__(self) -> int:
        return len(self._data)

    @property
    def used_bytes(self) -> int:
        return self._bytes

    def contains(self, seq_hash: int) -> bool:
        return seq_hash in self._data

    def admit_bytes(self, nbytes: int) -> bool:
        """Could ``nbytes`` ever fit this tier's budget?  The reject-early
        gate restore and promotion consult before copying anything: an
        oversized batch must fail before it stages a single byte, not blow
        the budget transiently and evict the working set for nothing."""
        return nbytes <= self.capacity_bytes

    def drain_transitions(self) -> List[Tuple[str, int]]:
        with self._tlock:
            out, self._transitions = self._transitions, []
            return out

    def _evict_one(self) -> None:
        # caller holds self._lock
        h, old = self._data.popitem(last=False)  # LRU
        self._bytes -= old.nbytes
        self.evicted_blocks += 1
        demoted = False
        if self.on_evict is not None:
            try:
                # _sums still holds h here: the demotion hook reads
                # checksum(h) to carry the offload stamp into the disk
                # envelope; popped only after the hook returns.
                demoted = bool(self.on_evict(h, old))
            except Exception:
                # Demotion is an optimization; a failing disk tier must
                # never break the host tier's eviction path.
                logger.exception("host-tier demotion failed for %#x", h)
        self._sums.pop(h, None)
        if demoted:
            self.demoted_blocks += 1
        with self._tlock:
            self._transitions.append(("demote" if demoted else "drop", h))

    def put(self, seq_hash: int, block: torch.Tensor, checksum: Optional[int] = None) -> None:
        """Insert ``block`` (a CPU tensor) under ``seq_hash``.  ``checksum``
        is the carried stamp (disk promotion) or one the caller computed;
        None computes it here — THE integrity stamp, verified at every
        later media boundary."""
        if checksum is None:
            checksum = block_checksum(block)
        with self._lock:
            if seq_hash in self._data:
                self._data.move_to_end(seq_hash)
                return
            nbytes = block.nbytes
            if nbytes > self.capacity_bytes:
                return
            while self._bytes + nbytes > self.capacity_bytes and self._data:
                self._evict_one()
            self._data[seq_hash] = block
            self._sums[seq_hash] = checksum
            self._bytes += nbytes
            self.stored_blocks += 1

    def get(self, seq_hash: int) -> Optional[torch.Tensor]:
        with self._lock:
            blk = self._data.get(seq_hash)
            if blk is not None:
                self._data.move_to_end(seq_hash)  # touch
            return blk

    def touch(self, seq_hash: int) -> None:
        """Best-effort recency touch that never blocks: the event loop
        refreshes LRU order after a restore, and the main lock can be held
        by a thread through an on_evict disk write — skipping a touch under
        contention costs at most one suboptimal future eviction."""
        if self._lock.acquire(blocking=False):
            try:
                if seq_hash in self._data:
                    self._data.move_to_end(seq_hash)
            finally:
                self._lock.release()

    def peek(self, seq_hash: int) -> Optional[torch.Tensor]:
        """Read without the LRU touch (restore candidate selection, which
        may be truncated before anything is restored)."""
        return self._data.get(seq_hash)

    def checksum(self, seq_hash: int) -> Optional[int]:
        """The block's offload-time integrity stamp (None: absent).
        Lock-free like the other reads — a stale answer degrades to one
        spurious recompute, never a wrong scatter."""
        return self._sums.get(seq_hash)

    def drop(self, seq_hash: int) -> bool:
        """Remove one block without demotion (corruption quarantine: the
        contents failed verification, pushing them down a tier would just
        relocate the poison).  Records the loss for the engine's event
        flush so the router stops advertising the prefix."""
        with self._lock:
            blk = self._data.pop(seq_hash, None)
            self._sums.pop(seq_hash, None)
            if blk is None:
                return False
            self._bytes -= blk.nbytes
            self.corrupt_blocks += 1
        with self._tlock:
            self._transitions.append(("drop", seq_hash))
        return True

"""Object-store KV tier: the fourth, durable rung of the hierarchy
(device → host → disk → object store).

The JAX package's ``engine/object_store.py`` on torch tensors.  The first
three tiers die with the worker process; this one decouples a prefix's
lifetime from the worker's: chains demoted from disk (or persisted
explicitly) land in an object layout that a brand-new worker re-indexes at
boot and restores from (object → host → device), turning cold-start
prefill into a prefix-cache hit.

Local-FS-backed object layout: objects live under two-level fan-out
directories (``{hash>>56:02x}/{hash:016x}.obj``).  Writes are
multipart-style and atomic: the envelope streams into a ``*.tmp`` staging
file in bounded parts, then one ``os.replace`` publishes the object.  The
``DOBJ1`` envelope is the disk tier's with its own magic, byte for byte the
JAX package's, so either package reads the other's objects.

Integrity: the envelope carries the same CRC-32 stamp minted at host
offload — demotion parses and re-verifies the disk envelope before
re-wrapping it, and reads verify again before any promotion; a corrupt
object is deleted and quarantined (recompute, never a wrong scatter).

GC is byte-budgeted and batched: puts may transiently overshoot
``capacity_bytes``; a sweep then evicts coldest-first down to the low
watermark.

Thread-safety mirrors DiskKvStore: one internal lock around mutation, a
tiny separate lock for the transition records the engine drains on the
event loop, and lock-free GIL-atomic membership reads.
"""

from __future__ import annotations

import logging
import os
import struct
import threading
from collections import OrderedDict
from typing import List, Optional, Tuple

import torch

from ..llm.metrics import kv_integrity_metrics, objstore_metrics
from ..runtime.faultinject import faults
from .disk_cache import (
    _MAGIC as _DISK_MAGIC,
    _NAMES,
    dtype_name,
    encode_prefix,
    parse_envelope,
    parse_header,
    read_file,
)
from .integrity import bytes_checksum, flip_blob_byte, raw_bytes

logger = logging.getLogger(__name__)

_MAGIC = b"DOBJ1\n"
_HLEN = struct.Struct("<I")


class ObjectKvStore:
    """hash → one durable block object ``[L, page_size, 2*kv_heads,
    head_dim]``.  Duck-types ``DiskKvStore`` (contains/block_nbytes/put/
    get/read/drop/drain_transitions/used_bytes) so the promotion and
    quarantine paths treat it as one more rung; single-process writers,
    any-process readers (a scale-from-zero worker re-indexes the directory
    at boot)."""

    def __init__(
        self,
        capacity_bytes: int,
        directory: str,
        fsync: bool = False,
        part_bytes: int = 1 << 20,
        gc_watermark: float = 0.9,
        pin_memory: bool = False,
    ):
        self.capacity_bytes = capacity_bytes
        self.directory = directory
        self.fsync = fsync
        self.part_bytes = max(1, part_bytes)
        self.pin_memory = pin_memory
        # GC target as a fraction of capacity: a sweep stops once
        # used_bytes <= capacity * gc_watermark.
        self.gc_watermark = gc_watermark
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._tlock = threading.Lock()
        # hash → object bytes, access-ordered (coldest first).
        self._index: "OrderedDict[int, int]" = OrderedDict()
        self._bytes = 0
        # counters (metrics / tests)
        self.stored_blocks = 0
        self.fetched_blocks = 0
        self.evicted_blocks = 0
        self.rejected_blocks = 0
        self.corrupt_blocks = 0
        self.gc_runs = 0
        self._transitions: List[Tuple[str, int]] = []
        # Re-index an existing object root (the scale-from-zero boot path).
        # Coldest = oldest mtime; orphaned staging files from a crashed
        # upload are deleted.
        entries = []
        for sub in sorted(os.listdir(directory)):
            subdir = os.path.join(directory, sub)
            if not os.path.isdir(subdir):
                continue
            for name in os.listdir(subdir):
                if name.endswith(".obj.tmp"):
                    try:
                        os.remove(os.path.join(subdir, name))
                    except OSError:
                        pass
                    continue
                if not name.endswith(".obj"):
                    continue
                try:
                    h = int(name[: -len(".obj")], 16)
                except ValueError:
                    continue
                try:
                    st = os.stat(os.path.join(subdir, name))
                except OSError:
                    continue
                entries.append((st.st_mtime, h, st.st_size))
        for _, h, size in sorted(entries):
            self._index[h] = size
            self._bytes += size

    # ------------------------------------------------------------------ state
    def _path(self, seq_hash: int) -> str:
        return os.path.join(
            self.directory, f"{(seq_hash >> 56) & 0xFF:02x}", f"{seq_hash:016x}.obj"
        )

    def _tmp_path(self, final: str) -> str:
        """Staging path of the multipart write: parts land in
        ``<final>.tmp``, ``os.replace``d into place on completion or
        removed on failure."""
        return final + ".tmp"

    def __len__(self) -> int:
        return len(self._index)

    @property
    def used_bytes(self) -> int:
        return self._bytes

    def contains(self, seq_hash: int) -> bool:
        return seq_hash in self._index

    def block_nbytes(self, seq_hash: int) -> Optional[int]:
        return self._index.get(seq_hash)

    def drain_transitions(self) -> List[Tuple[str, int]]:
        with self._tlock:
            out, self._transitions = self._transitions, []
            return out

    # -------------------------------------------------------------------- put
    def put(self, seq_hash: int, block: torch.Tensor, checksum: Optional[int] = None) -> bool:
        """Persist one block (a CPU tensor) as a durable object.
        ``checksum`` is the offload-time stamp; a payload that fails it
        rotted upstream, and persisting it would hand the poison to every
        future scale-from-zero worker."""
        if not isinstance(block, torch.Tensor) or block.dtype not in _NAMES:
            self.rejected_blocks += 1
            return False
        payload = raw_bytes(block)
        payload_crc = bytes_checksum(payload)
        if checksum is not None and int(checksum) != payload_crc:
            kv_integrity_metrics.corrupt_total["host"] += 1
            self.corrupt_blocks += 1
            self.rejected_blocks += 1
            logger.warning(
                "refusing to persist block %#x: payload fails its offload "
                "checksum (upstream corruption)", seq_hash,
            )
            return False
        prefix = encode_prefix(_MAGIC, dtype_name(block.dtype), block.shape, payload_crc)
        return self._store(seq_hash, prefix, memoryview(payload))

    def ingest_kvblk(self, seq_hash: int, path: str) -> bool:
        """Demotion entry point (``DiskKvStore.on_evict``): parse and verify
        the evicted ``.kvblk`` envelope and re-wrap it as a durable object.
        Runs inside the disk store's eviction loop (under its lock, off the
        event loop), so it never calls back into the disk tier.  A file
        that fails validation is refused; the carried CRC rides into the
        object header unchanged."""
        try:
            blob = read_file(path)
        except OSError:
            self.rejected_blocks += 1
            return False
        parsed = parse_header(blob, _DISK_MAGIC)
        if parsed is None:
            self.corrupt_blocks += 1
            self.rejected_blocks += 1
            logger.warning(
                "refusing to persist demoted block %#x: disk envelope fails validation",
                seq_hash,
            )
            return False
        name, shape, checksum, off = parsed
        # Same header, object magic: the payload bytes (and their CRC) are
        # carried, not recomputed.
        return self._store(seq_hash, encode_prefix(_MAGIC, name, shape, checksum),
                           memoryview(blob)[off:])

    def _store(self, seq_hash: int, prefix: bytes, payload: memoryview) -> bool:
        nbytes = len(prefix) + payload.nbytes
        with self._lock:
            if nbytes > self.capacity_bytes:
                self.rejected_blocks += 1
                return False
            if seq_hash in self._index:
                self._index.move_to_end(seq_hash)
                return True
            path = self._path(seq_hash)
            tmp = self._tmp_path(path)
            try:
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(tmp, "wb") as f:
                    # Multipart-style upload: bounded parts, one final
                    # atomic publish.  A crash between parts leaves only
                    # the staging file (re-index deletes it).
                    f.write(prefix)
                    for off in range(0, payload.nbytes, self.part_bytes):
                        f.write(payload[off: off + self.part_bytes])
                    if self.fsync:
                        f.flush()
                        os.fsync(f.fileno())
                os.replace(tmp, path)  # atomic: readers never see parts
            except OSError:
                logger.exception("object KV tier write failed for %#x", seq_hash)
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                self.rejected_blocks += 1
                return False
            self._index[seq_hash] = nbytes
            self._bytes += nbytes
            self.stored_blocks += 1
            objstore_metrics.puts_total += 1
            objstore_metrics.put_bytes_total += nbytes
            if self._bytes > self.capacity_bytes:
                self._gc_locked()
            return True

    # --------------------------------------------------------------------- gc
    def _gc_locked(self) -> None:
        """Byte-budgeted sweep: evict coldest objects until used bytes sit
        at or below the low watermark.  Caller holds the main lock."""
        target = int(self.capacity_bytes * self.gc_watermark)
        swept = 0
        while self._bytes > target and self._index:
            old, old_bytes = self._index.popitem(last=False)  # coldest
            self._bytes -= old_bytes
            self.evicted_blocks += 1
            swept += 1
            objstore_metrics.gc_evictions_total += 1
            with self._tlock:
                self._transitions.append(("drop", old))
            try:
                os.remove(self._path(old))
            except OSError:
                pass
        if swept:
            self.gc_runs += 1
            logger.info("object KV GC: evicted %d objects, %d bytes in use", swept, self._bytes)

    def gc(self) -> int:
        """Run one sweep now (operator/test hook); returns evicted count."""
        with self._lock:
            before = self.evicted_blocks
            self._gc_locked()
            return self.evicted_blocks - before

    # -------------------------------------------------------------------- get
    def get(self, seq_hash: int, expected_shape=None, expected_dtype=None) -> Optional[torch.Tensor]:
        return self.read(seq_hash, expected_shape, expected_dtype)[0]

    def read(
        self, seq_hash: int, expected_shape=None, expected_dtype: Optional[torch.dtype] = None
    ) -> Tuple[Optional[torch.Tensor], Optional[int], bool]:
        """Read and VALIDATE one object: ``(block, carried_checksum,
        corrupt)`` exactly like ``DiskKvStore.read`` — a corrupt object is
        deleted and the loss recorded."""
        with self._lock:
            if seq_hash not in self._index:
                return None, None, False
            path = self._path(seq_hash)
            try:
                blob = read_file(path)
            except OSError:
                self._drop_locked(seq_hash)
                with self._tlock:
                    self._transitions.append(("drop", seq_hash))
                return None, None, False
            if (
                faults.enabled
                and len(blob) > len(_MAGIC) + _HLEN.size
                and faults.should("kv_corrupt", "objstore")
            ):
                # Chaos hook: flip one payload byte after the read —
                # durable media rots too.
                (hlen,) = _HLEN.unpack_from(blob, len(_MAGIC))
                blob = flip_blob_byte(blob, len(_MAGIC) + _HLEN.size + hlen)
            parsed = parse_envelope(blob, _MAGIC, expected_shape, expected_dtype, self.pin_memory)
            if parsed is None:
                self.corrupt_blocks += 1
                self._drop_locked(seq_hash)
                with self._tlock:
                    self._transitions.append(("drop", seq_hash))
                try:
                    os.remove(path)
                except OSError:
                    pass
                return None, None, True
            arr, checksum = parsed
            self._index.move_to_end(seq_hash)  # touch
            objstore_metrics.gets_total += 1
            objstore_metrics.get_bytes_total += len(blob)
            self.fetched_blocks += 1
            return arr, checksum, False

    def drop(self, seq_hash: int) -> bool:
        """Remove one object (corruption quarantine of chained
        descendants); records the loss for the engine's event flush."""
        with self._lock:
            if seq_hash not in self._index:
                return False
            self._drop_locked(seq_hash)
            try:
                os.remove(self._path(seq_hash))
            except OSError:
                pass
        with self._tlock:
            self._transitions.append(("drop", seq_hash))
        return True

    def _drop_locked(self, seq_hash: int) -> None:
        nbytes = self._index.pop(seq_hash, None)
        if nbytes is not None:
            self._bytes -= nbytes

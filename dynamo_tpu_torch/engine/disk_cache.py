"""Disk KV tier: the third rung of the memory hierarchy (device → host → disk).

The JAX package's ``engine/disk_cache.py`` on torch tensors.  Blocks arrive
here only by demotion from the host tier (``HostKvStore.on_evict``) and
leave by promotion back into it (``HostOffloadMixin._promote_blocks``) or
by LRU eviction — the device never talks to this tier directly.

Layout: one file per block, named by the block's chained sequence hash
(``{hash:016x}.kvblk``).  Each file is the ``DKVB1`` envelope: magic, a
little-endian u32 header length, a JSON header ``{dtype, shape,
checksum}`` and the block's raw bytes.  The envelope is the JAX package's
byte for byte: a file written by either package reads back in the other.
The dtype travels by its numpy name (``float32``, ``bfloat16``,
``float8_e4m3fn``, ...); bytes move through a same-width integer view, so
no dtype is ever cast.  Reads validate the envelope byte-for-byte: a
truncated or corrupt file is deleted and treated as a miss, never
scattered.  The ``checksum`` (CRC-32 over the payload, engine/integrity.py)
is carried from the host tier's offload stamp, not recomputed, so a bit
that rotted in host RAM is refused at the write.

Thread-safety: all mutation happens under one internal lock because
callers run file I/O off the event loop (``asyncio.to_thread``).  Tier
transitions (evictions) are recorded, not published — the engine drains
``drain_transitions()`` after each threaded call and publishes from the
event loop (``TorchEngine._flush_tier_events``).
"""

from __future__ import annotations

import json
import logging
import math
import os
import struct
import threading
from collections import OrderedDict
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..llm.metrics import kv_integrity_metrics
from ..runtime.faultinject import faults
from .integrity import bytes_checksum, flip_blob_byte, raw_bytes

logger = logging.getLogger(__name__)

_MAGIC = b"DKVB1\n"
_HLEN = struct.Struct("<I")

# Envelope dtype names (numpy's, as the JAX package writes them) → torch.
DTYPES = {
    name: getattr(torch, name)
    for name in ("float32", "float16", "bfloat16", "float64", "int8", "uint8",
                 "int16", "int32", "int64", "float8_e4m3fn", "float8_e5m2")
}
_NAMES = {dt: name for name, dt in DTYPES.items()}


def dtype_name(dtype: torch.dtype) -> str:
    return _NAMES[dtype]


def encode_prefix(magic: bytes, dtype: str, shape, checksum: Optional[int]) -> bytes:
    """An envelope up to its payload: magic, header length, JSON header."""
    header = json.dumps({"dtype": dtype, "shape": list(shape), "checksum": checksum}).encode()
    return magic + _HLEN.pack(len(header)) + header


def parse_header(
    blob, magic: bytes, expected_shape=None, expected_dtype: Optional[torch.dtype] = None
) -> Optional[Tuple[str, Tuple[int, ...], Optional[int], int]]:
    """Validate one envelope byte for byte: ``(dtype name, shape, carried
    checksum, payload offset)``, or None on any structural or checksum
    failure — a bad envelope is a miss, never a crash or a wrong scatter."""
    if not blob.startswith(magic) or len(blob) < len(magic) + _HLEN.size:
        return None
    off = len(magic)
    (hlen,) = _HLEN.unpack_from(blob, off)
    off += _HLEN.size
    if len(blob) < off + hlen:
        return None
    try:
        header = json.loads(bytes(blob[off: off + hlen]))
        name = header["dtype"]
        dt = DTYPES[name]
        shape = tuple(int(s) for s in header["shape"])
        checksum = header.get("checksum")
        checksum = None if checksum is None else int(checksum)
    except (ValueError, KeyError, TypeError):
        return None
    off += hlen
    if len(blob) - off != math.prod(shape) * dt.itemsize:
        return None  # truncated/padded payload
    if expected_shape is not None and shape != tuple(expected_shape):
        return None
    if expected_dtype is not None and dt != expected_dtype:
        return None
    if checksum is not None and bytes_checksum(memoryview(blob)[off:]) != checksum:
        return None  # payload bit-rot: structural checks passed, CRC not
    return name, shape, checksum, off


def parse_envelope(
    blob, magic: bytes, expected_shape=None, expected_dtype=None, pin_memory: bool = False
) -> Optional[Tuple[torch.Tensor, Optional[int]]]:
    """``parse_header``, then the payload copied into a fresh CPU tensor
    (pinned when asked): ``(block, carried checksum)`` or None."""
    parsed = parse_header(blob, magic, expected_shape, expected_dtype)
    if parsed is None:
        return None
    name, shape, checksum, off = parsed
    out = torch.empty(shape, dtype=DTYPES[name], pin_memory=pin_memory)
    flat = raw_bytes(out)
    flat[:] = np.frombuffer(blob, np.uint8, flat.size, off)
    return out, checksum


def read_file(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


class DiskKvStore:
    """hash → one block's pages ``[L, page_size, 2*kv_heads, head_dim]`` on
    disk.  Byte-budgeted LRU like the host tier; counters mirror
    HostKvStore so the tier metrics read uniformly.  ``pin_memory``: read
    blocks land in pinned memory (a CUDA engine's host tier)."""

    def __init__(self, capacity_bytes: int, directory: str, fsync: bool = False,
                 pin_memory: bool = False):
        self.capacity_bytes = capacity_bytes
        self.directory = directory
        self.pin_memory = pin_memory
        # Demotion hook (mirrors HostKvStore.on_evict): with an object
        # store configured (engine/object_store.py) LRU eviction DEMOTES
        # instead of dropping — ``on_evict(hash, path) -> bool`` receives
        # the block's envelope PATH (the next tier parses and re-verifies
        # the file itself, so rot on this tier is refused at the handoff)
        # and a True return means the object tier took it.
        self.on_evict: Optional[Callable[[int, str], bool]] = None
        # ``os.replace`` is rename-atomic but a power loss can persist the
        # renamed file with unflushed payload pages; fsync-before-rename
        # closes that window at a per-demotion latency cost.  Off by
        # default: the read-side checksum already catches a torn payload.
        self.fsync = fsync
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        # Transition records get their own tiny lock: the event loop drains
        # them and must never wait behind a thread holding the main lock
        # through file I/O.
        self._tlock = threading.Lock()
        # hash → file bytes, LRU-ordered (oldest first).
        self._index: "OrderedDict[int, int]" = OrderedDict()
        self._bytes = 0
        # counters (metrics / tests)
        self.stored_blocks = 0
        self.promoted_blocks = 0
        self.evicted_blocks = 0
        self.rejected_blocks = 0
        self.corrupt_blocks = 0
        self.demoted_blocks = 0
        # (kind, hash) records for the engine's event flush: "drop" and
        # "demote" (object-tier handoff).
        self._transitions: List[Tuple[str, int]] = []
        # Rebuild the index from an existing directory (a restarted worker
        # finds its demoted blocks again): coldest = oldest mtime.  Orphaned
        # ``*.kvblk.tmp`` files (a crash mid-write) are deleted: they hold
        # no indexable content but consume disk outside the byte budget.
        entries = []
        for name in os.listdir(directory):
            if name.endswith(".kvblk.tmp"):
                try:
                    os.remove(os.path.join(directory, name))
                except OSError:
                    pass
                continue
            if not name.endswith(".kvblk"):
                continue
            try:
                h = int(name[: -len(".kvblk")], 16)
            except ValueError:
                continue
            try:
                st = os.stat(os.path.join(directory, name))
            except OSError:
                continue
            entries.append((st.st_mtime, h, st.st_size))
        for _, h, size in sorted(entries):
            self._index[h] = size
            self._bytes += size

    # ------------------------------------------------------------------ state
    def _path(self, seq_hash: int) -> str:
        return os.path.join(self.directory, f"{seq_hash:016x}.kvblk")

    def _tmp_path(self, final: str) -> str:
        """Staging path of the atomic write: bytes land in ``<final>.tmp``
        and are ``os.replace``d into place on success or removed on
        failure."""
        return final + ".tmp"

    # Reads are deliberately lock-free: the main lock is held across file
    # I/O by worker threads, and the event loop calls contains() and
    # block_nbytes() on hot paths (kv_manager.tier_lookup at eviction,
    # local_prefix_blocks) — blocking the loop on a disk write would stall
    # every live stream.  A stale answer is safe: a just-evicted hash reads
    # as present, the later validated read misses, and the tail recomputes.
    def __len__(self) -> int:
        return len(self._index)

    @property
    def used_bytes(self) -> int:
        return self._bytes

    def contains(self, seq_hash: int) -> bool:
        return seq_hash in self._index

    def block_nbytes(self, seq_hash: int) -> Optional[int]:
        """On-disk size of one block (index lookup, no I/O) — lets the
        promotion path budget the copy before reading any file."""
        return self._index.get(seq_hash)

    def drain_transitions(self) -> List[Tuple[str, int]]:
        with self._tlock:
            out, self._transitions = self._transitions, []
            return out

    # -------------------------------------------------------------------- put
    def put(self, seq_hash: int, block: torch.Tensor, checksum: Optional[int] = None) -> bool:
        """Demote one host-tier block (a CPU tensor) to disk.  Returns False
        (the caller emits Removed instead of a disk tier tag) when the block
        cannot be taken: larger than the whole budget, a failed write, or a
        payload that fails ``checksum``, its offload-time stamp — the bytes
        rotted in host RAM after the stamp, and writing them would launder
        the corruption into a structurally valid file."""
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
                "refusing to demote block %#x: payload fails its offload "
                "checksum (host-RAM corruption)", seq_hash,
            )
            return False
        prefix = encode_prefix(_MAGIC, dtype_name(block.dtype), block.shape, payload_crc)
        nbytes = len(prefix) + payload.size
        with self._lock:
            if nbytes > self.capacity_bytes:
                self.rejected_blocks += 1
                return False
            if seq_hash in self._index:
                self._index.move_to_end(seq_hash)
                return True
            while self._bytes + nbytes > self.capacity_bytes and self._index:
                old, old_bytes = self._index.popitem(last=False)  # LRU
                self._bytes -= old_bytes
                self.evicted_blocks += 1
                demoted = False
                if self.on_evict is not None:
                    try:
                        # The file still exists here: the hook parses and
                        # re-verifies it before taking a copy.
                        demoted = bool(self.on_evict(old, self._path(old)))
                    except Exception:
                        # Demotion is an optimization; a failing object
                        # tier must never break the disk eviction path.
                        logger.exception("disk-tier demotion failed for %#x", old)
                if demoted:
                    self.demoted_blocks += 1
                with self._tlock:
                    self._transitions.append(("demote" if demoted else "drop", old))
                try:
                    os.remove(self._path(old))
                except OSError:
                    pass
            path = self._path(seq_hash)
            tmp = self._tmp_path(path)
            try:
                with open(tmp, "wb") as f:
                    f.write(prefix)
                    f.write(payload)
                    if self.fsync:
                        f.flush()
                        os.fsync(f.fileno())
                os.replace(tmp, path)  # atomic: readers never see a torn file
            except OSError:
                logger.exception("disk KV tier write failed for %#x", seq_hash)
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                self.rejected_blocks += 1
                return False
            self._index[seq_hash] = nbytes
            self._bytes += nbytes
            self.stored_blocks += 1
            return True

    # -------------------------------------------------------------------- get
    def get(self, seq_hash: int, expected_shape=None, expected_dtype=None) -> Optional[torch.Tensor]:
        """Read and validate one block; see ``read`` (this wrapper drops
        the integrity detail for callers that only care hit/miss)."""
        return self.read(seq_hash, expected_shape, expected_dtype)[0]

    def read(
        self, seq_hash: int, expected_shape=None, expected_dtype: Optional[torch.dtype] = None
    ) -> Tuple[Optional[torch.Tensor], Optional[int], bool]:
        """Read and VALIDATE one block: ``(block, carried_checksum,
        corrupt)``.  The checksum rides to the host tier on promotion so
        the stamp survives the round trip; ``corrupt`` tells a failed
        verification from a plain miss so the engine can quarantine the
        chain.  A corrupt file is deleted (it cannot miss forever) and its
        loss recorded so the router stops advertising the prefix."""
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
                and faults.should("kv_corrupt", "disk")
            ):
                # Chaos hook: flip one payload byte after the OS read —
                # media rot the structural checks cannot see.
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
            return arr, checksum, False

    def drop(self, seq_hash: int) -> bool:
        """Remove one block (corruption quarantine of chained
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

"""Cross-engine KV block transfer: the host-staged export/import (the
cross-process wire format of disaggregated prefill) and the same-process
device-to-device path.

The JAX package's ``engine/transfer.py`` (``KvTransferMixin``) for one
device.  The payload is the JAX package's key for key and byte for byte
(``dtype`` by its numpy name, ``k``/``v`` as C-order bytes of ``[L, n, ps,
KV, hd]``, K the even combined heads and V the odd), so a JAX prefill
worker can feed a port decode worker and the reverse.

What touches the device is a gather of whole pages and an in-place scatter
of whole pages (``index_select``, ``index_copy_``), ordered by stream as
the KV tiers' copies are (engine/offload.py), never by a device-wide sync:

- export: under ``_device_lock`` the gather and the K/V split are enqueued
  on the stream the graph replays run on, behind the dispatches that wrote
  the blocks; the split buffers are copied into pinned host memory on the
  copy stream behind an event, and a worker thread waits on the copy's
  event outside the lock before the checksums and the payload bytes;
- import: every check runs before anything is allocated; the payload is
  copied into pinned memory, uploaded and interleaved back into combined
  pages on the copy stream outside the lock; under the lock the replay
  stream waits on the upload's event and the pages are scattered in place,
  before the admission whose step reads them.  The lock is held for that
  scatter alone, so an import never stops decode for longer than one
  chunk's scatter.  The pages tensor is never rebound: every captured
  graph holds its address.  No power-of-two padding is needed (the JAX
  path pads to bound its compiled scatter shapes; an eager scatter has
  none to bound).
- the same-process path (``transfer_blocks_device``): a gather from the
  source engine's pages and an in-place scatter into the destination's,
  ordered by an event from the source's stream to the destination's, with
  no host staging.

The JAX package's multi-host guards and the follower broadcast of an
import (``_publisher``) have no counterpart: tp and multi-host are ROADMAP
queue 1 item 7.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import TYPE_CHECKING, Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..llm.metrics import kv_integrity_metrics
from ..runtime.faultinject import faults
from ..tokens import hash_token_blocks
from .disk_cache import DTYPES, dtype_name
from .integrity import flip_array_byte, payload_block_checksums, raw_bytes
from .offload import as_bits

if TYPE_CHECKING:  # annotation-only (transfer_blocks_device signature)
    from .engine import TorchEngine

logger = logging.getLogger(__name__)

# Payload bytes are viewed through the unsigned integer of the dtype's
# width: every check and the wire fault work on bytes, never on values.
_INT_VIEW = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _scales_close(a, b, rtol: float = 1e-3) -> bool:
    """Stored-representation scale compatibility for KV transfers.

    Exact equality would disable transfers between two workers that each
    calibrated ``kv_scale='auto'`` (independent calibrations drift at the
    ULP level across devices and compilers).  The tolerance covers that
    drift and no more: beyond it the quantized rows encode different
    values, and importing them raw would carry a systematic dequantization
    error — such imports are rejected and the caller prefills locally."""
    if a is None or b is None:
        return a is None and b is None
    av = np.asarray(a, np.float32).reshape(-1)
    bv = np.asarray(b, np.float32).reshape(-1)
    if av.shape != bv.shape and av.size != 1 and bv.size != 1:
        return False
    return bool(np.allclose(av, bv, rtol=rtol))


def _host_tensor(a: np.ndarray, dtype: torch.dtype, pin: bool) -> torch.Tensor:
    """A CPU tensor of ``dtype`` holding the bytes of ``a`` (a numpy
    array of the same itemsize), pinned when ``pin``: the bytes are copied
    through uint8 views, never cast."""
    a = np.ascontiguousarray(a)  # a copy only for a sliced (verified-prefix) view
    t = torch.empty(a.shape, dtype=dtype, pin_memory=pin)
    np.copyto(t.view(torch.uint8).numpy(), a.view(np.uint8))
    return t


class KvTransferMixin:
    """TorchEngine's transfer methods.  Expects ``cfg``, ``device``,
    ``cache``, ``kv``, ``kv_scale``, ``_device_lock``, ``_copy_stream``,
    the copy counters with their ``_copy_lock``, ``step_trace`` and the
    offload mixin's ``_page_index`` / ``_restore_scatter`` (engine.py)."""

    def _init_transfer(self) -> None:
        # Host wall of each export's and import's parts, newest last:
        # (kind, blocks, {part: seconds}).  Host instrumentation only.
        self.transfer_parts: Deque[Tuple[str, int, Dict[str, float]]] = collections.deque(
            maxlen=1024)

    def _checksum_pool(self) -> ThreadPoolExecutor:
        """The engine's checksum threads (the host tier's, made here when
        the tiers are off) for the per-block wire checksums: zlib releases
        the GIL, and a 127-block llama-3.1-8b payload is 254 MiB."""
        if self._crc_pool is None:
            self._crc_pool = ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 1), thread_name_prefix="kv-crc")
        return self._crc_pool

    def _kv_scale_repr(self):
        """JSON-safe scale for transfer payloads: None, float, or list."""
        if self.kv_scale is None:
            return None
        a = np.asarray(self.kv_scale, np.float32).reshape(-1)
        return [float(x) for x in a] if a.size > 1 else float(a[0])

    # -------------------------------------------------------------- export
    async def export_prompt_blocks(
        self,
        token_ids: List[int],
        start_block: int = 0,
        max_blocks: int = 0,
        salt: Optional[str] = None,
        blocks: Optional[List[Any]] = None,
    ) -> Optional[Dict[str, Any]]:
        """Gather cached KV for ``token_ids``'s complete blocks to host.

        Exports the longest RESIDENT run starting at ``start_block`` (a
        prompt that lost tail blocks to eviction still transfers its
        resident prefix), bounded by ``max_blocks`` (chunked transfer).
        Returns None when nothing is resident at ``start_block``.
        ``salt`` is the owning tenant's KV salt: tenant blocks seal under
        salted chained hashes, so an unsalted lookup cannot see them.

        ``blocks`` lets a caller that already holds the sealed chained-hash
        list pass it through instead of rehashing per chunk; under
        ``__debug__`` it is asserted equal to a fresh recompute.
        """
        if blocks is None:
            blocks = hash_token_blocks(token_ids, self.cfg.block_size, salt)
        elif __debug__:
            fresh = hash_token_blocks(token_ids, self.cfg.block_size, salt)
            assert [tb.sequence_hash for tb in blocks] == [
                tb.sequence_hash for tb in fresh
            ], "export_prompt_blocks: passed block chain != sealed recompute"
        ids: List[int] = []
        for tb in blocks[start_block:]:
            bid = self.kv._by_hash.get(tb.sequence_hash)
            if bid is None:
                break
            ids.append(bid)
            if max_blocks and len(ids) >= max_blocks:
                break
        if not ids:
            return None
        pool = self._checksum_pool()
        parts: Dict[str, float] = {}
        t0 = time.perf_counter()
        staging = await asyncio.to_thread(self._export_staging, len(ids))
        t1 = time.perf_counter()
        async with self._device_lock:
            t2 = time.perf_counter()
            staged = await asyncio.to_thread(self._export_gather, ids, staging)
            t3 = time.perf_counter()
        parts.update(pin=t1 - t0, lock_wait=t2 - t1, gather=t3 - t2)
        out = await asyncio.to_thread(self._export_finish, staged, pool, parts)
        self.transfer_parts.append(("export", len(ids), parts))
        k_shape, name, sums, kb, vb = out
        return {
            "n_blocks": len(ids),
            "start_block": start_block,
            "block_size": self.cfg.block_size,
            "dtype": name,
            # Stored representation metadata: the importer must match (a
            # different quantization scale/dtype would seal wrongly-scaled
            # KV under valid hashes).
            "kv_scale": self._kv_scale_repr(),
            "shape": list(k_shape),
            # Per-block content checksums stamped from the device gather
            # (the source of truth): the importer verifies before sealing.
            "checksums": sums,
            "k": kb,
            "v": vb,
        }

    def _export_staging(self, n: int) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """Pinned host buffers for ``n`` blocks' K and V (CUDA only),
        allocated before the device lock is taken."""
        if self.device.type != "cuda":
            return None
        L, _, ps, KV2, hd = self.cache.pages.shape
        shape = (L, n, ps, KV2 // 2, hd)
        dt = self.cache.pages.dtype
        return (torch.empty(shape, dtype=dt, pin_memory=True),
                torch.empty(shape, dtype=dt, pin_memory=True))

    def _export_gather(self, ids: List[int], staging) -> Tuple[torch.Tensor, torch.Tensor, Any]:
        """Gather pages ``ids`` and split them into K (even combined heads)
        and V (odd), each ``[L, n, ps, KV, hd]``, then start their copy to
        the pinned ``staging`` on the copy stream.  Returns the host K, V
        and the copy's event (None on the CPU, where they are made at
        once).  Runs in a worker thread under the device lock."""
        with torch.inference_mode():
            idx = self._page_index(ids)
            pages = self.cache.pages
            gathered = as_bits(pages).index_select(1, idx)  # [L, n, ps, 2KV, hd]
            k = gathered[:, :, :, 0::2].contiguous().view(pages.dtype)
            v = gathered[:, :, :, 1::2].contiguous().view(pages.dtype)
            if self.device.type != "cuda":
                with self._copy_lock:
                    self.d2h_bytes += k.nbytes + v.nbytes
                return k, v, None
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
            stream = self._copy_stream
            stream.wait_event(ready)
            kh, vh = staging
            with self._copy_lock, torch.cuda.stream(stream):
                t0 = self.d2h_spans.start()
                kh.copy_(k, non_blocking=True)
                vh.copy_(v, non_blocking=True)
                self.d2h_spans.stop(t0)
                done = torch.cuda.Event()
                done.record(stream)
                self.d2h_bytes += k.nbytes + v.nbytes
            k.record_stream(stream)
            v.record_stream(stream)
            return kh, vh, done

    def _export_finish(self, staged, pool, parts: Dict[str, float]):
        """Wait for the host K/V (outside the device lock), then the
        per-block checksums and the payload bytes: (K shape, dtype name,
        checksums, K bytes, V bytes)."""
        k, v, done = staged
        t0 = time.perf_counter()
        if done is not None:
            done.synchronize()
        t1 = time.perf_counter()
        sums = payload_block_checksums(k, v, pool)
        t2 = time.perf_counter()
        kb, vb = raw_bytes(k).tobytes(), raw_bytes(v).tobytes()
        parts.update(d2h_wait=t1 - t0, crc=t2 - t1, bytes=time.perf_counter() - t2)
        return tuple(k.shape), dtype_name(k.dtype), sums, kb, vb

    # -------------------------------------------------------------- import
    async def inject_blocks(
        self,
        token_ids: List[int],
        payload: Dict[str, Any],
        salt: Optional[str] = None,
        donor: Optional[int] = None,
    ) -> int:
        """Write transferred KV into this engine's pages as sealed blocks.

        ``payload["start_block"]`` supports chunked transfers: chunk k's
        blocks seal under their chained hashes as they arrive, so decode can
        overlap with the remaining chunks' transfer.

        When the payload carries per-block ``checksums`` they are verified
        against the parsed arrays before anything is allocated or sealed
        (the wire integrity boundary): the verified prefix seals, the first
        corrupt block and everything after it is dropped and the hash
        negative-cached.  Payloads without checksums inject unverified
        (omit-when-absent wire compat).  ``donor`` attributes a corrupt
        payload to its sender for the health ledger.

        Returns the number of tokens covered.  The blocks are released to
        the reuse pool at once (contents intact), so the next generate() for
        these tokens admits with a prefix hit — no remote-prefill state in
        the scheduler.
        """
        start = int(payload.get("start_block", 0))
        # Tenant imports seal under the tenant's salted hash chain — the
        # identity the exporter read them under.
        blocks = hash_token_blocks(token_ids, self.cfg.block_size, salt)[start:]
        n = min(int(payload["n_blocks"]), len(blocks))
        if n == 0:
            return 0
        blocks = blocks[:n]
        # Validate the payload BEFORE allocating: allocation can LRU-evict
        # sealed prefix-cache blocks, and an import about to be rejected
        # must never pay that eviction for blocks it frees right back.
        if int(payload.get("block_size", self.cfg.block_size)) != self.cfg.block_size:
            logger.warning(
                "rejecting KV import: block_size %s != local %s",
                payload.get("block_size"), self.cfg.block_size,
            )
            return 0
        local_name = dtype_name(self.cache.pages.dtype)
        local_scale = self._kv_scale_repr()
        if payload.get("dtype", local_name) != local_name or not _scales_close(
            payload.get("kv_scale", local_scale), local_scale
        ):
            # Stored-representation mismatch (quantization dtype/scale):
            # importing raw rows would mis-scale the prefix silently.
            logger.warning(
                "rejecting KV import: stored repr %s/scale %s != local %s/%s",
                payload.get("dtype"), payload.get("kv_scale"), local_name, local_scale,
            )
            return 0
        t0 = time.perf_counter()
        shape = tuple(payload["shape"])
        dt = DTYPES[payload["dtype"]]
        expected = int(np.prod(shape)) * dt.itemsize
        if len(payload["k"]) != expected or len(payload["v"]) != expected:
            logger.warning("rejecting KV import: payload bytes != shape")
            return 0
        if shape[1] < n:
            logger.warning(
                "rejecting KV import: payload carries %d pages for n_blocks %d", shape[1], n,
            )
            return 0
        if not self.kv.would_fit(blocks, n):
            # Destination-budget reject-early, before any staging copy.
            logger.warning("rejecting KV import: %d blocks exceed free KV capacity", n)
            return 0
        try:
            view = _INT_VIEW[dt.itemsize]
            k = np.frombuffer(payload["k"], dtype=view).reshape(shape)[:, :n]
            v = np.frombuffer(payload["v"], dtype=view).reshape(shape)[:, :n]
        except ValueError:
            logger.warning("rejecting KV import: malformed payload arrays")
            return 0
        if faults.enabled and faults.should("kv_corrupt", "wire"):
            # Chaos hook: flip one byte of the staged K payload — a
            # wire/staging bit-flip the structural checks cannot see.
            k = flip_array_byte(k)
        parts: Dict[str, float] = {"parse": time.perf_counter() - t0}
        sums = payload.get("checksums")
        if sums is not None:
            # The wire integrity boundary: every block verified before the
            # upload (and long before allocation/sealing), on threads off
            # the event loop.  The verified prefix stays usable; the first
            # corrupt block truncates the import.
            t0 = time.perf_counter()
            got = await asyncio.to_thread(payload_block_checksums, k, v, self._checksum_pool())
            parts["verify"] = time.perf_counter() - t0
            valid = n
            for i in range(n):
                if i >= len(sums) or int(sums[i]) != got[i]:
                    valid = i
                    break
            kv_integrity_metrics.verified_total["wire"] += valid
            if valid < n:
                self._record_corruption("wire", blocks[valid].sequence_hash, donor=donor)
                self._flush_tier_events()
                logger.warning(
                    "KV import failed checksum at block %d/%d; sealing the "
                    "verified prefix only", valid, n,
                )
                n = valid
                if n == 0:
                    self.transfer_parts.append(("inject", 0, parts))
                    return 0
                blocks = blocks[:n]
                k = k[:, :n]
                v = v[:, :n]
        t0 = time.perf_counter()
        staged = await asyncio.to_thread(self._inject_upload, k, v, dt)
        parts["upload"] = time.perf_counter() - t0
        alloc = self.kv.allocate_sequence(blocks, n, count_hits=False)
        if alloc is None:
            return 0  # no capacity; the caller falls back to local prefill
        ids, _ = alloc
        try:
            async with self._device_lock:
                # Lock-HOLD wall only (t0 inside the lock: queueing behind a
                # decode chunk is the scheduler working as intended): the
                # overlap contract is that an import never blocks decode
                # longer than ONE chunk's scatter.
                t0 = time.perf_counter()
                await asyncio.to_thread(self._restore_scatter, ids, staged)
                hold = time.perf_counter() - t0
        except BaseException:
            # Mid-transfer failure: the blocks were never sealed — return
            # them to the pool, then surface the error (the sender retries
            # or drops; the decode side's timeout prefills locally).
            self.kv.free_sequence(ids)
            raise
        parts["hold"] = hold
        self.transfer_parts.append(("inject", n, parts))
        self.step_trace.append(("inject", hold, n, 0))
        for bid, tb in zip(ids, blocks):
            self.kv.seal_block(bid, tb)
        self.kv.free_sequence(ids)
        return n * self.cfg.block_size

    def _inject_upload(self, k: np.ndarray, v: np.ndarray, dt: torch.dtype):
        """Stage the payload's K and V (``[L, n, ps, KV, hd]``) and
        interleave them back into combined pages ``[L, n, ps, 2KV, hd]``
        (K at even heads), on the copy stream on CUDA.  Returns the staged
        blocks as ``[n, L, ps, 2KV, hd]`` (``_restore_scatter``'s layout)
        and the upload's event (None on the CPU)."""
        cuda = self.device.type == "cuda"
        with torch.inference_mode():
            kh, vh = _host_tensor(k, dt, cuda), _host_tensor(v, dt, cuda)
            L, n, ps, KV, hd = kh.shape
            if not cuda:
                comb = torch.stack([as_bits(kh), as_bits(vh)], dim=4).reshape(
                    L, n, ps, 2 * KV, hd).view(dt)
                with self._copy_lock:
                    self.h2d_bytes += kh.nbytes + vh.nbytes
                return comb.transpose(0, 1), None
            stream = self._copy_stream
            with self._copy_lock, torch.cuda.stream(stream):
                t0 = self.h2d_spans.start()
                kd = kh.to(self.device, non_blocking=True)
                vd = vh.to(self.device, non_blocking=True)
                self.h2d_spans.stop(t0)
                comb = torch.stack([as_bits(kd), as_bits(vd)], dim=4).reshape(
                    L, n, ps, 2 * KV, hd).view(dt)
                done = torch.cuda.Event()
                done.record(stream)
                self.h2d_bytes += kh.nbytes + vh.nbytes
            return comb.transpose(0, 1), done

    async def inject_blocks_from_device(
        self,
        token_ids: List[int],
        pages_dev: torch.Tensor,
        n: int,
        start_block: int = 0,
        salt: Optional[str] = None,
        ready: Any = None,
    ) -> int:
        """Seal ``n`` transferred blocks whose pages are ALREADY on this
        engine's device (no host staging).  ``pages_dev`` is ``[L, m, ps,
        2KV, hd]`` with the first n slots valid; ``ready`` is the event
        behind the work that wrote it (None: stream order already holds)."""
        blocks = hash_token_blocks(token_ids, self.cfg.block_size, salt)[start_block:]
        n = min(n, len(blocks))
        if n == 0:
            return 0
        pages = self.cache.pages
        # Validate layout and capacity BEFORE allocating: a mismatched
        # layout would seal wrong KV under valid hashes, and a doomed
        # allocation must never LRU-evict sealed contents.
        if (
            pages_dev.ndim != 5
            or pages_dev.shape[0] != pages.shape[0]
            or pages_dev.shape[1] < n
            or pages_dev.shape[2:] != pages.shape[2:]
            or pages_dev.dtype != pages.dtype
            or pages_dev.device != pages.device
        ):
            logger.warning(
                "rejecting device KV import: pages %s/%s/%s vs local cache %s/%s/%s",
                tuple(pages_dev.shape), pages_dev.dtype, pages_dev.device,
                tuple(pages.shape), pages.dtype, pages.device,
            )
            return 0
        alloc = self.kv.allocate_sequence(blocks[:n], n, count_hits=False)
        if alloc is None:
            return 0
        ids, _ = alloc
        try:
            async with self._device_lock:
                t0 = time.perf_counter()  # lock HOLD, not wait (see inject_blocks)
                await asyncio.to_thread(
                    self._restore_scatter, ids, (pages_dev[:, :n].transpose(0, 1), ready))
                hold = time.perf_counter() - t0
        except BaseException:
            self.kv.free_sequence(ids)  # roll back: blocks never sealed
            raise
        self.step_trace.append(("inject", hold, n, 0))
        for bid, tb in zip(ids, blocks[:n]):
            self.kv.seal_block(bid, tb)
        self.kv.free_sequence(ids)
        return n * self.cfg.block_size

    def _pin_prefix(self, token_ids: List[int], salt: Optional[str] = None):
        """Take references on the resident prefix blocks of ``token_ids``
        (keeps pre-admission work alive)."""
        return self.kv.acquire_prefix(hash_token_blocks(token_ids, self.cfg.block_size, salt))


async def transfer_blocks_device(
    src: "TorchEngine", dst: "TorchEngine", token_ids, salt: Optional[str] = None
) -> int:
    """Co-located prefill→decode KV transfer that never stages in host
    memory: a gather from the source's pages, ordered to the destination's
    stream by an event, then an in-place scatter.  On one card this is a
    device-memory copy.  Returns tokens covered (the longest resident
    prefix run)."""
    if src.cfg.block_size != dst.cfg.block_size:
        return 0
    if src.cache.pages.shape[0] != dst.cache.pages.shape[0]:
        return 0  # different layer counts: not the same model
    if src.cache.pages.dtype != dst.cache.pages.dtype or not _scales_close(
        src._kv_scale_repr(), dst._kv_scale_repr()
    ):
        return 0  # stored representation differs: the host path refuses too
    blocks = hash_token_blocks(token_ids, src.cfg.block_size, salt)
    src_ids: List[int] = []
    for tb in blocks:
        bid = src.kv._by_hash.get(tb.sequence_hash)
        if bid is None:
            break
        src_ids.append(bid)
    if not src_ids:
        return 0
    async with src._device_lock:
        pages, ready = await asyncio.to_thread(_device_gather, src, src_ids, dst.cache.pages.device)
    return await dst.inject_blocks_from_device(token_ids, pages, len(src_ids), salt=salt,
                                               ready=ready)


def _device_gather(src: "TorchEngine", ids: List[int], dst_device: torch.device):
    """Gather ``src``'s pages ``ids`` on its stream (under its device lock)
    and record the event a consumer waits on; moved to ``dst_device`` on
    that stream when it is another device."""
    with torch.inference_mode():
        pages = as_bits(src.cache.pages).index_select(1, src._page_index(ids)).view(
            src.cache.pages.dtype)
        if src.device.type != "cuda":
            return pages.to(dst_device), None
        if pages.device != dst_device:
            pages = pages.to(dst_device, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(src.device))
        return pages, ready

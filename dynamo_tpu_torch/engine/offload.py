"""The KV memory tiers' device side: the write-behind offload pump and the
restore of evicted prefixes ahead of admission.

The JAX package's ``engine/offload.py`` (``HostOffloadMixin``) for one
device.  The tiers themselves are host code (engine/host_cache.py,
disk_cache.py, object_store.py); what touches the device is a gather of
whole pages and an in-place scatter of whole pages — plain torch ops
(``index_select``, ``index_copy_``), as they were plain XLA programs on the
TPU — and the copies between them and pinned host memory.

Ordering is by stream, never by a device-wide sync (a
``torch.cuda.synchronize`` would stall behind every graph in flight):

- offload: under ``_device_lock`` the gather is enqueued on the stream the
  graph replays run on, so it follows the dispatches that wrote the blocks
  and precedes any later one that reuses them; its fresh device buffer is
  copied into pinned host blocks on a side copy stream that waits on an
  event behind the gather (``record_stream`` keeps the buffer alive), and a
  worker thread waits on the copy's event outside the lock before the
  blocks enter the host tier;
- restore: the host blocks are copied into a fresh device buffer on the
  copy stream outside the lock; under the lock the replay stream waits on
  the copy's event and the pages are scattered in place with
  ``index_copy_``, before the admission whose step reads them.  The pages
  tensor is never rebound: every captured graph holds its address.

On one node with more than one rank the tiers hold whole blocks on the
leader, as one JAX process holds them: the offload's gather assembles
every rank's heads there (``_node_heads``, one gather over ``tp``), and a
restore, verified on the leader's device, publishes only the block ids
("restore_blocks"): one scatter over all ranks (``_restore_node``) hands
each rank its heads of those blocks from the leader's device.  Across
nodes each rank's host tier keeps its own slice and a restore is the
"restore_host" mirror of the leader's choice.

Page ids are sliced to the live count (no out-of-range padding ids: on
CUDA one would fault the context).  Nothing here falls back: a failed
pinned allocation, copy or scatter raises; the tiers recompute only where
the JAX package does — a miss, a corrupt block or a full budget.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..llm.metrics import kv_integrity_metrics, kv_tier_metrics
from ..ops.crc32 import block_crc32
from ..runtime.faultinject import faults
from ..tokens import hash_token_blocks
from .integrity import block_checksums, flip_array_byte

logger = logging.getLogger(__name__)

_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def as_bits(t: torch.Tensor) -> torch.Tensor:
    """``t``, or for fp8 its same-width integer view: page gathers and
    scatters move bytes, and the CPU has no fp8 index kernels."""
    return t.view(torch.uint8) if t.dtype in _FP8 else t


class HostOffloadMixin:
    """TorchEngine's tier methods.  Expects ``cfg``, ``device``, ``cache``,
    ``kv``, ``host_kv``/``disk_kv``/``object_kv``, ``integrity``,
    ``_offload_queue``, ``_device_lock``, ``_copy_stream``, ``_crc_pool``
    and the copy counters with their ``_copy_lock`` (engine.py
    ``_init_tiers``)."""

    # ------------------------------------------------------------- offload
    async def _offload_pump(self) -> None:
        """Write-behind: batch-gather queued sealed blocks to the host tier
        (one device gather and one device→host copy a cycle)."""
        while not self._closed:
            await asyncio.sleep(self.cfg.host_offload_interval)
            if self._offload_queue:
                try:
                    await self.drain_offload()
                except asyncio.CancelledError:
                    raise
                except Exception:
                    # Offload is an optimization; never let it kill serving.
                    logger.exception("host KV offload cycle failed")

    async def drain_offload(self, max_blocks: int = 64) -> int:
        """Copy up to ``max_blocks`` queued sealed blocks to host RAM.
        Returns how many were stored (public so tests can force a cycle).

        The device lock is held only while the gather is enqueued: its
        output is a fresh buffer, so once it is on the stream the copy to
        host and the host-tier store run outside the lock — decode dispatch
        never waits on an offload's host copy."""
        if self.host_kv is None or not self._offload_queue:
            return 0
        batch, self._offload_queue = (
            self._offload_queue[:max_blocks],
            self._offload_queue[max_blocks:],
        )
        async with self._device_lock:
            # A block may have been recycled since sealing; only blocks
            # still holding their hash are snapshotted.
            live = [
                (bid, tb) for bid, tb in batch
                if self.kv._blocks[bid].sequence_hash == tb.sequence_hash
            ]
            if not live:
                return 0
            hashes = [tb.sequence_hash for _, tb in live]
            ids = [bid for bid, _ in live]
            # Every rank sends its heads to the leader (one node) or
            # stores its own slice (across nodes).
            await self._publish("offload", (ids, hashes))
            staged = await asyncio.to_thread(self._offload_gather, ids)
        await asyncio.to_thread(self._offload_commit, staged, hashes)
        self._flush_tier_events()
        return len(live)

    def _page_index(self, ids: Sequence[int]) -> torch.Tensor:
        """``ids`` as an int64 index on the device: staged through pinned
        memory so the copy is queued on the stream, never a blocking one
        (a pageable host→device copy syncs the stream)."""
        idx = torch.tensor(list(ids), dtype=torch.int64)
        if self.device.type == "cuda":
            idx = idx.pin_memory().to(self.device, non_blocking=True)
        return idx

    def _offload_gather(self, ids: List[int]) -> Optional[Tuple[List[torch.Tensor], Any]]:
        """Gather pages ``ids`` into fresh memory, whole blocks on one node
        (every rank's heads, on the leader), and start their copy to host
        blocks ``[L, ps, 2KV, D]`` (pinned on CUDA).  Returns the host
        blocks and the copy's event (None on the CPU, where the copy is
        made at once), or None on a follower of one node, whose heads went
        to the leader.  Runs in a worker thread under the device lock."""
        with torch.inference_mode():
            idx = self._page_index(ids)
            # [n, L, ps, 2KV, D]: block i is one contiguous run of bytes.
            pages = self.cache.pages
            gathered = as_bits(pages).transpose(0, 1).index_select(0, idx).contiguous()
            if self._whole_blocks:
                gathered = self._node_heads(gathered, 3)
                if gathered is None:
                    return None
            gathered = gathered.view(pages.dtype)
            self.d2h_bytes += gathered.nbytes
            if self.device.type != "cuda":
                return [b.clone() for b in gathered.unbind(0)], None
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
            stream = self._copy_stream
            stream.wait_event(ready)
            blocks = [torch.empty(gathered.shape[1:], dtype=gathered.dtype, pin_memory=True)
                      for _ in ids]
            with self._copy_lock, torch.cuda.stream(stream):
                t0 = self.d2h_spans.start()
                for dst, src in zip(blocks, gathered.unbind(0)):
                    dst.copy_(src, non_blocking=True)
                self.d2h_spans.stop(t0)
                done = torch.cuda.Event()
                done.record(stream)
            gathered.record_stream(stream)
            return blocks, done

    def _offload_commit(self, staged: Tuple[List[torch.Tensor], Any], hashes: List[int]) -> None:
        """Wait for the gathered blocks to reach host memory and store them
        in the host tier (runs outside the device lock)."""
        blocks, done = staged
        if done is not None:
            done.synchronize()
        for h, blk, crc in zip(hashes, blocks, block_checksums(blocks, self._crc_pool)):
            self.host_kv.put(h, blk, checksum=crc)

    # ---------------------------------------------------------- sp prefill
    async def _sp_prefill(self, token_ids: List[int], salt: Optional[str] = None) -> int:
        """Whole-prompt sequence-parallel prefill (the JAX engine's
        ``_sp_prefill``): compute the prompt's KV in one ring-attention pass
        over the ``sp`` ranks and seal its complete blocks into the pages
        (released to the reuse pool), so admission sees a prefix hit; the
        trailing partial block and the last token recompute through the
        normal unified step, which also samples the first token.  Returns
        the tokens sealed.

        Unlike the JAX engine, the pass holds the device lock: its
        collectives must reach every rank in the order of every other
        dispatch's, so it is published and run like one ("sp_prefill").
        The block ids are allocated first, and every rank runs the pass and
        seals its rows within that one hold of the lock, so two long
        prompts in flight cannot interleave their passes and seals."""
        cfg = self.cfg
        bs = cfg.block_size
        n_complete = len(token_ids) // bs
        blocks = hash_token_blocks(token_ids, bs, salt)
        resident = len(self.kv.match_prefix(blocks))
        if resident >= n_complete or n_complete == 0:
            return 0
        n_new = n_complete - resident
        sealing = blocks[resident:n_complete]
        alloc = self.kv.allocate_sequence(sealing, n_new, count_hits=False)
        if alloc is None:
            return 0
        ids, _ = alloc
        # The token bucket: a power of two, a multiple of sp.
        Tg = max(cfg.sp, 1 << (len(token_ids) - 1).bit_length())
        Tg += (-Tg) % cfg.sp
        toks = np.zeros((Tg,), np.int64)
        toks[: len(token_ids)] = token_ids
        payload = (toks, len(token_ids), ids, resident)
        try:
            async with self._device_lock:
                await self._publish("sp_prefill", payload)
                await asyncio.to_thread(self._sp_prefill_seal, *payload)
        except BaseException:
            self.kv.free_sequence(ids)  # roll back: blocks never sealed
            raise
        for bid, tb in zip(ids, sealing):
            self.kv.seal_block(bid, tb)
        self.kv.free_sequence(ids)
        covered = n_new * bs
        logger.info("sp prefill sealed %d tokens of %d (sp=%d, bucket %d)",
                    covered, len(token_ids), cfg.sp, Tg)
        return covered

    # ----------------------------------------------------------- promotion
    def _promote_blocks(self, seq_hashes: List[int], stop_on_miss: bool) -> List[int]:
        """Disk→host promotion (thread context): read and validate each
        block's file and insert it into the host tier.  A hash the disk
        tier no longer holds falls through to the object-store tier
        (object → host directly — the scale-from-zero restore path, where
        the disk tier starts empty).  The byte budget is counted against
        the destination tier before any file is read, so an oversized batch
        rejects early instead of evicting the working set for nothing.
        ``stop_on_miss`` stops at the first unavailable hash (prefix
        restores need a contiguous leading run); prefetch skips instead.

        Integrity: the envelope checksum verifies inside ``read`` (a
        corrupt file is a quarantine event — the chain's deeper tier blocks
        drop with it and the hash is negative-cached), and the carried
        stamp rides into the host entry so the later host→device restore
        re-verifies the same identity."""
        shape, dtype = self.block_shape, self.cache.pages.dtype
        staged = 0
        promoted: List[int] = []
        for h in seq_hashes:
            if self.integrity.banned(h):
                # Recently corrupt: a miss for the TTL, so a
                # promote→corrupt→drop loop cannot thrash on the hash.
                kv_integrity_metrics.negative_cache_hits_total += 1
                if stop_on_miss:
                    break
                continue
            if self.host_kv.contains(h):
                continue
            source, plane = self.disk_kv, "disk"
            nbytes = self.disk_kv.block_nbytes(h)
            if nbytes is None and self.object_kv is not None:
                source, plane = self.object_kv, "objstore"
                nbytes = self.object_kv.block_nbytes(h)
            if nbytes is None:
                if stop_on_miss:
                    break
                continue
            if not self.host_kv.admit_bytes(staged + nbytes):
                break  # destination budget exhausted: reject BEFORE copying
            arr, checksum, corrupt = source.read(h, expected_shape=shape, expected_dtype=dtype)
            if corrupt:
                # The file was already dropped by read(); quarantine the
                # chain (descendants + negative cache) and recompute.
                self._record_corruption(plane, h, chain=seq_hashes)
                kv_integrity_metrics.recomputed_total += 1
                if stop_on_miss:
                    break
                continue
            if arr is None:
                if stop_on_miss:
                    break
                continue
            if checksum is not None:
                kv_integrity_metrics.verified_total[plane] += 1
            self.host_kv.put(h, arr, checksum=checksum)
            staged += nbytes
            promoted.append(h)
        if promoted:
            self.disk_kv.promoted_blocks += len(promoted)
            kv_tier_metrics.promoted_blocks_total += len(promoted)
        return promoted

    def _emit_promotions(self, promoted: List[int]) -> None:
        """Tier-tag promoted blocks back to 'host' (unless the device still
        holds them, in which case the router's view never left 'hbm'), then
        flush any demotions the promotion's own evictions caused."""
        self.kv.emit_tiered("host", [h for h in promoted if h not in self.kv._by_hash])
        self._flush_tier_events()

    async def prefetch_hashes(self, seq_hashes: List[int]) -> int:
        """Warm predicted prefixes disk→host ahead of arrivals.  Returns
        blocks promoted; skips hashes already resident in a faster tier."""
        if self.disk_kv is None or self.host_kv is None or not seq_hashes:
            return 0
        want = [h for h in seq_hashes if h not in self.kv._by_hash]
        if not want:
            return 0
        promoted = await asyncio.to_thread(self._promote_blocks, want, False)
        if promoted:
            kv_tier_metrics.prefetched_blocks_total += len(promoted)
        self._emit_promotions(promoted)
        return len(promoted)

    async def persist_hashes(self, seq_hashes: List[int]) -> int:
        """Persist predicted-hot chains into the durable object tier: a
        chain persisted here survives this worker's death and warm-starts
        its scale-from-zero replacement.  Sources the host tier first
        (carried offload stamp), then the disk tier (validated read);
        device-only blocks are skipped — the write-behind pump lands them
        in host within a cycle.  Returns objects stored."""
        if self.object_kv is None or not seq_hashes:
            return 0
        stored = await asyncio.to_thread(self._persist_blocks, seq_hashes)
        self._flush_tier_events()
        return stored

    def _persist_blocks(self, seq_hashes: List[int]) -> int:
        stored = 0
        for h in seq_hashes:
            if self.integrity.banned(h) or self.object_kv.contains(h):
                continue
            blk = self.host_kv.peek(h) if self.host_kv is not None else None
            if blk is not None:
                if self.object_kv.put(h, blk, checksum=self.host_kv.checksum(h)):
                    stored += 1
                continue
            if self.disk_kv is None or not self.disk_kv.contains(h):
                continue
            arr, checksum, corrupt = self.disk_kv.read(h)
            if corrupt:
                self._record_corruption("disk", h, chain=list(seq_hashes))
                continue
            if arr is not None and self.object_kv.put(h, arr, checksum=checksum):
                stored += 1
        return stored

    # ------------------------------------------------------------- restore
    async def restore_prefix(self, token_ids: List[int], salt: Optional[str] = None) -> int:
        """Public tier restore: bring ``token_ids``'s leading blocks back
        onto the device from the host/disk/object tiers if any are resident
        there.  Returns restored blocks."""
        if self.host_kv is None or not self._tiers_hold_blocks():
            return 0
        return await self._restore_from_host(token_ids, salt)

    def _tiers_hold_blocks(self) -> bool:
        return bool(
            len(self.host_kv)
            or (self.disk_kv is not None and len(self.disk_kv))
            or (self.object_kv is not None and len(self.object_kv))
        )

    async def _restore_from_host(self, token_ids: List[int], salt: Optional[str] = None) -> int:
        """Scatter tier blocks beyond the device-resident prefix back into
        the paged cache (sealed and released to the reuse pool), so
        admission sees them as ordinary prefix-cache hits.  Iterates
        promote→restore rounds until no progress: a prefix deeper than the
        host tier's budget still restores fully, one host budget a round
        (disk → host → device).  ``salt``: the tiers index blocks by the
        salted hashes they sealed under."""
        total = 0
        while True:
            n = await self._restore_pass(token_ids, salt)
            if n <= 0:
                return total
            total += n
            if self.disk_kv is None:
                return total  # one pass covers the whole host-resident run

    async def _restore_pass(self, token_ids: List[int], salt: Optional[str] = None) -> int:
        """One promote→restore round of ``_restore_from_host``."""
        if self.host_kv is None:
            return 0
        t0 = time.perf_counter()
        blocks = hash_token_blocks(token_ids, self.cfg.block_size, salt)
        resident = len(self.kv.match_prefix(blocks))
        if self.disk_kv is not None and (
            len(self.disk_kv) or (self.object_kv is not None and len(self.object_kv))
        ):
            # Promote the leading disk/object-resident run into the host
            # tier first, so the host→device scatter below sees one
            # contiguous restorable prefix.
            promoted = await asyncio.to_thread(
                self._promote_blocks, [tb.sequence_hash for tb in blocks[resident:]], True
            )
            self._emit_promotions(promoted)
        chain = [tb.sequence_hash for tb in blocks]
        # Candidates: the leading host-resident run, peeked (no LRU touch:
        # the run may be truncated below).  The host→device boundary
        # verifies each offload stamp before the scatter (host RAM rots
        # too, and the block may have round-tripped disk).  The candidates
        # are uploaded first and their copies checked (ops/crc32.py: the
        # kernel on CUDA, zlib on the CPU), so the check covers the copy and
        # a restore never waits on the host's cores; the verified prefix
        # scatters from the same buffer.
        cands: List[Tuple[Any, torch.Tensor, Optional[int]]] = []
        for tb in blocks[resident:]:
            if self.integrity.banned(tb.sequence_hash):
                kv_integrity_metrics.negative_cache_hits_total += 1
                break  # recently corrupt: a miss; the tail recomputes
            host = self.host_kv.peek(tb.sequence_hash)
            if host is None:
                break
            stamp = self.host_kv.checksum(tb.sequence_hash)
            flipped = stamp is not None and faults.enabled and faults.should("kv_corrupt", "host")
            if flipped:
                # Chaos hook gated on a present stamp; verification stops
                # the run at the flipped block.
                host = flip_array_byte(host)
            cands.append((tb, host, stamp))
            if flipped:
                break
        if not cands:
            return 0
        t1 = time.perf_counter()
        staged, upload = await asyncio.to_thread(self._restore_upload,
                                                 [host for _, host, _ in cands])
        t2 = time.perf_counter()
        rows = [i for i, (_, _, stamp) in enumerate(cands) if stamp is not None]
        sums = iter(await asyncio.to_thread(self._restore_verify, staged, rows) if rows else ())
        t3 = time.perf_counter()
        run: List[Tuple[Any, torch.Tensor]] = []
        for tb, host, stamp in cands:
            if stamp is not None:
                if next(sums) != stamp:
                    self._record_corruption("host", tb.sequence_hash, chain=chain)
                    self._flush_tier_events()
                    kv_integrity_metrics.recomputed_total += 1
                    break  # the verified prefix still restores below
                kv_integrity_metrics.verified_total["host"] += 1
            run.append((tb, host))
        run = run[: max(0, self.kv.free_blocks - 1)]
        if not run:
            return 0
        # PIN the resident prefix (take references) while allocating the
        # tail: the prefix blocks sit in the reuse pool and are otherwise
        # legitimate LRU victims of our own allocations — which would turn
        # recompute-the-tail into recompute-everything.
        prefix_ids: List[int] = (self.kv.acquire_prefix(blocks[:resident]) or []) if resident else []
        try:
            ids: List[int] = []
            for _ in run:
                bid = self.kv.allocate_block()
                if bid is None:
                    break
                ids.append(bid)
            run = run[: len(ids)]
            if not run:
                self.kv.free_sequence(ids)
                return 0
            n = len(run)
            buf, done = staged
            t4 = time.perf_counter()
            try:
                async with self._device_lock:
                    t5 = time.perf_counter()
                    if self.shard is not None and self._whole_blocks:
                        # One node: the ids alone cross the step plane, and
                        # each rank takes its heads of the verified whole
                        # blocks from the leader's device; a block that
                        # failed its stamp reaches none.
                        await self._publish("restore_blocks", (ids,))
                        t6 = time.perf_counter()
                        await asyncio.to_thread(self._restore_node, ids, (buf[:n], done))
                    else:
                        await self._publish("restore_host",
                                            (ids, [tb.sequence_hash for tb, _ in run]))
                        t6 = time.perf_counter()
                        await asyncio.to_thread(self._restore_scatter, ids, (buf[:n], done))
            except Exception:
                self.kv.free_sequence(ids)  # unsealed: back to the free list
                raise
            t7 = time.perf_counter()
            self.transfer_parts.append(("restore", n, dict(
                promote=t1 - t0, upload=t2 - t1, **upload, verify=t3 - t2, select=t4 - t3,
                lock_wait=t5 - t4, publish=t6 - t5, scatter=t7 - t6)))
            # Candidate selection peeked; refresh recency for the blocks
            # restored.  touch(), not get(): this runs on the event loop and
            # must never wait behind a thread holding the lock through a
            # disk write.
            for tb, _ in run:
                self.host_kv.touch(tb.sequence_hash)
            for bid, (tb, _) in zip(ids, run):
                self.kv.seal_block(bid, tb)
            self.kv.free_sequence(ids)
            self.host_kv.restored_blocks += n
            kv_tier_metrics.restored_blocks_total += n
            return n
        finally:
            if prefix_ids:
                self.kv.free_sequence(prefix_ids)

    def _restore_upload(self, blocks: List[torch.Tensor]
                        ) -> Tuple[Tuple[torch.Tensor, Any], Dict[str, float]]:
        """Copy host blocks into one fresh device buffer ``[n, L, ps, 2KV,
        D]``: on CUDA on the copy stream, with the copy's event (the pages
        are not touched, so no lock is needed).  Returns ``((buffer,
        event), parts)``: the host wall in seconds of the wait for
        ``_copy_lock`` (``upload_lock_wait``), the buffer's allocation
        (``upload_alloc``) and the copies' enqueue (``upload_enqueue``),
        and ``unpinned``, the source blocks not in pinned memory (a
        pageable source turns an asynchronous copy into a synchronous one).

        The copies are enqueued in one call: a loop of ``copy_`` calls
        gives up and takes back the GIL once a block, and each take waits
        out the interpreter's switch interval whenever another thread runs
        Python, which once turned phase g's 128 enqueues (~1 ms) into
        122 ms."""
        unpinned = sum(not b.is_pinned() for b in blocks) if self.device.type == "cuda" else 0
        with torch.inference_mode():
            t0 = time.perf_counter()
            if self.device.type != "cuda":
                with self._copy_lock:
                    t1 = time.perf_counter()
                    buf = torch.stack(blocks)
                    t2 = t3 = time.perf_counter()
                    self.h2d_bytes += buf.nbytes
                done = None
            else:
                stream = self._copy_stream
                # Two requests may restore at once: the lock keeps the copy
                # accounting whole.
                with self._copy_lock, torch.cuda.stream(stream):
                    t1 = time.perf_counter()
                    span = self.h2d_spans.start()
                    buf = torch.empty((len(blocks), *blocks[0].shape), dtype=blocks[0].dtype,
                                      device=self.device)
                    t2 = time.perf_counter()
                    torch._foreach_copy_(list(buf.unbind(0)), blocks, non_blocking=True)
                    t3 = time.perf_counter()
                    self.h2d_spans.stop(span)
                    done = torch.cuda.Event()
                    done.record(stream)
                    self.h2d_bytes += buf.nbytes
        return (buf, done), {"upload_lock_wait": t1 - t0, "upload_alloc": t2 - t1,
                             "upload_enqueue": t3 - t2, "unpinned": unpinned}

    def _restore_verify(self, staged: Tuple[torch.Tensor, Any], rows: List[int]) -> List[int]:
        """CRC-32 of the uploaded blocks ``rows`` (ops/crc32.py).  On CUDA
        the kernel runs on the copy stream behind the upload and its [n]
        results come back through pinned memory: the wait is on that
        stream's event, never on the replay stream."""
        buf, _ = staged
        with torch.inference_mode():
            if self.device.type != "cuda":
                sel = buf if len(rows) == buf.shape[0] else buf[rows]
                return block_crc32(sel, self._crc_pool).tolist()
            stream = self._copy_stream
            with torch.cuda.stream(stream):
                sums = block_crc32(buf)
                host = torch.empty(sums.shape, dtype=sums.dtype, pin_memory=True)
                host.copy_(sums, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(stream)
            ready.synchronize()
            got = host.tolist()
            return [got[i] for i in rows]

    def _restore_scatter(self, ids: List[int], staged: Tuple[torch.Tensor, Any]) -> None:
        """Scatter the uploaded blocks into pages ``ids`` in place, on the
        replay stream behind the upload's event (under the device lock)."""
        buf, done = staged
        with torch.inference_mode():
            if done is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(done)
                buf.record_stream(stream)
            as_bits(self.cache.pages).index_copy_(1, self._page_index(ids),
                                                  as_bits(buf.transpose(0, 1)))

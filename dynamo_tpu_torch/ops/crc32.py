"""CRC-32 (zlib's) of equal-size KV blocks: ``csrc/crc32_blocks.cu`` on the
card, zlib on the host.

The host tier verifies each block's offload stamp before the block serves
again (engine/offload.py ``_restore_pass``).  On CUDA the candidates are
uploaded first and their copies checked by the kernel; CPU tensors take
the plain version, zlib over each block's bytes (the JAX package's check,
``dynamo_tpu/engine/offload.py:422``).  The integers are the same either
way: CRC-32 with the reflected polynomial 0xEDB88320, initial value and
final xor 0xFFFFFFFF, over a block's raw bytes.

The kernel streams TILE-byte tiles of the blocks through shared memory;
in a tile, thread t hashes the SUB bytes at t * SUB from a zero register
with the four slicing-by-4 ``tables``.  A thread carries its register
across consecutive full tiles of a block by Horner's rule (a
multiplication by ``tile_step``'s x^(8 * TILE)) and moves the run's
register to the block's end by multiplying with x^(8 * bytes after the
run's last slice) mod P: ``chunk_shifts`` gives those factors, one a
slice, and ``init_term`` the initial value's contribution, all computed
here in zlib's arithmetic (``multmodp``).  ``tiles_of`` is the split of
the tiles over the kernel's CTAs.  The host decides the whole plan and
passes it to each launch; the kernel computes none of it.
"""

from __future__ import annotations

import ctypes
import functools
import zlib
from concurrent.futures import Executor
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import _build

SUB = 64  # bytes a CUDA thread hashes in a tile (csrc/crc32_blocks.cu SUB)
TILE = 512 * SUB  # bytes of a tile: one slice for each of a CTA's 512 threads
POLY = 0xEDB88320
ONE = 1 << 31  # x^0: bit 31 holds the lowest power in the reflected form


def multmodp(a: int, b: int) -> int:
    """a(x) * b(x) mod P in the reflected form (zlib's ``multmodp``)."""
    p = 0
    for i in range(32):
        if a & (ONE >> i):
            p ^= b
        b = (b >> 1) ^ POLY if b & 1 else b >> 1
    return p


@functools.lru_cache(maxsize=None)
def x8n(n: int) -> int:
    """x^(8n) mod P (zlib's ``x2nmodp(n, 3)``)."""
    p, sq = ONE, multmodp(ONE >> 1, ONE >> 1)  # x^2
    sq = multmodp(sq, sq)  # x^4
    sq = multmodp(sq, sq)  # x^8
    while n:
        if n & 1:
            p = multmodp(sq, p)
        n >>= 1
        sq = multmodp(sq, sq)
    return p


@functools.lru_cache(maxsize=None)
def chunk_shifts(block_bytes: int) -> np.ndarray:
    """[ceil(block_bytes / SUB)] uint32: slice i's factor x^(8 * (bytes
    of the block after slice i)) mod P."""
    k = -(-block_bytes // SUB)
    out = np.empty(k, np.uint32)
    out[k - 1] = ONE
    if k > 1:
        step = x8n(SUB)
        s = x8n(block_bytes - (k - 1) * SUB)  # the last slice's length
        for i in range(k - 2, -1, -1):
            out[i] = s
            s = multmodp(step, s)
    return out


@functools.lru_cache(maxsize=None)
def tables() -> np.ndarray:
    """[4, 256] uint32: the slicing-by-4 tables.  Table 0 is the bytewise
    table; table k carries table k-1's entry through one more zero
    byte."""
    t = np.zeros((4, 256), np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ POLY if c & 1 else c >> 1
        t[0, i] = c
    for k in range(1, 4):
        for i in range(256):
            c = int(t[k - 1, i])
            t[k, i] = (c >> 8) ^ int(t[0, c & 0xFF])
    return t


@functools.lru_cache(maxsize=None)
def tile_step() -> Tuple[int, ...]:
    """Bit j's column of the multiplication by x^(8 * TILE) mod P, j =
    0..31: the kernel's Horner step, passed to each launch."""
    c = x8n(TILE)
    return tuple(multmodp(1 << j, c) for j in range(32))


def tiles_of(n_blocks: int, block_bytes: int, ctas: int,
             tile: int = TILE) -> Tuple[int, int, int]:
    """The kernel's split, passed to each launch: (tiles a block, tiles a
    CTA, CTAs launched) for ``ctas`` streaming multiprocessors, each CTA a
    contiguous range of the tiles.  ``tile`` other than TILE only replays
    the plan at a small size (tests/test_torch_crc32.py)."""
    per_block = -(-block_bytes // tile)
    tiles = per_block * n_blocks
    grid = min(tiles, ctas)
    return per_block, -(-tiles // grid), grid


def init_term(block_bytes: int) -> int:
    """The initial value 0xFFFFFFFF carried through ``block_bytes`` bytes:
    zlib's CRC = ~(raw register from zero ^ this)."""
    return multmodp(x8n(block_bytes), 0xFFFFFFFF)


def block_crc32_plain(blocks: torch.Tensor, executor: Optional[Executor] = None) -> torch.Tensor:
    """[n] int64: zlib's CRC-32 of each ``blocks[i]``'s bytes (a CPU
    tensor, any dtype, never cast), over ``executor``'s threads when given
    (zlib releases the GIL)."""
    raw = blocks.contiguous().reshape(blocks.shape[0], -1).view(torch.uint8).numpy()

    def one(i: int) -> int:
        return zlib.crc32(raw[i]) & 0xFFFFFFFF

    n = raw.shape[0]
    if executor is None or n <= 1:
        return torch.tensor([one(i) for i in range(n)], dtype=torch.int64)
    return torch.tensor(list(executor.map(one, range(n))), dtype=torch.int64)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("crc32_blocks")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    ll = ctypes.c_longlong
    lib.crc32_blocks_launch.argtypes = [vp, ll, ci, vp, vp, ctypes.POINTER(ctypes.c_uint32), ll,
                                        ll, ci, vp, ci, vp]
    lib.crc32_blocks_launch.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def _step_words() -> ctypes.Array:
    return (ctypes.c_uint32 * 32)(*tile_step())


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_consts: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _consts_on(dev: torch.device, block_bytes: int) -> torch.Tensor:
    """The tables (1024 words) then the slices' shifts, on ``dev``."""
    key = (dev, block_bytes)
    t = _consts.get(key)
    if t is None:
        host = np.concatenate([tables().reshape(-1), chunk_shifts(block_bytes)])
        t = torch.from_numpy(host.view(np.int32)).to(dev)
        # Once per block size: the copy lands before any stream reads it.
        torch.cuda.current_stream(dev).synchronize()
        _consts[key] = t
    return t


def block_crc32_cuda(blocks: torch.Tensor) -> torch.Tensor:
    """Launch csrc/crc32_blocks.cu on the current stream (no sync): [n]
    int64 CRCs of ``blocks[i]``'s bytes, on the device."""
    dev = blocks.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {dev}")
    if not blocks.is_contiguous():
        raise ValueError("kernel input must be contiguous")
    n = blocks.shape[0]
    if n == 0:
        return torch.empty((0,), dtype=torch.int64, device=dev)
    nbytes = blocks[0].numel() * blocks.element_size()
    if nbytes == 0:
        raise ValueError("blocks of zero bytes")
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    consts = _consts_on(dev, nbytes)
    aligned16 = int(blocks.data_ptr() % 16 == 0 and nbytes % 16 == 0)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    per_block, per_cta, grid = tiles_of(n, nbytes, _sms(index))
    lib = _lib()
    p = _build.ptr
    code = lib.crc32_blocks_launch(p(blocks), nbytes, n, p(consts), p(consts[1024:]),
                                   _step_words(), per_block, per_cta, grid, p(out), aligned16,
                                   _build.stream_ptr(dev))
    _build.check(lib, code, "crc32_blocks")
    block_crc32_cuda.launches += 1
    return (out.to(torch.int64) & 0xFFFFFFFF) ^ (init_term(nbytes) ^ 0xFFFFFFFF)


block_crc32_cuda.launches = 0  # kernel launches (chip_smoke.py reads it)


def block_crc32(blocks: torch.Tensor, executor: Optional[Executor] = None) -> torch.Tensor:
    """[n] int64 CRC-32 of each block's bytes, zlib's integers.  Routes by
    device: CUDA tensors launch the kernel (or raise), CPU tensors take the
    plain version.  No fallback."""
    if blocks.device.type == "cuda":
        return block_crc32_cuda(blocks)
    if blocks.device.type == "cpu":
        return block_crc32_plain(blocks, executor)
    raise ValueError(f"no CRC-32 path for device {blocks.device}")

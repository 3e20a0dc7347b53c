"""The KV blocks' CRC-32 (ops/crc32.py) on the CPU: the plain version
against the JAX package's ``block_checksum``, and the kernel's plan
(csrc/crc32_blocks.cu: TILE-byte tiles split over the CTAs in contiguous
ranges; in a tile, slicing-by-4 over each thread's SUB-byte slice from a
zero register; Horner's rule across a run of full tiles with
``tile_step``; each run moved to the block's end by ``chunk_shifts``;
then ``init_term`` and the final xor) replayed in Python against zlib on
every geometry the kernel takes.  The launch takes its split
(``tiles_of``), its Horner step (``tile_step``), its tables and its
shifts from ops/crc32.py, the functions replayed here.  The kernel itself runs in
tests/test_torch_kernels_cuda.py on a card."""

import random
import zlib

import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.integrity import block_checksum as jax_block_checksum
from dynamo_tpu_torch.engine.integrity import block_checksums
from dynamo_tpu_torch.ops import crc32

pytestmark = pytest.mark.torch_port

POLY = 0xEDB88320
T = [[int(x) for x in row] for row in crc32.tables()]
THREADS = crc32.TILE // crc32.SUB


def _slice_register(data: bytes) -> int:
    """A thread's slice from a zero register: slicing by 4, then bytes."""
    c = 0
    n4 = len(data) // 4 * 4
    for o in range(0, n4, 4):
        c ^= int.from_bytes(data[o:o + 4], "little")
        c = T[3][c & 0xFF] ^ T[2][(c >> 8) & 0xFF] ^ T[1][(c >> 16) & 0xFF] ^ T[0][c >> 24]
    for b in data[n4:]:
        c = T[0][(c ^ b) & 0xFF] ^ (c >> 8)
    return c


def _mult_step(r: int) -> int:
    p = 0
    for j, m in enumerate(crc32.tile_step()):
        if r >> j & 1:
            p ^= m
    return p


def kernel_plan(buf: bytes, n: int, ctas: int, tile: int = crc32.TILE) -> list:
    """csrc/crc32_blocks.cu's plan for ``n`` blocks of ``buf`` on ``ctas``
    streaming multiprocessors, in Python: zlib's CRC of each block.
    ``tile`` shrinks the tiles (and the threads a tile) to replay more
    tiles a block at a small size."""
    nb = len(buf) // n
    sub = crc32.SUB
    threads = tile // sub
    shifts = [int(x) for x in crc32.chunk_shifts(nb)]
    step = crc32.x8n(tile)
    per_block, per_cta, grid = crc32.tiles_of(n, nb, ctas, tile)  # the launch's split
    tiles = per_block * n
    out = [0] * n

    def moved(k, t, r):
        s = k * threads + t
        return crc32.multmodp(shifts[s], r) if s < len(shifts) else 0

    for cta in range(grid):
        first, last = cta * per_cta, min(tiles, (cta + 1) * per_cta)
        acc, bacc, run_k = [0] * threads, [0] * threads, [-1] * threads
        cur_b = -1

        def flush(b):
            for t in range(threads):
                if run_k[t] >= 0:
                    bacc[t] ^= moved(run_k[t], t, acc[t])
                run_k[t] = -1
                out[b] ^= bacc[t]
                bacc[t] = 0

        for g in range(first, last):
            b, k = divmod(g, per_block)
            blk = buf[b * nb:(b + 1) * nb]
            length = min(tile, nb - k * tile)
            if b != cur_b:
                if cur_b >= 0:
                    flush(cur_b)
                cur_b = b
            for t in range(threads):
                lo = k * tile + t * sub
                r = _slice_register(blk[lo:lo + max(0, min(sub, length - t * sub))])
                if length == tile:
                    if run_k[t] >= 0:
                        # Horner's rule: x^(8 * tile) is tile_step's at TILE.
                        acc[t] = (_mult_step(acc[t]) if tile == crc32.TILE
                                  else crc32.multmodp(step, acc[t])) ^ r
                    else:
                        acc[t] = r
                    run_k[t] = k
                else:
                    if run_k[t] >= 0:
                        bacc[t] ^= moved(run_k[t], t, acc[t])
                    run_k[t] = -1
                    bacc[t] ^= moved(k, t, r)
        if cur_b >= 0:
            flush(cur_b)
    return [(~(raw ^ crc32.init_term(nb))) & 0xFFFFFFFF for raw in out]


def kernel_arithmetic(data: bytes, aligned8: bool) -> int:
    """csrc/crc32_blocks.cu's arithmetic for one block, in Python (the
    byte-wise load path when not ``aligned8``; the plan is the same)."""
    return kernel_plan(data, 1, 1 if aligned8 else 3)[0]


@pytest.mark.parametrize("nbytes", [1, 7, 8, 1023, 1024, 1025, 2048, 3001, 4100, 9000])
@pytest.mark.parametrize("aligned8", [True, False])
def test_kernel_arithmetic_equals_zlib(nbytes, aligned8):
    rng = random.Random(nbytes)
    data = bytes(rng.randrange(256) for _ in range(nbytes))
    assert kernel_arithmetic(data, aligned8) == zlib.crc32(data)


# (blocks, bytes a block, CTAs, tile): the geometries the kernel takes.
PLANS = {
    "one byte": (2, 1, 132, crc32.TILE),
    "unaligned short blocks": (3, 2053, 132, crc32.TILE),
    "a tail shorter than a tile": (5, 4100, 132, crc32.TILE),
    "one full tile": (2, crc32.TILE, 132, crc32.TILE),
    "full tiles and a short tail": (3, 2 * crc32.TILE + 4112, 2, crc32.TILE),
    "runs split over CTAs": (4, 8 * 512 + 48, 5, 512),
    "one CTA, many blocks": (6, 4 * 512, 1, 512),
    "aligned, odd split": (7, 3 * 512, 4, 512),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_tile_plan_equals_zlib_at_every_geometry(case):
    """The kernel's tile, slice and shift plan on random bytes: each
    block's integer is zlib's, whatever the split of the tiles over the
    CTAs (runs broken mid-block, a CTA spanning blocks, short tails)."""
    n, nb, ctas, tile = PLANS[case]
    rng = np.random.default_rng(nb)
    buf = rng.integers(0, 256, n * nb, dtype=np.uint8).tobytes()
    want = [zlib.crc32(buf[i * nb:(i + 1) * nb]) for i in range(n)]
    assert kernel_plan(buf, n, ctas, tile) == want


def test_tiles_of_matches_the_launch():
    """``tiles_of``, the split each launch is given (and ``kernel_plan``
    replays): a 128-block llama-3.1-8b prefix on 132 SMs is 64 tiles a
    block, 63 a CTA, 131 CTAs doing work (the last two tiles short)."""
    assert crc32.tiles_of(128, 2 << 20, 132) == (64, 63, 132)
    assert -(-128 * 64 // 63) == 131
    assert crc32.tiles_of(3, 2053, 132) == (1, 1, 3)


def test_tables_and_tile_step():
    """Table 0 is zlib's bytewise table, table k steps one more zero
    byte, and ``tile_step`` multiplies by x^(8 * TILE)."""
    assert T[0][1] == 0x77073096 and T[0][255] == 0x2D02EF8D
    for k in range(1, 4):
        for i in (0, 1, 77, 255):
            c = T[k - 1][i]
            assert T[k][i] == (c >> 8) ^ T[0][c & 0xFF]
    r = 0x12345678
    c = r
    for _ in range(crc32.TILE):
        c = T[0][c & 0xFF] ^ (c >> 8)
    assert _mult_step(r) == c


def test_chunk_shifts_move_a_register_to_the_block_end():
    """Each factor equals x^(8 * bytes after the slice): a register moved
    byte by byte through that many zero bytes lands on the same value."""
    nb = 3 * crc32.SUB + crc32.SUB // 2 + 3
    shifts = crc32.chunk_shifts(nb)
    assert len(shifts) == 4 and int(shifts[-1]) == crc32.ONE
    reg = 0x12345678
    for ch, s in enumerate(shifts):
        c = reg
        for _ in range(nb - min((ch + 1) * crc32.SUB, nb)):
            c = T[0][c & 0xFF] ^ (c >> 8)
        assert crc32.multmodp(int(s), reg) == c


@pytest.mark.parametrize("dtype,np_dtype", [
    (torch.float32, np.float32), (torch.bfloat16, ml_dtypes.bfloat16),
    (torch.int8, np.int8), (torch.float8_e4m3fn, ml_dtypes.float8_e4m3fn)])
def test_plain_version_equals_the_jax_checksum(dtype, np_dtype):
    """The plain version, the port's ``block_checksums`` and the JAX
    package's ``block_checksum`` give the same integers for the same
    block bytes, any page dtype."""
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 256, (4, 2, 4, 4, 8 * np.dtype(np_dtype).itemsize), dtype=np.uint8)
    blocks = torch.from_numpy(bits.copy()).view(dtype)
    want = [jax_block_checksum(bits[i].view(np_dtype)) for i in range(4)]
    assert crc32.block_crc32_plain(blocks).tolist() == want
    assert crc32.block_crc32(blocks).tolist() == want
    assert block_checksums(list(blocks)) == want


def test_wrapper_routes_by_device():
    blocks = torch.zeros((2, 3), dtype=torch.float32)
    assert crc32.block_crc32(blocks).tolist() == [zlib.crc32(bytes(12))] * 2
    with pytest.raises(ValueError, match="CUDA kernel given"):
        crc32.block_crc32_cuda(blocks)
    with pytest.raises(ValueError, match="no CRC-32 path"):
        crc32.block_crc32(torch.zeros((2, 3), device="meta"))

"""The KV blocks' CRC-32 (ops/crc32.py) on the CPU: the plain version
against the JAX package's ``block_checksum``, and the kernel's arithmetic
(csrc/crc32_blocks.cu: slicing-by-8 over CHUNK-byte slices from a zero
register, each moved to the block's end by ``chunk_shifts``, xored, then
``init_term`` and the final xor) replayed in Python against zlib.  The
kernel itself runs in tests/test_torch_kernels_cuda.py on a card."""

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


def _tables():
    t = [[0] * 256 for _ in range(8)]
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ POLY if c & 1 else c >> 1
        t[0][i] = c
    for i in range(256):
        c = t[0][i]
        for k in range(1, 8):
            c = (c >> 8) ^ t[0][c & 0xFF]
            t[k][i] = c
    return t


T = _tables()


def kernel_arithmetic(data: bytes, aligned8: bool) -> int:
    """csrc/crc32_blocks.cu's arithmetic for one block, in Python."""
    nb = len(data)
    shifts = crc32.chunk_shifts(nb)
    acc = 0
    for ch in range(len(shifts)):
        pos, end = ch * crc32.CHUNK, min((ch + 1) * crc32.CHUNK, nb)
        c = 0
        if aligned8:
            for j in range((end - pos) // 8):
                v = int.from_bytes(data[pos + 8 * j:pos + 8 * j + 8], "little")
                lo, hi = (v & 0xFFFFFFFF) ^ c, v >> 32
                c = (T[7][lo & 0xFF] ^ T[6][(lo >> 8) & 0xFF] ^ T[5][(lo >> 16) & 0xFF]
                     ^ T[4][lo >> 24] ^ T[3][hi & 0xFF] ^ T[2][(hi >> 8) & 0xFF]
                     ^ T[1][(hi >> 16) & 0xFF] ^ T[0][hi >> 24])
            pos += (end - pos) // 8 * 8
        for b in data[pos:end]:
            c = T[0][(c ^ b) & 0xFF] ^ (c >> 8)
        acc ^= crc32.multmodp(int(shifts[ch]), c)
    return (~(acc ^ crc32.init_term(nb))) & 0xFFFFFFFF


@pytest.mark.parametrize("nbytes", [1, 7, 8, 1023, 1024, 1025, 2048, 3001, 4100, 9000])
@pytest.mark.parametrize("aligned8", [True, False])
def test_kernel_arithmetic_equals_zlib(nbytes, aligned8):
    rng = random.Random(nbytes)
    data = bytes(rng.randrange(256) for _ in range(nbytes))
    assert kernel_arithmetic(data, aligned8) == zlib.crc32(data)


def test_chunk_shifts_move_a_register_to_the_block_end():
    """Each factor equals x^(8 * bytes after the slice): a register moved
    byte by byte through that many zero bytes lands on the same value."""
    nb = 3 * crc32.CHUNK + 100
    shifts = crc32.chunk_shifts(nb)
    assert len(shifts) == 4 and int(shifts[-1]) == crc32.ONE
    reg = 0x12345678
    for ch, s in enumerate(shifts):
        c = reg
        for _ in range(nb - min((ch + 1) * crc32.CHUNK, nb)):
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

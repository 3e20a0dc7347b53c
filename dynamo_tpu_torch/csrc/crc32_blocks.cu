// CRC-32 of each of n equal-size blocks of device memory: the integers
// zlib.crc32 gives for the same bytes (reflected polynomial 0xEDB88320,
// initial value and final xor 0xFFFFFFFF).
//
// No TPU kernel is replaced: the JAX package verifies a host-tier block's
// stamp with zlib on the host before the block goes back to the device
// (dynamo_tpu/engine/offload.py:422, _restore_pass).  The port uploads the
// candidate blocks first and checks the copies here, so a restore's
// verification no longer waits on the host's cores (256 MiB for a
// 128-block llama-3.1-8b prefix) and covers the copy itself.  Its plain
// version is zlib over each block on the host (ops/crc32.py
// block_crc32_plain).
//
// Bound on this card: reading the blocks once (the output is 4 bytes a
// block); ~23 integer operations per 8 bytes.
// Design: CRC is linear over GF(2).  Each thread hashes one CHUNK-byte
// slice of a block from a zero register with slicing-by-8 tables in shared
// memory, then moves its register to the block's end by multiplying it with
// x^(8 * bytes after the slice) mod P (``shifts``, one per slice, from the
// host); the slices' registers xor together (a warp shuffle, then one
// atomicXor a CTA into ``out``, zeroed first).  The result is the raw
// register of the block from zero; the wrapper applies the initial value
// and the final xor.  No allocation, no sync.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 1024;  // bytes a thread hashes (ops/crc32.py CHUNK)
constexpr uint32_t POLY = 0xEDB88320u;

// a(x) * b(x) mod P, bit 31 holding x^0 (zlib's multmodp, a bounded loop).
__device__ __forceinline__ uint32_t mult_mod_p(uint32_t a, uint32_t b) {
  uint32_t p = 0u;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (a & (0x80000000u >> i)) p ^= b;
    b = (b & 1u) ? (b >> 1) ^ POLY : (b >> 1);
  }
  return p;
}

__global__ void __launch_bounds__(THREADS)
crc32_blocks_kernel(const uint8_t* __restrict__ data, long long block_bytes,
                    int chunks, const uint32_t* __restrict__ shifts,
                    uint32_t* __restrict__ out, int aligned8) {
  __shared__ uint32_t table[8][256];
  __shared__ uint32_t partial[THREADS / 32];
  for (int i = threadIdx.x; i < 256; i += THREADS) {
    uint32_t c = static_cast<uint32_t>(i);
#pragma unroll
    for (int k = 0; k < 8; ++k) c = (c & 1u) ? (c >> 1) ^ POLY : (c >> 1);
    table[0][i] = c;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 256; i += THREADS) {
    uint32_t c = table[0][i];
    for (int t = 1; t < 8; ++t) {
      c = (c >> 8) ^ table[0][c & 0xffu];
      table[t][i] = c;
    }
  }
  __syncthreads();

  const int chunk = blockIdx.x * THREADS + threadIdx.x;
  const uint8_t* base = data + static_cast<long long>(blockIdx.y) * block_bytes;
  uint32_t acc = 0u;
  if (chunk < chunks) {
    const long long start = static_cast<long long>(chunk) * CHUNK;
    const long long end = start + CHUNK < block_bytes ? start + CHUNK : block_bytes;
    long long pos = start;
    uint32_t c = 0u;
    if (aligned8) {
      const unsigned long long* w = reinterpret_cast<const unsigned long long*>(base + pos);
      const int words = static_cast<int>((end - pos) / 8);
      for (int j = 0; j < words; ++j) {
        const unsigned long long v = __ldg(w + j);
        const uint32_t lo = static_cast<uint32_t>(v) ^ c;
        const uint32_t hi = static_cast<uint32_t>(v >> 32);
        c = table[7][lo & 0xffu] ^ table[6][(lo >> 8) & 0xffu] ^
            table[5][(lo >> 16) & 0xffu] ^ table[4][lo >> 24] ^
            table[3][hi & 0xffu] ^ table[2][(hi >> 8) & 0xffu] ^
            table[1][(hi >> 16) & 0xffu] ^ table[0][hi >> 24];
      }
      pos += static_cast<long long>(words) * 8;
    }
    for (; pos < end; ++pos) c = table[0][(c ^ base[pos]) & 0xffu] ^ (c >> 8);
    acc = mult_mod_p(shifts[chunk], c);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc ^= __shfl_xor_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t r = 0u;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) r ^= partial[w];
    atomicXor(out + blockIdx.y, r);
  }
}

}  // namespace

// ``out`` gets each block's raw register (from zero, no final xor).
// ``aligned8``: ``data`` and ``block_bytes`` are multiples of 8.
extern "C" int crc32_blocks_launch(const void* data, long long block_bytes,
                                   int n_blocks, const void* shifts, void* out,
                                   int aligned8, void* stream) {
  if (block_bytes <= 0 || n_blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks == 0) return 0;
  const long long chunks = (block_bytes + CHUNK - 1) / CHUNK;
  if (n_blocks > 65535 || chunks > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(uint32_t) * n_blocks, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((chunks + THREADS - 1) / THREADS),
                  static_cast<unsigned>(n_blocks));
  crc32_blocks_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const uint8_t*>(data), block_bytes, static_cast<int>(chunks),
      static_cast<const uint32_t*>(shifts), static_cast<uint32_t*>(out), aligned8);
  return static_cast<int>(cudaGetLastError());
}

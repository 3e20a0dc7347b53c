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
// block), beside the INT32 operations and the shared-memory wavefronts
// that the design below needs (chip_smoke.py counts them).
//
// Design (Hopper, sm_90a).  CRC is linear over GF(2): a block's register
// is the xor of each slice's register from zero, moved to the block's end
// by a multiplication with x^(8 * bytes after the slice) mod P.
//
// - One persistent CTA a streaming multiprocessor (512 threads, 224 KiB of
//   shared memory) takes a contiguous range of TILE-byte tiles of the
//   blocks.  A tile reaches shared memory through a cp.async ring of
//   STAGES tiles, 16 bytes a thread an instruction: a warp reads 512
//   contiguous bytes at once.
// - In a tile, thread t hashes the contiguous SUB bytes at t * SUB from a
//   zero register, slicing by 4 (a byte's table address is one PRMT and
//   one LEA).  Its four 16-byte units are stored swizzled (unit j at
//   j ^ ((t >> 1) & 3)), so the eight threads of a quarter warp read eight
//   different bank groups, and the ring's writes stay conflict-free.
//   Sixteen warps an SM hide the lookups' latency.
// - The four slicing tables come once from global memory (ops/crc32.py
//   builds them on the host) and are held 32 times over, entry i of lane
//   l's copy in bank l: a warp's 32 random lookups hit 32 banks, one
//   wavefront.
// - Thread t carries its register across consecutive full tiles of one
//   block by Horner's rule, acc = acc * x^(8 * TILE) ^ r, a multiplication
//   by a constant (32 predicated xors of kernel parameters); a run of tiles
//   ends with one multiplication by x^(8 * bytes after its last slice)
//   (``shifts``, one a slice, from the host).  The CTA xors its threads'
//   registers (a warp shuffle, then shared memory) into the block's word
//   with one atomicXor.  The result is the raw register of the block from
//   zero; the wrapper applies the initial value and the final xor.
// - Blocks that are not 16-byte aligned or not a multiple of 16 bytes load
//   their tiles byte by byte into the same layout (the tests' odd sizes;
//   every KV block is aligned).
//
// No allocation, no sync: the launch is a memset and the kernel on the
// caller's stream.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int SUB = 64;               // bytes a thread hashes in a tile (ops/crc32.py SUB)
constexpr int TILE = THREADS * SUB;   // 32 KiB (ops/crc32.py TILE)
constexpr int STAGES = 3;
constexpr int TABLE_WORDS = 4 * 256 * 32;  // four tables, 32 copies each
constexpr size_t SMEM_BYTES =
    static_cast<size_t>(TABLE_WORDS) * 4 + static_cast<size_t>(STAGES) * TILE + (THREADS / 32) * 4;
constexpr uint32_t POLY = 0xEDB88320u;

// Multiplication by x^(8 * TILE) mod P: bit j of a register times that
// constant, for j = 0..31 (the reflected form, bit 31 holds x^0).
struct TileStep {
  uint32_t m[32];
};

// a(x) * b(x) mod P, bit 31 holding x^0 (zlib's multmodp), without
// branches.
__device__ __forceinline__ uint32_t mult_mod_p(uint32_t a, uint32_t b) {
  uint32_t p = 0u;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    p ^= b & static_cast<uint32_t>(static_cast<int32_t>(a) >> 31);
    a <<= 1;
    b = (b >> 1) ^ (POLY & (0u - (b & 1u)));
  }
  return p;
}

__device__ __forceinline__ uint32_t mult_step(uint32_t r, const TileStep& s) {
  uint32_t p = 0u;
#pragma unroll
  for (int j = 0; j < 32; ++j) p ^= (r & (1u << j)) ? s.m[j] : 0u;
  return p;
}

// Tile k of block b; both advance by one a tile, so the loop divides
// nothing.
struct Pos {
  long long b, k;
  __device__ __forceinline__ void next(int per_block) {
    if (++k == per_block) {
      k = 0;
      ++b;
    }
  }
};

// The byte at logical offset g of a tile, in shared memory: thread
// (g / SUB)'s unit j = (g / 16) % 4 sits at unit j ^ ((thread >> 1) & 3).
__device__ __forceinline__ int swizzled(int g) {
  return (g & ~(SUB - 1)) | ((((g >> 4) & 3) ^ ((g >> 7) & 3)) << 4) | (g & 15);
}

// Four bytes through the replicated slicing tables (``tab`` is this lane's
// column: entry i of table k at tab[(k * 256 + i) * 32]); each byte is
// pulled out zero-extended by one PRMT.
__device__ __forceinline__ uint32_t step4(uint32_t c, const uint32_t* tab) {
  const uint32_t b0 = __byte_perm(c, 0u, 0x4440);
  const uint32_t b1 = __byte_perm(c, 0u, 0x4441);
  const uint32_t b2 = __byte_perm(c, 0u, 0x4442);
  const uint32_t b3 = c >> 24;
  return tab[(3 * 256 << 5) + (b0 << 5)] ^ tab[(2 * 256 << 5) + (b1 << 5)] ^
         tab[(1 * 256 << 5) + (b2 << 5)] ^ tab[b3 << 5];
}

// The register from zero of thread t's slice of a tile holding ``len``
// bytes.
__device__ __forceinline__ uint32_t hash_slice(const uint8_t* stage, int t, int len,
                                               const uint32_t* tab) {
  const int n = min(SUB, max(0, len - t * SUB));
  uint32_t c = 0u;
  if (n == SUB) {
    const uint4* u = reinterpret_cast<const uint4*>(stage + t * SUB);
#pragma unroll
    for (int j = 0; j < SUB / 16; ++j) {
      const uint4 v = u[j ^ ((t >> 1) & 3)];
      c = step4(c ^ v.x, tab);
      c = step4(c ^ v.y, tab);
      c = step4(c ^ v.z, tab);
      c = step4(c ^ v.w, tab);
    }
    return c;
  }
  const int base = t * SUB;
  int o = 0;
  for (; o + 4 <= n; o += 4) {
    c = step4(c ^ *reinterpret_cast<const uint32_t*>(stage + swizzled(base + o)), tab);
  }
  for (; o < n; ++o) c = tab[((c ^ stage[swizzled(base + o)]) & 0xffu) << 5] ^ (c >> 8);
  return c;
}

__global__ void __launch_bounds__(THREADS, 1)
crc32_blocks_kernel(const uint8_t* __restrict__ data, long long block_bytes, int tiles_per_block,
                    long long tiles, long long tiles_per_cta,
                    const uint32_t* __restrict__ tables, const uint32_t* __restrict__ shifts,
                    int n_slices, uint32_t* __restrict__ out, int aligned16, TileStep step) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* tab_all = reinterpret_cast<uint32_t*>(smem);
  uint8_t* ring = smem + static_cast<size_t>(TABLE_WORDS) * 4;
  uint32_t* partial = reinterpret_cast<uint32_t*>(ring + static_cast<size_t>(STAGES) * TILE);
  const int t = threadIdx.x;
  const int lane = t & 31;

  const long long first = static_cast<long long>(blockIdx.x) * tiles_per_cta;
  const long long last = first + tiles_per_cta < tiles ? first + tiles_per_cta : tiles;
  if (first >= last) return;

  const Pos start{first / tiles_per_block, first % tiles_per_block};

  // A tile's bytes into ring stage ``s`` (cp.async when aligned).
  auto load = [&](const Pos& p, int s) {
    const long long off = p.k * TILE;
    const int len = static_cast<int>(block_bytes - off < TILE ? block_bytes - off : TILE);
    const uint8_t* src = data + p.b * block_bytes + off;
    uint8_t* dst = ring + static_cast<size_t>(s) * TILE;
    if (aligned16) {
      for (int u = t; u < len / 16; u += THREADS) dyn::cp_async16(dst + swizzled(u * 16), src + u * 16);
    } else {
      for (int i = t; i < len; i += THREADS) dst[swizzled(i)] = src[i];
    }
  };

  Pos ahead = start;  // the next tile to load
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (first + s < last) {
      load(ahead, s);
      ahead.next(tiles_per_block);
    }
    dyn::cp_async_commit();
  }
  // The slicing tables, 32 copies: word w holds entry (w / 32) for lane
  // (w % 32).  Read once a CTA, while the ring's first tiles are in
  // flight.
  for (int w = t; w < TABLE_WORDS; w += THREADS) tab_all[w] = __ldg(tables + (w >> 5));
  const uint32_t* tab = tab_all + lane;

  long long cur_b = -1;
  long long run_k = -1;  // the last full tile of the open run (-1: none)
  uint32_t acc = 0u, bacc = 0u;

  auto moved = [&](long long k, uint32_t r) -> uint32_t {
    const long long s = k * THREADS + t;
    return s < n_slices ? mult_mod_p(__ldg(shifts + s), r) : 0u;
  };
  auto flush = [&](long long b) {
    if (run_k >= 0) bacc ^= moved(run_k, acc);
    run_k = -1;
    uint32_t v = bacc;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v ^= __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) partial[t >> 5] = v;
    __syncthreads();
    if (t == 0) {
      uint32_t r = 0u;
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) r ^= partial[w];
      atomicXor(out + b, r);
    }
    __syncthreads();
    bacc = 0u;
  };

  Pos at = start;
  for (long long g = first; g < last; ++g, at.next(tiles_per_block)) {
    const long long i = g - first;
    if (g + STAGES - 1 < last) {
      load(ahead, static_cast<int>((i + STAGES - 1) % STAGES));
      ahead.next(tiles_per_block);
    }
    dyn::cp_async_commit();
    dyn::cp_async_wait<STAGES - 1>();
    __syncthreads();

    const long long rest = block_bytes - at.k * TILE;
    const int len = static_cast<int>(rest < TILE ? rest : TILE);
    const uint32_t r = hash_slice(ring + static_cast<size_t>(i % STAGES) * TILE, t, len, tab);
    if (at.b != cur_b) {
      if (cur_b >= 0) flush(cur_b);
      cur_b = at.b;
    }
    if (len == TILE) {
      acc = run_k >= 0 ? mult_step(acc, step) ^ r : r;
      run_k = at.k;
    } else {  // a block's short last tile: its own run
      if (run_k >= 0) bacc ^= moved(run_k, acc);
      run_k = -1;
      bacc ^= moved(at.k, r);
    }
    __syncthreads();  // the stage is free for the load two tiles ahead
  }
  flush(cur_b);
}

}  // namespace

// ``out`` gets each block's raw register (from zero, no final xor).
// ``tables``: the four slicing-by-4 tables [4][256]; ``shifts``: one
// factor per SUB-byte slice of a block; ``step``: 32 host words, bit j's
// column of the multiplication by x^(8 * TILE); ``per_block``, ``per_cta``
// and ``grid``: the split of the tiles over the CTAs.  The host decides all
// of them (ops/crc32.py tables, chunk_shifts, tile_step, tiles_of); the
// launch only checks that the split covers the tiles.  ``aligned16``:
// ``data`` and ``block_bytes`` are multiples of 16.
extern "C" int crc32_blocks_launch(const void* data, long long block_bytes, int n_blocks,
                                   const void* tables, const void* shifts, const uint32_t* step,
                                   long long per_block, long long per_cta, int grid, void* out,
                                   int aligned16, void* stream) {
  if (block_bytes <= 0 || n_blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks == 0) return 0;
  const long long slices = (block_bytes + SUB - 1) / SUB;
  const long long tiles = per_block * n_blocks;
  if (per_block * TILE < block_bytes || per_block > (1LL << 30) || slices > (1LL << 31) - 1 ||
      grid <= 0 || per_cta <= 0 || static_cast<long long>(grid) * per_cta < tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TileStep s_step;
  for (int j = 0; j < 32; ++j) s_step.m[j] = step[j];
  cudaError_t err = cudaFuncSetAttribute(
      crc32_blocks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(out, 0, sizeof(uint32_t) * n_blocks, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  crc32_blocks_kernel<<<static_cast<unsigned>(grid), THREADS, SMEM_BYTES, s>>>(
      static_cast<const uint8_t*>(data), block_bytes, static_cast<int>(per_block), tiles,
      per_cta, static_cast<const uint32_t*>(tables), static_cast<const uint32_t*>(shifts),
      static_cast<int>(slices), static_cast<uint32_t*>(out), aligned16, s_step);
  return static_cast<int>(cudaGetLastError());
}

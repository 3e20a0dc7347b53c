// Shared device helpers for the paged attention kernels: typed 4-wide loads
// with dequant to f32, warp reductions, cp.async staging of K/V pages,
// ldmatrix / mma.sync wrappers for bf16 tiles, and the log-sum-exp combine
// of split-KV partials.  Header-only; each kernel source includes it once and
// is built into its own shared library (ops/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dyn {

// The kernels are specialised for head_dim 128 (every model the repo
// registers); the Python wrappers refuse other widths.  Each lane of a warp
// owns DPL consecutive values of a head row.
constexpr int HEAD_DIM = 128;
constexpr int DPL = HEAD_DIM / 32;
constexpr float NEG_INF = -1e30f;  // the JAX package's mask value

// dtype codes shared with the Python wrappers (ops/_build.py DTYPE_CODES).
enum DType : int { F32 = 0, BF16 = 1, I8 = 2, FP8E4M3 = 3 };

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]);
  const float2 b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4(static_cast<float>(c.x), static_cast<float>(c.y),
                     static_cast<float>(c.z), static_cast<float>(c.w));
}

__device__ __forceinline__ float4 load4(const __nv_fp8_e4m3* p) {
  const __nv_fp8x4_e4m3 v = *reinterpret_cast<const __nv_fp8x4_e4m3*>(p);
  return static_cast<float4>(v);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(p);
  p2[0] = __floats2bfloat162_rn(v.x, v.y);
  p2[1] = __floats2bfloat162_rn(v.z, v.w);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

__device__ __forceinline__ float4 fma4(float s, float4 v, float4 acc) {
  return make_float4(fmaf(s, v.x, acc.x), fmaf(s, v.y, acc.y),
                     fmaf(s, v.z, acc.z), fmaf(s, v.w, acc.w));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16-byte asynchronous global -> shared copy (cp.async, sm_80+): many can
// be in flight per thread without holding registers.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}

// Wait for every cp.async this thread issued.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Clamped page-table read: padding rows may carry arbitrary tables, so the
// logical page index and the physical page id are both kept in range.
__device__ __forceinline__ int page_of(const int* table, int key, int ps, int PP, int P) {
  const int pid = table[min(key / ps, PP - 1)];
  return min(max(pid, 0), P - 1);
}

// The same copy with zero fill: when ``valid`` is false nothing is read and
// the 16 destination bytes become zeros (a masked key's V row must be 0,
// not stale shared memory, since 0 * NaN poisons p.V).  ``gmem_src`` must
// still be a mapped address.
__device__ __forceinline__ void cp_async16_zfill(void* smem_dst, const void* gmem_src, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem_src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------- mma.sync
// A bf16 tile row of HEAD_DIM values is 256 bytes: 16 chunks of 16 bytes.
// Chunk c of row r lives at chunk c ^ (r & 7), so the 8 rows an ldmatrix
// phase reads at one logical chunk fall in 8 different bank groups.
constexpr int BF16_ROW_BYTES = HEAD_DIM * 2;

__device__ __forceinline__ int swz(int row, int chunk) {
  return row * BF16_ROW_BYTES + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and register i receives matrix i in the mma fragment layout.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// The same, each matrix transposed on the way (for V as the B operand).
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators.
// Lane l holds, with g = l / 4 and c = 2 * (l % 4): a = {(g, c..c+1),
// (g+8, c..), (g, c+8..), (g+8, c+8..)}, b = {(k c..c+1, n g), (k c+8.., n g)},
// d = {(g, c), (g, c+1), (g+8, c), (g+8, c+1)}.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values as one bf16x2 register, ``lo`` in the low half (the lower
// column of an mma fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Eight consecutive page values widened to bf16 (one 16-byte chunk).  Exact
// for int8 and fp8-e4m3 (every such value is a bf16 value); f32 rounds.
__device__ __forceinline__ uint4 widen8(const int8_t* p) {
  const float4 a = load4(p), b = load4(p + 4);
  return make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
}
__device__ __forceinline__ uint4 widen8(const __nv_fp8_e4m3* p) {
  const float4 a = load4(p), b = load4(p + 4);
  return make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
}
__device__ __forceinline__ uint4 widen8(const float* p) {
  const float4 a = load4(p), b = load4(p + 4);
  return make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
}

// Where a staged K/V tile row keeps 16-byte chunk c: bf16 tiles are read by
// ldmatrix in place and are swizzled; other page dtypes are staged raw,
// row-major, and widened into a swizzled bf16 tile (widen_tile).
template <typename PT>
__device__ __forceinline__ int stage_off(int row, int chunk) {
  if constexpr (sizeof(PT) == 2) {
    return swz(row, chunk);
  } else {
    return row * HEAD_DIM * static_cast<int>(sizeof(PT)) + (chunk << 4);
  }
}

// Gather ``NK`` keys k0.. of one KV head (K and V rows) through the page
// table into a stage with 16-byte cp.async copies, spread over ``nthr``
// threads; keys at or past ``kend`` are zero-filled.  The caller commits.
template <typename PT, int NK>
__device__ __forceinline__ void stage_kv(unsigned char* k_st, unsigned char* v_st,
                                         const unsigned char* head_base, const int* table,
                                         int k0, int kend, int ps, int PP, int P,
                                         size_t slot_bytes, int tid, int nthr) {
  constexpr int HB = HEAD_DIM * static_cast<int>(sizeof(PT));
  constexpr int CPR = HB / 16;  // 16-byte chunks a row
  for (int i = tid; i < NK * CPR; i += nthr) {
    const int r = i / CPR, c = i % CPR;
    const int key = k0 + r;
    const bool ok = key < kend;
    const int src_key = ok ? key : k0;  // k0 < kend: a mapped address
    const unsigned char* src =
        head_base + (static_cast<size_t>(page_of(table, src_key, ps, PP, P)) * ps + src_key % ps) * slot_bytes +
        c * 16;
    const int off = stage_off<PT>(r, c);
    cp_async16_zfill(k_st + off, src, ok);
    cp_async16_zfill(v_st + off, src + HB, ok);
  }
}

// A raw stage of NK rows (K or V) widened into a swizzled bf16 tile.
template <typename PT, int NK>
__device__ __forceinline__ void widen_tile(unsigned char* dst, const unsigned char* raw, int tid, int nthr) {
  for (int i = tid; i < NK * 16; i += nthr) {
    const int r = i >> 4, c = i & 15;
    const PT* src = reinterpret_cast<const PT*>(raw) + r * HEAD_DIM + c * 8;
    *reinterpret_cast<uint4*>(dst + swz(r, c)) = widen8(src);
  }
}

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// One warp's FlashAttention step over NT*8 keys k0..: S = Q K^T for its 16
// query rows (Q as 8 A fragments over the 128 dims, K from ldmatrix), keys
// at or past a row's ``lim`` masked when ``need_mask``, the online softmax
// in base 2 on f32 scores scaled by ``sc``, then O += P V with P re-packed
// from the accumulators as bf16 A fragments and V from ldmatrix.trans.  K
// and V are swizzled bf16 rows in shared memory.  A lane holds rows
// g = lane/4 (h = 0) and g + 8 (h = 1): their running max m[h], its share
// l[h] of their sums (the quad's shares add up at the end), and
// o[dt][2h + e] = O at dim dt*8 + 2*(lane%4) + e.
template <int NT>
__device__ __forceinline__ void attend_tile(const uint32_t (&qa)[8][4], const unsigned char* kt,
                                            const unsigned char* vt, int k0, const int (&lim)[2],
                                            bool need_mask, float sc, float (&m)[2], float (&l)[2],
                                            float (&o)[16][4]) {
  const int lane = threadIdx.x & 31, tig = lane & 3;
  float s[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, kt + swz(np * 16 + (lane & 7) + ((lane >> 4) << 3), kk * 2 + ((lane >> 3) & 1)));
      mma_bf16(s[2 * np], qa[kk], b[0], b[1]);
      mma_bf16(s[2 * np + 1], qa[kk], b[2], b[3]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[nt][e] * sc;
      if (need_mask && k0 + nt * 8 + tig * 2 + (e & 1) >= lim[e >> 1]) x = -INFINITY;
      s[nt][e] = x;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));  // a quad shares each row
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m[h], mx);  // finite: m starts at NEG_INF
    const float alpha = exp2f(m[h] - mn);
    m[h] = mn;
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = exp2f(s[nt][2 * h + e] - mn);  // masked: exp2(-inf) = 0
        s[nt][2 * h + e] = p;
        sum += p;
      }
    }
    l[h] = l[h] * alpha + sum;
#pragma unroll
    for (int dt = 0; dt < 16; ++dt) {
      o[dt][2 * h] *= alpha;
      o[dt][2 * h + 1] *= alpha;
    }
  }
#pragma unroll
  for (int kc = 0; kc < NT / 2; ++kc) {
    const uint32_t a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]), pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                           pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                           pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
    for (int dp = 0; dp < 8; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, vt + swz(kc * 16 + (lane & 7) + (((lane >> 3) & 1) << 3), dp * 2 + (lane >> 4)));
      mma_bf16(o[2 * dp], a, b[0], b[1]);
      mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// A warp's private ring over every WARPS-th 16-key tile of keys
// kstart..kend of one KV head: ST stages of 16 raw K and V page rows each
// at ``ring``, and a swizzled bf16 K|V tile at ``wide`` for pages that are
// not bf16.  Copies for the next ST-1 tiles stay in flight while
// ``step(kt, vt, k0)`` consumes the current one.  No block barrier: warps
// run apart.
template <typename PT, int ST, typename Step>
__device__ __forceinline__ void warp_ring_loop(unsigned char* ring, unsigned char* wide,
                                               const unsigned char* head_base, const int* table,
                                               int kstart, int kend, int ps, int PP, int P,
                                               size_t slot_bytes, int warp, int nwarps, Step step) {
  constexpr int NK = 16;
  constexpr int RAW = NK * HEAD_DIM * static_cast<int>(sizeof(PT));
  const int lane = threadIdx.x & 31;
  const int ntiles = (kend - kstart + NK - 1) / NK;
  const int nloc = ntiles > warp ? (ntiles - warp + nwarps - 1) / nwarps : 0;
  auto key0 = [&](int i) { return kstart + (warp + i * nwarps) * NK; };
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < nloc) {
      unsigned char* st = ring + i * 2 * RAW;
      stage_kv<PT, NK>(st, st + RAW, head_base, table, key0(i), kend, ps, PP, P, slot_bytes, lane, 32);
    }
    cp_async_commit();
  }

  for (int i = 0; i < nloc; ++i) {
    cp_async_wait<ST - 2>();  // tile i has landed (this lane's copies)
    __syncwarp();             // ... every lane's; and tile i-1 is consumed
    const int in = i + ST - 1;
    if (in < nloc) {
      unsigned char* st = ring + (in % ST) * 2 * RAW;
      stage_kv<PT, NK>(st, st + RAW, head_base, table, key0(in), kend, ps, PP, P, slot_bytes, lane, 32);
    }
    cp_async_commit();

    const unsigned char* kt = ring + (i % ST) * 2 * RAW;
    const unsigned char* vt = kt + RAW;
    if constexpr (sizeof(PT) != 2) {
      widen_tile<PT, NK>(wide, kt, lane, 32);
      widen_tile<PT, NK>(wide + NK * BF16_ROW_BYTES, vt, lane, 32);
      __syncwarp();
      kt = wide;
      vt = wide + NK * BF16_ROW_BYTES;
    }
    step(kt, vt, key0(i));
  }
  cp_async_wait<0>();
}

// Log-sum-exp combine of unnormalised split partials (o, m, l) into the
// normalised output — the reduction the TPU wrappers ran as XLA ops after
// their kernels.  One warp per (n, h); lane owns DPL values of the row.
// Layout: o [J, N, H, D] f32, m/l [J, N, H] f32 (m in natural-log units),
// out [N, H, D].
//   * Ragged token runs (cu != nullptr, prefill): every row reads all J
//     splits; tokens at or past cu[num_seqs] are written as exact zeros.
//   * Decode rows (cu == nullptr): row n reads only the ceil(kv_len /
//     part_tokens) partitions its context covers.  Rows that need no
//     combine — past num_seqs, kv_len 0, or one partition — were written
//     by the partial kernel and are left alone.
template <typename OutT>
__global__ void __launch_bounds__(32) lse_combine_kernel(
    const float* __restrict__ o_part, const float* __restrict__ m_part,
    const float* __restrict__ l_part, OutT* __restrict__ out,
    const int* __restrict__ cu, const int* __restrict__ num_seqs,
    const int* __restrict__ kv_lens, int part_tokens, int N, int H, int J) {
  const int n = blockIdx.x, h = blockIdx.y, lane = threadIdx.x;
  OutT* dst = out + (static_cast<size_t>(n) * H + h) * HEAD_DIM + lane * DPL;
  int parts = J;
  if (cu != nullptr) {
    if (n >= cu[num_seqs[0]]) {
      store4(dst, make_float4(0.f, 0.f, 0.f, 0.f));
      return;
    }
  } else {
    const int kv_len = kv_lens[n];
    if (n >= num_seqs[0] || kv_len <= part_tokens) return;
    parts = (kv_len + part_tokens - 1) / part_tokens;
  }
  float mmax = NEG_INF;
  for (int j = 0; j < parts; ++j)
    mmax = fmaxf(mmax, m_part[(static_cast<size_t>(j) * N + n) * H + h]);
  float ltot = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < parts; ++j) {
    const size_t idx = (static_cast<size_t>(j) * N + n) * H + h;
    const float a = expf(m_part[idx] - mmax);
    ltot += a * l_part[idx];
    acc = fma4(a, load4(o_part + idx * HEAD_DIM + lane * DPL), acc);
  }
  const float denom = ltot + 1e-30f;
  store4(dst, make_float4(acc.x / denom, acc.y / denom, acc.z / denom, acc.w / denom));
}

}  // namespace dyn

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shared device helpers for the paged attention kernels: typed 4-wide loads
// with dequant to f32, warp reductions, and the log-sum-exp combine of
// split-KV partials.  Header-only; each kernel source includes it once and
// is built into its own shared library (ops/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
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

// Log-sum-exp combine of J unnormalised split partials (o, m, l) into the
// normalised output — the reduction the TPU wrappers ran as XLA ops after
// their kernels.  One warp per (n, h); lane owns DPL values of the row.
// Layout: o [J, N, H, D] f32, m/l [J, N, H] f32, out [N, H, D].  Rows at or
// past the valid limit (cu[num_seqs] for ragged token runs, num_seqs for
// decode rows when cu is null) are written as exact zeros.
template <typename OutT>
__global__ void __launch_bounds__(32) lse_combine_kernel(
    const float* __restrict__ o_part, const float* __restrict__ m_part,
    const float* __restrict__ l_part, OutT* __restrict__ out,
    const int* __restrict__ cu, const int* __restrict__ num_seqs, int N, int H,
    int J) {
  const int n = blockIdx.x, h = blockIdx.y, lane = threadIdx.x;
  const int limit = cu != nullptr ? cu[num_seqs[0]] : num_seqs[0];
  OutT* dst = out + (static_cast<size_t>(n) * H + h) * HEAD_DIM + lane * DPL;
  if (n >= limit) {
    store4(dst, make_float4(0.f, 0.f, 0.f, 0.f));
    return;
  }
  float mmax = NEG_INF;
  for (int j = 0; j < J; ++j)
    mmax = fmaxf(mmax, m_part[(static_cast<size_t>(j) * N + n) * H + h]);
  float ltot = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < J; ++j) {
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

// Paged DECODE attention for Hopper (sm_90a), hand-written CUDA.
//
// Replaces: dynamo_tpu/ops/decode_attention.py::fused_decode_attention (the
// Pallas TPU kernel, body _make_kernel).  Same contract as the JAX XLA path
// ragged_decode_attention: one query token per row at context position
// kv_len - 1, GQA over G = H / KV query heads per KV head, pages
// [P, ps, 2KV, D] with K at even and V at odd combined-head indices,
// int8 / fp8-e4m3 / bf16 / f32 pages dequantized in registers by a scalar
// kv_scale, zeros for rows past num_seqs and rows with kv_len 0.
//
// What bounds it on an H100: bytes.  A decode step reads every live KV
// position once (2 * KV * D values per position) and does ~4 * G flops per
// value read — far below the ~295 flop/byte where bf16 tensor cores become
// the limit.  So the design streams each KV byte from HBM exactly once and
// keeps the work in f32 registers:
//   * flash-decoding: one block per (row, KV head, KV split), the split
//     count chosen by the wrapper so S * KV * J blocks fill the SMs even at
//     small batch (one block per row would leave most SMs idle);
//   * each of the block's 4 warps walks 32-key tiles of its split, gathered
//     through the page table into its own shared-memory stage with
//     coalesced 16-byte cp.async copies, the whole tile's K and V in flight
//     at once (a first version that read K and V straight from global
//     memory, one dependent load at a time, was latency-bound);
//   * from the stage a lane owns one key for q.k and four head-dim values
//     for p.V; dequantization happens in registers;
//   * an online softmax per query head in f32; warps merge through shared
//     memory and write an unnormalised (o, m, l) partial;
//   * a second kernel LSE-combines the J partials (blocks run in no order
//     and share nothing, where the TPU carried its split sums through a
//     sequential grid).
// Each split is masked at split_end = min(kv_len, split coverage end) so no
// position is counted by two splits; page-table reads are clamped because
// padding rows carry arbitrary tables with kv_len 1.
// Later work: TMA page gathers into a shared-memory ring and wgmma for the
// G-row q.K^T once several decode tokens share a row.
#include "common.cuh"

using namespace dyn;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_G = 8;
constexpr int TILE = 32;

// A staged K or V row: the head row plus 16 bytes of padding, so that the
// lanes of a warp reading 32 different rows start in different banks.
template <typename PT>
__host__ __device__ constexpr int row_bytes() { return HEAD_DIM * static_cast<int>(sizeof(PT)) + 16; }

template <typename PT>
__host__ __device__ constexpr size_t smem_bytes() {
  return static_cast<size_t>(WARPS) * 2 * TILE * row_bytes<PT>() +
         sizeof(float) * (MAX_G * HEAD_DIM + WARPS * MAX_G * TILE);
}

template <typename QT, typename PT>
__global__ void __launch_bounds__(THREADS) decode_partial_kernel(
    const QT* __restrict__ q,              // [S, H, D]
    const PT* __restrict__ pages,          // [P, ps, 2KV, D]
    const int* __restrict__ kv_lens,       // [S]
    const int* __restrict__ page_indices,  // [S, PP]
    const int* __restrict__ num_seqs,      // [1]
    float* __restrict__ o_part,            // [J, S, H, D]
    float* __restrict__ m_part,            // [J, S, H]
    float* __restrict__ l_part,            // [J, S, H]
    int S, int KV, int G, int P, int ps, int PP, int split_pages,
    float sm_scale, float kv_scale) {
  constexpr int RB = row_bytes<PT>();
  constexpr int CPR = HEAD_DIM * static_cast<int>(sizeof(PT)) / 16;  // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* stage = smem;  // [WARPS][K|V][TILE][RB]
  float* q_s = reinterpret_cast<float*>(smem + static_cast<size_t>(WARPS) * 2 * TILE * RB);  // [MAX_G][D]
  float* p_s = q_s + MAX_G * HEAD_DIM;  // [WARPS][MAX_G][TILE]
  float* acc_s = reinterpret_cast<float*>(smem);  // [WARPS][MAX_G][D], reuses the stage
  __shared__ float ml_s[WARPS][MAX_G][2];

  const int s = blockIdx.x, kvh = blockIdx.y, j = blockIdx.z;
  const int H = KV * G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int kv_len = kv_lens[s];
  const int kstart = j * split_pages * ps;
  const int split_end = min(kv_len, (j + 1) * split_pages * ps);
  const bool active = s < num_seqs[0] && kv_len > 0 && kstart < split_end;

  float m[MAX_G], l[MAX_G];
  float4 acc[MAX_G];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
    acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  if (active) {
    // This KV head's G query rows, pre-scaled by sm_scale, in f32.
    for (int i = threadIdx.x; i < G * (HEAD_DIM / 4); i += THREADS) {
      const int g = i / (HEAD_DIM / 4), d = (i % (HEAD_DIM / 4)) * 4;
      const float4 v = load4(q + (static_cast<size_t>(s) * H + kvh * G + g) * HEAD_DIM + d);
      *reinterpret_cast<float4*>(q_s + g * HEAD_DIM + d) = scale4(v, sm_scale);
    }
  }
  __syncthreads();

  if (active) {
    const int* table = page_indices + static_cast<size_t>(s) * PP;
    const size_t slot_bytes = static_cast<size_t>(2 * KV) * HEAD_DIM * sizeof(PT);
    const size_t head_bytes = static_cast<size_t>(HEAD_DIM) * sizeof(PT);
    const unsigned char* base = reinterpret_cast<const unsigned char*>(pages) + 2 * kvh * head_bytes;
    unsigned char* k_st = stage + static_cast<size_t>(warp) * 2 * TILE * RB;
    unsigned char* v_st = k_st + TILE * RB;
    float* pw = p_s + warp * MAX_G * TILE;
    const int ntiles = (split_end - kstart + TILE - 1) / TILE;
    for (int t = warp; t < ntiles; t += WARPS) {
      const int k0 = kstart + t * TILE;
      const int nk = min(TILE, split_end - k0);
      // Stage the tile's K and V rows with coalesced 16-byte async copies,
      // all in flight at once: the loads, not the math, set the pace.
      for (int i = lane; i < nk * CPR; i += 32) {
        const int r = i / CPR, c = i % CPR;
        const int key = k0 + r;
        const unsigned char* src =
            base + (static_cast<size_t>(page_of(table, key, ps, PP, P)) * ps + key % ps) * slot_bytes + c * 16;
        cp_async16(k_st + r * RB + c * 16, src);
        cp_async16(v_st + r * RB + c * 16, src + head_bytes);
      }
      cp_async_wait_all();
      __syncwarp();

      // q.k with one key a lane, dequantized in registers.
      const bool valid = lane < nk;
      float sc[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) sc[g] = 0.f;
      if (valid) {
        const PT* kr = reinterpret_cast<const PT*>(k_st + lane * RB);
#pragma unroll 4
        for (int d = 0; d < HEAD_DIM; d += 4) {
          const float4 k4 = load4(kr + d);
#pragma unroll
          for (int g = 0; g < MAX_G; ++g)
            if (g < G) sc[g] += dot4(*reinterpret_cast<const float4*>(q_s + g * HEAD_DIM + d), k4);
        }
      }
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g < G) {
          // kv_scale dequantizes K: q.(k*s) == (q.k)*s.
          const float x = valid ? sc[g] * kv_scale : NEG_INF;
          const float mn = fmaxf(m[g], warp_max(x));
          const float p = valid ? expf(x - mn) : 0.f;
          const float alpha = expf(m[g] - mn);
          l[g] = l[g] * alpha + warp_sum(p);
          m[g] = mn;
          acc[g] = scale4(acc[g], alpha);
          pw[g * TILE + lane] = p;
        }
      }
      __syncwarp();
      // p.V with DPL head-dim values a lane.
      for (int u = 0; u < nk; ++u) {
        const float4 v4 = load4(reinterpret_cast<const PT*>(v_st + u * RB) + lane * DPL);
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < G) acc[g] = fma4(pw[g * TILE + u], v4, acc[g]);
      }
      __syncwarp();  // the next tile overwrites this warp's stage
    }
  }
  __syncthreads();  // every warp is done with the stage that acc_s reuses

  // Merge the warps' online-softmax states; inactive blocks and idle warps
  // carry the neutral state (m = NEG_INF, l = 0, o = 0).
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    if (g < G) {
      *reinterpret_cast<float4*>(acc_s + (warp * MAX_G + g) * HEAD_DIM + lane * DPL) = acc[g];
      if (lane == 0) {
        ml_s[warp][g][0] = m[g];
        ml_s[warp][g][1] = l[g];
      }
    }
  }
  __syncthreads();
  for (int g = warp; g < G; g += WARPS) {
    float mm = NEG_INF;
    for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, ml_s[w][g][0]);
    float ll = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int w = 0; w < WARPS; ++w) {
      const float a = expf(ml_s[w][g][0] - mm);
      ll += a * ml_s[w][g][1];
      o = fma4(a, *reinterpret_cast<const float4*>(acc_s + (w * MAX_G + g) * HEAD_DIM + lane * DPL), o);
    }
    const size_t idx = (static_cast<size_t>(j) * S + s) * H + kvh * G + g;
    // kv_scale dequantizes V: sum p*(v*s) == s * sum p*v.
    store4(o_part + idx * HEAD_DIM + lane * DPL, scale4(o, kv_scale));
    if (lane == 0) {
      m_part[idx] = mm;
      l_part[idx] = ll;
    }
  }
}

template <typename QT, typename PT>
int launch_typed(const void* q, const void* pages, const int* kv_lens,
                 const int* page_indices, const int* num_seqs, float* o_part,
                 float* m_part, float* l_part, void* out, int S, int KV, int G,
                 int P, int ps, int PP, int J, int split_pages, float sm_scale,
                 float kv_scale, cudaStream_t stream) {
  // Above 48 KB of shared memory a block needs the opt-in, once per kernel.
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(decode_partial_kernel<QT, PT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes<PT>()));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(S, KV, J);
  decode_partial_kernel<QT, PT><<<grid, THREADS, smem_bytes<PT>(), stream>>>(
      static_cast<const QT*>(q), static_cast<const PT*>(pages), kv_lens,
      page_indices, num_seqs, o_part, m_part, l_part, S, KV, G, P, ps, PP,
      split_pages, sm_scale, kv_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lse_combine_kernel<QT><<<dim3(S, KV * G), 32, 0, stream>>>(
      o_part, m_part, l_part, static_cast<QT*>(out), nullptr, num_seqs, S,
      KV * G, J);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int launch_pages(int page_dtype, const void* q, const void* pages,
                 const int* kv_lens, const int* page_indices,
                 const int* num_seqs, float* o_part, float* m_part,
                 float* l_part, void* out, int S, int KV, int G, int P, int ps,
                 int PP, int J, int split_pages, float sm_scale, float kv_scale,
                 cudaStream_t stream) {
#define DYN_LAUNCH(PT)                                                       \
  return launch_typed<QT, PT>(q, pages, kv_lens, page_indices, num_seqs,    \
                              o_part, m_part, l_part, out, S, KV, G, P, ps, \
                              PP, J, split_pages, sm_scale, kv_scale, stream)
  switch (page_dtype) {
    case F32: DYN_LAUNCH(float);
    case BF16: DYN_LAUNCH(__nv_bfloat16);
    case I8: DYN_LAUNCH(int8_t);
    case FP8E4M3: DYN_LAUNCH(__nv_fp8_e4m3);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DYN_LAUNCH
}

}  // namespace

// Launches the partial kernel and the LSE combine on ``stream``; returns the
// cudaGetLastError() code of the launches (0 = both accepted).
extern "C" int decode_attention_launch(
    const void* q, const void* pages, const int* kv_lens,
    const int* page_indices, const int* num_seqs, float* o_part,
    float* m_part, float* l_part, void* out, int S, int KV, int G, int P,
    int ps, int PP, int J, int split_pages, int q_dtype, int page_dtype,
    float sm_scale, float kv_scale, void* stream) {
  if (G < 1 || G > MAX_G) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case F32:
      return launch_pages<float>(page_dtype, q, pages, kv_lens, page_indices,
                                 num_seqs, o_part, m_part, l_part, out, S, KV,
                                 G, P, ps, PP, J, split_pages, sm_scale,
                                 kv_scale, st);
    case BF16:
      return launch_pages<__nv_bfloat16>(
          page_dtype, q, pages, kv_lens, page_indices, num_seqs, o_part,
          m_part, l_part, out, S, KV, G, P, ps, PP, J, split_pages, sm_scale,
          kv_scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Ragged chunked paged PREFILL attention for Hopper (sm_90a), hand-written
// CUDA.
//
// Replaces: dynamo_tpu/ops/prefill_attention.py::fused_prefill_attention
// (the Pallas TPU kernel, body _make_kernel).  Same contract as the JAX XLA
// path of ragged_attention: row s's queries are the LAST
// q_len = cu[s+1] - cu[s] tokens of its kv_len-token context, whose K/V
// (prior prefix and the chunk itself) already sit in pages [P, ps, 2KV, D];
// causal mask ctx <= kv_len - q_len + t; int8 / fp8-e4m3 / bf16 / f32 pages
// dequantized by a scalar kv_scale; zeros for tokens at or past
// cu[num_seqs].
//
// What bounds it on an H100: operations once the chunk is long (a 512-token
// chunk over a 2k context does ~2k flops per KV byte), bytes for short
// chunks over long prefixes.  This first version runs the dots on the f32
// CUDA cores — simple and exact against the plain version; wgmma on bf16
// tiles is the next step.  Its design answers the reuse question instead:
//   * one block per (row, q-block, KV head, split) holds 64 query-head rows
//     (QB = 64 / G tokens x G heads) in shared memory, so each K/V tile
//     staged from HBM serves 64 rows;
//   * 32-key tiles are gathered through the page table, dequantized once
//     into shared memory, and consumed by 4 warps of 16 rows each: a lane
//     owns one key for q.k and four head-dim values for p.V;
//   * a q-block stops at its last query's causal bound, not at kv_len.
// Rows are ragged and the grid cannot wait on the host for cu_q_lens: the
// wrapper launches ceil(T/QB) + S block slots and each block finds its
// (row, q-block) by walking cu_q_lens on the device; spare slots exit.
// The TPU kernel let a row's tail q-block spill writes into the next row's
// tokens, relying on its sequential grid; CUDA blocks run concurrently, so
// every store here is masked to the row's own tokens, and the LSE combine
// writes exact zeros for padding tokens, which no block touches.
#include "common.cuh"

using namespace dyn;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = 64;            // query-head rows per block
constexpr int RW = ROWS / WARPS;    // rows per warp
constexpr int TILE = 32;            // keys per staged tile
constexpr int KSTRIDE = HEAD_DIM + 4;  // padded K rows: conflict-free float4 reads
constexpr size_t SMEM_BYTES =
    sizeof(float) * (ROWS * HEAD_DIM + TILE * KSTRIDE + TILE * HEAD_DIM + WARPS * RW * TILE);

template <typename QT, typename PT>
__global__ void __launch_bounds__(THREADS) prefill_partial_kernel(
    const QT* __restrict__ q,              // [T, H, D]
    const PT* __restrict__ pages,          // [P, ps, 2KV, D]
    const int* __restrict__ kv_lens,       // [S]
    const int* __restrict__ page_indices,  // [S, PP]
    const int* __restrict__ cu_q_lens,     // [S+1]
    const int* __restrict__ num_seqs,      // [1]
    float* __restrict__ o_part,            // [J, T, H, D]
    float* __restrict__ m_part,            // [J, T, H]
    float* __restrict__ l_part,            // [J, T, H]
    int T, int KV, int G, int P, int ps, int PP, int split_pages,
    float sm_scale, float kv_scale) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                      // [ROWS][HEAD_DIM]
  float* k_s = q_s + ROWS * HEAD_DIM;     // [TILE][KSTRIDE]
  float* v_s = k_s + TILE * KSTRIDE;      // [TILE][HEAD_DIM]
  float* p_s = v_s + TILE * HEAD_DIM;     // [WARPS][RW][TILE]

  const int QB = ROWS / G;
  // Resolve this block slot to (row, q-block) on the device.
  int b = blockIdx.x, s = -1, qb = 0;
  const int nseq = num_seqs[0];
  for (int r = 0; r < nseq; ++r) {
    const int nq = (cu_q_lens[r + 1] - cu_q_lens[r] + QB - 1) / QB;
    if (b < nq) {
      s = r;
      qb = b;
      break;
    }
    b -= nq;
  }
  if (s < 0) return;  // spare slot: uniform across the block

  const int kvh = blockIdx.y, j = blockIdx.z;
  const int H = KV * G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q_start = cu_q_lens[s];
  const int q_len = cu_q_lens[s + 1] - q_start;
  const int kv_len = kv_lens[s];
  const int i0 = qb * QB;                    // first in-row token of the block
  const int i_end = min(q_len, i0 + QB);     // one past its last
  const int kstart = j * split_pages * ps;
  const int split_end = min(kv_len, (j + 1) * split_pages * ps);
  // Stop at the block's last query's causal bound.
  const int kend = min(split_end, kv_len - q_len + i_end);

  // Query rows: row r is token i0 + r / G, head kvh * G + r % G.
  for (int i = threadIdx.x; i < ROWS * (HEAD_DIM / 4); i += THREADS) {
    const int r = i / (HEAD_DIM / 4), d = (i % (HEAD_DIM / 4)) * 4;
    const int tok = i0 + r / G;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tok < i_end)
      v = scale4(load4(q + (static_cast<size_t>(q_start + tok) * H + kvh * G + r % G) * HEAD_DIM + d),
                 sm_scale);
    *reinterpret_cast<float4*>(q_s + r * HEAD_DIM + d) = v;
  }

  float m[RW], l[RW];
  float4 acc[RW];
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    m[rr] = NEG_INF;
    l[rr] = 0.f;
    acc[rr] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int row0 = warp * RW;
  const int* table = page_indices + static_cast<size_t>(s) * PP;
  const size_t slot_stride = static_cast<size_t>(2 * KV) * HEAD_DIM;
  float* pw = p_s + warp * RW * TILE;

  for (int k0 = kstart; k0 < kend; k0 += TILE) {
    __syncthreads();  // the previous tile is consumed (and q_s is written)
    for (int i = threadIdx.x; i < TILE * (HEAD_DIM / 4); i += THREADS) {
      const int t = i / (HEAD_DIM / 4), d = (i % (HEAD_DIM / 4)) * 4;
      const int key = k0 + t;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (key < kend) {
        const int pid = page_of(table, key, ps, PP, P);
        const PT* base = pages + (static_cast<size_t>(pid) * ps + key % ps) * slot_stride +
                         static_cast<size_t>(2 * kvh) * HEAD_DIM;
        kv = load4(base + d);
        vv = load4(base + HEAD_DIM + d);
      }
      *reinterpret_cast<float4*>(k_s + t * KSTRIDE + d) = kv;
      *reinterpret_cast<float4*>(v_s + t * HEAD_DIM + d) = vv;
    }
    __syncthreads();

    float sc[RW];
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) sc[rr] = 0.f;
    const float* kr = k_s + lane * KSTRIDE;
#pragma unroll 2
    for (int d = 0; d < HEAD_DIM; d += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int rr = 0; rr < RW; ++rr)
        sc[rr] += dot4(*reinterpret_cast<const float4*>(q_s + (row0 + rr) * HEAD_DIM + d), k4);
    }
    const int key = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const int tok = i0 + (row0 + rr) / G;
      const int qpos = kv_len - q_len + tok;
      const bool valid = tok < i_end && key < kend && key <= qpos;
      const float x = valid ? sc[rr] * kv_scale : NEG_INF;
      const float mn = fmaxf(m[rr], warp_max(x));
      const float p = valid ? expf(x - mn) : 0.f;
      const float alpha = expf(m[rr] - mn);
      l[rr] = l[rr] * alpha + warp_sum(p);
      m[rr] = mn;
      acc[rr] = scale4(acc[rr], alpha);
      pw[rr * TILE + lane] = p;
    }
    __syncwarp();
    const int nk = min(TILE, kend - k0);
    for (int u = 0; u < nk; ++u) {
      const float4 v4 = *reinterpret_cast<const float4*>(v_s + u * HEAD_DIM + lane * DPL);
#pragma unroll
      for (int rr = 0; rr < RW; ++rr) acc[rr] = fma4(pw[rr * TILE + u], v4, acc[rr]);
    }
  }

  // Partials for the block's own tokens only: nothing spills into the next
  // row's region.
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int r = row0 + rr;
    const int tok = i0 + r / G;
    if (tok < i_end) {
      const size_t idx = (static_cast<size_t>(j) * T + q_start + tok) * H + kvh * G + r % G;
      store4(o_part + idx * HEAD_DIM + lane * DPL, scale4(acc[rr], kv_scale));
      if (lane == 0) {
        m_part[idx] = m[rr];
        l_part[idx] = l[rr];
      }
    }
  }
}

template <typename QT, typename PT>
int launch_typed(const void* q, const void* pages, const int* kv_lens,
                 const int* page_indices, const int* cu_q_lens,
                 const int* num_seqs, float* o_part, float* m_part,
                 float* l_part, void* out, int T, int S, int KV, int G, int P,
                 int ps, int PP, int J, int split_pages, float sm_scale,
                 float kv_scale, cudaStream_t stream) {
  // Above 48 KB of shared memory a block needs the opt-in, once per kernel.
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(prefill_partial_kernel<QT, PT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM_BYTES));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int QB = ROWS / G;
  const dim3 grid((T + QB - 1) / QB + S, KV, J);
  prefill_partial_kernel<QT, PT><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const QT*>(q), static_cast<const PT*>(pages), kv_lens,
      page_indices, cu_q_lens, num_seqs, o_part, m_part, l_part, T, KV, G, P,
      ps, PP, split_pages, sm_scale, kv_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lse_combine_kernel<QT><<<dim3(T, KV * G), 32, 0, stream>>>(
      o_part, m_part, l_part, static_cast<QT*>(out), cu_q_lens, num_seqs, T,
      KV * G, J);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int launch_pages(int page_dtype, const void* q, const void* pages,
                 const int* kv_lens, const int* page_indices,
                 const int* cu_q_lens, const int* num_seqs, float* o_part,
                 float* m_part, float* l_part, void* out, int T, int S, int KV,
                 int G, int P, int ps, int PP, int J, int split_pages,
                 float sm_scale, float kv_scale, cudaStream_t stream) {
#define DYN_LAUNCH(PT)                                                        \
  return launch_typed<QT, PT>(q, pages, kv_lens, page_indices, cu_q_lens,    \
                              num_seqs, o_part, m_part, l_part, out, T, S,   \
                              KV, G, P, ps, PP, J, split_pages, sm_scale,    \
                              kv_scale, stream)
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
extern "C" int prefill_attention_launch(
    const void* q, const void* pages, const int* kv_lens,
    const int* page_indices, const int* cu_q_lens, const int* num_seqs,
    float* o_part, float* m_part, float* l_part, void* out, int T, int S,
    int KV, int G, int P, int ps, int PP, int J, int split_pages, int q_dtype,
    int page_dtype, float sm_scale, float kv_scale, void* stream) {
  if (G < 1 || ROWS % G != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case F32:
      return launch_pages<float>(page_dtype, q, pages, kv_lens, page_indices,
                                 cu_q_lens, num_seqs, o_part, m_part, l_part,
                                 out, T, S, KV, G, P, ps, PP, J, split_pages,
                                 sm_scale, kv_scale, st);
    case BF16:
      return launch_pages<__nv_bfloat16>(
          page_dtype, q, pages, kv_lens, page_indices, cu_q_lens, num_seqs,
          o_part, m_part, l_part, out, T, S, KV, G, P, ps, PP, J, split_pages,
          sm_scale, kv_scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

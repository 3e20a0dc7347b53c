// Paged DECODE attention for Hopper (sm_90a), hand-written CUDA.
//
// Replaces: dynamo_tpu/ops/decode_attention.py:330 fused_decode_attention
// (the Pallas TPU kernel, body _make_kernel; pallas_call at :423).  Same
// contract as the JAX XLA path ragged_decode_attention: one query token per
// row at context position kv_len - 1, GQA over G = H / KV query heads per
// KV head, pages [P, ps, 2KV, D] with K at even and V at odd combined-head
// indices, int8 / fp8-e4m3 / bf16 / f32 pages dequantized by a scalar
// kv_scale, zeros for rows past num_seqs and rows with kv_len 0.
//
// What bounds it on an H100: bytes.  A decode step reads every live KV
// position once (2 * KV * D values per position) and does ~4 * G flops per
// value read — far below the ~295 flop/byte where bf16 tensor cores become
// the limit.  The first version reached 17% of HBM rate: each warp had one
// 32-key tile in flight and then stopped to compute; the split count
// followed the row count (padding rows included) so a few long rows set
// the tail; and the f32 dots re-read q and p from shared memory on the
// critical path.  This design:
//   * partitions each row's context into fixed runs of part_tokens (256 by
//     default) positions; the grid is S x KV x ceil(PP*ps / part_tokens),
//     sized from the table width alone (no host read of kv_lens, so the
//     launch can be captured in a CUDA graph); blocks past their row's
//     kv_len, and rows with no work, exit at once;
//   * each of a block's 4 warps walks every 4th 16-key tile of the
//     partition through its own ring of cp.async stages (3 for bf16, 4 for
//     1-byte pages), waiting with cp.async.wait_group so the next tiles'
//     K/V copies are in flight while the current one is computed: up to
//     16 KB a warp, ~128 KB an SM at 2 blocks an SM;
//   * bf16 queries over bf16 / int8 / fp8 pages run both products on the
//     tensor cores (mma.sync.m16n8k16): S = q K^T with the G query heads as
//     rows 0..G-1 of the A fragment (held in registers for the whole loop,
//     rows G..15 zero), K from ldmatrix; then O += P V with P re-packed
//     from the accumulators and V from ldmatrix.trans.  Putting the heads
//     and not the keys on M wastes rows of the idle tensor cores but keeps
//     P in the accumulator layout (no shuffle or shared-memory transpose).
//     1-byte pages are staged raw and widened to bf16 exactly;
//   * f32 pages (and f32 queries) keep the first version's f32 CUDA-core
//     dots: the f32 checks hold them to 1e-4, which bf16 inputs cannot;
//   * warps merge through shared memory; a row whose context fits in one
//     partition is normalised and written by its block, and only rows with
//     two or more partitions are LSE-combined, reading just the partitions
//     their kv_len covers.
// Each partition is masked at min(kv_len, its end) so no position is
// counted twice; page-table reads are clamped because padding rows carry
// arbitrary tables with kv_len 1.
// Later work: a producer warp feeding a TMA ring, and warp-specialised
// consumers (ROADMAP queue 2).
#include "common.cuh"

using namespace dyn;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_G = 8;

// Zeros for a row with no attention output: rows past num_seqs and rows
// with kv_len 0.
template <typename QT>
__device__ __forceinline__ void zero_row(QT* out, int s, int kvh, int G, int H) {
  for (int i = threadIdx.x; i < G * (HEAD_DIM / 4); i += THREADS) {
    const int g = i / (HEAD_DIM / 4), d = (i % (HEAD_DIM / 4)) * 4;
    store4(out + (static_cast<size_t>(s) * H + kvh * G + g) * HEAD_DIM + d, make_float4(0.f, 0.f, 0.f, 0.f));
  }
}

// Merge the warps' online-softmax states (m in base-2 units, l, o) from
// shared memory and write either the normalised output (``direct``: the
// row's whole context was this partition) or an unnormalised partial.
// Idle warps carry the neutral state (m = NEG_INF, l = 0, o = 0).
template <typename QT>
__device__ __forceinline__ void merge_store(const float* acc_s, float (*ml_s)[MAX_G][2], int G,
                                            bool direct, QT* out, float* o_part, float* m_part,
                                            float* l_part, int S, int H, int s, int kvh, int part,
                                            float kv_scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int g = warp; g < G; g += WARPS) {
    float mm = NEG_INF;
    for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, ml_s[w][g][0]);
    float ll = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int w = 0; w < WARPS; ++w) {
      const float a = exp2f(ml_s[w][g][0] - mm);
      ll += a * ml_s[w][g][1];
      o = fma4(a, *reinterpret_cast<const float4*>(acc_s + (w * MAX_G + g) * HEAD_DIM + lane * DPL), o);
    }
    const int h = kvh * G + g;
    // kv_scale dequantizes V: sum p*(v*s) == s * sum p*v.
    if (direct) {
      store4(out + (static_cast<size_t>(s) * H + h) * HEAD_DIM + lane * DPL, scale4(o, kv_scale / (ll + 1e-30f)));
    } else {
      const size_t idx = (static_cast<size_t>(part) * S + s) * H + h;
      store4(o_part + idx * HEAD_DIM + lane * DPL, scale4(o, kv_scale));
      if (lane == 0) {
        m_part[idx] = mm * LN2;  // natural-log units for the combine
        l_part[idx] = ll;
      }
    }
  }
}

// ----------------------------------- tensor-core body (bf16 q, 16-bit/8-bit pages)

constexpr int DKT = 16;  // keys a warp's tile

template <typename PT>
__host__ __device__ constexpr int tc_stages() { return sizeof(PT) == 1 ? 4 : 3; }

template <typename PT>
__host__ __device__ constexpr int tc_raw_bytes() { return DKT * HEAD_DIM * static_cast<int>(sizeof(PT)); }

template <typename PT>
__host__ __device__ constexpr int tc_warp_bytes() {
  return tc_stages<PT>() * 2 * tc_raw_bytes<PT>() + (sizeof(PT) == 2 ? 0 : 2 * DKT * BF16_ROW_BYTES);
}

template <typename PT>
__host__ __device__ constexpr size_t tc_smem_bytes() {
  return static_cast<size_t>(WARPS) * tc_warp_bytes<PT>();  // >= the merge area, 16 KB
}

template <typename PT>
__global__ void __launch_bounds__(THREADS, 2) decode_tc_kernel(
    const __nv_bfloat16* __restrict__ q,   // [S, H, D]
    const PT* __restrict__ pages,          // [P, ps, 2KV, D]
    const int* __restrict__ kv_lens,       // [S]
    const int* __restrict__ page_indices,  // [S, PP]
    const int* __restrict__ num_seqs,      // [1]
    float* __restrict__ o_part,            // [NPART, S, H, D]
    float* __restrict__ m_part,            // [NPART, S, H]
    float* __restrict__ l_part,            // [NPART, S, H]
    __nv_bfloat16* __restrict__ out,       // [S, H, D]
    int S, int KV, int G, int P, int ps, int PP, int part_tokens,
    float sm_scale, float kv_scale) {
  constexpr int ST = tc_stages<PT>();
  constexpr int RAW = tc_raw_bytes<PT>();
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float ml_s[WARPS][MAX_G][2];

  const int s = blockIdx.x, kvh = blockIdx.y, part = blockIdx.z;
  const int H = KV * G;
  const int kv_len = kv_lens[s];
  if (s >= num_seqs[0] || kv_len <= 0) {
    if (part == 0) zero_row(out, s, kvh, G, H);
    return;
  }
  const int kstart = part * part_tokens;
  if (kstart >= kv_len) return;  // past the row's context: nothing to read or write
  const int kend = min(kv_len, kstart + part_tokens);
  const bool direct = kv_len <= part_tokens;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;

  // Row g of the A fragment is query head kvh*G + g; rows G..15 are zero
  // (and so are the fragment's second and fourth registers, rows 8..15).
  uint32_t qa[8][4];
  {
    const bool on = g < G;
    const __nv_bfloat16* qrow = q + (static_cast<size_t>(s) * H + kvh * G + (on ? g : 0)) * HEAD_DIM + tig * 2;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      qa[kk][0] = on ? *reinterpret_cast<const uint32_t*>(qrow + kk * 16) : 0u;
      qa[kk][1] = 0u;
      qa[kk][2] = on ? *reinterpret_cast<const uint32_t*>(qrow + kk * 16 + 8) : 0u;
      qa[kk][3] = 0u;
    }
  }
  const int* table = page_indices + static_cast<size_t>(s) * PP;
  const size_t slot_bytes = static_cast<size_t>(2 * KV) * HEAD_DIM * sizeof(PT);
  const unsigned char* head_base =
      reinterpret_cast<const unsigned char*>(pages) + static_cast<size_t>(2 * kvh) * HEAD_DIM * sizeof(PT);
  const int lim[2] = {kend, 0};

  float o[16][4];
#pragma unroll
  for (int dt = 0; dt < 16; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const float sc = sm_scale * kv_scale * LOG2E;
  unsigned char* wst = smem + warp * tc_warp_bytes<PT>();  // this warp's ring, then its widened tile
  warp_ring_loop<PT, ST>(wst, wst + ST * 2 * RAW, head_base, table, kstart, kend, ps, PP, P, slot_bytes, warp,
                         WARPS, [&](const unsigned char* kt, const unsigned char* vt, int k0) {
                           attend_tile<DKT / 8>(qa, kt, vt, k0, lim, k0 + DKT > kend, sc, m, l, o);
                         });
  l[0] += __shfl_xor_sync(0xffffffffu, l[0], 1);
  l[0] += __shfl_xor_sync(0xffffffffu, l[0], 2);

  __syncthreads();  // every warp is done with its ring, which acc_s reuses
  float* acc_s = reinterpret_cast<float*>(smem);  // [WARPS][MAX_G][D]
  if (g < G) {
#pragma unroll
    for (int dt = 0; dt < 16; ++dt)
      *reinterpret_cast<float2*>(acc_s + (warp * MAX_G + g) * HEAD_DIM + dt * 8 + tig * 2) =
          make_float2(o[dt][0], o[dt][1]);
    if (tig == 0) {
      ml_s[warp][g][0] = m[0];
      ml_s[warp][g][1] = l[0];
    }
  }
  __syncthreads();
  merge_store(acc_s, ml_s, G, direct, out, o_part, m_part, l_part, S, H, s, kvh, part, kv_scale);
}

// ------------------------------------------- CUDA-core body (f32 pages or q)

constexpr int TILE = 32;

// A staged K or V row: the head row plus 16 bytes of padding, so that the
// lanes of a warp reading 32 different rows start in different banks.
template <typename PT>
__host__ __device__ constexpr int row_bytes() { return HEAD_DIM * static_cast<int>(sizeof(PT)) + 16; }

template <typename PT>
__host__ __device__ constexpr size_t f32_smem_bytes() {
  return static_cast<size_t>(WARPS) * 2 * TILE * row_bytes<PT>() +
         sizeof(float) * (MAX_G * HEAD_DIM + WARPS * MAX_G * TILE);
}

// The first version's body, kept where a 1e-4 f32 check holds the result:
// a lane owns one key for q.k and four head-dim values for p.V, in f32.
template <typename QT, typename PT>
__global__ void __launch_bounds__(THREADS) decode_f32_kernel(
    const QT* __restrict__ q, const PT* __restrict__ pages,
    const int* __restrict__ kv_lens, const int* __restrict__ page_indices,
    const int* __restrict__ num_seqs, float* __restrict__ o_part,
    float* __restrict__ m_part, float* __restrict__ l_part, QT* __restrict__ out,
    int S, int KV, int G, int P, int ps, int PP, int part_tokens,
    float sm_scale, float kv_scale) {
  constexpr int RB = row_bytes<PT>();
  constexpr int CPR = HEAD_DIM * static_cast<int>(sizeof(PT)) / 16;  // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char f32_smem[];
  unsigned char* stage = f32_smem;  // [WARPS][K|V][TILE][RB]
  float* q_s = reinterpret_cast<float*>(f32_smem + static_cast<size_t>(WARPS) * 2 * TILE * RB);  // [MAX_G][D]
  float* p_s = q_s + MAX_G * HEAD_DIM;  // [WARPS][MAX_G][TILE]
  __shared__ float ml_s[WARPS][MAX_G][2];

  const int s = blockIdx.x, kvh = blockIdx.y, part = blockIdx.z;
  const int H = KV * G;
  const int kv_len = kv_lens[s];
  if (s >= num_seqs[0] || kv_len <= 0) {
    if (part == 0) zero_row(out, s, kvh, G, H);
    return;
  }
  const int kstart = part * part_tokens;
  if (kstart >= kv_len) return;
  const int kend = min(kv_len, kstart + part_tokens);
  const bool direct = kv_len <= part_tokens;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float m[MAX_G], l[MAX_G];
  float4 acc[MAX_G];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
    acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // This KV head's G query rows, pre-scaled by sm_scale, in f32.
  for (int i = threadIdx.x; i < G * (HEAD_DIM / 4); i += THREADS) {
    const int g = i / (HEAD_DIM / 4), d = (i % (HEAD_DIM / 4)) * 4;
    const float4 v = load4(q + (static_cast<size_t>(s) * H + kvh * G + g) * HEAD_DIM + d);
    *reinterpret_cast<float4*>(q_s + g * HEAD_DIM + d) = scale4(v, sm_scale);
  }
  __syncthreads();

  const float sc = kv_scale * LOG2E;
  const int* table = page_indices + static_cast<size_t>(s) * PP;
  const size_t slot_bytes = static_cast<size_t>(2 * KV) * HEAD_DIM * sizeof(PT);
  const size_t head_bytes = static_cast<size_t>(HEAD_DIM) * sizeof(PT);
  const unsigned char* base = reinterpret_cast<const unsigned char*>(pages) + 2 * kvh * head_bytes;
  unsigned char* k_st = stage + static_cast<size_t>(warp) * 2 * TILE * RB;
  unsigned char* v_st = k_st + TILE * RB;
  float* pw = p_s + warp * MAX_G * TILE;
  const int ntiles = (kend - kstart + TILE - 1) / TILE;
  for (int t = warp; t < ntiles; t += WARPS) {
    const int k0 = kstart + t * TILE;
    const int nk = min(TILE, kend - k0);
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

    const bool valid = lane < nk;
    float scr[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) scr[g] = 0.f;
    if (valid) {
      const PT* kr = reinterpret_cast<const PT*>(k_st + lane * RB);
#pragma unroll 4
      for (int d = 0; d < HEAD_DIM; d += 4) {
        const float4 k4 = load4(kr + d);
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < G) scr[g] += dot4(*reinterpret_cast<const float4*>(q_s + g * HEAD_DIM + d), k4);
      }
    }
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < G) {
        // kv_scale dequantizes K: q.(k*s) == (q.k)*s.
        const float x = valid ? scr[g] * sc : NEG_INF;
        const float mn = fmaxf(m[g], warp_max(x));
        const float p = valid ? exp2f(x - mn) : 0.f;
        const float alpha = exp2f(m[g] - mn);
        l[g] = l[g] * alpha + warp_sum(p);
        m[g] = mn;
        acc[g] = scale4(acc[g], alpha);
        pw[g * TILE + lane] = p;
      }
    }
    __syncwarp();
    for (int u = 0; u < nk; ++u) {
      const float4 v4 = load4(reinterpret_cast<const PT*>(v_st + u * RB) + lane * DPL);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) acc[g] = fma4(pw[g * TILE + u], v4, acc[g]);
    }
    __syncwarp();  // the next tile overwrites this warp's stage
  }
  __syncthreads();  // every warp is done with the stage that acc_s reuses

  float* acc_s = reinterpret_cast<float*>(f32_smem);  // [WARPS][MAX_G][D]
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
  merge_store(acc_s, ml_s, G, direct, out, o_part, m_part, l_part, S, H, s, kvh, part, kv_scale);
}

// ---------------------------------------------------------------- launch

template <typename QT, typename PT>
int launch_typed(const void* q, const void* pages, const int* kv_lens,
                 const int* page_indices, const int* num_seqs, float* o_part,
                 float* m_part, float* l_part, void* out, int S, int KV, int G,
                 int P, int ps, int PP, int NPART, int part_tokens, float sm_scale,
                 float kv_scale, cudaStream_t stream) {
  // bf16 q over bf16 / int8 / fp8 pages: tensor cores; f32 anywhere: CUDA cores.
  constexpr bool TC = sizeof(QT) == 2 && sizeof(PT) <= 2;
  const size_t smem = TC ? tc_smem_bytes<PT>() : f32_smem_bytes<PT>();
  // Above 48 KB of shared memory a block needs the opt-in, once per kernel.
  static bool configured = false;
  if (!configured) {
    cudaError_t e;
    if constexpr (TC)
      e = cudaFuncSetAttribute(decode_tc_kernel<PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    else
      e = cudaFuncSetAttribute(decode_f32_kernel<QT, PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(S, KV, NPART);
  if constexpr (TC)
    decode_tc_kernel<PT><<<grid, THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const PT*>(pages), kv_lens, page_indices,
        num_seqs, o_part, m_part, l_part, static_cast<__nv_bfloat16*>(out), S, KV, G, P, ps, PP,
        part_tokens, sm_scale, kv_scale);
  else
    decode_f32_kernel<QT, PT><<<grid, THREADS, smem, stream>>>(
        static_cast<const QT*>(q), static_cast<const PT*>(pages), kv_lens, page_indices, num_seqs,
        o_part, m_part, l_part, static_cast<QT*>(out), S, KV, G, P, ps, PP, part_tokens, sm_scale,
        kv_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || NPART == 1) return static_cast<int>(err);
  lse_combine_kernel<QT><<<dim3(S, KV * G), 32, 0, stream>>>(
      o_part, m_part, l_part, static_cast<QT*>(out), nullptr, num_seqs, kv_lens, part_tokens, S,
      KV * G, NPART);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int launch_pages(int page_dtype, const void* q, const void* pages,
                 const int* kv_lens, const int* page_indices,
                 const int* num_seqs, float* o_part, float* m_part,
                 float* l_part, void* out, int S, int KV, int G, int P, int ps,
                 int PP, int NPART, int part_tokens, float sm_scale, float kv_scale,
                 cudaStream_t stream) {
#define DYN_LAUNCH(PT)                                                       \
  return launch_typed<QT, PT>(q, pages, kv_lens, page_indices, num_seqs,    \
                              o_part, m_part, l_part, out, S, KV, G, P, ps, \
                              PP, NPART, part_tokens, sm_scale, kv_scale, stream)
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

// Launches the partial kernel over NPART partitions of part_tokens
// positions on ``stream`` and, when NPART > 1, the LSE combine of the rows
// that span more than one.  Returns the cudaGetLastError() code of the
// launches (0 = accepted).
extern "C" int decode_attention_launch(
    const void* q, const void* pages, const int* kv_lens,
    const int* page_indices, const int* num_seqs, float* o_part,
    float* m_part, float* l_part, void* out, int S, int KV, int G, int P,
    int ps, int PP, int NPART, int part_tokens, int q_dtype, int page_dtype,
    float sm_scale, float kv_scale, void* stream) {
  if (G < 1 || G > MAX_G || part_tokens < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case F32:
      return launch_pages<float>(page_dtype, q, pages, kv_lens, page_indices,
                                 num_seqs, o_part, m_part, l_part, out, S, KV,
                                 G, P, ps, PP, NPART, part_tokens, sm_scale,
                                 kv_scale, st);
    case BF16:
      return launch_pages<__nv_bfloat16>(
          page_dtype, q, pages, kv_lens, page_indices, num_seqs, o_part,
          m_part, l_part, out, S, KV, G, P, ps, PP, NPART, part_tokens, sm_scale,
          kv_scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

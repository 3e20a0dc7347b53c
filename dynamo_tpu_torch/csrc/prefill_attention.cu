// Ragged chunked paged PREFILL attention for Hopper (sm_90a), hand-written
// CUDA.
//
// Replaces: dynamo_tpu/ops/prefill_attention.py:285 fused_prefill_attention
// (the Pallas TPU kernel, body _make_kernel; pallas_call at :386).  Same
// contract as the JAX XLA path of ragged_attention: row s's queries are the
// LAST q_len = cu[s+1] - cu[s] tokens of its kv_len-token context, whose
// K/V (prior prefix and the chunk itself) already sit in pages
// [P, ps, 2KV, D]; causal mask ctx <= kv_len - q_len + t; int8 / fp8-e4m3 /
// bf16 / f32 pages dequantized by a scalar kv_scale; zeros for tokens at or
// past cu[num_seqs].
//
// What bounds it on an H100: operations.  A 512-token chunk over a
// 1024-token prefix (the serve shape) does 10.7 GFLOP on 6.3 MB of K/V and
// queries, ~1700 flops a byte, far above the ~295 where the bf16 tensor
// cores and not HBM set the pace.  The first version ran every dot on the
// f32 CUDA cores (67 TFLOP/s peak, ~13 reached); bf16 queries now run on
// the tensor cores with mma.sync.m16n8k16 (FlashAttention-2 shape):
//   * one block per (row, q-block, KV head, split) holds 64 (token, query
//     head) rows of one KV head (QB = 64 / G tokens x G heads), so every
//     K/V tile staged from HBM serves all 64 rows; each of 4 warps owns 16
//     rows as one m16 tile and keeps Q as A fragments in registers for the
//     whole key loop;
//   * 64-key K/V tiles are gathered through the page table with 16-byte
//     cp.async copies into a ring of 3 stages (2 for f32 pages), so tiles
//     t+1 and t+2 are in flight while tile t is computed; rows are XOR-
//     swizzled by 16-byte chunk so ldmatrix reads them conflict-free;
//   * S = Q K^T from ldmatrix K fragments; online softmax in f32 registers
//     on the accumulators, sm_scale * kv_scale applied to the f32 scores
//     (never folded into bf16 Q), in base 2; P re-packed to bf16 A
//     fragments and O += P V with V from ldmatrix.trans;
//   * int8 / fp8 pages are staged raw (half the bytes) and widened to bf16
//     in shared memory, exactly; f32 pages are rounded to bf16 there;
//   * the causal mask is evaluated only on tiles that cross a warp's
//     diagonal, and a warp stops at its last row's causal bound;
//   * with one split (the default) the kernel normalises and writes the
//     output itself, padding tokens included, and no combine runs; J > 1
//     splits write (o, m, l) partials for lse_combine_kernel.
// Why mma.sync and not wgmma + TMA yet: after this change attention is a
// few percent of a prefill chunk, which the GEMMs and the host dominate,
// and the timed problem (~256 blocks of 64 rows) is about one wave on 132
// SMs, so the asynchronous warpgroup path would gain well under a
// millisecond a chunk.  It is queued (ROADMAP queue 2).
// f32 queries keep the CUDA-core body (prefill_f32_kernel): the f32 model
// check holds the path to 1e-4, which bf16 or TF32 tensor-core inputs
// cannot meet.  The q dtype picks the body; a bf16 q never reaches it.
// Rows are ragged and the grid cannot wait on the host for cu_q_lens: the
// wrapper launches prefill_slots(...) block slots per KV head (one per
// q-block of the bucket, plus room for the rows' partial q-blocks) and each
// block finds its (row, q-block) by walking cu_q_lens on the device; spare
// slots zero the padding tokens (there are always enough of them) and
// exit.  A q-block whose rows fit one m16 tile (decode tokens riding a
// mixed step) would leave 3 warps idle while one walks the whole context:
// it gets SMALL_SLICES slots, one per slice of its keys, a slice's 4 warps
// split it, each through its own cp.async ring, and the last slice to
// finish (an atomic arrival count) merges the slices' partials.  Small
// q-blocks take the last slots, so they fill in behind the long blocks.
// The TPU kernel let a row's tail q-block spill writes into the next row's
// tokens, relying on its sequential grid; CUDA blocks run concurrently, so
// every store here is masked to the row's own tokens.
#include "common.cuh"

using namespace dyn;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = 64;          // query-head rows per block
constexpr int RW = ROWS / WARPS;  // rows per warp (one m16 tile)

constexpr int SMALL_SLICES = 4;   // key slices of a small q-block (bf16 q)

struct Slot {
  int s, qb, slice;
};

// A block slot's (row, q-block, key slice), or s = -1 and the slot's index
// among the spare slots.  Slots run along blockIdx.y (the KV head is
// blockIdx.x, so a slot's 8 heads launch together).  Full q-blocks take
// the first slots, in row order, and the small ones (a q-block whose rows
// fit one warp's m16 tile: decode tokens of a mixed step, a row's short
// tail) the last, ``nsl`` slots each (one per key slice): blocks launch
// roughly in index order, so the short blocks fill in behind the long ones
// instead of pushing long ones into a second wave.
__device__ __forceinline__ Slot resolve_slot(const int* cu, int nseq, int G, int nsl) {
  const int QB = ROWS / G;
  const int small = RW / G;  // tokens a small q-block holds at most
  int b = blockIdx.y;
  for (int pass = 0; pass < 2; ++pass) {
    for (int r = 0; r < nseq; ++r) {
      const int q_len = cu[r + 1] - cu[r];
      const int nq = (q_len + QB - 1) / QB;
      const int nsmall = nq > 0 && q_len - (nq - 1) * QB <= small ? 1 : 0;  // its last q-block
      const int n = pass == 0 ? nq - nsmall : nsmall * nsl;
      if (b < n) return pass == 0 ? Slot{r, b, 0} : Slot{r, nq - 1, b};
      b -= n;
    }
  }
  return {-1, b, 0};
}

// Spare slot k writes the zeros of padding tokens first + k*QB .. + QB for
// this KV head's G query heads.  Slots number ceil(T/QB) + S*nsl (the
// wrapper's prefill_slots) and rows
// take sum ceil(q_len/QB) <= (first + nseq*(QB-1)) / QB of them, plus
// nsl - 1 more per small q-block (at most one a row), so the spares cover
// every token in [first, T).
template <typename OutT>
__device__ __forceinline__ void zero_padding(OutT* out, int first, int spare, int T, int H, int G,
                                             int kvh) {
  const int QB = ROWS / G;
  const int t0 = first + spare * QB;
  for (int i = threadIdx.x; i < ROWS * (HEAD_DIM / 4); i += THREADS) {
    const int r = i / (HEAD_DIM / 4), d = (i % (HEAD_DIM / 4)) * 4;
    const int tok = t0 + r / G;
    if (tok < T)
      store4(out + (static_cast<size_t>(tok) * H + kvh * G + r % G) * HEAD_DIM + d,
             make_float4(0.f, 0.f, 0.f, 0.f));
  }
}

// ------------------------------------------------ tensor-core body (bf16 q)

constexpr int KT = 64;  // keys a staged tile

template <typename PT>
__host__ __device__ constexpr int tc_stages() { return sizeof(PT) == 4 ? 2 : 3; }

template <typename PT>
__host__ __device__ constexpr int tc_raw_bytes() { return KT * HEAD_DIM * static_cast<int>(sizeof(PT)); }

template <typename PT>
__host__ __device__ constexpr size_t tc_smem_bytes() {
  return static_cast<size_t>(ROWS) * BF16_ROW_BYTES +
         static_cast<size_t>(tc_stages<PT>()) * 2 * tc_raw_bytes<PT>() +
         (sizeof(PT) == 2 ? 0 : static_cast<size_t>(2) * KT * BF16_ROW_BYTES);
}

template <typename PT>
__global__ void __launch_bounds__(THREADS, 2) prefill_tc_kernel(
    const __nv_bfloat16* __restrict__ q,   // [T, H, D]
    const PT* __restrict__ pages,          // [P, ps, 2KV, D]
    const int* __restrict__ kv_lens,       // [S]
    const int* __restrict__ page_indices,  // [S, PP]
    const int* __restrict__ cu_q_lens,     // [S+1]
    const int* __restrict__ num_seqs,      // [1]
    float* __restrict__ o_part,            // [J, T, H, D] (J > 1)
    float* __restrict__ m_part,            // [J, T, H]
    float* __restrict__ l_part,            // [J, T, H]
    __nv_bfloat16* __restrict__ out,       // [T, H, D]
    float* __restrict__ slice_o,           // [J*S*KV, SMALL_SLICES, RW, D]
    float* __restrict__ slice_ml,          // [J*S*KV, SMALL_SLICES, RW, 2]
    int* __restrict__ slice_cnt,           // [J*S*KV], zero between launches
    int T, int S, int KV, int G, int P, int ps, int PP, int split_pages,
    float sm_scale, float kv_scale) {
  constexpr int ST = tc_stages<PT>();
  constexpr int RAW = tc_raw_bytes<PT>();
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* q_s = smem;                            // [ROWS] swizzled bf16 rows
  unsigned char* ring = q_s + ROWS * BF16_ROW_BYTES;    // [ST][K|V][KT] raw page rows
  unsigned char* wide = ring + ST * 2 * RAW;            // [K|V][KT] bf16 (non-bf16 pages)

  const int H = KV * G;
  const int kvh = blockIdx.x, j = blockIdx.z;
  const bool direct = gridDim.z == 1;
  const int nseq = num_seqs[0];
  const Slot sl = resolve_slot(cu_q_lens, nseq, G, SMALL_SLICES);
  if (sl.s < 0) {  // uniform across the block
    if (direct) zero_padding(out, cu_q_lens[nseq], sl.qb, T, H, G, kvh);
    return;
  }
  const int s = sl.s;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int QB = ROWS / G;
  const int q_start = cu_q_lens[s];
  const int q_len = cu_q_lens[s + 1] - q_start;
  const int kv_len = kv_lens[s];
  const int i0 = sl.qb * QB;               // first in-row token of the block
  const int i_end = min(q_len, i0 + QB);   // one past its last
  const int kstart = j * split_pages * ps;
  const int split_end = min(kv_len, (j + 1) * split_pages * ps);
  const int qoff = kv_len - q_len;         // context position of in-row token 0
  const int kend = min(split_end, qoff + i_end);  // the block's last causal bound
  // A block whose rows fit one m16 tile (decode tokens riding a mixed step,
  // a row's short tail) would leave 3 warps idle and one walking the whole
  // context: it takes one of SMALL_SLICES slices of the keys, and its 4
  // warps split the slice, each with its own ring.
  const bool split_keys = (i_end - i0) * G <= RW;
  const int base = split_keys ? 0 : warp * RW;  // this warp's first row

  // Query rows into shared memory (row r: token i0 + r / G, head kvh*G + r % G),
  // zeros past the block's tokens.
  for (int i = tid; i < ROWS * 16; i += THREADS) {
    const int r = i >> 4, c = i & 15;
    const int tok = i0 + r / G;
    const bool ok = tok < i_end;
    const __nv_bfloat16* src =
        q + (static_cast<size_t>(q_start + (ok ? tok : i0)) * H + kvh * G + r % G) * HEAD_DIM + c * 8;
    cp_async16_zfill(q_s + swz(r, c), src, ok);
  }
  cp_async_commit();

  const int* table = page_indices + static_cast<size_t>(s) * PP;
  const size_t slot_bytes = static_cast<size_t>(2 * KV) * HEAD_DIM * sizeof(PT);
  const unsigned char* head_base =
      reinterpret_cast<const unsigned char*>(pages) + static_cast<size_t>(2 * kvh) * HEAD_DIM * sizeof(PT);
  const int ntiles = !split_keys && kend > kstart ? (kend - kstart + KT - 1) / KT : 0;
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {
    if (t < ntiles) {
      unsigned char* st = ring + t * 2 * RAW;
      stage_kv<PT, KT>(st, st + RAW, head_base, table, kstart + t * KT, kend, ps, PP, P, slot_bytes, tid,
                       THREADS);
    }
    cp_async_commit();
  }
  cp_async_wait<ST - 1>();  // the queries have landed
  __syncthreads();

  uint32_t qa[8][4];  // this warp's 16 rows x 128 dims as 8 A fragments
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) ldsm_x4(qa[kk], q_s + swz(base + (lane & 15), kk * 2 + (lane >> 4)));

  // The two rows whose fragments this lane holds (base + g, + 8): one past
  // the last key each may see (0 for rows past the block's tokens).
  int lim[2], row_tok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row_tok[h] = i0 + (base + g + 8 * h) / G;
    lim[h] = row_tok[h] < i_end ? min(split_end, qoff + row_tok[h] + 1) : 0;
  }
  // Warp-wide: keys below lo_lim need no mask; none at or past hi_lim is seen.
  const int tok_lo = i0 + base / G;
  const int tok_hi = min(i_end - 1, i0 + (base + RW - 1) / G);
  const bool warp_on = tok_lo < i_end;
  const int lo_lim = min(split_end, qoff + tok_lo + 1);
  const int hi_lim = min(split_end, qoff + tok_hi + 1);

  float o[16][4];
#pragma unroll
  for (int dt = 0; dt < 16; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const float sc = sm_scale * kv_scale * LOG2E;

  if (split_keys) {
    constexpr int WRING = ST * 2 * RAW / WARPS;  // a warp's ring: ST stages of 16 keys
    const int slen = (max(kend - kstart, 0) + SMALL_SLICES * 16 - 1) / (SMALL_SLICES * 16) * 16;
    const int ks = kstart + sl.slice * slen;
    warp_ring_loop<PT, ST>(ring + warp * WRING, wide + warp * 2 * (KT / WARPS) * BF16_ROW_BYTES, head_base,
                           table, ks, min(kend, ks + slen), ps, PP, P, slot_bytes, warp, WARPS,
                           [&](const unsigned char* kt, const unsigned char* vt, int k0) {
                             attend_tile<2>(qa, kt, vt, k0, lim, k0 + 16 > lo_lim, sc, m, l, o);
                           });
  } else {
    for (int t = 0; t < ntiles; ++t) {
      cp_async_wait<ST - 2>();  // tile t has landed (this thread's copies)
      __syncthreads();          // ... everyone's; and tile t-1 is consumed
      {
        const int tn = t + ST - 1;
        if (tn < ntiles) {
          unsigned char* st = ring + (tn % ST) * 2 * RAW;
          stage_kv<PT, KT>(st, st + RAW, head_base, table, kstart + tn * KT, kend, ps, PP, P, slot_bytes,
                           tid, THREADS);
        }
        cp_async_commit();
      }
      const unsigned char* kt = ring + (t % ST) * 2 * RAW;
      const unsigned char* vt = kt + RAW;
      if constexpr (sizeof(PT) != 2) {
        widen_tile<PT, KT>(wide, kt, tid, THREADS);
        widen_tile<PT, KT>(wide + KT * BF16_ROW_BYTES, vt, tid, THREADS);
        __syncthreads();
        kt = wide;
        vt = wide + KT * BF16_ROW_BYTES;
      }
      const int k0 = kstart + t * KT;
      if (warp_on && k0 < hi_lim) attend_tile<KT / 8>(qa, kt, vt, k0, lim, k0 + KT > lo_lim, sc, m, l, o);
    }
    cp_async_wait<0>();  // no copy may outlive the block
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }

  if (split_keys) {
    // Merge the 4 warps' states of rows 0..15 through shared memory (the
    // rings are done) into this slice's partial; warp w handles rows w,
    // w+4, .. with a lane owning 4 dims.  The last slice of the q-block to
    // arrive merges the slices' partials and writes the rows.
    __syncthreads();
    float* acc_s = reinterpret_cast<float*>(ring);  // [WARPS][RW][D]
    float* ml_s = acc_s + WARPS * RW * HEAD_DIM;    // [WARPS][RW][2]
    int* last_s = reinterpret_cast<int*>(ml_s + WARPS * RW * 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
#pragma unroll
      for (int dt = 0; dt < 16; ++dt)
        *reinterpret_cast<float2*>(acc_s + (warp * RW + r) * HEAD_DIM + dt * 8 + tig * 2) =
            make_float2(o[dt][2 * h], o[dt][2 * h + 1]);
      if (tig == 0) {
        ml_s[(warp * RW + r) * 2] = m[h];
        ml_s[(warp * RW + r) * 2 + 1] = l[h];
      }
    }
    __syncthreads();
    const size_t qblk = (static_cast<size_t>(j) * S + s) * KV + kvh;  // one small q-block per row
    for (int r = warp; r < RW; r += WARPS) {
      float mm = NEG_INF;
      for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, ml_s[(w * RW + r) * 2]);
      float ll = 0.f;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int w = 0; w < WARPS; ++w) {
        const float a = exp2f(ml_s[(w * RW + r) * 2] - mm);
        ll += a * ml_s[(w * RW + r) * 2 + 1];
        acc = fma4(a, *reinterpret_cast<const float4*>(acc_s + (w * RW + r) * HEAD_DIM + lane * DPL), acc);
      }
      const size_t part = (qblk * SMALL_SLICES + sl.slice) * RW + r;
      store4(slice_o + part * HEAD_DIM + lane * DPL, acc);
      if (lane == 0) {
        slice_ml[part * 2] = mm;
        slice_ml[part * 2 + 1] = ll;
      }
    }
    __threadfence();  // this slice's partial is visible before it is counted
    __syncthreads();
    if (tid == 0) *last_s = atomicAdd(slice_cnt + qblk, 1) == SMALL_SLICES - 1;
    __syncthreads();
    if (!*last_s) return;
    __threadfence();
    for (int r = warp; r < RW; r += WARPS) {
      const int tok = i0 + r / G;
      if (tok >= i_end) continue;
      float mm = NEG_INF;
      for (int k = 0; k < SMALL_SLICES; ++k)
        mm = fmaxf(mm, __ldcg(slice_ml + ((qblk * SMALL_SLICES + k) * RW + r) * 2));
      float ll = 0.f;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = 0; k < SMALL_SLICES; ++k) {
        const size_t part = (qblk * SMALL_SLICES + k) * RW + r;
        const float a = exp2f(__ldcg(slice_ml + part * 2) - mm);
        ll += a * __ldcg(slice_ml + part * 2 + 1);
        acc = fma4(a, __ldcg(reinterpret_cast<const float4*>(slice_o + part * HEAD_DIM + lane * DPL)), acc);
      }
      const size_t row = static_cast<size_t>(q_start + tok) * H + kvh * G + r % G;
      if (direct) {
        store4(out + row * HEAD_DIM + lane * DPL, scale4(acc, kv_scale / (ll + 1e-30f)));
      } else {
        const size_t idx = static_cast<size_t>(j) * T * H + row;
        store4(o_part + idx * HEAD_DIM + lane * DPL, scale4(acc, kv_scale));
        if (lane == 0) {
          m_part[idx] = mm * LN2;
          l_part[idx] = ll;
        }
      }
    }
    if (tid == 0) slice_cnt[qblk] = 0;  // ready for the next launch
    return;
  }

  // Stores for the block's own tokens only: nothing spills into the next
  // row's region.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row_tok[h] >= i_end) continue;
    const size_t row = static_cast<size_t>(q_start + row_tok[h]) * H + kvh * G + (base + g + 8 * h) % G;
    if (direct) {
      // kv_scale dequantizes V: sum p*(v*s) == s * sum p*v.
      const float inv = kv_scale / (l[h] + 1e-30f);
      __nv_bfloat16* dst = out + row * HEAD_DIM + tig * 2;
#pragma unroll
      for (int dt = 0; dt < 16; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8) =
            __floats2bfloat162_rn(o[dt][2 * h] * inv, o[dt][2 * h + 1] * inv);
    } else {
      const size_t idx = static_cast<size_t>(j) * T * H + row;
      float* dst = o_part + idx * HEAD_DIM + tig * 2;
#pragma unroll
      for (int dt = 0; dt < 16; ++dt)
        *reinterpret_cast<float2*>(dst + dt * 8) = make_float2(o[dt][2 * h] * kv_scale, o[dt][2 * h + 1] * kv_scale);
      if (tig == 0) {
        m_part[idx] = m[h] * LN2;  // natural-log units for the combine
        l_part[idx] = l[h];
      }
    }
  }
}

// ------------------------------------------------- CUDA-core body (f32 q)

constexpr int TILE = 32;               // keys per staged tile
constexpr int KSTRIDE = HEAD_DIM + 4;  // padded K rows: conflict-free float4 reads
constexpr size_t F32_SMEM_BYTES =
    sizeof(float) * (ROWS * HEAD_DIM + TILE * KSTRIDE + TILE * HEAD_DIM + WARPS * RW * TILE);

// The first version's body, kept for f32 queries: a lane owns one key for
// q.k and four head-dim values for p.V, all in f32 on the CUDA cores.
template <typename PT>
__global__ void __launch_bounds__(THREADS) prefill_f32_kernel(
    const float* __restrict__ q, const PT* __restrict__ pages,
    const int* __restrict__ kv_lens, const int* __restrict__ page_indices,
    const int* __restrict__ cu_q_lens, const int* __restrict__ num_seqs,
    float* __restrict__ o_part, float* __restrict__ m_part,
    float* __restrict__ l_part, float* __restrict__ out, int T, int KV, int G,
    int P, int ps, int PP, int split_pages, float sm_scale, float kv_scale) {
  extern __shared__ __align__(16) float fsmem[];
  float* q_s = fsmem;                     // [ROWS][HEAD_DIM]
  float* k_s = q_s + ROWS * HEAD_DIM;     // [TILE][KSTRIDE]
  float* v_s = k_s + TILE * KSTRIDE;      // [TILE][HEAD_DIM]
  float* p_s = v_s + TILE * HEAD_DIM;     // [WARPS][RW][TILE]

  const int H = KV * G;
  const int kvh = blockIdx.x, j = blockIdx.z;
  const bool direct = gridDim.z == 1;
  const int nseq = num_seqs[0];
  const Slot sl = resolve_slot(cu_q_lens, nseq, G, 1);
  if (sl.s < 0) {
    if (direct) zero_padding(out, cu_q_lens[nseq], sl.qb, T, H, G, kvh);
    return;
  }
  const int s = sl.s;
  const int QB = ROWS / G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q_start = cu_q_lens[s];
  const int q_len = cu_q_lens[s + 1] - q_start;
  const int kv_len = kv_lens[s];
  const int i0 = sl.qb * QB;
  const int i_end = min(q_len, i0 + QB);
  const int kstart = j * split_pages * ps;
  const int split_end = min(kv_len, (j + 1) * split_pages * ps);
  const int kend = min(split_end, kv_len - q_len + i_end);
  const float sc = kv_scale * LOG2E;

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

    float scr[RW];
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) scr[rr] = 0.f;
    const float* kr = k_s + lane * KSTRIDE;
#pragma unroll 2
    for (int d = 0; d < HEAD_DIM; d += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int rr = 0; rr < RW; ++rr)
        scr[rr] += dot4(*reinterpret_cast<const float4*>(q_s + (row0 + rr) * HEAD_DIM + d), k4);
    }
    const int key = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const int tok = i0 + (row0 + rr) / G;
      const int qpos = kv_len - q_len + tok;
      const bool valid = tok < i_end && key < kend && key <= qpos;
      const float x = valid ? scr[rr] * sc : NEG_INF;
      const float mn = fmaxf(m[rr], warp_max(x));
      const float p = valid ? exp2f(x - mn) : 0.f;
      const float alpha = exp2f(m[rr] - mn);
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

#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int r = row0 + rr;
    const int tok = i0 + r / G;
    if (tok >= i_end) continue;
    const size_t row = static_cast<size_t>(q_start + tok) * H + kvh * G + r % G;
    if (direct) {
      const float inv = kv_scale / (l[rr] + 1e-30f);
      store4(out + row * HEAD_DIM + lane * DPL, scale4(acc[rr], inv));
    } else {
      const size_t idx = static_cast<size_t>(j) * T * H + row;
      store4(o_part + idx * HEAD_DIM + lane * DPL, scale4(acc[rr], kv_scale));
      if (lane == 0) {
        m_part[idx] = m[rr] * LN2;
        l_part[idx] = l[rr];
      }
    }
  }
}

// ---------------------------------------------------------------- launch

template <typename QT, typename PT>
int launch_typed(const void* q, const void* pages, const int* kv_lens,
                 const int* page_indices, const int* cu_q_lens,
                 const int* num_seqs, float* o_part, float* m_part,
                 float* l_part, void* out, float* slice_o, float* slice_ml,
                 int* slice_cnt, int slots, int T, int S, int KV, int G, int P,
                 int ps, int PP, int J, int split_pages, float sm_scale,
                 float kv_scale, cudaStream_t stream) {
  constexpr bool TC = sizeof(QT) == 2;  // bf16 q: tensor cores; f32 q: CUDA cores
  const size_t smem = TC ? tc_smem_bytes<PT>() : F32_SMEM_BYTES;
  // Above 48 KB of shared memory a block needs the opt-in, once per kernel.
  static bool configured = false;
  if (!configured) {
    cudaError_t e;
    if constexpr (TC)
      e = cudaFuncSetAttribute(prefill_tc_kernel<PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    else
      e = cudaFuncSetAttribute(prefill_f32_kernel<PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(KV, slots, J);
  if constexpr (TC)
    prefill_tc_kernel<PT><<<grid, THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const PT*>(pages), kv_lens, page_indices,
        cu_q_lens, num_seqs, o_part, m_part, l_part, static_cast<__nv_bfloat16*>(out), slice_o, slice_ml,
        slice_cnt, T, S, KV, G, P, ps, PP, split_pages, sm_scale, kv_scale);
  else
    prefill_f32_kernel<PT><<<grid, THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const PT*>(pages), kv_lens, page_indices, cu_q_lens,
        num_seqs, o_part, m_part, l_part, static_cast<float*>(out), T, KV, G, P, ps, PP, split_pages,
        sm_scale, kv_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || J == 1) return static_cast<int>(err);
  lse_combine_kernel<QT><<<dim3(T, KV * G), 32, 0, stream>>>(
      o_part, m_part, l_part, static_cast<QT*>(out), cu_q_lens, num_seqs, nullptr, 0, T, KV * G, J);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int launch_pages(int page_dtype, const void* q, const void* pages,
                 const int* kv_lens, const int* page_indices,
                 const int* cu_q_lens, const int* num_seqs, float* o_part,
                 float* m_part, float* l_part, void* out, float* slice_o,
                 float* slice_ml, int* slice_cnt, int slots, int T, int S, int KV,
                 int G, int P, int ps, int PP, int J, int split_pages,
                 float sm_scale, float kv_scale, cudaStream_t stream) {
#define DYN_LAUNCH(PT)                                                        \
  return launch_typed<QT, PT>(q, pages, kv_lens, page_indices, cu_q_lens,    \
                              num_seqs, o_part, m_part, l_part, out,         \
                              slice_o, slice_ml, slice_cnt, slots, T, S,     \
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

// Launches the partial kernel on ``stream`` and, for J > 1 splits, the LSE
// combine; with J = 1 the partial kernel writes ``out`` itself and the
// partial buffers may be null.  bf16 queries also take the key-slice
// scratch of small q-blocks (slice_o / slice_ml, and slice_cnt, J*S*KV
// counters that are zero before the launch and left zero after it); f32
// queries pass nulls.  ``slots``: block slots per KV head and split
// (ops/prefill_attention.py prefill_slots).  Returns the cudaGetLastError()
// code of the launches (0 = accepted).
extern "C" int prefill_attention_launch(
    const void* q, const void* pages, const int* kv_lens,
    const int* page_indices, const int* cu_q_lens, const int* num_seqs,
    float* o_part, float* m_part, float* l_part, void* out, float* slice_o,
    float* slice_ml, int* slice_cnt, int slots, int T, int S, int KV, int G,
    int P, int ps, int PP, int J, int split_pages, int q_dtype, int page_dtype,
    float sm_scale, float kv_scale, void* stream) {
  if (G < 1 || ROWS % G != 0 || slots < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case F32:
      return launch_pages<float>(page_dtype, q, pages, kv_lens, page_indices,
                                 cu_q_lens, num_seqs, o_part, m_part, l_part,
                                 out, slice_o, slice_ml, slice_cnt, slots, T,
                                 S, KV, G, P, ps, PP, J, split_pages,
                                 sm_scale, kv_scale, st);
    case BF16:
      if (slice_o == nullptr || slice_ml == nullptr || slice_cnt == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
      return launch_pages<__nv_bfloat16>(
          page_dtype, q, pages, kv_lens, page_indices, cu_q_lens, num_seqs,
          o_part, m_part, l_part, out, slice_o, slice_ml, slice_cnt, slots, T,
          S, KV, G, P, ps, PP, J, split_pages, sm_scale, kv_scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Transposed flash attention forward (the layout probe), packed heads, bf16,
// for Hopper (sm_90a): kernel 9.
//
// Replaces: tools/microbench.py, `probe_pvt`'s Pallas kernel `kernel_t`
// (:405, launched by its `flash_t`, `pallas_call` :482): a flash forward
// computed transposed, logits^T = K Q^T with the softmax taken down each
// column, and acc^T = [V^T; 1] P^T, which yields out and the column sums at
// once. It is a standalone copy of kernel A's function, kept to time the
// orientation against kernel A (csrc/flash_attention.cu); no path of the
// port runs it.
//
// Computes, for each batch row b, head h and query column, with q already
// scaled by d^-1/2 * log2(e) and rounded to bf16 by the wrapper (as the JAX
// probe folds the scale into q):
//   s^T = k_h qs_h^T + bias[b] * log2(e)   (keys down, queries across)
//   m = max over keys, p = exp2(s^T - m), l = sum over keys of bf16(p)
//   out_h = (v_h^T p / l)^T,   lse = m + log2(l)   (log2 units)
// in an online pass over 128-key tiles, p rounded to bf16 before the PV
// product, and l summed from the rounded p in fp32 by the tensor cores (a
// ones row under V^T), as `kernel_t` sums it. q/out are (B, Lq, heads*d),
// k/v (B, Lk, heads*d), bias fp32 (B, Lk) or absent, lse fp32 (B, heads, Lq).
//
// What bounds it on the H100: the tensor cores on paper, as kernel A (4 *
// Lq * Lk * d FLOPs per head, 2.3 TFLOP at 24 x 8 heads x 6144 x 12288, d =
// 40, against ~0.1 GB of traffic), and at d = 40, as in kernel A, the
// consumers' instruction issue first. The orientation adds two costs of its
// own: O^T's M axis is d padded to 64 (with the ones row; (48 + 64) / (48 +
// 40) = 1.27x kernel A's tensor work at d = 40), and a query's keys lie
// across the 4 warps of a warpgroup, so its column max crosses warps
// through shared memory once per key tile.
//
// Design: kernel A's machinery (flash_attention.cu) in the probe's
// orientation. A block is 1 producer warpgroup, whose first warp keeps TMA
// loads of K, V and the keys' bias (log2 units, -inf past Lk) in flight in a
// 3-stage mbarrier ring and whose registers `setmaxnreg` moves to the
// consumers, and NC consumer warpgroups that own 64 queries each (BQ =
// 64 NC); Q stays resident for the block's whole loop. Per 128-key tile a
// consumer warpgroup computes
//   S^T = K Q^T        two wgmma m64n64k16 stacked (keys 0-63, 64-127), A =
//                      K and B = Q from shared memory, both K-major over d
//                      padded to 48 (80);
//   column max         in-thread over its 4 keys of a column, a butterfly of
//                      shuffles across the 8 lanes that share columns (14
//                      shuffles leave each lane 2 of the warp's 64 columns),
//                      then the 4 warps' maxima through shared memory under
//                      a warpgroup named barrier: one exchange per 128 keys;
//                      the new max and the rescale factor go back to every
//                      lane by shuffles;
//   P^T                exp2(s^T - m) in place, rounded to bf16 and staged in
//                      shared memory by `stmatrix` (wgmma reads B only from
//                      there), behind a proxy fence and a second named
//                      barrier;
//   O^T += V^T P^T     wgmma m64n64k16 with A = V^T, read MN-major from the
//                      key-major V tile (the transpose bit), and B = P^T,
//                      MN-major; M = d + 1 rows padded to 64 (128 at d >
//                      40): the rows under the head are V^T, row d is ones
//                      (a slab written once at the start, never by TMA), so
//                      O^T's row d is l.
// O^T's columns are the same queries as S^T's, so the rescale by the moved
// max reads the same per-column factors. The epilogue divides by l, stages
// O in shared memory (the P^T buffer) and stores it in 16-byte rows; lse =
// m + log2(l). TMA maps are 3-D (C, L, B) with boxes of 8 columns (a 40-wide
// head is no multiple of a swizzle row), so a ragged tile reads zeros and
// never the next batch row; keys >= Lk get -inf through the bias words.
// No atomics: the same inputs give the same bits.
//
// The un-transposed variant (kTransposedPV = false, timed by `python -m
// humanvid_tpu_torch.tools.flash_variants --pvt`): O (64 queries x [V | 1],
// N = d + 1 padded to 8: 48 at d = 40) += P V with A = P read MN-major from
// the same staged P^T and B = V, MN-major, as kernel A's product; only the
// per-row rescale and l move between lanes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kLog2e = 1.4426950408889634f;
constexpr bool kTransposedPV = true;  // O^T += V^T P^T; false: O += P V

// DQK: S^T's contracted depth (d padded to 16); MT: m64 tiles of O^T's rows
// (d + 1 padded to 64); NV: the un-transposed variant's N (d + 1 padded to
// 8); NC: consumer warpgroups of 64 queries.
template <int DQK_, int MT_, int NV_, int NC_>
struct PvtCfg {
  static constexpr int DQK = DQK_;
  static constexpr int MT = MT_;
  static constexpr int NV = NV_;
  static constexpr int NC = NC_;
  static constexpr int THREADS = 128 * (NC + 1);  // + the producer warpgroup
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = NC == 2 ? 240 : 160;
  static_assert(128 * (PRODUCER_REGS + NC * CONSUMER_REGS) <= 65536, "registers");
  static constexpr int BQ = 64 * NC;  // queries per block
  static constexpr int BK = 128;      // keys per stage
  static constexpr int STAGES = 3;
  static constexpr int VS = 8 * MT;   // 8-column slabs of a V stage: V^T's rows
  static_assert(NV <= 8 * VS, "the variant's N reads the V slabs");
  static constexpr int Q_BYTES = BQ * DQK * 2;
  static constexpr int K_BYTES = BK * DQK * 2;
  static constexpr int V_BYTES = BK * VS * 16;
  static constexpr int P_BYTES = BK * 64 * 2;  // one warpgroup's P^T (keys x 64 queries)
  // shared memory: Q, K ring, V ring, bias ring, P^T per consumer, column
  // maxima per consumer warp (at the end: l), barriers (1024-aligned tiles)
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * K_BYTES;
  static constexpr int OFF_P = OFF_V + STAGES * V_BYTES;
  static constexpr int OFF_BIAS = OFF_P + NC * P_BYTES;
  static constexpr int OFF_RED = OFF_BIAS + STAGES * BK * 4;
  static constexpr int OFF_BAR = OFF_RED + NC * 4 * 64 * 4;
  static constexpr int SMEM = OFF_BAR + (3 * STAGES + 1) * 8 + 1024;  // + alignment
  static_assert(Q_BYTES % 1024 == 0 && K_BYTES % 1024 == 0 && V_BYTES % 1024 == 0, "");
  static_assert(SMEM <= 232448, "shared memory");
};

// D (64 x N) = A B over 16 deep, both operands MN-major (the transpose bits).
template <int N>
__device__ __forceinline__ void wgmma_tt(float (&d)[N / 2], uint64_t da, uint64_t db) {
  WgmmaSSt<N>::template run<1, 1>(d, da, db, 1);
}

template <class C, bool PVT>
__global__ void __launch_bounds__(C::THREADS, 1)
probe_pvt_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, const float* __restrict__ bias,
                 bf16* __restrict__ out, float* __restrict__ lse, int Lq, int Lk, int heads,
                 int d) {
  constexpr int BQ = C::BQ, BK = C::BK, STAGES = C::STAGES, DQK = C::DQK, MT = C::MT;
  constexpr int NC = C::NC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sQ = smem;
  unsigned char* sK = smem + C::OFF_K;
  unsigned char* sV = smem + C::OFF_V;
  float* sBias = reinterpret_cast<float*>(smem + C::OFF_BIAS);
  uint64_t* full_k = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);  // K and bias
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty = full_v + STAGES;
  uint64_t* full_q = empty + STAGES;

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C_all = heads * d;
  const int n_kv = (Lk + BK - 1) / BK;
  const int n_box = d / 8;  // 8-column TMA boxes of a head

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 32);  // the producer warp's lanes (bias writes)
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], 4 * NC);  // one arrival per consumer warp
    }
    mbar_init(full_q, 1);
    fence_barrier_init();
  }
  // Slabs TMA never writes, set once: the contracted pad of Q and of every K
  // stage (zeros), and in every V stage slab n_box holding ones in its first
  // column (V^T's row d, which sums l) and zeros after it.
  for (int s = -1; s < STAGES; ++s) {
    unsigned char* tile = s < 0 ? sQ : sK + s * C::K_BYTES;
    const int rows = s < 0 ? BQ : BK;
    uint4* pad = reinterpret_cast<uint4*>(tile + n_box * rows * 16);
    const int n = (DQK / 8 - n_box) * rows;
    for (int i = threadIdx.x; i < n; i += C::THREADS) pad[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int s = 0; s < STAGES; ++s) {
    uint4* pad = reinterpret_cast<uint4*>(sV + s * C::V_BYTES + n_box * BK * 16);
    const int n = (C::VS - n_box) * BK;
    for (int i = threadIdx.x; i < n; i += C::THREADS)
      pad[i] = make_uint4(i < BK ? 0x3F80u : 0u, 0u, 0u, 0u);  // bf16 1.0 in column 0
  }
  fence_proxy_async();
  __syncthreads();

  if (wg == NC) {
    // ---------------- producer ----------------
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (warp != 0) return;
    const int col0 = h * d;
    if (lane == 0) {
      tma_prefetch_desc(&q_map);
      tma_prefetch_desc(&k_map);
      tma_prefetch_desc(&v_map);
      mbar_arrive_expect_tx(full_q, BQ * n_box * 16);
      for (int i = 0; i < n_box; ++i)
        tma_load_3d(sQ + i * BQ * 16, &q_map, full_q, col0 + 8 * i, q0, b);
    }
    for (int kt = 0; kt < n_kv; ++kt) {
      const int s = kt % STAGES;
      const int k0 = kt * BK;
      mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
      for (int c = lane; c < BK; c += 32) {
        const int key = k0 + c;
        sBias[s * BK + c] = key >= Lk ? -INFINITY
                                      : (bias ? bias[(size_t)b * Lk + key] * kLog2e : 0.f);
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full_k[s], BK * n_box * 16);
        for (int i = 0; i < n_box; ++i)
          tma_load_3d(sK + s * C::K_BYTES + i * BK * 16, &k_map, &full_k[s], col0 + 8 * i, k0,
                      b);
        mbar_arrive_expect_tx(&full_v[s], BK * n_box * 16);
        for (int i = 0; i < n_box; ++i)
          tma_load_3d(sV + s * C::V_BYTES + i * BK * 16, &v_map, &full_v[s], col0 + 8 * i, k0,
                      b);
      } else {
        mbar_arrive(&full_k[s]);
      }
    }
    return;
  }

  // ---------------- consumers ----------------
  setmaxnreg_inc<C::CONSUMER_REGS>();
  const int qoff = 64 * wg;  // this warpgroup's first query of the block
  const int g = lane / 4;
  const int c2 = 2 * (lane % 4);
  const int bar_id = 1 + wg;  // this warpgroup's named barrier
  unsigned char* sP = smem + C::OFF_P + wg * C::P_BYTES;
  float* red = reinterpret_cast<float*>(smem + C::OFF_RED) + wg * 4 * 64;

  // descriptors without their stage offsets. Every tile is [8-column slab]
  // [rows][8]: K-major (Q, K) LBO = rows*16, SBO = 128; MN-major (V^T as A,
  // P^T as B or P as A) LBO = 128 (8 keys), SBO = rows*16 (8 columns).
  const uint64_t q_desc = gmma_desc(smem_u32(sQ) + qoff * 16, BQ * 16, 128, kNoSwizzle);
  const uint64_t k_desc0 = gmma_desc(smem_u32(sK), BK * 16, 128, kNoSwizzle);
  const uint64_t v_desc0 = gmma_desc(smem_u32(sV), 128, BK * 16, kNoSwizzle);
  const uint64_t p_desc = gmma_desc(smem_u32(sP), 128, BK * 16, kNoSwizzle);

  // O^T (d rows x 64 queries; element 4j + e of tile mt: row mt*64 + 16 warp
  // + g + 8 (e >> 1), query 8j + c2 + (e & 1)) or, in the variant, O (64
  // queries x NV: query 16 warp + g + 8 (e >> 1), column 8j + c2 + (e & 1))
  constexpr int OM = PVT ? MT : 1, ON = PVT ? 32 : C::NV / 2;
  float o[OM][ON];
#pragma unroll
  for (int mt = 0; mt < OM; ++mt)
#pragma unroll
    for (int i = 0; i < ON; ++i) o[mt][i] = 0.f;
  // the running max of this lane's two columns, queries 8g + c2 and + 1
  float m_lane[2] = {-INFINITY, -INFINITY};
  const bool has_bias = bias != nullptr;

  mbar_wait(full_q, 0);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int s = kt % STAGES;
    const uint32_t parity = (kt / STAGES) & 1;
    mbar_wait(&full_k[s], parity);

    // S^T = K Q^T: st[half][4j + e] is key 64 half + 16 warp + g + 8 (e >> 1),
    // query 8j + c2 + (e & 1)
    float st[2][32];
    wgmma_fence();
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk)
        WgmmaSS<64>::run(st[half],
                         k_desc0 + ((s * C::K_BYTES + half * 64 * 16 + 2 * kk * BK * 16) >> 4),
                         q_desc + ((2 * kk * BQ * 16) >> 4), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st[0]);
    fence_regs(st[1]);

    // the keys' bias (log2 units; -inf past Lk), one word per accumulator row
    if (has_bias || (kt + 1) * BK > Lk) {
      const float* bt = sBias + s * BK + 16 * warp + g;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float b0 = bt[64 * half], b1 = bt[64 * half + 8];
#pragma unroll
        for (int i = 0; i < 32; ++i) st[half][i] += (i & 2) ? b1 : b0;
      }
    }

    // column maxima: over this thread's 4 keys, then a butterfly across the
    // 8 lanes of equal lane % 4 (lane bits 16, 8, 4 split the column blocks
    // j by their bits 4, 2, 1), leaving this lane queries 8g + c2 + e
    float v8[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        v8[j][e] = fmaxf(fmaxf(st[0][4 * j + e], st[0][4 * j + 2 + e]),
                         fmaxf(st[1][4 * j + e], st[1][4 * j + 2 + e]));
    float v4[4][2], v2[2][2], v1[2];
    {
      const bool up = lane & 16;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float send = up ? v8[j][e] : v8[j + 4][e];
          v4[j][e] = fmaxf(up ? v8[j + 4][e] : v8[j][e],
                           __shfl_xor_sync(0xffffffffu, send, 16));
        }
    }
    {
      const bool up = lane & 8;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float send = up ? v4[j][e] : v4[j + 2][e];
          v2[j][e] = fmaxf(up ? v4[j + 2][e] : v4[j][e], __shfl_xor_sync(0xffffffffu, send, 8));
        }
    }
    {
      const bool up = lane & 4;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float send = up ? v2[0][e] : v2[1][e];
        v1[e] = fmaxf(up ? v2[1][e] : v2[0][e], __shfl_xor_sync(0xffffffffu, send, 4));
      }
    }
    // the 4 warps' maxima through shared memory
    *reinterpret_cast<float2*>(red + warp * 64 + 8 * g + c2) = make_float2(v1[0], v1[1]);
    named_bar_sync(bar_id, 128);
    float m_use_l[2], alpha_l[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float x = fmaxf(fmaxf(red[8 * g + c2 + e], red[64 + 8 * g + c2 + e]),
                      fmaxf(red[128 + 8 * g + c2 + e], red[192 + 8 * g + c2 + e]));
      const float m_new = fmaxf(m_lane[e], x);
      // a column whose keys are all masked so far keeps p = 0, alpha = 0
      m_use_l[e] = m_new == -INFINITY ? 0.f : m_new;
      alpha_l[e] = fast_exp2(m_lane[e] - m_use_l[e]);
      m_lane[e] = m_new;
    }
    const bool moved = __any_sync(0xffffffffu, alpha_l[0] != 1.f || alpha_l[1] != 1.f);

    // p = exp2(s^T - m), the max of each column from the lane that owns it
    // (lane 4j + lane % 4 owns column block j)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float m0 = __shfl_sync(0xffffffffu, m_use_l[0], 4 * j + lane % 4);
      const float m1 = __shfl_sync(0xffffffffu, m_use_l[1], 4 * j + lane % 4);
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[half][4 * j + e] = fast_exp2(st[half][4 * j + e] - ((e & 1) ? m1 : m0));
    }
    // P^T to shared memory as bf16, 8 x 8 blocks by stmatrix: matrices
    // (rows g / g + 8, query blocks j / j + 1) of each half
    {
      const int mi = lane / 8;  // the matrix this lane addresses a row of
      const uint32_t row_addr = smem_u32(sP) + (16 * warp + 8 * (mi & 1) + lane % 8) * 16 +
                                (mi >> 1) * BK * 16;
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int j = 0; j < 8; j += 2)
          stmatrix_x4(row_addr + half * 64 * 16 + j * BK * 16,
                      pack_bf16x2(st[half][4 * j], st[half][4 * j + 1]),
                      pack_bf16x2(st[half][4 * j + 2], st[half][4 * j + 3]),
                      pack_bf16x2(st[half][4 * j + 4], st[half][4 * j + 5]),
                      pack_bf16x2(st[half][4 * j + 6], st[half][4 * j + 7]));
    }
    fence_proxy_async();  // the generic-proxy writes before wgmma reads them

    // rescale the accumulator where a max moved
    if (moved) {
      if constexpr (PVT) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float a0 = __shfl_sync(0xffffffffu, alpha_l[0], 4 * j + lane % 4);
          const float a1 = __shfl_sync(0xffffffffu, alpha_l[1], 4 * j + lane % 4);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[mt][4 * j + e] *= (e & 1) ? a1 : a0;
        }
      } else {
        // rows 16 warp + g + 8r: query column owned by lane 4 (2 warp + r) + g / 2
        float a[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int src = 4 * (2 * warp + r) + g / 2;
          const float x0 = __shfl_sync(0xffffffffu, alpha_l[0], src);
          const float x1 = __shfl_sync(0xffffffffu, alpha_l[1], src);
          a[r] = (g & 1) ? x1 : x0;
        }
#pragma unroll
        for (int i = 0; i < ON; ++i) o[0][i] *= a[(i >> 1) & 1];
      }
    }
    named_bar_sync(bar_id, 128);  // the warpgroup's P^T is whole

    mbar_wait(&full_v[s], parity);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      const uint32_t step = t * 256;  // 16 keys
      if constexpr (PVT) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          wgmma_tt<64>(o[mt], v_desc0 + ((s * C::V_BYTES + mt * 8 * BK * 16 + step) >> 4),
                       p_desc + (step >> 4));
      } else {
        wgmma_tt<C::NV>(o[0], p_desc + (step >> 4), v_desc0 + ((s * C::V_BYTES + step) >> 4));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < OM; ++mt) fence_regs(o[mt]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // ---- epilogue: l, out = O / l staged through shared memory, lse ----
  bf16* sO = reinterpret_cast<bf16*>(sP);  // 64 queries x OS, the P^T buffer reused
  constexpr int OS = C::NV + 8;            // row stride of the staged O (>= d), bf16
  const float* lsum = red;                 // l of the 64 queries
  if constexpr (PVT) {
    // l is O^T's row d: tile d / 64, warp (d % 64) / 16, g = d % 8, half
    // (d % 16) / 8. Those lanes write every (tile, half) candidate into the
    // free column-max slots and the row is picked there: a register array
    // indexed by d would be put in local memory.
    if (warp == (d % 64) / 16 && g == d % 8) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<float2*>(red + (2 * mt + r) * 64 + 8 * j + c2) =
                make_float2(o[mt][4 * j + 2 * r], o[mt][4 * j + 2 * r + 1]);
    }
    named_bar_sync(bar_id, 128);  // l is whole; every P^T read is done
    lsum = red + (2 * (d / 64) + (d % 16) / 8) * 64;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(lsum + 8 * j + c2);
      const float inv[2] = {1.f / l.x, 1.f / l.y};
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = mt * 64 + 16 * warp + g + 8 * (e >> 1);  // head column
          if (row < d)
            sO[(8 * j + c2 + (e & 1)) * OS + row] =
                __float2bfloat16_rn(o[mt][4 * j + e] * inv[e & 1]);
        }
    }
  } else {
    // l is O's column d: lane 4g of each quad holds it (d % 8 == 0)
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < C::NV / 8; ++j)
      if (j == d / 8) {  // constant indices into o
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = o[0][4 * j + 2 * r];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = __shfl_sync(0xffffffffu, l[r], lane & ~3);
    if (lane % 4 == 0) {
      red[16 * warp + g] = l[0];
      red[16 * warp + g + 8] = l[1];
    }
    named_bar_sync(bar_id, 128);  // l is whole; every P^T read is done
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv = 1.f / l[r];
#pragma unroll
      for (int j = 0; j < C::NV / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(sO + (16 * warp + g + 8 * r) * OS + 8 * j + c2) =
            __floats2bfloat162_rn(o[0][4 * j + 2 * r] * inv, o[0][4 * j + 2 * r + 1] * inv);
    }
  }
  named_bar_sync(bar_id, 128);  // sO is whole
  // lse of this lane's two columns, log2 units; warp 0 covers the 64 queries
  if (warp == 0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = q0 + qoff + 8 * g + c2 + e;
      if (q < Lq)
        lse[((size_t)b * heads + h) * Lq + q] = m_lane[e] + log2f(lsum[8 * g + c2 + e]);
    }
  }
  const int vecs = d / 8;
  for (int i = threadIdx.x % 128; i < 64 * vecs; i += 128) {
    const int r = i / vecs, v = i % vecs;
    const int q = q0 + qoff + r;
    if (q < Lq)
      *reinterpret_cast<uint4*>(out + ((size_t)b * Lq + q) * C_all + (size_t)h * d + 8 * v) =
          *reinterpret_cast<const uint4*>(sO + r * OS + 8 * v);
  }
}

template <class C>
int launch(const void* qs, const void* k, const void* v, const void* bias, void* out, void* lse,
           int B, int Lq, int Lk, int heads, int d, cudaStream_t stream) {
  CUtensorMap maps[3];
  const int C_all = heads * d;
  int err = make_map(&maps[0], qs, C_all, Lq, B, 8, C::BQ, false);
  if (!err) err = make_map(&maps[1], k, C_all, Lk, B, 8, C::BK, false);
  if (!err) err = make_map(&maps[2], v, C_all, Lk, B, 8, C::BK, false);
  if (err) return err;
  auto kernel = probe_pvt_kernel<C, kTransposedPV>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Lq + C::BQ - 1) / C::BQ, heads, B);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const float*>(bias), static_cast<bf16*>(out),
      static_cast<float*>(lse), Lq, Lk, heads, d);
  return (int)cudaGetLastError();
}

}  // namespace

// Head widths: d a multiple of 8 with d <= 80: S^T contracted over 48 (d <=
// 40, O^T's rows in one m64 tile, 3 consumer warpgroups) or 80 (two m64
// tiles, 2 consumers).
extern "C" int hv_probe_pvt(const void* qs, const void* k, const void* v, const void* bias,
                            void* out, void* lse, int B, int Lq, int Lk, int heads, int d,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d % 8 != 0) return (int)cudaErrorInvalidValue;
  if (d <= 40)
    return launch<PvtCfg<48, 1, 48, 3>>(qs, k, v, bias, out, lse, B, Lq, Lk, heads, d, s);
  if (d <= 80)
    return launch<PvtCfg<80, 2, 88, 2>>(qs, k, v, bias, out, lse, B, Lq, Lk, heads, d, s);
  return (int)cudaErrorInvalidValue;
}

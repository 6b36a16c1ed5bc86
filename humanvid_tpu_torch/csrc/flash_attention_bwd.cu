// Flash attention backward, packed heads, bf16, for Hopper (sm_90a).
//
// Replaces: humanvid_tpu/ops/flash_attention.py, the Pallas kernels
// `_dkv_kernel_t` (:415, dk/dv; `pallas_call` :636) and `_dq_kernel_t`
// (:479, dq; :673), launched by `_flash_bwd_kernel` for heads with d <= 128,
// and the straight-layout `_dkv_kernel` (:354) and `_dq_kernel` (:537) it
// takes for d > 128 (here d = 512, the VAE mid block's single head, and
// every d > 512 in the xwide kernels at the end of this file).
//
// Computes the gradient of out_h = softmax(q_h k_h^T * d_s^-1/2 + bias[b]) v_h
// (the forward of csrc/flash_attention.cu; d_s = `scale_d`, the true width
// of a head the wrapper zero-pads, else d) given g = dL/dout, the forward's
// per-(row, head) log-sum-exp `lse` (B, heads, Lq) in NATURAL-log units and
// delta = rowsum(g * out) per (row, head) (B, heads, Lq), fp32:
//   p  = exp2((s * scale + bias) * log2e - lse * log2e),   s = q_h k_h^T
//   dv = p^T g_h
//   ds = p * (g_h v_h^T - delta)
//   dk = ds^T q_h * scale,   dq = ds k_h * scale,   scale = d_s^-1/2
// with p and ds rounded to bf16 before their products, as the JAX kernels
// do. q/g/dq are (B, Lq, heads*d), k/v/dk/dv (B, Lk, heads*d), the bias is
// fp32 (B, Lk) or absent. A key hidden by a -1e9 bias gets p == 0 exactly
// in every row, hence exactly zero dk and dv.
//
// What bounds it on the H100: the five (Lq x Lk x d) products per head
// (recomputed s, dp, dv, dk, dq; 10 * Lq * Lk * d FLOPs, 7.9 TFLOP or 8.0 ms
// at the 989 TFLOP/s peak at the stage-2 level-0 shape, d = 40) against
// ~0.2 GB of device-memory traffic: the tensor cores, on paper. Three more
// limits sit close to them. With no atomics, each of the two kernels
// recomputes p, one SFU exp2 per (q, key) pair: at 16 a clock per SM ~5 ms
// per kernel at level 0, as long as the products at d = 40. Each block
// streams the other side's tiles from L2 once (Q and G for every key block,
// K and V for every q block), in boxes of 16- or 32-byte rows. And each
// consumer's step is a chain (s and dp, then p, then dv / ds, then dk or
// dq) that only other warpgroups can overlap.
//
// Design at d <= 80 (the UNet's heads): FlashAttention-3's block shape, two
// kernels and no atomics. A block is one producer warp (in a warpgroup of
// its own, whose registers `setmaxnreg` moves to the consumers) and NC
// consumer warpgroups of 64 rows each that run `wgmma`. The producer loads
// the block's own two tiles once by TMA and keeps the streamed two tiles of
// every step in flight in a 3-stage mbarrier ring (full/empty pairs), with
// per-row words its lanes read from device memory before the stage is free
// and write beside them.
//   dk/dv (`flash_bwd_dkv_kernel`): grid (key blocks, heads, B). Each
//     consumer owns 64 keys of K and V; the ring carries the Q and G tiles
//     of 64-row q steps, with -lse*log2e and delta of their rows. Per step:
//       S^T = K Q^T, dP^T = V G^T   wgmma m64n64k16, both operands from
//                                   shared memory, K-major, depth d padded
//                                   to 48 / 80;
//       P^T, dS^T                   on the fp32 accumulators: the key's bias
//                                   is a register per row, lse and delta
//                                   vary along N;
//       dV += P^T G, dK += dS^T Q   wgmma m64n40k16 / m64n80k16 with A = the
//                                   accumulators packed to bf16 (registers)
//                                   and B = G / Q from shared memory,
//                                   MN-major (q rows contracted); dV's
//                                   product runs while dS^T is computed.
//     dK * scale and dV are written once, in bf16. NC = 3 at d <= 40 (192
//     keys a block: 160 registers hold S^T, dP^T, dK, dV and the packed
//     P^T, dS^T), 2 at d <= 80 (128 keys; 240 registers, 80 of them dK, dV).
//   dq (`flash_bwd_dq_kernel`): grid (q blocks, heads, B), the forward's
//     loop with one more product. Each consumer owns 64 q rows of Q and G;
//     the ring carries 128-key tiles of K and V and the keys' bias in log2
//     units (keys >= Lk get -inf: TMA's zero fill would give s = 0 and p !=
//     0). Per tile: S = Q K^T and dP = G V^T (shared-memory operands,
//     K-major), P and dS (lse and delta per row), dQ += dS K (A from
//     registers, B = K, MN-major). At d <= 40 3 consumers (192 rows a
//     block) fit 160 registers by taking dP in two 64-key halves, the
//     second half's product beside the first half's dQ; at d <= 80 2
//     consumers take all 128 keys at once.
// Design at 80 < d <= 128 (the 128-wide heads of other head counts):
// FlashAttention-3's d = 128 backward in the same two kernels. dk/dv: 2
// consumer warpgroups of 64 keys (128 a block) with dK and dV in registers
// (64 + 64 a thread), 64-row q steps in 3 stages (owned K, V 64 KB + 3 x
// (Q, G) 32 KB = 160 KB); dq: 2 consumer warpgroups of 64 q rows over
// 128-key tiles, dP in two 64-key halves beside dQ, 2 stages (Q, G 64 KB +
// 2 x (K, V) 64 KB = 192 KB). Hidden key tiles are passed over as at d <=
// 80, and no atomics: dQ keeps its own kernel.
// Layouts: a tile is [boxes][rows][box columns]. At d = 40 (and every d not
// a multiple of 16 up to 120) TMA boxes of 8 columns land as the no-swizzle
// core-matrix layout, as in the forward; at d = 48, 64 and 80, boxes of 16
// columns in the 32-byte swizzle, which halves the box rows TMA fetches (at
// level 1 the 16-byte rows bounded both kernels); at d = 128, whole 64-column
// boxes in the 128-byte swizzle (a head is two of them, so a box never reads
// the next head), as the d = 512 kernels take them. Either layout serves a
// tile as a K-major and as an MN-major operand. A box reads only its head's
// columns, so never past C at the last head; the contracted pad boxes are
// zeroed once. TMA maps are 3-D (C, L, B): rows past L read zeros, never the
// next batch row. A padded q row reads zero Q and G, and its -lse*log2e is
// -inf, so its p is exactly 0.
// Hidden keys: a 128-key tile all of whose keys carry a bias <= -1e9
// (NEG_INF of ops/attention.py) contributes exactly 0 to every dq, and its
// dk and dv are exactly 0, as long as every row sees some key (its lse >
// -5e8, which the kernels check) and |s * scale| < 4e8. Such a dk/dv block
// writes zeros and returns; the dq producer loads nothing for such a tile
// and flags it in the ring, and the consumers pass over it. The result is
// the same bits as computing it. No atomics: the same inputs give the same
// bits.
//
// Design at d = 512 (the VAE mid block's one head; `flash_bwd_dv_wide_kernel`,
// `flash_bwd_dk_wide_kernel`, `flash_bwd_dq_wide_kernel`): what bounds it.
// The gradient needs 5 * 512 = 2560 multiply-adds per (q, key) pair (1.56
// ms at 8 x 6144 x 6144). A 64 x 512 fp32 gradient block is 256 registers a
// thread in one warpgroup, and dK and dV of 64 keys together are the whole
// register file, so no block holds two gradients; 64 rows of two tiles (K
// and V, or Q and G) are 128 KB of the 227 KB of shared memory, which
// leaves one 32-row stage of the two streamed tiles; and each block streams
// the other side's 512-wide tiles from L2 (~10 GB per kernel here). Split
// by gradient, three kernels on `wgmma` and a TMA ring, with the same
// producer warp and `setmaxnreg` as at d <= 80: a block owns 64 rows (keys
// for dV and dK, q rows for dQ) of one gradient, and its two consumer
// warpgroups split the gradient's columns, 256 each (128 registers a
// thread). The recomputed products are computed once per block and passed
// between the two warpgroups through shared memory (fp32, double-buffered by
// step, one named barrier a step): dV splits S^T's 512-deep sum between
// them (each adds the other's half: the same bits in both); dK and dQ give S
// to warpgroup 0, which takes p from it, and dP to warpgroup 1, and both
// form dS from the two. Per step (32 q rows for dV and dK, 32 keys for dQ)
// the products are
//   dV: S^T = K Q^T (halves)                     dV += P^T G
//   dK: S^T = K Q^T, dP^T = V G^T               dK += dS^T Q
//   dQ: S = Q K^T, dP = G V^T                    dQ += dS K
// the first ones as wgmma m64n32k16 from shared memory (K-major, 128-byte
// swizzle: TMA boxes of 64 columns as in the forward's d = 512 path), the
// gradient's as m64n256k16 with A = P^T / dS^T / dS packed from registers
// and B = the streamed tile, MN-major. That is 1024 + 1536 + 1536 = 4096
// multiply-adds a pair, 1.6x the least (the mma.sync design's four
// 128-column chunks did 9728, 3.8x). dV's ring has 2 stages (K 64 KB + 2 x
// (Q, G) 64 KB + the exchange 32 KB), dK's and dQ's one (two owned tiles
// 128 KB + 64 KB + 32 KB). Rows past Lq get -lse = -inf and keys past Lk a
// -inf bias through the ring's words or the owned rows' registers, so their
// p is 0; a key hidden by the bias gets p = 0 and exactly zero dk and dv.
// No atomics: the same inputs give the same bits. Measured against other
// designs by `python -m humanvid_tpu_torch.tools.flash_variants --bwd`
// (PERF.md section 6), these were slower: S and dP recomputed by both
// warpgroups instead of exchanged; dV on one stage; dK and dQ on 16-row
// steps in two stages (S and dP at N = 16 wait on shared memory); tile 2
// released early to the producer; every 64-column box on its own barrier
// (the boxes of a step land together); clusters of two blocks sharing the
// streamed tiles by TMA multicast (the pair waits for its slower block).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_tiles.cuh"

namespace {

using namespace hopper;

constexpr float kLog2e = 1.4426950408889634f;

// ---- d <= 80: wgmma on a TMA ring ------------------------------------------

constexpr float kHiddenBias = -1e9f;  // NEG_INF of ops/attention.py
constexpr float kLseFloor = -5e8f;    // a row above it sees some key

// DQK: the contracted depth of s and dp (d padded to 16); DV: the gradient's
// columns (N of its products); CW: columns of one TMA box, 8 (no swizzle),
// 16 (32-byte swizzle) or 64 (128-byte swizzle); NC: consumer warpgroups, each owning 64 rows of
// the block (keys for dk/dv, q rows for dq); BS: rows of one streamed step
// (q rows for dk/dv, keys for dq); DPN: the keys of each dp product of the
// dq kernel, BS or BS / 2 (dp in two halves, for 3 consumers' registers).
template <int DQK_, int DV_, int CW_, int NC_, int BS_, int STAGES_, int DPN_ = BS_>
struct BwdCfg {
  static constexpr int DQK = DQK_;
  static constexpr int DV = DV_;
  static constexpr int CW = CW_;
  static constexpr int NC = NC_;
  static constexpr int BS = BS_;
  static constexpr int STAGES = STAGES_;
  static constexpr int DPN = DPN_;
  static_assert(BS % DPN == 0, "dp parts");
  static_assert((CW == 8 || CW == 16 || CW == 64) && DQK % CW == 0 && DV % 8 == 0, "layout");
  static constexpr uint32_t LAYOUT =
      CW == 64 ? kSwizzle128B : CW == 16 ? kSwizzle32B : kNoSwizzle;
  static constexpr CUtensorMapSwizzle TMA_SWIZZLE =
      CW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
               : CW == 16 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_NONE;
  static constexpr int THREADS = 128 * (NC + 1);  // + the producer warpgroup
  // setmaxnreg: the producer's registers go to the consumers
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = NC == 2 ? 240 : 160;
  static_assert(128 * (PRODUCER_REGS + NC * CONSUMER_REGS) <= 65536, "registers");
  static constexpr int BR = 64 * NC;            // rows the block owns
  static constexpr int R_BYTES = BR * DQK * 2;  // one owned tile (K or V; Q or G)
  static constexpr int S_BYTES = BS * DQK * 2;  // one streamed tile
  // shared memory: the two owned tiles, the ring's two streamed tiles, its
  // 2 * BS words per stage (dk/dv: -lse*log2e and delta of each q row; dq:
  // each key's bias in log2 units, then the tile's skip flag), barriers,
  // and for dq -lse*log2e and delta of each of the block's rows
  static constexpr int OFF_R2 = R_BYTES;
  static constexpr int OFF_S1 = 2 * R_BYTES;
  static constexpr int OFF_S2 = OFF_S1 + STAGES * S_BYTES;
  static constexpr int OFF_W = OFF_S2 + STAGES * S_BYTES;
  static constexpr int OFF_BAR = OFF_W + STAGES * BS * 8;
  static constexpr int OFF_ROWS = OFF_BAR + (3 * STAGES + 1) * 8;  // dq: per-row words
  static constexpr int SMEM = OFF_ROWS + BR * 8 + 1024;             // + alignment
  static_assert(R_BYTES % 1024 == 0 && S_BYTES % 1024 == 0, "");
  static_assert(SMEM <= 232448, "shared memory");
};

// In every thread of the block: whether every x[i], i < n, is <= hi (NaN
// is not). A block-wide barrier.
__device__ __forceinline__ bool block_all_le(const float* x, int n, float hi) {
  int ok = 1;
  for (int i = threadIdx.x; i < n; i += blockDim.x) ok &= x[i] <= hi;
  return __syncthreads_and(ok);
}

// The same for x[i] > lo.
__device__ __forceinline__ bool block_all_gt(const float* x, int n, float lo) {
  int ok = 1;
  for (int i = threadIdx.x; i < n; i += blockDim.x) ok &= x[i] > lo;
  return __syncthreads_and(ok);
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                          ~uintptr_t(1023));
}

// Barriers and the contracted pad: TMA writes only the n_box boxes of a
// head, so the pad boxes (d = 40 -> 48, d < 80 -> 80) of every tile are
// zeroed here once and never written again. Ends in a block-wide barrier.
template <class C>
__device__ __forceinline__ void init_block(unsigned char* smem, int n_box) {
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&bar[s], 32);                     // full_a: the producer's lanes + tx
      mbar_init(&bar[C::STAGES + s], 1);          // full_b: tx
      mbar_init(&bar[2 * C::STAGES + s], 4 * C::NC);  // empty: one per consumer warp
    }
    mbar_init(&bar[3 * C::STAGES], 1);  // the owned tiles
    fence_barrier_init();
  }
  for (int t = 0; t < 2 + 2 * C::STAGES; ++t) {
    const bool owned = t < 2;
    const int rows = owned ? C::BR : C::BS;
    unsigned char* tile = smem + (owned ? t * C::R_BYTES : C::OFF_S1 + (t - 2) * C::S_BYTES);
    uint4* pad = reinterpret_cast<uint4*>(tile + n_box * rows * C::CW * 2);
    const int n = (C::DQK / C::CW - n_box) * rows * C::CW / 8;
    for (int i = threadIdx.x; i < n; i += C::THREADS) pad[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  fence_proxy_async();
  __syncthreads();
}

// A lane's share of a step's words: row or key lane + 32 i.
template <int N>
struct LaneWords {
  float a[N], b[N];
};

// The producer warp: the block's two owned tiles (rows r0.., from r1/r2)
// once, then for every step the two streamed tiles (rows step * BS.., from
// s1/s2) into the ring. `fetch(step)` reads a lane's share of the step's
// words from device memory before the stage is free, so that the read's
// latency passes while the producer waits; `put(s, step, words)` writes
// them into stage s and returns whether the step is skipped: then nothing
// is loaded and the consumers find the flag.
template <class C, class Fetch, class Put>
__device__ __forceinline__ void produce(const CUtensorMap* r1, const CUtensorMap* r2,
                                        const CUtensorMap* s1, const CUtensorMap* s2,
                                        unsigned char* smem, int col0, int r0, int b,
                                        int n_box, int n_steps, int lane, Fetch fetch,
                                        Put put) {
  uint64_t* full_a = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* full_b = full_a + C::STAGES;
  uint64_t* empty = full_b + C::STAGES;
  uint64_t* full_r = empty + C::STAGES;
  if (lane == 0) {
    tma_prefetch_desc(r1);
    tma_prefetch_desc(r2);
    tma_prefetch_desc(s1);
    tma_prefetch_desc(s2);
    mbar_arrive_expect_tx(full_r, 2 * C::BR * n_box * C::CW * 2);
    for (int i = 0; i < n_box; ++i) {
      tma_load_3d(smem + i * C::BR * C::CW * 2, r1, full_r, col0 + C::CW * i, r0, b);
      tma_load_3d(smem + C::OFF_R2 + i * C::BR * C::CW * 2, r2, full_r, col0 + C::CW * i, r0,
                  b);
    }
  }
  for (int step = 0; step < n_steps; ++step) {
    const int s = step % C::STAGES;
    const LaneWords<C::BS / 32> w = fetch(step);
    mbar_wait(&empty[s], ((step / C::STAGES) & 1) ^ 1);
    const bool skip = put(s, step, w);
    if (lane == 0) {
      if (skip) {
        mbar_arrive(&full_a[s]);
        mbar_arrive(&full_b[s]);
        continue;
      }
      unsigned char* t1 = smem + C::OFF_S1 + s * C::S_BYTES;
      unsigned char* t2 = smem + C::OFF_S2 + s * C::S_BYTES;
      const int bytes = C::BS * C::CW * 2;  // one box
      mbar_arrive_expect_tx(&full_a[s], n_box * bytes);
      for (int i = 0; i < n_box; ++i)
        tma_load_3d(t1 + i * bytes, s1, &full_a[s], col0 + C::CW * i, step * C::BS, b);
      mbar_arrive_expect_tx(&full_b[s], n_box * bytes);
      for (int i = 0; i < n_box; ++i)
        tma_load_3d(t2 + i * bytes, s2, &full_b[s], col0 + C::CW * i, step * C::BS, b);
    } else {
      mbar_arrive(&full_a[s]);
    }
  }
}

// Store this warp's rows (row0 + lane/4, +8) of a 64 x DV accumulator of
// one head as bf16, times `mul`, skipping rows >= valid_rows and columns >= d.
template <int DV>
__device__ __forceinline__ void store_acc(bf16* dst, int C_all, const float (&acc)[DV / 2],
                                          int row0, int valid_rows, int d, float mul,
                                          int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + lane / 4 + 8 * r;
    if (row >= valid_rows) continue;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      if (col < d) {
        *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row * C_all + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
      }
    }
  }
}

// Tiles are [DQK / CW boxes][rows][CW]: a box of CW columns lands as one
// slab of 8-row atoms (core matrices without swizzle, 32- or 128-byte
// swizzled atoms with it). A 16-deep step of a K-major operand starts
// kk * rows * 32 bytes in (in the 128-byte swizzle: the step's box, then 32
// bytes a step inside the row); a 16-row step of an MN-major one t * 32 * CW
// bytes in.

// Byte offset of the 16-deep step kk of a K-major tile of `rows` rows.
template <class C>
__device__ __forceinline__ uint32_t kstep(int kk, int rows) {
  if constexpr (C::CW == 64) return (kk / 4) * rows * 128 + (kk % 4) * 32;
  else return kk * rows * 32;
}

// K-major operand (rows along M/N, the contracted d along K): 64 rows from
// row r0 of a tile of `rows` rows.
template <class C>
__device__ __forceinline__ uint64_t kmajor_desc(const unsigned char* tile, int rows, int r0) {
  const uint32_t addr = smem_u32(tile) + r0 * C::CW * 2;
  if constexpr (C::CW == 64) return gmma_desc(addr, 16, 1024, C::LAYOUT);
  else if constexpr (C::CW == 16) return gmma_desc(addr, 16, 256, C::LAYOUT);
  else return gmma_desc(addr, rows * 16, 128, C::LAYOUT);
}

// MN-major operand (the tile's rows contracted, its d columns along N).
template <class C>
__device__ __forceinline__ uint64_t mnmajor_desc(const unsigned char* tile, int rows) {
  if constexpr (C::CW == 64) return gmma_desc(smem_u32(tile), rows * 128, 1024, C::LAYOUT);
  else if constexpr (C::CW == 16) return gmma_desc(smem_u32(tile), rows * 32, 256, C::LAYOUT);
  else return gmma_desc(smem_u32(tile), 128, rows * 16, C::LAYOUT);
}

// acc (64 x N) = A B^T over the contracted depth, A the owned tile's 64
// rows (a_desc, a tile of BR rows), B N rows of the streamed tile (b_desc,
// a tile of BS rows).
template <class C, int N>
__device__ __forceinline__ void product_ab(float (&acc)[N / 2], uint64_t a_desc,
                                           uint64_t b_desc) {
#pragma unroll
  for (int kk = 0; kk < C::DQK / 16; ++kk)
    WgmmaSS<N>::run(acc, a_desc + (kstep<C>(kk, C::BR) >> 4),
                    b_desc + (kstep<C>(kk, C::BS) >> 4), kk > 0);
}

// P (or dS) as bf16: the accumulators' n8 blocks 2t and 2t+1 form the A
// fragment of the 16-deep step t.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int t = 0; t < N / 16; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[t][i] = pack_bf16x2(x[8 * t + 2 * i], x[8 * t + 2 * i + 1]);
}

// dk/dv: grid (key blocks of BR, heads, B). Accumulator element 4j + e of a
// consumer is key 16 * warp + lane/4 + 8 * (e >> 1) of its 64 and column
// 8j + 2 * (lane % 4) + (e & 1): a q row of the step for S^T, P^T, dP^T,
// dS^T; a head column for dK, dV.
template <class C>
__global__ void __launch_bounds__(C::THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap g_map, const float* __restrict__ bias,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int Lq, int Lk, int heads,
                     int d, float scale_log2, float scale) {
  constexpr int BS = C::BS, BR = C::BR, DV = C::DV, STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * BR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C_all = heads * d;
  const int n_box = d / C::CW;
  const float* lse_bh = lse + ((size_t)b * heads + h) * Lq;
  const float* delta_bh = delta + ((size_t)b * heads + h) * Lq;

  if (bias != nullptr && block_all_le(bias + (size_t)b * Lk + k0, min(BR, Lk - k0), kHiddenBias) &&
      block_all_gt(lse_bh, Lq, kLseFloor)) {
    // every key of the block hidden from every row: dk = dv = 0 exactly
    const int vecs = d / 8;
    const int n = min(BR, Lk - k0) * vecs;
    for (int i = threadIdx.x; i < n; i += C::THREADS) {
      const size_t at = ((size_t)b * Lk + k0 + i / vecs) * C_all + (size_t)h * d + 8 * (i % vecs);
      *reinterpret_cast<uint4*>(dk + at) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(dv + at) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  init_block<C>(smem, n_box);
  float* words = reinterpret_cast<float*>(smem + C::OFF_W);
  const int n_q = (Lq + BS - 1) / BS;

  if (wg == C::NC) {
    // ---------------- producer ----------------
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (warp != 0) return;
    produce<C>(&k_map, &v_map, &q_map, &g_map, smem, h * d, k0, b, n_box, n_q, lane,
               [&](int step) {
                 LaneWords<BS / 32> v;  // -lse*log2e and delta; p = 0 past Lq
#pragma unroll
                 for (int i = 0; i < BS / 32; ++i) {
                   const int row = step * BS + lane + 32 * i;
                   v.a[i] = row < Lq ? -lse_bh[row] * kLog2e : -INFINITY;
                   v.b[i] = row < Lq ? delta_bh[row] : 0.f;
                 }
                 return v;
               },
               [&](int s, int, const LaneWords<BS / 32>& v) {
                 float* w = words + s * 2 * BS;
#pragma unroll
                 for (int i = 0; i < BS / 32; ++i) {
                   w[lane + 32 * i] = v.a[i];
                   w[BS + lane + 32 * i] = v.b[i];
                 }
                 return false;
               });
    return;
  }

  // ---------------- consumers ----------------
  setmaxnreg_inc<C::CONSUMER_REGS>();
  uint64_t* full_a = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* full_b = full_a + STAGES;
  uint64_t* empty = full_b + STAGES;
  uint64_t* full_r = empty + STAGES;
  const int roff = 64 * wg;  // this warpgroup's first key of the block
  const int c2 = 2 * (lane % 4);

  // the bias of this thread's two keys, log2 units; keys >= Lk get p = 0
  float kb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + roff + 16 * warp + lane / 4 + 8 * r;
    kb[r] = key >= Lk ? -INFINITY : (bias ? bias[(size_t)b * Lk + key] * kLog2e : 0.f);
  }
  const bool use_kb = bias != nullptr || k0 + BR > Lk;

  // descriptors without their stage offsets: K and V as A (K-major), Q and
  // G as B K-major (s^T, dp^T) and MN-major (dV, dK)
  const uint64_t k_desc = kmajor_desc<C>(smem, BR, roff);
  const uint64_t v_desc = kmajor_desc<C>(smem + C::OFF_R2, BR, roff);
  const uint64_t q_desc = kmajor_desc<C>(smem + C::OFF_S1, BS, 0);
  const uint64_t g_desc = kmajor_desc<C>(smem + C::OFF_S2, BS, 0);
  const uint64_t qt_desc = mnmajor_desc<C>(smem + C::OFF_S1, BS);
  const uint64_t gt_desc = mnmajor_desc<C>(smem + C::OFF_S2, BS);

  float dk_acc[DV / 2], dv_acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(full_r, 0);
  for (int qt = 0; qt < n_q; ++qt) {
    const int s = qt % STAGES;
    const uint32_t parity = (qt / STAGES) & 1;
    const uint32_t so = s * C::S_BYTES;

    // S^T = K Q^T and dP^T = V G^T (64 keys x BS q rows each)
    float st[BS / 2], dpt[BS / 2];
    mbar_wait(&full_a[s], parity);
    wgmma_fence();
    product_ab<C, BS>(st, k_desc, q_desc + (so >> 4));
    wgmma_commit();
    mbar_wait(&full_b[s], parity);
    wgmma_fence();
    product_ab<C, BS>(dpt, v_desc, g_desc + (so >> 4));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);

    // P^T = exp2(s^T * scale*log2e + bias*log2e - lse*log2e), in place
    const float* w = words + s * 2 * BS;
    if (use_kb) {
#pragma unroll
      for (int j = 0; j < BS / 8; ++j) {
        const float2 nl = *reinterpret_cast<const float2*>(w + 8 * j + c2);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[4 * j + e] =
              fast_exp2(fmaf(st[4 * j + e], scale_log2, (e & 1) ? nl.y : nl.x) + kb[e >> 1]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < BS / 8; ++j) {
        const float2 nl = *reinterpret_cast<const float2*>(w + 8 * j + c2);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[4 * j + e] = fast_exp2(fmaf(st[4 * j + e], scale_log2, (e & 1) ? nl.y : nl.x));
      }
    }
    uint32_t p_a[BS / 16][4];
    pack_a<BS>(p_a, st);

    // dV += P^T G, running while dS^T is computed
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < BS / 16; ++t)
      WgmmaRS<DV>::run(dv_acc, p_a[t], gt_desc + ((so + t * 32 * C::CW) >> 4));
    wgmma_commit();
    wgmma_wait<1>();  // dP^T is done
    fence_regs(dpt);

    // dS^T = P^T * (dP^T - delta), in place
#pragma unroll
    for (int j = 0; j < BS / 8; ++j) {
      const float2 dl = *reinterpret_cast<const float2*>(w + BS + 8 * j + c2);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - ((e & 1) ? dl.y : dl.x));
    }
    uint32_t ds_a[BS / 16][4];
    pack_a<BS>(ds_a, dpt);

    // dK += dS^T Q
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < BS / 16; ++t)
      WgmmaRS<DV>::run(dk_acc, ds_a[t], qt_desc + ((so + t * 32 * C::CW) >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(p_a);
    fence_regs(ds_a);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const size_t out0 = (size_t)b * Lk * C_all + (size_t)h * d;
  const int row0 = k0 + roff + 16 * warp;
  store_acc<DV>(dk + out0, C_all, dk_acc, row0, Lk, d, scale, lane);
  store_acc<DV>(dv + out0, C_all, dv_acc, row0, Lk, d, 1.f, lane);
}

// dq: grid (q blocks of BR, heads, B). Accumulator element 4j + e of a
// consumer is q row 16 * warp + lane/4 + 8 * (e >> 1) of its 64 and column
// 8j + 2 * (lane % 4) + (e & 1): a key of the tile for S, P, dP, dS; a head
// column for dQ.
template <class C>
__global__ void __launch_bounds__(C::THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap g_map, const float* __restrict__ bias,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int Lq, int Lk, int heads, int d, float scale_log2,
                    float scale) {
  constexpr int BS = C::BS, BR = C::BR, DV = C::DV, STAGES = C::STAGES, DPN = C::DPN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * BR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C_all = heads * d;
  const int n_box = d / C::CW;
  const float* lse_bh = lse + ((size_t)b * heads + h) * Lq;
  const float* delta_bh = delta + ((size_t)b * heads + h) * Lq;

  // hidden key tiles may be passed over only if every row of the block sees
  // some key
  const bool may_skip =
      bias != nullptr && block_all_gt(lse_bh + q0, min(BR, Lq - q0), kLseFloor);
  init_block<C>(smem, n_box);
  float* words = reinterpret_cast<float*>(smem + C::OFF_W);
  const int n_kv = (Lk + BS - 1) / BS;

  if (wg == C::NC) {
    // ---------------- producer ----------------
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (warp != 0) return;
    const float* bias_b = bias ? bias + (size_t)b * Lk : nullptr;
    produce<C>(&q_map, &g_map, &k_map, &v_map, smem, h * d, q0, b, n_box, n_kv, lane,
               [&](int step) {
                 LaneWords<BS / 32> v;  // the keys' bias
#pragma unroll
                 for (int i = 0; i < BS / 32; ++i) {
                   const int key = step * BS + lane + 32 * i;
                   v.a[i] = key < Lk && bias_b ? bias_b[key] : 0.f;
                   v.b[i] = 0.f;
                 }
                 return v;
               },
               [&](int s, int step, const LaneWords<BS / 32>& v) {
                 float* w = words + s * 2 * BS;
                 bool hidden = true;
#pragma unroll
                 for (int i = 0; i < BS / 32; ++i) {
                   const int key = step * BS + lane + 32 * i;
                   hidden = hidden && (key >= Lk || v.a[i] <= kHiddenBias);
                   w[lane + 32 * i] = key >= Lk ? -INFINITY : v.a[i] * kLog2e;
                 }
                 const bool skip = may_skip && __all_sync(0xffffffffu, hidden);
                 if (lane == 0) reinterpret_cast<int*>(w)[BS] = skip;
                 return skip;
               });
    return;
  }

  // ---------------- consumers ----------------
  setmaxnreg_inc<C::CONSUMER_REGS>();
  uint64_t* full_a = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* full_b = full_a + STAGES;
  uint64_t* empty = full_b + STAGES;
  uint64_t* full_r = empty + STAGES;
  const int roff = 64 * wg;  // this warpgroup's first q row of the block
  const int c2 = 2 * (lane % 4);

  // -lse*log2e and delta of this thread's two rows (rows >= Lq get p = 0),
  // kept in shared memory and read in every step: 3 consumers are short of
  // registers
  float2* my_rows = reinterpret_cast<float2*>(smem + C::OFF_ROWS) + roff + 16 * warp + lane / 4;
  if (lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + roff + 16 * warp + lane / 4 + 8 * r;
      my_rows[8 * r] = row < Lq ? make_float2(-lse_bh[row] * kLog2e, delta_bh[row])
                                : make_float2(-INFINITY, 0.f);
    }
  }
  __syncwarp();

  // descriptors without their stage offsets: Q and G as A (K-major), K and
  // V as B K-major (s, dp), K as B MN-major (dQ)
  const uint64_t q_desc = kmajor_desc<C>(smem, BR, roff);
  const uint64_t g_desc = kmajor_desc<C>(smem + C::OFF_R2, BR, roff);
  const uint64_t k_desc = kmajor_desc<C>(smem + C::OFF_S1, BS, 0);
  const uint64_t v_desc = kmajor_desc<C>(smem + C::OFF_S2, BS, 0);
  const uint64_t kt_desc = mnmajor_desc<C>(smem + C::OFF_S1, BS);

  float dq_acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dq_acc[i] = 0.f;
  // the same branch in every step (one that changes from step to step while
  // dP is in flight makes ptxas serialize the wgmmas)
  const bool use_bias = bias != nullptr || Lk % BS != 0;

  mbar_wait(full_r, 0);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int s = kt % STAGES;
    const uint32_t parity = (kt / STAGES) & 1;
    const uint32_t so = s * C::S_BYTES;
    const float* w = words + s * 2 * BS;
    mbar_wait(&full_a[s], parity);
    if (may_skip && reinterpret_cast<const int*>(w)[BS]) {  // a hidden tile, not loaded
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      continue;
    }

    // S = Q K^T and dP = G V^T (64 q rows x BS keys each)
    // S = Q K^T (64 q rows x BS keys) and dP = G V^T over the first DPN keys
    float sc[BS / 2], dp[DPN / 2];
    wgmma_fence();
    product_ab<C, BS>(sc, q_desc, k_desc + (so >> 4));
    wgmma_commit();
    mbar_wait(&full_b[s], parity);
    wgmma_fence();
    product_ab<C, DPN>(dp, g_desc, v_desc + (so >> 4));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    // P = exp2(s * scale*log2e + bias*log2e - lse*log2e), in place
    const float2 row0 = my_rows[0], row1 = my_rows[8];
    const float nl[2] = {row0.x, row1.x}, dl[2] = {row0.y, row1.y};
    if (use_bias) {
#pragma unroll
      for (int j = 0; j < BS / 8; ++j) {
        const float2 bb = *reinterpret_cast<const float2*>(w + 8 * j + c2);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * j + e] =
              fast_exp2(fmaf(sc[4 * j + e], scale_log2, (e & 1) ? bb.y : bb.x) + nl[e >> 1]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BS / 2; ++i)
        sc[i] = fast_exp2(fmaf(sc[i], scale_log2, nl[(i >> 1) & 1]));
    }
    wgmma_wait<0>();
    fence_regs(dp);

    // per part of DPN keys: dS = P * (dP - delta) in place, then dQ += dS K,
    // beside the next part's dP
#pragma unroll
    for (int part = 0; part < BS / DPN; ++part) {
#pragma unroll
      for (int i = 0; i < DPN / 2; ++i)
        dp[i] = sc[part * DPN / 2 + i] * (dp[i] - dl[(i >> 1) & 1]);
      uint32_t ds_a[DPN / 16][4];
      pack_a<DPN>(ds_a, dp);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < DPN / 16; ++t)
        WgmmaRS<DV>::run(dq_acc, ds_a[t],
                         kt_desc + ((so + (part * DPN / 16 + t) * 32 * C::CW) >> 4));
      if (part + 1 < BS / DPN)
        product_ab<C, DPN>(dp, g_desc, v_desc + ((so + (part + 1) * DPN * C::CW * 2) >> 4));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq_acc);
      fence_regs(dp);
      fence_regs(ds_a);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  store_acc<DV>(dq + (size_t)b * Lq * C_all + (size_t)h * d, C_all, dq_acc,
                q0 + roff + 16 * warp, Lq, d, scale, lane);
}

HostCache host_cache;

template <class C>
int launch_dkv(const void* q, const void* k, const void* v, const void* bias, const void* g,
               const void* lse, const void* delta, void* dk, void* dv, int B, int Lq, int Lk,
               int heads, int d, int scale_d, cudaStream_t stream) {
  CUtensorMap maps[4];  // q, k, v, g: boxes of a step's q rows or of the block's keys
  const int C_all = heads * d;
  int err = make_map(&maps[0], q, C_all, Lq, B, C::CW, C::BS, C::TMA_SWIZZLE);
  if (!err) err = make_map(&maps[1], k, C_all, Lk, B, C::CW, C::BR, C::TMA_SWIZZLE);
  if (!err) err = make_map(&maps[2], v, C_all, Lk, B, C::CW, C::BR, C::TMA_SWIZZLE);
  if (!err) err = make_map(&maps[3], g, C_all, Lq, B, C::CW, C::BS, C::TMA_SWIZZLE);
  if (err) return err;
  auto kernel = flash_bwd_dkv_kernel<C>;
  cudaError_t e = host_cache.reserve_smem(reinterpret_cast<const void*>(kernel), C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const float scale = 1.f / sqrtf((float)scale_d);
  const dim3 grid((Lk + C::BR - 1) / C::BR, heads, B);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(bias),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Lq, Lk, heads, d, scale * kLog2e, scale);
  return (int)cudaGetLastError();
}

template <class C>
int launch_dq(const void* q, const void* k, const void* v, const void* bias, const void* g,
              const void* lse, const void* delta, void* dq, int B, int Lq, int Lk, int heads,
              int d, int scale_d, cudaStream_t stream) {
  CUtensorMap maps[4];  // q, k, v, g: boxes of the block's q rows or of a tile's keys
  const int C_all = heads * d;
  int err = make_map(&maps[0], q, C_all, Lq, B, C::CW, C::BR, C::TMA_SWIZZLE);
  if (!err) err = make_map(&maps[1], k, C_all, Lk, B, C::CW, C::BS, C::TMA_SWIZZLE);
  if (!err) err = make_map(&maps[2], v, C_all, Lk, B, C::CW, C::BS, C::TMA_SWIZZLE);
  if (!err) err = make_map(&maps[3], g, C_all, Lq, B, C::CW, C::BR, C::TMA_SWIZZLE);
  if (err) return err;
  auto kernel = flash_bwd_dq_kernel<C>;
  cudaError_t e = host_cache.reserve_smem(reinterpret_cast<const void*>(kernel), C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const float scale = 1.f / sqrtf((float)scale_d);
  const dim3 grid((Lq + C::BR - 1) / C::BR, heads, B);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(bias),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<bf16*>(dq),
      Lq, Lk, heads, d, scale * kLog2e, scale);
  return (int)cudaGetLastError();
}

// d <= 40 (contracted depth 48, 40 gradient columns) and d <= 80 (80, 80):
// 64-row q steps for dk/dv (3 consumer warpgroups at d <= 40, where their
// 160 registers hold S^T, dP^T, dK and dV; 2 at d <= 80), 2 consumers on
// 128-key tiles for dq. Heads of 48, 64 and 80 take 16-column boxes in the
// 32-byte swizzle, the others 8-column boxes (a 40-wide head's 80-byte rows
// do not split into 32-byte boxes).
using DkvCfg48 = BwdCfg<48, 40, 8, 3, 64, 3>;
using DkvCfg80 = BwdCfg<80, 80, 8, 2, 64, 3>;
using DkvCfg80s = BwdCfg<80, 80, 16, 2, 64, 3>;
using DqCfg48 = BwdCfg<48, 40, 8, 3, 128, 3, 64>;
using DqCfg80 = BwdCfg<80, 80, 8, 2, 128, 3>;
using DqCfg80s = BwdCfg<80, 80, 16, 2, 128, 3>;
// 80 < d <= 128 (contracted depth 128, 128 gradient columns): 2 consumers,
// 64-row q steps in 3 stages for dk/dv, 128-key tiles in 2 stages with dP in
// 64-key halves for dq; 128-byte swizzle at d = 128, 8-column boxes at 88..120.
using DkvCfg128 = BwdCfg<128, 128, 8, 2, 64, 3>;
using DkvCfg128w = BwdCfg<128, 128, 64, 2, 64, 3>;
using DqCfg128 = BwdCfg<128, 128, 8, 2, 128, 2, 64>;
using DqCfg128w = BwdCfg<128, 128, 64, 2, 128, 2, 64>;

// ---- d = 512: wgmma on a TMA ring, one kernel per gradient -----------------

// MODE: the gradient a block writes (kDv, kDk: of its 64 keys; kDq: of its
// 64 q rows); BS: rows of one streamed step (q rows for dV and dK, keys for
// dQ); STAGES: the ring's depth. Two consumer warpgroups take the same 64
// owned rows and split the gradient's 512 columns, 256 each (128 fp32
// registers a thread), and share the recomputed products through shared
// memory (the header). Tiles use the 128-byte swizzle: TMA boxes of 64
// columns x rows land as [8 boxes][rows][64].
enum WideMode { kDv = 0, kDk = 1, kDq = 2 };

template <int MODE_, int BS_, int STAGES_>
struct WideCfg {
  static constexpr int MODE = MODE_;
  static constexpr int BS = BS_;
  static constexpr int STAGES = STAGES_;
  static constexpr int D = 512;
  static constexpr int DH = 256;                 // gradient columns of one consumer
  static constexpr int NC = 2;
  static constexpr int THREADS = 128 * (NC + 1);  // + the producer warpgroup
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = 240;
  static constexpr int OWN = MODE == kDv ? 1 : 2;  // owned tiles: K; K and V; Q and G
  static constexpr int R_BYTES = 64 * D * 2;       // one owned tile
  static constexpr int S_BYTES = BS * D * 2;       // one streamed tile
  // shared memory: the owned tiles, the ring's two streamed tiles and its
  // 2 * BS words per stage (dV, dK: -lse*log2e and delta of each q row; dQ:
  // each key's bias in log2 units), barriers
  static constexpr int OFF_S1 = OWN * R_BYTES;
  static constexpr int OFF_S2 = OFF_S1 + STAGES * S_BYTES;
  static constexpr int OFF_W = OFF_S2 + STAGES * S_BYTES;
  // the consumers' exchange: 2 buffers (by step parity) x 2 warpgroups x
  // 64 x BS fp32, slot i of thread t at [i][t]
  static constexpr int X_FLOATS = (BS / 2) * 128;
  static constexpr int OFF_X = OFF_W + STAGES * BS * 8;
  static constexpr int OFF_BAR = OFF_X + 4 * X_FLOATS * 4;
  static constexpr int SMEM = OFF_BAR + (3 * STAGES + 1) * 8 + 1024;  // + alignment
  static_assert(BS % 16 == 0 && S_BYTES % 1024 == 0, "");
  static_assert(SMEM <= 232448, "shared memory");
};

// Byte offset of the 16-deep step kk of a K-major swizzled tile of `rows` rows.
__device__ __forceinline__ uint32_t wide_kstep(int kk, int rows) {
  return (kk / 4) * rows * 128 + (kk % 4) * 32;
}

// acc (64 x BS) = A B^T over KS 16-deep steps of the 512 columns from step
// kk0: A the owned tile's 64 rows, B the streamed tile's BS rows, both
// K-major.
template <class C, int KS>
__device__ __forceinline__ void wide_product(float (&acc)[C::BS / 2], uint64_t a_desc,
                                             uint64_t b_desc, int kk0) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    WgmmaSS<C::BS>::run(acc, a_desc + (wide_kstep(kk0 + kk, 64) >> 4),
                        b_desc + (wide_kstep(kk0 + kk, C::BS) >> 4), kk > 0);
}

template <class C>
__device__ __forceinline__ void flash_bwd_wide(
    const CUtensorMap* q_map, const CUtensorMap* k_map, const CUtensorMap* v_map,
    const CUtensorMap* g_map, const float* __restrict__ bias, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ grad, int Lq, int Lk, int heads,
    float scale_log2, float scale) {
  constexpr int BS = C::BS, STAGES = C::STAGES, MODE = C::MODE;
  constexpr bool ROWS_ARE_KEYS = MODE != kDq;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* full_a = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);  // tile 1 + words
  uint64_t* full_b = full_a + STAGES;                                 // tile 2
  uint64_t* empty = full_b + STAGES;
  uint64_t* full_r = empty + STAGES;                                  // the owned tiles
  float* words = reinterpret_cast<float*>(smem + C::OFF_W);
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int r0 = blockIdx.x * 64;  // the block's first owned row
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C_all = heads * C::D;
  const int col0 = h * C::D;
  const int L_own = ROWS_ARE_KEYS ? Lk : Lq;
  const int L_str = ROWS_ARE_KEYS ? Lq : Lk;
  const int n_steps = (L_str + BS - 1) / BS;
  const float* lse_bh = lse + ((size_t)b * heads + h) * Lq;
  const float* delta_bh = delta + ((size_t)b * heads + h) * Lq;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_a[s], 32);     // the producer's lanes (words) + tx
      mbar_init(&full_b[s], 1);      // tx
      mbar_init(&empty[s], 4 * C::NC);  // one per consumer warp
    }
    mbar_init(full_r, 1);
    fence_barrier_init();
  }
  __syncthreads();

  // owned tiles (64 rows) and streamed ones: dV: K; Q, G. dK: K, V; Q, G.
  // dQ: Q, G; K, V.
  const CUtensorMap* own1 = ROWS_ARE_KEYS ? k_map : q_map;
  const CUtensorMap* own2 = ROWS_ARE_KEYS ? v_map : g_map;
  const CUtensorMap* str1 = ROWS_ARE_KEYS ? q_map : k_map;
  const CUtensorMap* str2 = ROWS_ARE_KEYS ? g_map : v_map;

  if (wg == C::NC) {
    // ---------------- producer ----------------
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (warp != 0) return;
    if (lane == 0) {
      tma_prefetch_desc(own1);
      if (C::OWN == 2) tma_prefetch_desc(own2);
      tma_prefetch_desc(str1);
      tma_prefetch_desc(str2);
      mbar_arrive_expect_tx(full_r, C::OWN * C::R_BYTES);
      for (int i = 0; i < 8; ++i) {
        tma_load_3d(smem + i * 64 * 128, own1, full_r, col0 + 64 * i, r0, b);
        if (C::OWN == 2)
          tma_load_3d(smem + C::R_BYTES + i * 64 * 128, own2, full_r, col0 + 64 * i, r0, b);
      }
    }
    const float* bias_b = bias ? bias + (size_t)b * Lk : nullptr;
    for (int step = 0; step < n_steps; ++step) {
      const int s = step % STAGES;
      // the step's words, read before the stage is free: dV, dK: -lse*log2e
      // and delta of the q rows (p = 0 past Lq); dQ: the keys' bias, log2
      // units (-inf past Lk: TMA's zero fill would give s = 0, p != 0)
      float wa[BS / 32 > 0 ? BS / 32 : 1], wb[BS / 32 > 0 ? BS / 32 : 1];
#pragma unroll
      for (int i = 0; i * 32 < BS; ++i) {
        const int row = step * BS + lane + 32 * i;
        if (lane + 32 * i >= BS) break;
        if constexpr (ROWS_ARE_KEYS) {
          wa[i] = row < Lq ? -lse_bh[row] * kLog2e : -INFINITY;
          wb[i] = row < Lq ? delta_bh[row] : 0.f;
        } else {
          wa[i] = row >= Lk ? -INFINITY : (bias_b ? bias_b[row] * kLog2e : 0.f);
          wb[i] = 0.f;
        }
      }
      mbar_wait(&empty[s], ((step / STAGES) & 1) ^ 1);
      float* w = words + s * 2 * BS;
#pragma unroll
      for (int i = 0; i * 32 < BS; ++i) {
        if (lane + 32 * i >= BS) break;
        w[lane + 32 * i] = wa[i];
        w[BS + lane + 32 * i] = wb[i];
      }
      if (lane == 0) {
        unsigned char* t1 = smem + C::OFF_S1 + s * C::S_BYTES;
        unsigned char* t2 = smem + C::OFF_S2 + s * C::S_BYTES;
        mbar_arrive_expect_tx(&full_a[s], C::S_BYTES);
        for (int i = 0; i < 8; ++i)
          tma_load_3d(t1 + i * BS * 128, str1, &full_a[s], col0 + 64 * i, step * BS, b);
        mbar_arrive_expect_tx(&full_b[s], C::S_BYTES);
        for (int i = 0; i < 8; ++i)
          tma_load_3d(t2 + i * BS * 128, str2, &full_b[s], col0 + 64 * i, step * BS, b);
      } else {
        mbar_arrive(&full_a[s]);
      }
    }
    return;
  }

  // ---------------- consumers ----------------
  setmaxnreg_inc<C::CONSUMER_REGS>();
  const int c2 = 2 * (lane % 4);
  // per owned row (this thread's rows 16 warp + lane/4, + 8): dV, dK: the
  // key's bias in log2 units (-inf past Lk); dQ: -lse*log2e and delta
  float ra[2], rb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 16 * warp + lane / 4 + 8 * r;
    if constexpr (ROWS_ARE_KEYS) {
      ra[r] = row >= Lk ? -INFINITY : (bias ? bias[(size_t)b * Lk + row] * kLog2e : 0.f);
      rb[r] = 0.f;
    } else {
      ra[r] = row < Lq ? -lse_bh[row] * kLog2e : -INFINITY;
      rb[r] = row < Lq ? delta_bh[row] : 0.f;
    }
  }

  // descriptors without their stage offsets: the owned tiles as A and the
  // streamed ones as B, K-major (s and dp); the streamed tile of the
  // gradient's product as B, MN-major, this consumer's 256 columns (LBO =
  // BS*128 between 64-column atoms, SBO = 1024 between 8-row atoms)
  const uint64_t a1_desc = gmma_desc(smem_u32(smem), 16, 1024, kSwizzle128B);
  const uint64_t a2_desc = gmma_desc(smem_u32(smem + C::R_BYTES), 16, 1024, kSwizzle128B);
  const uint64_t b1_desc = gmma_desc(smem_u32(smem + C::OFF_S1), 16, 1024, kSwizzle128B);
  const uint64_t b2_desc = gmma_desc(smem_u32(smem + C::OFF_S2), 16, 1024, kSwizzle128B);
  // dV: G; dK: Q; dQ: K
  const uint32_t g_tile = MODE == kDv ? C::OFF_S2 : C::OFF_S1;
  const uint64_t gt_desc =
      gmma_desc(smem_u32(smem + g_tile) + wg * (C::DH / 64) * BS * 128, BS * 128, 1024,
                kSwizzle128B);

  float* xch = reinterpret_cast<float*>(smem + C::OFF_X);
  const int tid = threadIdx.x % 128;

  float acc[C::DH / 2];
#pragma unroll
  for (int i = 0; i < C::DH / 2; ++i) acc[i] = 0.f;

  mbar_wait(full_r, 0);
  for (int step = 0; step < n_steps; ++step) {
    const int s = step % STAGES;
    const uint32_t parity = (step / STAGES) & 1;
    const uint32_t so = s * C::S_BYTES;
    const float* w = words + s * 2 * BS;

    // S^T = K Q^T (dV, dK) or S = Q K^T (dQ), and dP^T = V G^T or dP = G V^T,
    // each computed once and passed between the two warpgroups through
    // shared memory: dV splits S^T's 512-deep sum (warpgroup w takes columns
    // 256 w..), dK and dQ give S to warpgroup 0 and dP to warpgroup 1
    float* mine = xch + ((step & 1) * 2 + wg) * C::X_FLOATS + tid;
    const float* other = xch + ((step & 1) * 2 + (wg ^ 1)) * C::X_FLOATS + tid;
    float x[BS / 2];
    mbar_wait(&full_a[s], parity);
    if (MODE == kDv || wg == 0) {
      wgmma_fence();
      if constexpr (MODE == kDv)
        wide_product<C, C::D / 32>(x, a1_desc, b1_desc + (so >> 4), wg * C::D / 32);
      else
        wide_product<C, C::D / 16>(x, a1_desc, b1_desc + (so >> 4), 0);
      wgmma_commit();
    } else {
      mbar_wait(&full_b[s], parity);
      wgmma_fence();
      wide_product<C, C::D / 16>(x, a2_desc, b2_desc + (so >> 4), 0);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(x);
    if constexpr (MODE == kDv) {
      // the two halves of S^T (a sum of two commutes: both warpgroups get
      // the same bits)
#pragma unroll
      for (int i = 0; i < BS / 2; ++i) mine[i * 128] = x[i];
      named_bar_sync(1, 256);
#pragma unroll
      for (int i = 0; i < BS / 2; ++i) x[i] += other[i * 128];
    }
    // p = exp2(s * scale*log2e + bias*log2e - lse*log2e), in place (dV, and
    // warpgroup 0 of dK and dQ); element 4j + e is owned row 16 warp +
    // lane/4 + 8 (e >> 1), streamed row 8j + c2 + (e & 1)
    if (MODE == kDv || wg == 0) {
#pragma unroll
      for (int j = 0; j < BS / 8; ++j) {
        const float2 wc = *reinterpret_cast<const float2*>(w + 8 * j + c2);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[4 * j + e] = fast_exp2(fmaf(x[4 * j + e], scale_log2, (e & 1) ? wc.y : wc.x) +
                                   ra[e >> 1]);
      }
    }
    uint32_t a_frag[BS / 16][4];
    if constexpr (MODE == kDv) {
      pack_a<BS>(a_frag, x);
      mbar_wait(&full_b[s], parity);
    } else {
      // P (warpgroup 0) and dP (warpgroup 1) change hands, then both take
      // dS = P * (dP - delta): delta per streamed q row (dK) or owned row (dQ)
#pragma unroll
      for (int i = 0; i < BS / 2; ++i) mine[i * 128] = x[i];
      named_bar_sync(1, 256);
#pragma unroll
      for (int j = 0; j < BS / 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(w + BS + 8 * j + c2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const float y = other[i * 128];
          const float p = wg == 0 ? x[i] : y, dp = wg == 0 ? y : x[i];
          const float dd = ROWS_ARE_KEYS ? ((e & 1) ? dl.y : dl.x) : rb[e >> 1];
          x[i] = p * (dp - dd);
        }
      }
      pack_a<BS>(a_frag, x);
    }

    // the gradient's 64 x 256: += P^T G (dV), dS^T Q (dK), dS K (dQ)
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < BS / 16; ++t)
      WgmmaRS<C::DH>::run(acc, a_frag[t], gt_desc + ((so + t * 2048) >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(a_frag);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  store_acc<C::DH>(grad + (size_t)b * L_own * C_all + col0 + wg * C::DH, C_all, acc,
                   r0 + 16 * warp, L_own, C::DH, MODE == kDv ? 1.f : scale, lane);
}

#define WIDE_KERNEL(name, Cfg)                                                          \
  __global__ void __launch_bounds__(Cfg::THREADS, 1)                                    \
      name(const __grid_constant__ CUtensorMap q_map,                                   \
           const __grid_constant__ CUtensorMap k_map,                                   \
           const __grid_constant__ CUtensorMap v_map,                                   \
           const __grid_constant__ CUtensorMap g_map, const float* __restrict__ bias,   \
           const float* __restrict__ lse, const float* __restrict__ delta,              \
           bf16* __restrict__ grad, int Lq, int Lk, int heads, float scale_log2,        \
           float scale) {                                                               \
    flash_bwd_wide<Cfg>(&q_map, &k_map, &v_map, &g_map, bias, lse, delta, grad, Lq, Lk, \
                        heads, scale_log2, scale);                                      \
  }

// dV of 64 keys over 32-row q steps in a 2-stage ring (K 64 KB + 2 x (Q, G)
// 64 KB); dK and dQ hold two owned tiles (128 KB), so one 32-row stage.
using WideDv = WideCfg<kDv, 32, 2>;
using WideDk = WideCfg<kDk, 32, 1>;
using WideDq = WideCfg<kDq, 32, 1>;
WIDE_KERNEL(flash_bwd_dv_wide_kernel, WideDv)
WIDE_KERNEL(flash_bwd_dk_wide_kernel, WideDk)
WIDE_KERNEL(flash_bwd_dq_wide_kernel, WideDq)
#undef WIDE_KERNEL

template <class C, class Kernel>
int launch_wide(Kernel kernel, const void* q, const void* k, const void* v, const void* bias,
                const void* g, const void* lse, const void* delta, void* grad, int B, int Lq,
                int Lk, int heads, int d, int scale_d, cudaStream_t stream) {
  // boxes of 64 columns x the owned tiles' 64 rows or a step's BS rows
  const bool keys_own = C::MODE != kDq;
  const int C_all = heads * d;
  CUtensorMap maps[4];  // q, k, v, g
  int err = make_map(&maps[0], q, C_all, Lq, B, 64, keys_own ? C::BS : 64, true);
  if (!err) err = make_map(&maps[1], k, C_all, Lk, B, 64, keys_own ? 64 : C::BS, true);
  if (!err) err = make_map(&maps[2], v, C_all, Lk, B, 64, keys_own ? 64 : C::BS, true);
  if (!err) err = make_map(&maps[3], g, C_all, Lq, B, 64, keys_own ? C::BS : 64, true);
  if (err) return err;
  cudaError_t e = host_cache.reserve_smem(reinterpret_cast<const void*>(kernel), C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const float scale = 1.f / sqrtf((float)scale_d);
  const dim3 grid(((keys_own ? Lk : Lq) + 63) / 64, heads, B);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(bias),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(grad), Lq, Lk, heads, scale * kLog2e, scale);
  return (int)cudaGetLastError();
}

// ---- heads wider than 512 columns: the xwide kernels ------------------------
//
// The d = 512 kernels hold two owned 64 x 512 tiles (128 KB) and a 64 x 512
// fp32 gradient split over two warpgroups; at 640 or 1280 columns neither
// fits. So, as the forward's xwide kernel does, a block (4 warps, 16 rows
// each, 64 rows) writes one slab of at most kXSlab columns of one gradient,
// one kernel per gradient (MODE: kDq over q rows, kDk and kDv over keys),
// and walks the other side in tiles of 64:
//   S = R X^T, dP = R2 X2^T   over the whole head in kPiece-column depth
//                             pieces through a 2-stage cp.async ring (dQ: R
//                             = Q, X = K, R2 = G, X2 = V; dK and dV: R = K,
//                             X = Q, R2 = V, X2 = G; dV needs no dP);
//   P = exp2(S * scale * log2e + bias * log2e - lse * log2e), dS = P (dP -
//                             delta): the row's words (dQ: lse and delta
//                             of the q row; dK, dV: the key's bias) in
//                             registers, the columns' read per tile; columns
//                             past the other side's length get P = 0;
//   grad += A Y               A = dS (dQ, dK) or P (dV) rounded to bf16, Y
//                             the slab's columns of K (dQ), Q (dK) or G
//                             (dV), copied under the tile's products.
// dQ and dK are scaled once at the end. A key hidden by a -1e9 bias gets P
// == 0 exactly in every row, hence exactly zero dk and dv. Each gradient
// element is written by one block, with no atomics: the same inputs give
// the same bits. Every slab recomputes S and dP (2x the least at d = 640
// for dK and dQ); simple and right first.
constexpr int kXRows = 64;   // rows of a block: 16 a warp
constexpr int kXCols = 64;   // the other side's rows a tile
constexpr int kXSlab = 256;  // the widest slab of a gradient a block accumulates
constexpr int kXThreads = 128;

// Two stages of four piece tiles (R, X, R2, X2), then the Y tile (kXCols x
// sw + 8).
__host__ __device__ inline size_t xwide_smem_bytes(int sw) {
  return 128 + ((size_t)2 * 2 * (kXRows + kXCols) * tiles::kLd + (size_t)kXCols * (sw + 8)) * 2;
}

template <int MODE>
__device__ __forceinline__ void flash_bwd_xwide(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ bias, const bf16* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ grad, int Lq, int Lk, int heads, int d,
    int SW, int slabs, float scale_log2, float scale) {
  constexpr bool kRowsQ = MODE == kDq, kDp = MODE != kDv;
  extern __shared__ unsigned char xwide_bwd_smem[];
  bf16* sm = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(xwide_bwd_smem) + 127) & ~static_cast<uintptr_t>(127));
  constexpr int HALF = (kXRows + kXCols) * tiles::kLd;  // an R piece then an X piece
  constexpr int STAGE = 2 * HALF;                        // S's pair, then dP's
  bf16* yt = sm + 2 * STAGE;
  const int LDY = SW + 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tid = threadIdx.x;
  const int slab = blockIdx.x % slabs, r0 = (blockIdx.x / slabs) * kXRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int C = heads * d, c0 = slab * SW, w = min(SW, d - c0);
  const int Lr = kRowsQ ? Lq : Lk, Lc = kRowsQ ? Lk : Lq;
  const size_t head = (size_t)h * d;
  const bf16* rb = (kRowsQ ? q + (size_t)b * Lq * C : k + (size_t)b * Lk * C) + head;
  const bf16* xb = (kRowsQ ? k + (size_t)b * Lk * C : q + (size_t)b * Lq * C) + head;
  const bf16* r2b = (kRowsQ ? g + (size_t)b * Lq * C : v + (size_t)b * Lk * C) + head;
  const bf16* x2b = (kRowsQ ? v + (size_t)b * Lk * C : g + (size_t)b * Lq * C) + head;
  const bf16* yb = (MODE == kDq ? k + (size_t)b * Lk * C
                                : (MODE == kDk ? q : g) + (size_t)b * Lq * C) + head + c0;
  const float* bb = bias ? bias + (size_t)b * Lk : nullptr;
  const float* lb = lse + ((size_t)b * heads + h) * Lq;
  const float* db = delta + ((size_t)b * heads + h) * Lq;
  const int P = (d + tiles::kPiece - 1) / tiles::kPiece, nct = (Lc + kXCols - 1) / kXCols;
  const int steps = nct * P;

  // the words of this thread's two rows: dQ's -lse * log2e and delta of
  // the q row, dK's and dV's bias * log2e of the key
  float word[2] = {0.f, 0.f}, row_delta[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + warp * 16 + lane / 4 + 8 * r;
    if (row < Lr) {
      if (kRowsQ) {
        word[r] = -lb[row] * kLog2e;
        row_delta[r] = db[row];
      } else if (bb) {
        word[r] = bb[row] * kLog2e;
      }
    }
  }

  auto load_piece = [&](int step) {
    const int ct = step / P, p = step % P, pw = min(tiles::kPiece, d - p * tiles::kPiece);
    bf16* st = sm + (step & 1) * STAGE;
    const int col = p * tiles::kPiece;
    tiles::load_rows_async<kXRows>(st, tiles::kLd, rb + col, C, r0, Lr, pw, tid, kXThreads);
    tiles::load_rows_async<kXCols>(st + kXRows * tiles::kLd, tiles::kLd, xb + col, C,
                                   ct * kXCols, Lc, pw, tid, kXThreads);
    if (kDp) {
      tiles::load_rows_async<kXRows>(st + HALF, tiles::kLd, r2b + col, C, r0, Lr, pw, tid,
                                     kXThreads);
      tiles::load_rows_async<kXCols>(st + HALF + kXRows * tiles::kLd, tiles::kLd, x2b + col, C,
                                     ct * kXCols, Lc, pw, tid, kXThreads);
    }
  };

  float acc[kXSlab / 8][4];
  tiles::zero(acc);
  const int npairs = tiles::round16(w) / 16;
  load_piece(0);
  tiles::cp_async_commit();
  for (int ct = 0; ct < nct; ++ct) {
    float s[kXCols / 8][4], dp[kXCols / 8][4];
    tiles::zero(s);
    tiles::zero(dp);
    for (int p = 0; p < P; ++p) {
      const int step = ct * P + p;
      // the Y tile is free: the last tile's product ended at a barrier
      if (p == 0)
        tiles::load_rows_async<kXCols>(yt, LDY, yb, C, ct * kXCols, Lc, w, tid, kXThreads);
      if (step + 1 < steps) load_piece(step + 1);
      tiles::cp_async_commit();
      tiles::cp_async_wait<1>();  // this step's pieces have landed
      __syncthreads();
      const bf16* st = sm + (step & 1) * STAGE;
      const int ks = tiles::round16(min(tiles::kPiece, d - p * tiles::kPiece)) / 16;
      tiles::mma_abt<kXCols / 8>(s, st + warp * 16 * tiles::kLd, tiles::kLd,
                                 st + kXRows * tiles::kLd, tiles::kLd, ks, lane);
      if (kDp)
        tiles::mma_abt<kXCols / 8>(dp, st + HALF + warp * 16 * tiles::kLd, tiles::kLd,
                                   st + HALF + kXRows * tiles::kLd, tiles::kLd, ks, lane);
      __syncthreads();  // the stage is free for the copy issued next step
    }
#pragma unroll
    for (int j = 0; j < kXCols / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = ct * kXCols + 8 * j + 2 * (lane % 4) + (e & 1);
        float a = 0.f;
        if (col < Lc) {
          float x = s[j][e] * scale_log2 + word[e >> 1], dl = row_delta[e >> 1];
          if (kRowsQ) {
            if (bb) x += bb[col] * kLog2e;
          } else {
            x -= lb[col] * kLog2e;
            dl = db[col];
          }
          const float pr = exp2f(x);
          a = MODE == kDv ? pr : pr * (dp[j][e] - dl);
        }
        s[j][e] = a;
      }
    uint32_t pa[kXCols / 16][4];
#pragma unroll
    for (int t = 0; t < kXCols / 16; ++t) tiles::pack_a(pa[t], s[2 * t], s[2 * t + 1]);
    tiles::cp_async_wait<0>();  // the Y tile (and the next pieces) have landed
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kXCols / 16; ++t)
      tiles::mma_av<kXSlab / 8>(acc, pa[t], yt + t * 16 * LDY, LDY, npairs, lane);
    __syncthreads();  // the Y tile is free
  }
  const float mul[2] = {MODE == kDv ? 1.f : scale, MODE == kDv ? 1.f : scale};
  tiles::store_acc<kXSlab / 8>(grad + (size_t)b * Lr * C + head + c0, C, acc,
                               r0 + warp * 16, Lr, w, mul, lane);
}

// one kernel of its own name per gradient, so a profile tells them apart
#define XWIDE_KERNEL(name, MODE)                                                              \
  __global__ void __launch_bounds__(kXThreads)                                                \
      name(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v, \
           const float* __restrict__ bias, const bf16* __restrict__ g,                        \
           const float* __restrict__ lse, const float* __restrict__ delta,                    \
           bf16* __restrict__ grad, int Lq, int Lk, int heads, int d, int SW, int slabs,      \
           float scale_log2, float scale) {                                                   \
    flash_bwd_xwide<MODE>(q, k, v, bias, g, lse, delta, grad, Lq, Lk, heads, d, SW, slabs,     \
                          scale_log2, scale);                                                 \
  }
XWIDE_KERNEL(flash_bwd_dv_xwide_kernel, kDv)
XWIDE_KERNEL(flash_bwd_dk_xwide_kernel, kDk)
XWIDE_KERNEL(flash_bwd_dq_xwide_kernel, kDq)
#undef XWIDE_KERNEL

template <int MODE, class Kernel>
int launch_xwide(Kernel kernel, const void* q, const void* k, const void* v, const void* bias,
                 const void* g, const void* lse, const void* delta, void* grad, int B, int Lq,
                 int Lk, int heads, int d, int scale_d, cudaStream_t stream) {
  const int slabs = (d + kXSlab - 1) / kXSlab;
  const int SW = tiles::round16((d + slabs - 1) / slabs);
  const int bytes = (int)xwide_smem_bytes(SW);
  cudaError_t e = host_cache.reserve_smem(reinterpret_cast<const void*>(kernel), bytes);
  if (e != cudaSuccess) return (int)e;
  const long long rows = (long long)((MODE == kDq ? Lq : Lk) + kXRows - 1) / kXRows * slabs;
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float scale = 1.f / sqrtf((float)scale_d);
  kernel<<<dim3((unsigned)rows, heads, B), kXThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<const bf16*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<bf16*>(grad),
      Lq, Lk, heads, d, SW, slabs, scale * kLog2e, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Head widths the kernels take: d a multiple of 8 with d <= 128 (SD's UNet
// heads, d = 40 and 80, and the 64- and 128-wide heads of other head counts;
// s and dp contracted over 48 / 80 / 128) or d = 512 (the VAE's one head).
// The logits are scaled by scale_d^-1/2, 1 <= scale_d <= d (the true width
// of a head the wrapper zero-pads, else d). Any d > 512 (a multiple of 8)
// runs in the xwide kernels: dV and dK from the dk/dv entry point, dQ from
// the dq entry point.
extern "C" int hv_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* bias, const void* g, const void* lse,
                                const void* delta, void* dk, void* dv, int B, int Lq,
                                int Lk, int heads, int d, int scale_d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d % 8 != 0 || scale_d < 1 || scale_d > d) return (int)cudaErrorInvalidValue;
#define DKV(Cfg) \
  launch_dkv<Cfg>(q, k, v, bias, g, lse, delta, dk, dv, B, Lq, Lk, heads, d, scale_d, s)
  if (d <= 40) return DKV(DkvCfg48);
  if (d <= 80 && d % 16 == 0) return DKV(DkvCfg80s);
  if (d <= 80) return DKV(DkvCfg80);
  if (d < 128) return DKV(DkvCfg128);
  if (d == 128) return DKV(DkvCfg128w);
#undef DKV
  if (d == 512) {
    const int err = launch_wide<WideDv>(flash_bwd_dv_wide_kernel, q, k, v, bias, g, lse, delta,
                                        dv, B, Lq, Lk, heads, d, scale_d, s);
    if (err) return err;
    return launch_wide<WideDk>(flash_bwd_dk_wide_kernel, q, k, v, bias, g, lse, delta, dk, B,
                               Lq, Lk, heads, d, scale_d, s);
  }
  if (d > 512) {
    const int err = launch_xwide<kDv>(flash_bwd_dv_xwide_kernel, q, k, v, bias, g, lse, delta,
                                      dv, B, Lq, Lk, heads, d, scale_d, s);
    if (err) return err;
    return launch_xwide<kDk>(flash_bwd_dk_xwide_kernel, q, k, v, bias, g, lse, delta, dk, B, Lq,
                             Lk, heads, d, scale_d, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int hv_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* bias, const void* g, const void* lse,
                               const void* delta, void* dq, int B, int Lq, int Lk,
                               int heads, int d, int scale_d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d % 8 != 0 || scale_d < 1 || scale_d > d) return (int)cudaErrorInvalidValue;
#define DQ(Cfg) launch_dq<Cfg>(q, k, v, bias, g, lse, delta, dq, B, Lq, Lk, heads, d, scale_d, s)
  if (d <= 40) return DQ(DqCfg48);
  if (d <= 80 && d % 16 == 0) return DQ(DqCfg80s);
  if (d <= 80) return DQ(DqCfg80);
  if (d < 128) return DQ(DqCfg128);
  if (d == 128) return DQ(DqCfg128w);
#undef DQ
  if (d == 512)
    return launch_wide<WideDq>(flash_bwd_dq_wide_kernel, q, k, v, bias, g, lse, delta, dq, B,
                               Lq, Lk, heads, d, scale_d, s);
  if (d > 512)
    return launch_xwide<kDq>(flash_bwd_dq_xwide_kernel, q, k, v, bias, g, lse, delta, dq, B, Lq,
                             Lk, heads, d, scale_d, s);
  return (int)cudaErrorInvalidValue;
}

// Flash attention backward between 128 and 512 columns, packed heads, bf16,
// for Hopper (sm_90a), at the head's own width.
//
// Replaces: humanvid_tpu/ops/flash_attention.py, the straight-layout Pallas
// kernels `_dkv_kernel` (:354; `pallas_call` :636) and `_dq_kernel` (:537;
// :673) that `_flash_bwd_kernel` takes for d > 128, at the widths 128 < d <
// 512 (d = 512 is flash_attention_bwd.cu's, past 512 its xwide kernels).
//
// Computes what flash_attention_bwd.cu computes (its header has the
// contract): given g = dL/dout, the forward's natural-log `lse` and delta =
// rowsum(g * out), both (B, heads, Lq) fp32,
//   p  = exp2((s * scale + bias) * log2e - lse * log2e),   s = q_h k_h^T
//   dv = p^T g_h,  ds = p * (g_h v_h^T - delta),  dk = ds^T q_h * scale,
//   dq = ds k_h * scale,   scale = scale_d^-1/2 (scale_d the true width)
// with p and ds rounded to bf16 before their products. A key hidden by a
// -1e9 bias gets exactly zero dk and dv in every batch row that sees some
// key. No atomics: the same inputs give the same bits.
//
// Before this file the band ran through a zero pad to 512 and the d = 512
// kernels: the pad copies in and out, zero columns multiplied (2.7x the
// work at d = 192, 1.6x at 320), and 8 products of the size of Q K^T where
// 5 are the least. Here the head is read through 4-D maps (d, heads, L, B)
// (`make_head_map`) in boxes of 32 columns in the 64-byte swizzle: a box's
// columns past the head's last read zeros, never the next head's, and the
// boxes wholly past d are not loaded (zeroed once in shared memory). The
// products run over DQK, the width rounded up to 64. With 32-column boxes
// every multiple of 32 starts a swizzle atom, so a warpgroup's half of the
// gradient's columns (DQK / 2: 96 .. 256) is an operand of its own at every
// DQK.
//
// A block is a producer warp (in a warpgroup of its own, whose registers
// `setmaxnreg` moves to the consumers) and two consumer warpgroups. It owns
// 64 rows (keys for dk/dv, q rows for dq) and their two tiles, loaded once,
// and the producer streams the other side's two tiles in BS-row steps
// through a ring of `stages` (full/empty mbarrier pairs), with each step's
// per-row words (-lse * log2e and delta of q rows; or the keys' bias in
// log2 units, -inf past Lk, and a skip flag), read 128 rows a round with
// every load in flight at once. The recomputed products pass between the
// warpgroups through shared memory, in one of two ways:
//   by role (DQK <= 320): warpgroup 0 computes S^T or S and P, and hands P
//     to warpgroup 1 through a ring of kXSlots buffers with a full and an
//     empty mbarrier each, so that it runs up to two steps ahead;
//   by columns (past 320, where a 64 x DQK fp32 gradient no longer fits a
//     warpgroup): both exchange what they computed, double-buffered by
//     step, one named barrier a step, and each takes half of the
//     gradient's columns (the d = 512 kernels' design at the head's width).
// The kernels:
//   dk/dv merged (by role): FlashAttention's one dk/dv kernel. Warpgroup 0
//     computes S^T = K Q^T, P^T, and dV += P^T G over all DQK columns;
//     warpgroup 1 dP^T = V G^T, dS^T = P^T (dP^T - delta), and dK += dS^T
//     Q. S^T and dP^T once each: 4 products the size of Q K^T, dV and dK of
//     64 keys in registers (DQK / 2 fp32 a thread each, 160 at 320), the
//     two warpgroups' work alike.
//   dq by role: warpgroup 0 S = Q K^T and P, warpgroup 1 dP = G V^T, dS and
//     dQ += dS K over all DQK columns. 3 products; warpgroup 0's S of the
//     next steps runs beside warpgroup 1's dS and dQ.
//   dV, dK (by columns): dV: both warpgroups take half of S^T's depth and
//     add the other's half (the same bits in both), then dV += P^T G. dK:
//     warpgroup 0 S^T and P^T, warpgroup 1 dP^T; both form dS^T, then dK.
//   dq by columns: S on warpgroup 0 and dP on warpgroup 1, exchanged; both
//     form dS and take dQ += dS K over their half of the columns.
// So 7 products at DQK <= 320 (8 past it), each over DQK columns, where the
// pad to 512 took 8 over 512.
// The first products are wgmma m64nBSk16 from shared memory (K-major), the
// gradients' m64nNk16 with A = P^T / dS^T / dS packed to bf16 in registers
// and B the streamed tile, MN-major (N = DQK by role, as a 256- and a
// 64-column product at 320; DQK / 2 by columns). Rows past Lq get -lse =
// -inf and keys past Lk a -inf bias, so their p is 0.
// Hidden keys: a 64-key block all of whose keys carry a bias <= -1e9 writes
// exact zeros to its dk and dv and returns, and the dq producer loads
// nothing for a BS-key step whose keys are all hidden and flags it in the
// words ring, where every row of the block sees some key (its lse > -5e8)
// and |s * scale| < 4e8: the result is the same bits as computing it.
// What bounds it: the tensor cores (long_wide's level-0 stage-2 call, 48 x
// 7168 x 14336 at d = 320: 1.58e13 operations of the least 5 products,
// 15.96 ms at 989 TFLOP/s, against 1.4 GB); each block streams the other
// side's tiles from L2 once. Measured against other designs by `python -m
// humanvid_tpu_torch.tools.flash_variants --mid-bwd` (PERF.md section 6),
// these were slower: a dV and a dK kernel at DQK <= 320 (S^T twice); dq by
// columns at DQK <= 320 (the two warpgroups in lockstep); rings of one
// stage; 32-row steps at DQK = 192; the next step's first product issued
// before this step's softmax (the ring's stage it holds, and ptxas
// serialized the wgmmas behind its branches).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_bwd.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;
using namespace flash_bwd;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kHiddenBias = -1e9f;  // NEG_INF of ops/attention.py
constexpr float kLseFloor = -5e8f;    // a row above it sees some key
constexpr int kBox = 32;              // columns of a TMA box: 64-byte rows
constexpr int kRows = 64;             // owned rows of a block
constexpr int kSmemLimit = 232448;

// kDkv: the merged dk/dv kernel; kDv, kDk: the split one's two kernels;
// kDq: dq with the columns split between the warpgroups; kDqRoles: dq with
// warpgroup 0 on S and P, warpgroup 1 on dP, dS and all of dQ.
enum MidMode { kDkv = 0, kDv = 1, kDk = 2, kDq = 3, kDqRoles = 4 };

// Whether the warpgroups split the work by role (warpgroup 0 passes P or
// P^T one way to warpgroup 1 through a ring of kXSlots buffers with full
// and empty mbarriers) rather than by columns (both exchange, in lockstep).
__host__ __device__ constexpr bool by_roles(int mode) { return mode == kDkv || mode == kDqRoles; }
constexpr int kXSlots = 2;

// Bytes of shared memory a block lays out: the owned tiles (64 x dqk each;
// one for dV), the ring's two streamed tiles (bs x dqk) and words (2 bs
// floats and a flag) a stage, the exchange (64 x bs fp32 buffers: kXSlots
// of warpgroup 0's by role, both warpgroups' twice by step parity by
// columns), the barriers (the exchange ring's too) and 1024 bytes of
// alignment. `mid_bwd_smem` in ops/flash_attention.py reckons the same.
__host__ __device__ constexpr int mid_smem(int mode, int dqk, int bs, int stages) {
  return (mode == kDv ? 1 : 2) * kRows * dqk * 2 + stages * (2 * bs * dqk * 2 + 2 * bs * 4 + 16) +
         (by_roles(mode) ? kXSlots : 4) * kRows * bs * 4 +
         (3 * stages + 1 + (by_roles(mode) ? 2 * kXSlots : 0)) * 8 + 1024;
}

template <int MODE_, int DQK_, int BS_>
struct MidCfg {
  static constexpr int MODE = MODE_;
  static constexpr int DQK = DQK_;
  static constexpr int BS = BS_;
  static constexpr bool KEYS = MODE != kDq && MODE != kDqRoles;  // owns keys (else q rows)
  static constexpr bool MERGED = MODE == kDkv;
  static constexpr bool ROLES = by_roles(MODE);
  static constexpr int DH = ROLES ? DQK : DQK / 2;  // gradient columns of a warpgroup
  static constexpr int OWN = MODE == kDv ? 1 : 2;    // owned tiles
  static constexpr int R_BYTES = kRows * DQK * 2;    // one owned tile
  static constexpr int S_BYTES = BS * DQK * 2;       // one streamed tile
  static constexpr int W_BYTES = 2 * BS * 4 + 16;    // a stage's words and skip flag
  static constexpr int X_FLOATS = BS / 2 * 128;      // a warpgroup's exchange buffer
  static constexpr int XBUFS = ROLES ? kXSlots : 4;
  static_assert(DQK % 64 == 0 && DH % kBox == 0 && BS % 32 == 0, "layout");
  static_assert(ROLES ? DQK <= 320 : DH <= 256, "a warpgroup's gradient columns");
  static_assert(R_BYTES % 1024 == 0 && S_BYTES % 1024 == 0, "tile alignment");
};

// Byte offset of the 16-deep step kk of a K-major tile of `rows` rows in
// 32-column boxes ([boxes][rows][32], 64-byte swizzle).
__device__ __forceinline__ uint32_t kstep(int kk, int rows) {
  return (kk / 2) * rows * 64 + (kk % 2) * 32;
}

// K-major operand: 64 rows of a tile from its first row.
__device__ __forceinline__ uint64_t kmajor(const unsigned char* tile) {
  return gmma_desc(smem_u32(tile), 16, 512, kSwizzle64B);
}

// MN-major operand: the tile's `rows` rows contracted, its columns from
// col0 (a multiple of 32) along N; LBO between 32-column boxes, SBO between
// 8-row atoms.
__device__ __forceinline__ uint64_t mnmajor(const unsigned char* tile, int rows, int col0) {
  return gmma_desc(smem_u32(tile) + (col0 / kBox) * rows * 64, rows * 64, 512, kSwizzle64B);
}

// acc (64 x BS) = A B^T over KS 16-deep steps from step kk0: A 64 owned
// rows, B the BS streamed rows at byte offset `so` of the ring's tile.
template <class C, int KS>
__device__ __forceinline__ void first_product(float (&acc)[C::BS / 2], uint64_t a_desc,
                                              uint64_t b_desc, uint32_t so, int kk0) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    WgmmaSS<C::BS>::run(acc, a_desc + (kstep(kk0 + kk, kRows) >> 4),
                        b_desc + ((so + kstep(kk0 + kk, C::BS)) >> 4), kk > 0);
}

// acc (64 x N) += A B, A a 16-deep step packed in registers, B (MN-major)
// N columns; N past 256 as a 256- and an (N - 256)-column product.
template <int N>
__device__ __forceinline__ void grad_product(float (&acc)[N / 2], const uint32_t (&a)[4],
                                             uint64_t b_desc, int rows) {
  if constexpr (N <= 256) {
    WgmmaRS<N>::run(acc, a, b_desc);
  } else {
    WgmmaRS<256>::run(*reinterpret_cast<float(*)[128]>(acc), a, b_desc);
    WgmmaRS<N - 256>::run(*reinterpret_cast<float(*)[(N - 256) / 2]>(acc + 128), a,
                          b_desc + ((256 / kBox) * rows * 64 >> 4));
  }
}

// Boxes n_box.. of a tile of `rows` rows, which TMA never writes (they lie
// wholly past the head's last column): zero, by every thread of the block.
__device__ __forceinline__ void zero_boxes(unsigned char* tile, int rows, int n_box, int boxes) {
  uint4* pad = reinterpret_cast<uint4*>(tile + n_box * rows * 64);
  const int n = (boxes - n_box) * rows * 4;  // 16-byte words
  for (int i = threadIdx.x; i < n; i += blockDim.x) pad[i] = make_uint4(0u, 0u, 0u, 0u);
}

// One kernel of the band. grad1: dK (merged and dK), dV (dV) or dQ; grad2:
// dV of the merged kernel.
template <class C>
__device__ __forceinline__ void flash_bwd_mid(
    const CUtensorMap* q_map, const CUtensorMap* k_map, const CUtensorMap* v_map,
    const CUtensorMap* g_map, const float* __restrict__ bias, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ grad1, bf16* __restrict__ grad2, int Lq,
    int Lk, int heads, int d, int stages, float scale_log2, float scale) {
  constexpr int BS = C::BS, DQK = C::DQK, DH = C::DH, MODE = C::MODE;
  constexpr bool KEYS = C::KEYS, MERGED = C::MERGED, ROLES = C::ROLES;
  constexpr int BOXES = DQK / kBox;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int off_s1 = C::OWN * C::R_BYTES;
  const int off_s2 = off_s1 + stages * C::S_BYTES;
  const int off_w = off_s2 + stages * C::S_BYTES;
  const int off_x = off_w + stages * C::W_BYTES;
  uint64_t* full_a = reinterpret_cast<uint64_t*>(smem + off_x + C::XBUFS * C::X_FLOATS * 4);
  uint64_t* full_b = full_a + stages;  // tile 2
  uint64_t* empty = full_b + stages;
  uint64_t* full_r = empty + stages;   // the owned tiles
  uint64_t* xfull = full_r + 1;        // by role: the exchange ring's slots
  uint64_t* xempty = xfull + kXSlots;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int r0 = blockIdx.x * kRows;  // the block's first owned row
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C_all = heads * d;
  const int L_own = KEYS ? Lk : Lq;
  const int n_steps = ((KEYS ? Lq : Lk) + BS - 1) / BS;
  const int n_box = (d + kBox - 1) / kBox;  // boxes TMA loads; the rest are zero
  const float* lse_bh = lse + ((size_t)b * heads + h) * Lq;
  const float* delta_bh = delta + ((size_t)b * heads + h) * Lq;
  const float* bias_b = bias ? bias + (size_t)b * Lk : nullptr;

  if constexpr (KEYS) {
    // every key of the block hidden from every row: dk = dv = 0 exactly
    if (bias_b && block_all_le(bias_b + r0, min(kRows, Lk - r0), kHiddenBias) &&
        block_all_gt(lse_bh, Lq, kLseFloor)) {
      const int vecs = d / 8;
      const int n = min(kRows, Lk - r0) * vecs;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const size_t at =
            ((size_t)b * Lk + r0 + i / vecs) * C_all + (size_t)h * d + 8 * (i % vecs);
        *reinterpret_cast<uint4*>(grad1 + at) = make_uint4(0u, 0u, 0u, 0u);
        if (MERGED) *reinterpret_cast<uint4*>(grad2 + at) = make_uint4(0u, 0u, 0u, 0u);
      }
      return;
    }
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full_a[s], 32);  // the producer's lanes (words) + tx
      mbar_init(&full_b[s], 1);   // tx
      mbar_init(&empty[s], 8);    // one per consumer warp
    }
    mbar_init(full_r, 1);
    if (ROLES) {
      for (int i = 0; i < kXSlots; ++i) {
        mbar_init(&xfull[i], 128);   // warpgroup 0's threads
        mbar_init(&xempty[i], 128);  // warpgroup 1's
      }
    }
    fence_barrier_init();
  }
  if (n_box < BOXES) {
    for (int t = 0; t < C::OWN; ++t) zero_boxes(smem + t * C::R_BYTES, kRows, n_box, BOXES);
    for (int t = 0; t < 2 * stages; ++t)
      zero_boxes(smem + off_s1 + t * C::S_BYTES, BS, n_box, BOXES);
    fence_proxy_async();
  }
  __syncthreads();

  // owned tiles and streamed ones: dk/dv K, V; Q, G. dq: Q, G; K, V.
  const CUtensorMap* own1 = KEYS ? k_map : q_map;
  const CUtensorMap* own2 = KEYS ? v_map : g_map;
  const CUtensorMap* str1 = KEYS ? q_map : k_map;
  const CUtensorMap* str2 = KEYS ? g_map : v_map;

  if (wg == 2) {
    // ---------------- producer ----------------
    setmaxnreg_dec<24>();
    if (warp != 0) return;
    // dq: hidden key steps may be passed over only if every row of the
    // block sees some key
    bool may_skip = false;
    if (!KEYS && bias_b) {
      int ok = 1;
      for (int e = 0; e < 2; ++e) {
        const int row = r0 + lane + 32 * e;
        ok &= row >= Lq || lse_bh[row] > kLseFloor;
      }
      may_skip = __all_sync(0xffffffffu, ok);
    }
    if (lane == 0) {
      tma_prefetch_desc(q_map);
      tma_prefetch_desc(k_map);
      tma_prefetch_desc(v_map);
      tma_prefetch_desc(g_map);
      mbar_arrive_expect_tx(full_r, C::OWN * n_box * kRows * 64);
      for (int i = 0; i < n_box; ++i) {
        tma_load_4d(smem + i * kRows * 64, own1, full_r, i * kBox, h, r0, b);
        if (C::OWN == 2)
          tma_load_4d(smem + C::R_BYTES + i * kRows * 64, own2, full_r, i * kBox, h, r0, b);
      }
    }
    // the words of 128 streamed rows a round, 4 a lane, all loads in flight
    // together: dk/dv -lse * log2e and delta of the q rows (p = 0 past Lq);
    // dq the keys' bias in log2 units (-inf past Lk: TMA's zero fill would
    // give s = 0, p != 0). One load's latency a step, where most steps are
    // hidden and pass at once, held the producer back.
    constexpr int LANES = BS / 4;  // the lanes that hold a step's rows
    for (int base = 0; base < n_steps * BS; base += 128) {
      float wa[4], wb[4];
      bool hid = true;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = base + 4 * lane + e;
        if constexpr (KEYS) {
          wa[e] = row < Lq ? -lse_bh[row] * kLog2e : -INFINITY;
          wb[e] = row < Lq ? delta_bh[row] : 0.f;
        } else {
          const float x = row < Lk && bias_b ? bias_b[row] : 0.f;
          hid = hid && (row >= Lk || x <= kHiddenBias);
          wa[e] = row >= Lk ? -INFINITY : x * kLog2e;
          wb[e] = 0.f;
        }
      }
      const unsigned hidden = __ballot_sync(0xffffffffu, hid);
#pragma unroll
      for (int t = 0; t < 128 / BS; ++t) {
        const int step = base / BS + t;
        if (step >= n_steps) break;
        const unsigned mine = (LANES == 32 ? 0xffffffffu : (1u << LANES) - 1u) << (t * LANES);
        const bool skip = may_skip && (hidden & mine) == mine;
        const int s = step % stages;
        mbar_wait(&empty[s], ((step / stages) & 1) ^ 1);
        float* w = reinterpret_cast<float*>(smem + off_w + s * C::W_BYTES);
        if ((mine >> lane) & 1u) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            w[4 * lane + e - t * BS] = wa[e];
            w[BS + 4 * lane + e - t * BS] = wb[e];
          }
        }
        if (lane == 0) {
          reinterpret_cast<int*>(w)[2 * BS] = skip;
          if (skip) {  // nothing loaded: the consumers find the flag
            mbar_arrive(&full_a[s]);
            mbar_arrive(&full_b[s]);
            continue;
          }
          unsigned char* t1 = smem + off_s1 + s * C::S_BYTES;
          unsigned char* t2 = smem + off_s2 + s * C::S_BYTES;
          mbar_arrive_expect_tx(&full_a[s], n_box * BS * 64);
          for (int i = 0; i < n_box; ++i)
            tma_load_4d(t1 + i * BS * 64, str1, &full_a[s], i * kBox, h, step * BS, b);
          mbar_arrive_expect_tx(&full_b[s], n_box * BS * 64);
          for (int i = 0; i < n_box; ++i)
            tma_load_4d(t2 + i * BS * 64, str2, &full_b[s], i * kBox, h, step * BS, b);
        } else {
          mbar_arrive(&full_a[s]);
        }
      }
    }
    return;
  }

  // ---------------- consumers ----------------
  setmaxnreg_inc<240>();
  const int c2 = 2 * (lane % 4);
  const int tid = threadIdx.x % 128;
  // per owned row (this thread's rows 16 warp + lane/4, + 8): dk/dv the
  // key's bias in log2 units (-inf past Lk); dq -lse * log2e and delta
  float ra[2], rb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 16 * warp + lane / 4 + 8 * r;
    if constexpr (KEYS) {
      ra[r] = row >= Lk ? -INFINITY : (bias_b ? bias_b[row] * kLog2e : 0.f);
      rb[r] = 0.f;
    } else {
      ra[r] = row < Lq ? -lse_bh[row] * kLog2e : -INFINITY;
      rb[r] = row < Lq ? delta_bh[row] : 0.f;
    }
  }
  // descriptors without their stage offsets: the owned tiles as A and the
  // streamed ones as B (K-major); the gradient's B (MN-major): merged
  // warpgroup 0 G (dV), warpgroup 1 Q (dK), all columns; dq by role K, all
  // columns; dV G, dK Q, dq K, this warpgroup's half of the columns
  const uint64_t a1_desc = kmajor(smem);
  const uint64_t a2_desc = kmajor(smem + C::R_BYTES);
  const uint64_t b1_desc = kmajor(smem + off_s1);
  const uint64_t b2_desc = kmajor(smem + off_s2);
  const bool g_is_tile2 = MERGED ? wg == 0 : MODE == kDv;
  const uint64_t gt_desc = mnmajor(smem + (g_is_tile2 ? off_s2 : off_s1), BS,
                                   ROLES ? 0 : wg * DH);
  float* xch = reinterpret_cast<float*>(smem + off_x);

  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;

  mbar_wait(full_r, 0);
  int xi = 0;  // the steps computed so far: the exchange's buffer
  for (int step = 0; step < n_steps; ++step) {
    const int s = step % stages;
    const uint32_t parity = (step / stages) & 1;
    const uint32_t so = s * C::S_BYTES;
    const float* w = reinterpret_cast<const float*>(smem + off_w + s * C::W_BYTES);
    mbar_wait(&full_a[s], parity);
    if (!KEYS && reinterpret_cast<const int*>(w)[2 * BS]) {  // a hidden step, not loaded
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      continue;
    }
    // the exchange buffers of this step (slot i of thread t at [i][t]): by
    // role warpgroup 0's P or P^T, the ring's slot xs % kXSlots, used for
    // the (xs / kXSlots)-th time; by columns each warpgroup's own, by parity
    const int xs = xi++;
    float* mine =
        xch + (ROLES ? xs % kXSlots : (xs & 1) * 2 + wg) * C::X_FLOATS + tid;
    const float* other =
        xch + (ROLES ? xs % kXSlots : (xs & 1) * 2 + (wg ^ 1)) * C::X_FLOATS + tid;

    // S^T = K Q^T (dk/dv) or S = Q K^T (dq) on warpgroup 0, dP^T = V G^T or
    // dP = G V^T on warpgroup 1; dV: both warpgroups half of S^T's depth
    float x[BS / 2];
    if (MODE == kDv || wg == 0) {
      wgmma_fence();
      if constexpr (MODE == kDv)
        first_product<C, DQK / 32>(x, a1_desc, b1_desc, so, wg * DQK / 32);
      else
        first_product<C, DQK / 16>(x, a1_desc, b1_desc, so, 0);
      wgmma_commit();
    } else {
      mbar_wait(&full_b[s], parity);
      wgmma_fence();
      first_product<C, DQK / 16>(x, a2_desc, b2_desc, so, 0);
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
    // p = exp2(s * scale*log2e + the streamed row's word + the owned row's
    // word), in place; element 4j + e is owned row 16 warp + lane/4 + 8 (e
    // >> 1), streamed row 8j + c2 + (e & 1)
    if (MODE == kDv || wg == 0) {
#pragma unroll
      for (int j = 0; j < BS / 8; ++j) {
        const float2 wc = *reinterpret_cast<const float2*>(w + 8 * j + c2);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[4 * j + e] =
              fast_exp2(fmaf(x[4 * j + e], scale_log2, (e & 1) ? wc.y : wc.x) + ra[e >> 1]);
      }
    }
    uint32_t a_frag[BS / 16][4];
    if constexpr (MODE == kDv) {
      pack_a<BS>(a_frag, x);
      mbar_wait(&full_b[s], parity);  // G
    } else if constexpr (ROLES) {
      const int slot = xs % kXSlots, use = xs / kXSlots;
      if (wg == 0) {
        // P^T (or P) to warpgroup 1 once it has read the slot's last use
        if (use > 0) mbar_wait(&xempty[slot], (use - 1) & 1);
#pragma unroll
        for (int i = 0; i < BS / 2; ++i) mine[i * 128] = x[i];
        mbar_arrive(&xfull[slot]);
        if constexpr (MODE == kDqRoles) {  // no gradient here: the stage is read
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[s]);
          continue;
        }
        // then dV's operand
        pack_a<BS>(a_frag, x);
        mbar_wait(&full_b[s], parity);  // G
      } else {
        // dS^T = P^T (dP^T - delta), delta per streamed q row; or dS = P
        // (dP - delta), delta per owned row
        mbar_wait(&xfull[slot], use & 1);
#pragma unroll
        for (int j = 0; j < BS / 8; ++j) {
          const float2 dl = *reinterpret_cast<const float2*>(w + BS + 8 * j + c2);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float dd = KEYS ? ((e & 1) ? dl.y : dl.x) : rb[e >> 1];
            x[4 * j + e] = other[(4 * j + e) * 128] * (x[4 * j + e] - dd);
          }
        }
        mbar_arrive(&xempty[slot]);
        pack_a<BS>(a_frag, x);
      }
    } else {
      // P (warpgroup 0) and dP (warpgroup 1) change hands, then both take
      // dS = P (dP - delta): delta per streamed q row (dK) or owned row (dQ)
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
          const float dd = KEYS ? ((e & 1) ? dl.y : dl.x) : rb[e >> 1];
          x[i] = p * (dp - dd);
        }
      }
      pack_a<BS>(a_frag, x);
    }

    // the gradient: += P^T G (dV), dS^T Q (dK), dS K (dQ)
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < BS / 16; ++t)
      grad_product<DH>(acc, a_frag[t], gt_desc + ((so + t * 1024) >> 4), BS);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(a_frag);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // merged: warpgroup 0 dV, warpgroup 1 dK (times scale); dq by role:
  // warpgroup 1 dQ; otherwise this warpgroup's half of the columns (dV
  // unscaled, dK and dQ times scale)
  const int col0 = ROLES ? 0 : wg * DH;
  const int cols = MODE == kDqRoles && wg == 0 ? 0 : min(DH, d - col0);
  const bool unscaled = MERGED ? wg == 0 : MODE == kDv;
  bf16* dst = (MERGED && wg == 0 ? grad2 : grad1) + (size_t)b * L_own * C_all + (size_t)h * d +
              col0;
  if (cols > 0)
    store_acc<DH>(dst, C_all, acc, r0 + 16 * warp, L_own, cols, unscaled ? 1.f : scale, lane);
}

// one kernel of its own name a mode, so a profile tells them apart
#define MID_KERNEL(name, MODE)                                                               \
  template <int DQK, int BS>                                                                 \
  __global__ void __launch_bounds__(384, 1)                                                  \
      name(const __grid_constant__ CUtensorMap q_map,                                        \
           const __grid_constant__ CUtensorMap k_map,                                        \
           const __grid_constant__ CUtensorMap v_map,                                        \
           const __grid_constant__ CUtensorMap g_map, const float* __restrict__ bias,        \
           const float* __restrict__ lse, const float* __restrict__ delta,                   \
           bf16* __restrict__ grad1, bf16* __restrict__ grad2, int Lq, int Lk, int heads,    \
           int d, int stages, float scale_log2, float scale) {                               \
    flash_bwd_mid<MidCfg<MODE, DQK, BS>>(&q_map, &k_map, &v_map, &g_map, bias, lse, delta,   \
                                         grad1, grad2, Lq, Lk, heads, d, stages, scale_log2, \
                                         scale);                                             \
  }
MID_KERNEL(flash_bwd_dkv_mid_kernel, kDkv)
MID_KERNEL(flash_bwd_dv_mid_kernel, kDv)
MID_KERNEL(flash_bwd_dk_mid_kernel, kDk)
MID_KERNEL(flash_bwd_dq_mid_kernel, kDq)
MID_KERNEL(flash_bwd_dqr_mid_kernel, kDqRoles)
#undef MID_KERNEL

HostCache host_cache;

template <int MODE, int DQK, int BS, class Kernel>
int launch_mid(Kernel kernel, const void* q, const void* k, const void* v, const void* bias,
               const void* g, const void* lse, const void* delta, void* grad1, void* grad2,
               int B, int Lq, int Lk, int heads, int d, int scale_d, int stages, int smem,
               cudaStream_t stream) {
  if (stages < 1 || smem != mid_smem(MODE, DQK, BS, stages) || smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  // boxes of 32 columns x the owned tiles' 64 rows or a step's BS rows
  const bool keys = MODE != kDq && MODE != kDqRoles;
  const int qrows = keys ? BS : kRows, krows = keys ? kRows : BS;
  CUtensorMap maps[4];  // q, k, v, g
  int err = make_head_map(&maps[0], q, d, heads, Lq, B, kBox, qrows, CU_TENSOR_MAP_SWIZZLE_64B);
  if (!err)
    err = make_head_map(&maps[1], k, d, heads, Lk, B, kBox, krows, CU_TENSOR_MAP_SWIZZLE_64B);
  if (!err)
    err = make_head_map(&maps[2], v, d, heads, Lk, B, kBox, krows, CU_TENSOR_MAP_SWIZZLE_64B);
  if (!err)
    err = make_head_map(&maps[3], g, d, heads, Lq, B, kBox, qrows, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err) return err;
  cudaError_t e = host_cache.reserve_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e != cudaSuccess) return (int)e;
  const float scale = 1.f / sqrtf((float)scale_d);
  const dim3 grid(((keys ? Lk : Lq) + kRows - 1) / kRows, heads, B);
  kernel<<<grid, 384, smem, stream>>>(maps[0], maps[1], maps[2], maps[3],
                                      static_cast<const float*>(bias),
                                      static_cast<const float*>(lse),
                                      static_cast<const float*>(delta),
                                      static_cast<bf16*>(grad1), static_cast<bf16*>(grad2), Lq,
                                      Lk, heads, d, stages, scale * kLog2e, scale);
  return (int)cudaGetLastError();
}

// The sizes every entry point checks: 128 < d < 512, d a multiple of 8, the
// products' depth x_slice >= d.
bool sizes_ok(int B, int Lq, int Lk, int heads, int d, int scale_d, int x_slice) {
  return B >= 1 && Lq >= 1 && Lk >= 1 && heads >= 1 && B <= 65535 && heads <= 65535 &&
         d > 128 && d < 512 && d % 8 == 0 && scale_d >= 1 && scale_d <= d && x_slice >= d;
}

}  // namespace

// Head widths 128 < d < 512 (a multiple of 8) at the head's own width, on
// the plan `mid_backward_plan` in ops/flash_attention.py computes and the
// wrapper passes as seven ints after scale_d: the products' depth x_slice
// (d rounded up to 64), the layout x_cluster (1: one merged dk/dv kernel;
// 2: a dV and a dK kernel), x_key_tile the q rows of a step, x_stages the
// ring's stages of the first kernel (merged, or dV) and x_smem its bytes;
// with the split layout x_exchange the dK kernel's stages and x_groups its
// bytes (zeros with the merged one). The C side refuses bytes that are not
// its own reckoning (`mid_smem`). The logits are scaled by scale_d^-1/2.
extern "C" int hv_flash_bwd_mid_dkv(const void* q, const void* k, const void* v,
                                    const void* bias, const void* g, const void* lse,
                                    const void* delta, void* dk, void* dv, int B, int Lq,
                                    int Lk, int heads, int d, int scale_d, int x_slice,
                                    int x_cluster, int x_groups, int x_key_tile, int x_stages,
                                    int x_exchange, int x_smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!sizes_ok(B, Lq, Lk, heads, d, scale_d, x_slice)) return (int)cudaErrorInvalidValue;
#define MERGED(DQK, BS)                                                                      \
  launch_mid<kDkv, DQK, BS>(flash_bwd_dkv_mid_kernel<DQK, BS>, q, k, v, bias, g, lse, delta,  \
                            dk, dv, B, Lq, Lk, heads, d, scale_d, x_stages, x_smem, s)
#define SPLIT(DQK, BS)                                                                       \
  {                                                                                          \
    const int err = launch_mid<kDv, DQK, BS>(flash_bwd_dv_mid_kernel<DQK, BS>, q, k, v, bias, \
                                             g, lse, delta, dv, nullptr, B, Lq, Lk, heads,   \
                                             d, scale_d, x_stages, x_smem, s);               \
    if (err) return err;                                                                     \
    return launch_mid<kDk, DQK, BS>(flash_bwd_dk_mid_kernel<DQK, BS>, q, k, v, bias, g, lse,  \
                                    delta, dk, nullptr, B, Lq, Lk, heads, d, scale_d,         \
                                    x_exchange, x_groups, s);                                \
  }
  if (x_cluster == 1) {
    if (x_groups || x_exchange) return (int)cudaErrorInvalidValue;
    if (x_slice == 192 && x_key_tile == 64) return MERGED(192, 64);
    if (x_slice == 256 && x_key_tile == 64) return MERGED(256, 64);
    if (x_slice == 320 && x_key_tile == 32) return MERGED(320, 32);
  } else if (x_cluster == 2 && x_key_tile == 32) {
    if (x_slice == 384) SPLIT(384, 32)
    if (x_slice == 448) SPLIT(448, 32)
    if (x_slice == 512) SPLIT(512, 32)
  }
#undef MERGED
#undef SPLIT
  return (int)cudaErrorInvalidValue;
}

// dq on the plan's dq ints: x_slice the products' depth, x_cluster the
// layout (1: by role, 2: by columns), x_key_tile the keys of a step,
// x_stages the ring's stages, x_smem their bytes; the others zero.
extern "C" int hv_flash_bwd_mid_dq(const void* q, const void* k, const void* v,
                                   const void* bias, const void* g, const void* lse,
                                   const void* delta, void* dq, int B, int Lq, int Lk,
                                   int heads, int d, int scale_d, int x_slice, int x_cluster,
                                   int x_groups, int x_key_tile, int x_stages, int x_exchange,
                                   int x_smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!sizes_ok(B, Lq, Lk, heads, d, scale_d, x_slice) || x_groups || x_exchange)
    return (int)cudaErrorInvalidValue;
#define DQ(MODE, KERNEL, DQK, BS)                                                                \
  launch_mid<MODE, DQK, BS>(KERNEL<DQK, BS>, q, k, v, bias, g, lse, delta, dq, nullptr, B, Lq, Lk, \
                            heads, d, scale_d, x_stages, x_smem, s)
#define ROLES(DQK, BS) DQ(kDqRoles, flash_bwd_dqr_mid_kernel, DQK, BS)
#define COLUMNS(DQK, BS) DQ(kDq, flash_bwd_dq_mid_kernel, DQK, BS)
  if (x_cluster == 1) {
    if (x_slice == 192 && x_key_tile == 64) return ROLES(192, 64);
    if (x_slice == 256 && x_key_tile == 32) return ROLES(256, 32);
    if (x_slice == 320 && x_key_tile == 32) return ROLES(320, 32);
  } else if (x_cluster == 2) {
    if (x_slice == 384 && x_key_tile == 32) return COLUMNS(384, 32);
    if (x_slice == 448 && x_key_tile == 32) return COLUMNS(448, 32);
    if (x_slice == 512 && x_key_tile == 32) return COLUMNS(512, 32);
  }
#undef ROLES
#undef COLUMNS
#undef DQ
  return (int)cudaErrorInvalidValue;
}

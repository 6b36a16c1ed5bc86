// Flash attention forward, packed heads, bf16, for Hopper (sm_90a): kernel A.
//
// Replaces: humanvid_tpu/ops/flash_attention.py, the Pallas kernels
// `_fwd_kernel_t` (:172, d + 1 <= 128) and `_fwd_kernel` (:96, wide heads),
// both launched by `_flash_fwd` (:323); past d = 512, the xwide kernel at
// the end of this file.
//
// Computes, for each batch row b and head h,
//   out_h = softmax(q_h k_h^T * d_s^-1/2 + bias[b]) v_h
// where d_s (`scale_d`) is the head's true width: d itself, or, for a head
// the wrapper zero-pads to a width the kernel holds, the width before the
// pad (the pad columns add nothing to q_h k_h^T).
// with q (B, Lq, heads*d), k/v (B, Lk, heads*d) and out (B, Lq, heads*d):
// heads sit side by side in the channel axis and head h is read at column
// offset h*d, so no head split/merge transpose exists outside the kernel.
// The optional bias is fp32 (B, Lk), additive per key (the CFG reference-KV
// disable uses -1e9). The kernel also writes the per-(row, head)
// log-sum-exp (B, heads, Lq) in fp32, in NATURAL-log units (the JAX kernel
// keeps log2 units), which the backward kernels recompute p from.
//
// What bounds it on the H100: a call is 4*Lq*Lk*d tensor-core operations
// against one read of q, k and v (level 0: 2.3 TFLOP, ~0.1 GB; the VAE's
// d = 512 head: 0.6 TFLOP, 0.2 GB), so the tensor cores bound it on paper.
// At d = 40, though, a logit is only 176 flops of products (48 + 40 deep)
// against ~5 instructions of softmax (max, FMA, exp2, sum, half a bf16
// pack): the consumer warps' instruction issue comes first. At d = 80 the
// K/V loads (16-byte TMA boxes, below) come first.
//
// Design (FlashAttention-3's shape, without its ping-pong scheduling).
// A block is 1 producer warpgroup and NC consumer warpgroups that run
// `wgmma`; the producer's first warp keeps TMA loads of K, V and the
// per-key bias in flight into a ring of stages (full/empty mbarrier
// pairs), and `setmaxnreg` moves its registers to the consumers. Per key
// tile a consumer warpgroup computes
//   S = Q K^T        wgmma, A = Q and B = K from shared memory, K-major;
//   softmax          in the log2 domain on the fp32 accumulators: one FMA
//                    folds scale*log2(e) with the bias (or with the running
//                    max when there is none), row maxima over the 4 lanes of
//                    a quad; O is rescaled only in warps where a max moved;
//   O += P V         wgmma, A = P from registers (S's accumulators repacked
//                    as bf16: they are the A fragment), B = V from shared
//                    memory, MN-major (keys contracted, d contiguous);
// then releases the stage. The warpgroups overlap one another: while one
// runs its softmax, the others' products use the tensor cores. Keys >= Lk
// get -inf through the bias tile (TMA fills them with zeros, which would
// give s = 0), rows >= Lq are not stored. No atomics: the same inputs give
// the same bits.
//
// Tiles and layouts, per head width:
//   d <= 80 (Cfg<48, 40> for d <= 40, Cfg<80, 80> up to 80): 3 consumer
//     warpgroups own 64 query rows each (BQ = 192) and share each 128-key
//     tile (BK = 128); 3 stages; 160 registers a consumer thread, 24 in the
//     producer. Every tile uses the no-swizzle layout: TMA boxes of 8
//     columns x rows (16 bytes a row) land as column slabs [d/8][rows][8],
//     the interleaved core-matrix layout for Q and K (K-major: LBO =
//     rows*16, SBO = 128) and for V (MN-major: LBO = 128, SBO = rows*16).
//     A box is 8 columns wide because a 40- or 80-column head is no
//     multiple of a swizzle row (64 columns) and a wider box at column h*40
//     would read the next head's first columns (at the last head, past C).
//     QK^T's contracted axis is padded to 48 at d = 40 (to 80 below 80):
//     the pad slabs of Q and of each K stage are zeroed once at the start
//     and never written by TMA, so the pad reads zeros. PV's N is d (40):
//     no pad. Shared memory at d = 40: Q 18 KB + 3 x (K 12 + V 10 + bias
//     0.5) KB = 86.6 KB with the barriers and alignment; at d = 80: 152.6 KB.
//   d = 512 (Cfg<512, 256, wide>): a 64 x 512 fp32 O is 256 registers a
//     thread in one warpgroup, so 2 consumer warpgroups take the same 64
//     query rows and split O's columns, 256 each (128 registers; 240 a
//     consumer thread). Each computes the full 512-deep S itself: S is
//     computed twice per query tile (the mma.sync kernel computed it 4
//     times, once per 128-column chunk), 2*QK + PV = 1.5x the least
//     product work, and no exchange between the warpgroups. BK = 32 keys,
//     2 stages. Tiles use the 128-byte swizzle: TMA boxes of 64 columns x
//     rows (CU_TENSOR_MAP_SWIZZLE_128B) land as [8][rows][64] (K-major Q and
//     K: SBO = 1024, a 16-deep step moves the start by 32 bytes inside the
//     row; MN-major V: LBO = rows*128 between 64-column atoms, SBO = 1024
//     between 8-key atoms). Shared memory: Q 64 KB + 2 x (K 32 + V 32) KB =
//     192 KB (193.3 KB with the bias, barriers and alignment) of 227 KB.
//   80 < d <= 128 (Cfg128): FlashAttention-3's d = 128 point. At d = 128
//     the d <= 80 shape does not fit: Q of 192 rows is 48 KB and 3 stages of
//     K and V 192 KB. So 2 consumer warpgroups own 64 query rows each (BQ =
//     128) and share 128-key tiles, 2 stages: Q 32 KB + 2 x (K 32 + V 32)
//     KB = 160 KB (162 KB with the bias, barriers and alignment); 240
//     registers a consumer thread (S and O 64 each, P 32). At d = 128 a
//     head is two whole 64-column rows, so the 128-byte swizzle with
//     64-column boxes never reads the next head's columns (unlike at 40 and
//     80): Cfg128<true> takes the d = 512 path's layouts (K-major Q and K,
//     MN-major V, the 16-key step of PV 2048 bytes). Widths 88..120 keep
//     8-column boxes, QK^T's depth padded to 128 by zeroed slabs as d = 40
//     pads to 48 (Cfg128<false>); PV's N is 128, the columns past d are not
//     stored.
// TMA maps are 3-D (C, L, B), so a ragged last tile reads zeros, never the
// next batch row's keys or queries. They are encoded on the host for each
// call (`make_map` in hopper.cuh: cuTensorMapEncodeTiled through the
// runtime's driver entry point, no libcuda) and passed as __grid_constant__
// parameters. Each configuration's shared-memory limit is raised once a
// process (`HostCache::reserve_smem`), not on every launch.
// `-Xptxas -v` on the H100: no spills at any width (168 registers a thread
// at launch with 2 consumers, 128 with 3; setmaxnreg sets the rest).
//
// Measured on the H100 against other designs (`python -m
// humanvid_tpu_torch.tools.flash_variants`, PERF.md section 6): 2 consumer
// warpgroups (BQ = 128) were ~1.2x slower at level 0 and ~1.4x at level 1;
// one exp2 in 8 on an FMA polynomial, or P's bf16 pack by integer rounding,
// slower too (the consumers are bound by instruction issue, not by the
// SFU). FA3's intra-warpgroup overlap (S of tile j+1 issued before PV of
// tile j) and cp.async loads from the producer warpgroup were slower as
// well; row sums from a ones column beside V cost the LSE its accuracy.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_tiles.cuh"

namespace {

using namespace hopper;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// DQK: QK^T's contracted depth (d padded to 16); DV: the output columns of
// one consumer warpgroup; WIDE: d = 512, the warpgroups split the columns;
// NC: consumer warpgroups; SWZ: the 128-byte swizzle with 64-column boxes
// (else 8-column boxes, no swizzle).
template <int DQK_, int DV_, bool WIDE_, int NC_>
struct Cfg {
  static constexpr int DQK = DQK_;
  static constexpr int DV = DV_;
  static constexpr bool WIDE = WIDE_;
  static constexpr bool SWZ = WIDE_;
  static constexpr int NC = NC_;
  static constexpr int THREADS = 128 * (NC + 1);  // + the producer warpgroup
  // setmaxnreg: the producer's registers go to the consumers
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = NC == 2 ? 240 : 160;
  static_assert(128 * (PRODUCER_REGS + NC * CONSUMER_REGS) <= 65536, "registers");
  static constexpr int BQ = WIDE ? 64 : 64 * NC;  // query rows per block
  static constexpr int BK = WIDE ? 32 : 128;      // keys per stage
  static constexpr int STAGES = WIDE ? 2 : 3;
  static constexpr int DVT = WIDE ? DV * NC : DV;  // v columns in a stage
  static constexpr int CW = WIDE ? 64 : 8;         // columns of one TMA box
  static constexpr uint32_t LAYOUT = WIDE ? kSwizzle128B : kNoSwizzle;
  static constexpr int Q_BYTES = BQ * DQK * 2;
  static constexpr int K_BYTES = BK * DQK * 2;
  static constexpr int V_BYTES = BK * DVT * 2;
  // shared memory: Q, K ring, V ring, bias ring, barriers (1024-aligned tiles)
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * K_BYTES;
  static constexpr int OFF_BIAS = OFF_V + STAGES * V_BYTES;
  static constexpr int OFF_BAR = OFF_BIAS + STAGES * BK * 4;
  static constexpr int SMEM = OFF_BAR + (3 * STAGES + 1) * 8 + 1024;  // + alignment
  static_assert(Q_BYTES % 1024 == 0 && K_BYTES % 1024 == 0 && V_BYTES % 1024 == 0, "");
  static_assert(SMEM <= 232448, "shared memory");
};

// 80 < d <= 128: 2 consumer warpgroups of 64 query rows over 128-key tiles
// in 2 stages; SWZ at d = 128 (the header).
template <bool SWZ_>
struct Cfg128 {
  static constexpr int DQK = 128;
  static constexpr int DV = 128;
  static constexpr bool WIDE = false;
  static constexpr bool SWZ = SWZ_;
  static constexpr int NC = 2;
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = 240;
  static_assert(128 * (PRODUCER_REGS + NC * CONSUMER_REGS) <= 65536, "registers");
  static constexpr int BQ = 64 * NC;
  static constexpr int BK = 128;
  static constexpr int STAGES = 2;
  static constexpr int DVT = DV;
  static constexpr int CW = SWZ ? 64 : 8;
  static constexpr uint32_t LAYOUT = SWZ ? kSwizzle128B : kNoSwizzle;
  static constexpr int Q_BYTES = BQ * DQK * 2;
  static constexpr int K_BYTES = BK * DQK * 2;
  static constexpr int V_BYTES = BK * DVT * 2;
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * K_BYTES;
  static constexpr int OFF_BIAS = OFF_V + STAGES * V_BYTES;
  static constexpr int OFF_BAR = OFF_BIAS + STAGES * BK * 4;
  static constexpr int SMEM = OFF_BAR + (3 * STAGES + 1) * 8 + 1024;
  static_assert(Q_BYTES % 1024 == 0 && K_BYTES % 1024 == 0 && V_BYTES % 1024 == 0, "");
  static_assert(SMEM <= 232448, "shared memory");
};

// Byte offset of the 16-deep step kk of a K-major tile of `rows` rows.
template <class C>
__device__ __forceinline__ uint32_t kmajor_step(int kk, int rows) {
  if constexpr (C::SWZ) return (kk / 4) * rows * 128 + (kk % 4) * 32;
  else return 2 * kk * rows * 16;
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, const float* __restrict__ bias,
                 bf16* __restrict__ out, float* __restrict__ lse, int Lq, int Lk, int heads,
                 int d, float scale_log2) {
  constexpr int BQ = C::BQ, BK = C::BK, STAGES = C::STAGES, DQK = C::DQK, DV = C::DV;
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
  // column boxes of a q/k/v head: d/8 slabs, or 8 swizzled 64-column blocks
  const int n_box = d / C::CW;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 32);  // the producer warp's lanes (bias writes)
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], 4 * NC);  // one arrival per consumer warp
    }
    mbar_init(full_q, 1);
    fence_barrier_init();
  }
  if constexpr (!C::SWZ) {
    // Trap: the contracted pad (d = 40 -> 48, or d < 80 -> 80) must read
    // zeros. TMA writes only the d/8 slabs of a head; the pad slabs of Q and
    // of every K stage are zeroed here once and never written again.
    for (int s = -1; s < STAGES; ++s) {
      unsigned char* tile = s < 0 ? sQ : sK + s * C::K_BYTES;
      const int rows = s < 0 ? BQ : BK;
      uint4* pad = reinterpret_cast<uint4*>(tile + n_box * rows * 16);
      const int n = (DQK / 8 - n_box) * rows;
      for (int i = threadIdx.x; i < n; i += C::THREADS) pad[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    fence_proxy_async();
  }
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
      mbar_arrive_expect_tx(full_q, BQ * n_box * C::CW * 2);
      for (int i = 0; i < n_box; ++i)
        tma_load_3d(sQ + i * BQ * C::CW * 2, &q_map, full_q, col0 + i * C::CW, q0, b);
    }
    for (int kt = 0; kt < n_kv; ++kt) {
      const int s = kt % STAGES;
      const int k0 = kt * BK;
      mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
      // the bias tile, log2 units; keys >= Lk are masked here
      for (int c = lane; c < BK; c += 32) {
        const int key = k0 + c;
        sBias[s * BK + c] = key >= Lk ? -INFINITY
                                      : (bias ? bias[(size_t)b * Lk + key] * kLog2e : 0.f);
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full_k[s], BK * n_box * C::CW * 2);
        for (int i = 0; i < n_box; ++i)
          tma_load_3d(sK + s * C::K_BYTES + i * BK * C::CW * 2, &k_map, &full_k[s],
                      col0 + i * C::CW, k0, b);
        mbar_arrive_expect_tx(&full_v[s], BK * n_box * C::CW * 2);
        for (int i = 0; i < n_box; ++i)
          tma_load_3d(sV + s * C::V_BYTES + i * BK * C::CW * 2, &v_map, &full_v[s],
                      col0 + i * C::CW, k0, b);
      } else {
        mbar_arrive(&full_k[s]);
      }
    }
    return;
  }

  // ---------------- consumers ----------------
  setmaxnreg_inc<C::CONSUMER_REGS>();
  const int qoff = C::WIDE ? 0 : 64 * wg;  // this warpgroup's first query row
  const int voff = C::WIDE ? DV * wg : 0;  // and first v/out column
  const int g = lane / 4;
  const int c2 = 2 * (lane % 4);

  // descriptors without their start offsets
  const uint32_t q_addr = smem_u32(sQ) + (C::SWZ ? qoff * 128 : qoff * 16);
  const uint64_t q_desc =
      C::SWZ ? gmma_desc(q_addr, 16, 1024, C::LAYOUT) : gmma_desc(q_addr, BQ * 16, 128, C::LAYOUT);
  const uint64_t k_desc0 = C::SWZ ? gmma_desc(smem_u32(sK), 16, 1024, C::LAYOUT)
                                  : gmma_desc(smem_u32(sK), BK * 16, 128, C::LAYOUT);
  const uint32_t v_addr = smem_u32(sV) + (C::SWZ ? (voff / 64) * BK * 128 : 0);
  const uint64_t v_desc0 = C::SWZ ? gmma_desc(v_addr, BK * 128, 1024, C::LAYOUT)
                                  : gmma_desc(v_addr, 128, BK * 16, C::LAYOUT);

  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  float m_row[2] = {-INFINITY, -INFINITY};  // running max, scaled log2 units
  float l_row[2] = {0.f, 0.f};              // partial sums over this lane's columns
  const bool has_bias = bias != nullptr;

  mbar_wait(full_q, 0);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int s = kt % STAGES;
    const uint32_t parity = (kt / STAGES) & 1;
    mbar_wait(&full_k[s], parity);

    // S = Q K^T (64 rows x BK keys)
    float sc[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) {
      WgmmaSS<BK>::run(sc, q_desc + (kmajor_step<C>(kk, BQ) >> 4),
                       k_desc0 + ((s * C::K_BYTES + kmajor_step<C>(kk, BK)) >> 4), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // online softmax, log2 domain, in place: sc[4j + e] (key 8j + c2 +
    // (e & 1) of row g + 8 * (e >> 1)) becomes p
    const float* bt = sBias + s * BK;
    const bool use_bias = has_bias || (kt + 1) * BK > Lk;
    float mx[2] = {-INFINITY, -INFINITY};
    if (use_bias) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float2 bb = *reinterpret_cast<const float2*>(bt + 8 * j + c2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[4 * j + e] = fmaf(sc[4 * j + e], scale_log2, (e & 1) ? bb.y : bb.x);
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      mx[0] *= scale_log2;  // scale > 0: the max commutes with it
      mx[1] *= scale_log2;
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_row[r], mx[r]);
      // a row whose keys are all masked so far keeps p = 0, alpha = 0
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = fast_exp2(m_row[r] - m_use[r]);
      m_row[r] = m_new;
      l_row[r] *= alpha[r];
    }
    // the biased logits are scaled already; raw ones take the scale here
    const float mul = use_bias ? 1.f : scale_log2;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      sc[i] = fast_exp2(fmaf(sc[i], mul, -m_use[(i >> 1) & 1]));
      l_row[(i >> 1) & 1] += sc[i];
    }
    // P as bf16: n8 blocks 2t and 2t+1 form the A fragment of the 16-key step t
    uint32_t p[BK / 16][4];
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) p[t][i] = pack_bf16x2(sc[8 * t + 2 * i], sc[8 * t + 2 * i + 1]);
    }
    // O *= alpha, in the warps where a row max moved
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
    }

    // O += P V
    mbar_wait(&full_v[s], parity);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      const uint32_t step = C::SWZ ? t * 2048 : t * 256;  // 16 keys
      WgmmaRS<DV>::run(o, p[t], v_desc0 + ((s * C::V_BYTES + step) >> 4));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // finish the row sums across the 4 lanes that share a row, then store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 1);
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
  }
  const int row0 = q0 + qoff + 16 * warp + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Lq) continue;
    const float inv = 1.f / l_row[r];
    bf16* orow = out + ((size_t)b * Lq + row) * C_all + (size_t)h * d + voff;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      if (8 * j < d) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + c2) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      }
    }
    if (voff == 0 && lane % 4 == 0) {
      lse[((size_t)b * heads + h) * Lq + row] = (m_row[r] + log2f(l_row[r])) * kLn2;
    }
  }
}

HostCache host_cache;

template <class C>
int launch(const void* q, const void* k, const void* v, const void* bias, void* out, void* lse,
           int B, int Lq, int Lk, int heads, int d, int scale_d, cudaStream_t stream) {
  CUtensorMap maps[3];
  const int C_all = heads * d;
  int err = make_map(&maps[0], q, C_all, Lq, B, C::CW, C::BQ, C::SWZ);
  if (!err) err = make_map(&maps[1], k, C_all, Lk, B, C::CW, C::BK, C::SWZ);
  if (!err) err = make_map(&maps[2], v, C_all, Lk, B, C::CW, C::BK, C::SWZ);
  if (err) return err;
  auto kernel = flash_fwd_kernel<C>;
  cudaError_t e = host_cache.reserve_smem(reinterpret_cast<const void*>(kernel), C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Lq + C::BQ - 1) / C::BQ, heads, B);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
      maps[0], maps[1], maps[2],
      static_cast<const float*>(bias), static_cast<bf16*>(out),
      static_cast<float*>(lse), Lq, Lk, heads, d, kLog2e / sqrtf((float)scale_d));
  return (int)cudaGetLastError();
}

// ---- heads wider than 512 columns: the xwide kernel -------------------------
//
// The d = 512 design keeps its 64-row Q tile resident (64 KB); a 640-wide
// one is 80 KB and a 1280-wide one 160 KB, which beside a K/V ring do not
// fit 227 KB, and a 64 x d fp32 O does not fit one warpgroup's registers.
// So a block (4 warps, 16 query rows each, 64 rows) owns one slab of at
// most kXSlab of O's columns (the grid's x axis walks the row tiles and
// the slabs), and walks the keys in tiles of kXKeys:
//   S = Q K^T    over the whole head, in kPiece-column depth pieces: each
//                piece of Q and K copied by cp.async into a 2-stage ring
//                (the next piece's copy runs under this piece's mma.sync);
//   softmax      online, in the log2 domain (scale * log2e folded with the
//                bias in one FMA, keys >= Lk at -inf), O rescaled when a
//                row's max moves; P rounded to bf16 unnormalized, as the
//                d <= 512 kernels round it;
//   O += P V     over the slab's columns of V, whose tile is copied under
//                the key tile's S.
// Each block computes S for its slab, so a head of ceil(d / kXSlab) slabs
// does that many QK^T products (at d = 640: 3, or 2x the least product
// work). The row's log-sum-exp is written by slab 0. No atomics: the same
// inputs give the same bits. What bounds it is the tensor cores (at the
// 768x512 level-1 cond call, 48 x 1536 x 3072 x 640, 5.8e11 operations
// against 0.57 GB); mma.sync, synchronous phases and the recomputed S keep
// it well short of that: simple and right first.
constexpr int kXRows = 64;   // query rows of a block: 16 a warp
constexpr int kXKeys = 64;   // keys a tile
constexpr int kXSlab = 256;  // the widest slab of O a block accumulates
constexpr int kXThreads = 128;

// Q and K piece tiles in two stages, then the V tile (kXKeys x sw + 8).
__host__ __device__ inline size_t xwide_smem_bytes(int sw) {
  return 128 + ((size_t)2 * (kXRows + kXKeys) * tiles::kLd + (size_t)kXKeys * (sw + 8)) * 2;
}

__global__ void __launch_bounds__(kXThreads)
flash_fwd_xwide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ bias,
                       bf16* __restrict__ out, float* __restrict__ lse, int Lq, int Lk,
                       int heads, int d, int SW, int slabs, float scale_log2) {
  extern __shared__ unsigned char xwide_smem[];
  bf16* sm = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(xwide_smem) + 127) & ~static_cast<uintptr_t>(127));
  constexpr int STAGE = (kXRows + kXKeys) * tiles::kLd;  // a stage: Q piece, then K piece
  bf16* vt = sm + 2 * STAGE;
  const int LDV = SW + 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tid = threadIdx.x;
  const int slab = blockIdx.x % slabs, q0 = (blockIdx.x / slabs) * kXRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int C = heads * d, c0 = slab * SW, w = min(SW, d - c0);
  const bf16* qb = q + (size_t)b * Lq * C + (size_t)h * d;
  const bf16* kb = k + (size_t)b * Lk * C + (size_t)h * d;
  const bf16* vb = v + (size_t)b * Lk * C + (size_t)h * d + c0;
  const float* bb = bias ? bias + (size_t)b * Lk : nullptr;
  const int P = (d + tiles::kPiece - 1) / tiles::kPiece, nkt = (Lk + kXKeys - 1) / kXKeys;
  const int steps = nkt * P;

  auto load_piece = [&](int step) {
    const int kt = step / P, p = step % P, pw = min(tiles::kPiece, d - p * tiles::kPiece);
    bf16* st = sm + (step & 1) * STAGE;
    tiles::load_rows_async<kXRows>(st, tiles::kLd, qb + p * tiles::kPiece, C, q0, Lq, pw, tid,
                                   kXThreads);
    tiles::load_rows_async<kXKeys>(st + kXRows * tiles::kLd, tiles::kLd, kb + p * tiles::kPiece,
                                   C, kt * kXKeys, Lk, pw, tid, kXThreads);
  };

  float o[kXSlab / 8][4];
  tiles::zero(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int npairs = tiles::round16(w) / 16;
  load_piece(0);
  tiles::cp_async_commit();
  for (int kt = 0; kt < nkt; ++kt) {
    float s[kXKeys / 8][4];
    tiles::zero(s);
    for (int p = 0; p < P; ++p) {
      const int step = kt * P + p;
      // the V tile is free: the last key tile's PV ended at a barrier
      if (p == 0)
        tiles::load_rows_async<kXKeys>(vt, LDV, vb, C, kt * kXKeys, Lk, w, tid, kXThreads);
      if (step + 1 < steps) load_piece(step + 1);
      tiles::cp_async_commit();
      tiles::cp_async_wait<1>();  // this step's piece has landed
      __syncthreads();
      const bf16* st = sm + (step & 1) * STAGE;
      const int pw = min(tiles::kPiece, d - p * tiles::kPiece);
      tiles::mma_abt<kXKeys / 8>(s, st + warp * 16 * tiles::kLd, tiles::kLd,
                                 st + kXRows * tiles::kLd, tiles::kLd, tiles::round16(pw) / 16,
                                 lane);
      __syncthreads();  // the stage is free for the copy issued next step
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kXKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt * kXKeys + 8 * j + 2 * (lane % 4) + (e & 1);
        float x = -INFINITY;
        if (key < Lk) x = s[j][e] * scale_log2 + (bb ? bb[key] * kLog2e : 0.f);
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float ref[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], tiles::quad_max(mx[r]));
      ref[r] = mn == -INFINITY ? 0.f : mn;  // no key so far: every p is 0
      const float corr = exp2f(m[r] - ref[r]);
      l[r] *= corr;
#pragma unroll
      for (int n = 0; n < kXSlab / 8; ++n) {
        o[n][2 * r] *= corr;
        o[n][2 * r + 1] *= corr;
      }
      m[r] = mn;
    }
    uint32_t pa[kXKeys / 16][4];
#pragma unroll
    for (int j = 0; j < kXKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - ref[e >> 1]);
        l[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int t = 0; t < kXKeys / 16; ++t) tiles::pack_a(pa[t], s[2 * t], s[2 * t + 1]);
    tiles::cp_async_wait<0>();  // the V tile (and the next piece) have landed
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kXKeys / 16; ++t)
      tiles::mma_av<kXSlab / 8>(o, pa[t], vt + t * 16 * LDV, LDV, npairs, lane);
    __syncthreads();  // the V tile is free
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = tiles::quad_sum(l[r]);
    inv[r] = 1.f / l[r];
  }
  const int row0 = q0 + warp * 16;
  tiles::store_acc<kXSlab / 8>(out + (size_t)b * Lq * C + (size_t)h * d + c0, C, o, row0, Lq, w,
                               inv, lane);
  if (slab == 0 && lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + lane / 4 + 8 * r;
      if (row < Lq) lse[((size_t)b * heads + h) * Lq + row] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

int launch_xwide(const void* q, const void* k, const void* v, const void* bias, void* out,
                 void* lse, int B, int Lq, int Lk, int heads, int d, int scale_d,
                 cudaStream_t stream) {
  const int slabs = (d + kXSlab - 1) / kXSlab;
  const int SW = tiles::round16((d + slabs - 1) / slabs);
  const int bytes = (int)xwide_smem_bytes(SW);
  const void* fn = reinterpret_cast<const void*>(flash_fwd_xwide_kernel);
  cudaError_t e = host_cache.reserve_smem(fn, bytes);
  if (e != cudaSuccess) return (int)e;
  const long long rows = (long long)(Lq + kXRows - 1) / kXRows * slabs;
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)rows, heads, B);
  flash_fwd_xwide_kernel<<<grid, kXThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<bf16*>(out), static_cast<float*>(lse), Lq, Lk,
      heads, d, SW, slabs, kLog2e / sqrtf((float)scale_d));
  return (int)cudaGetLastError();
}

}  // namespace

// Head widths the kernel takes: d a multiple of 8 with d <= 128 (SD's UNet
// heads, d = 40 and 80, and the 64- and 128-wide heads of other head counts;
// QK^T's depth padded to 48 / 80 / 128) or d = 512 (the VAE's one head). The
// logits are scaled by scale_d^-1/2, 1 <= scale_d <= d: the wrapper passes
// the true width of a head it zero-pads (ops/flash_attention.py,
// `flash_plan`), else d. Any d > 512 (a multiple of 8) runs in the xwide
// kernel.
extern "C" int hv_flash_fwd(const void* q, const void* k, const void* v,
                            const void* bias, void* out, void* lse, int B,
                            int Lq, int Lk, int heads, int d, int scale_d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d % 8 != 0 || scale_d < 1 || scale_d > d) return (int)cudaErrorInvalidValue;
  if (d <= 40)
    return launch<Cfg<48, 40, false, 3>>(q, k, v, bias, out, lse, B, Lq, Lk, heads, d, scale_d,
                                         s);
  if (d <= 80)
    return launch<Cfg<80, 80, false, 3>>(q, k, v, bias, out, lse, B, Lq, Lk, heads, d, scale_d,
                                         s);
  if (d < 128)
    return launch<Cfg128<false>>(q, k, v, bias, out, lse, B, Lq, Lk, heads, d, scale_d, s);
  if (d == 128)
    return launch<Cfg128<true>>(q, k, v, bias, out, lse, B, Lq, Lk, heads, d, scale_d, s);
  if (d == 512)
    return launch<Cfg<512, 256, true, 2>>(q, k, v, bias, out, lse, B, Lq, Lk, heads, d,
                                          scale_d, s);
  if (d > 512) return launch_xwide(q, k, v, bias, out, lse, B, Lq, Lk, heads, d, scale_d, s);
  return (int)cudaErrorInvalidValue;
}

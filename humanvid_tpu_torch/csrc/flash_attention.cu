// Flash attention forward, packed heads, bf16, for Hopper (sm_90a): kernel A.
//
// Replaces: humanvid_tpu/ops/flash_attention.py, the Pallas kernels
// `_fwd_kernel_t` (:172, d + 1 <= 128) and `_fwd_kernel` (:96, wide heads),
// both launched by `_flash_fwd` (:323); past d = 512 the xwide kernel, and
// for 128 < d < 512 the mid kernel, both near the end of this file.
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
// Design (FlashAttention-3's shape; its ping-pong scheduling in the
// own-width kernel at d = 128 only, below).
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
//   d <= 80 but 64 (Cfg<48, 40> for d <= 40, Cfg<80, 80> for 48, 56, 72
//     and 80): 3 consumer
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
//   d = 64 and 80 < d <= 128: `flash_fwd_own_kernel`, at the head's own
//     width (below).
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
#include "xwide.cuh"

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
// Past 512 columns a 64-row Q tile (80 KB at d = 640) beside a K/V ring
// does not fit 227 KB, and a 64 x d fp32 O does not fit one warpgroup's
// registers. So the head's depth is split over a thread-block cluster
// (csrc/xwide.cuh: slices, groups, the 4-D TMA maps, the exchange): a
// cluster of n blocks owns one 64-row query tile, and block `rank` one
// slice of SL <= 256 columns. A block is one consumer warpgroup and a
// producer warp (in a warpgroup of its own). The producer loads the
// block's Q slice once by TMA and keeps its K and V slices of each 64-key
// tile in flight in a ring of `stages` pieces (full/empty mbarriers), with
// the tile's bias in log2 units (-inf past Lk) and a skip flag in a ring
// of words beside it. Per key tile the consumer warpgroup computes
//   S_c = Q_c K_c^T    wgmma m64n64k16, both from shared memory, over the
//                      slice (its columns past the head read zeros);
//   S = sum_c S_c      over distributed shared memory in rank order (the
//                      same bits in every block, so the same m, l and P);
//   softmax            online, in the log2 domain, as the d <= 512 kernels
//                      (scale * log2e folded with the bias in one FMA, P
//                      rounded to bf16 unnormalized);
//   O_c += P V_c       wgmma with P from registers, V MN-major.
// Each block stores its own columns of O; rank 0 (of group 0) writes the
// natural-log LSE. QK^T is computed once (with groups > 1 once per group,
// the header), every byte of Q, K and V is read once per tile by one
// block, and there are no atomics: the same inputs give the same bits.
// A key tile whose bias hides every key (<= -1e9, NEG_INF of
// ops/attention.py, or past Lk) is neither loaded nor multiplied, in a
// batch row that sees some key: there every row's max is finite once a
// visible tile comes, a hidden tile's p is exactly 0, and a hidden tile
// before it is scaled by exactly 0, so passing it over gives the same bits
// as computing it (a row that sees no key computes every tile).
// What bounds it: the tensor cores (at long_wide's level-1 cond call, 48 x
// 1536 x 3072 x 640: 5.8e11 operations against 0.57 GB); per block and
// tile, 64 x 64 x 2 SL multiply-adds against (n - 1) x 16 KB of partials
// read from the other blocks.
constexpr float kHiddenBias = -1e9f;  // NEG_INF of ops/attention.py

template <int SL, bool EXTRA>
__global__ void __launch_bounds__(384, 1)
flash_fwd_xwide_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map, const float* __restrict__ bias,
                       bf16* __restrict__ out, float* __restrict__ lse, int Lq, int Lk,
                       int heads, int d, int n, int groups, int stages, int xbufs,
                       float scale_log2) {
  using namespace xwide;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Layout lay(SL, stages, xbufs);
  unsigned char* sQ = smem;  // [2 consumer warpgroups] Q slices
  float* xbuf = reinterpret_cast<float*>(smem + lay.off_x);  // [2 warpgroups][xbufs]
  unsigned char* info = smem + lay.off_info;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.off_bar);
  uint64_t* empty = full + stages;
  uint64_t* ifull = empty + stages;
  uint64_t* iempty = ifull + kInfoSlots;
  uint64_t* own = iempty + kInfoSlots;
  uint64_t* xfull = own + 1;                 // [2 warpgroups][xbufs][4 warps]
  uint64_t* xempty = xfull + 2 * xbufs * 4;  // the same

  const int rank = (int)cluster_ctarank();
  const int g = (int)(blockIdx.x / n) % groups;  // this block's group of output slices
  const int q0 = (int)(blockIdx.x / (n * groups)) * 2 * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int n_kv = (Lk + kRows - 1) / kRows;
  const int out_idx = rank + n * g;  // the output slice: depth slice jj = g
  const int out_w = slice_cols(out_idx, SL, d);
  Ring ring{smem + lay.off_ring, full, empty, stages, lay.piece, SL, h, b, 0};

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);   // tx
      mbar_init(&empty[s], 8);  // one per consumer warp
    }
    for (int i = 0; i < kInfoSlots; ++i) {
      mbar_init(&ifull[i], 32);  // the producer warp's lanes
      mbar_init(&iempty[i], 8);
    }
    mbar_init(own, 1);
    for (int i = 0; i < 2 * xbufs * 4; ++i) {
      mbar_init(&xfull[i], n);  // the same warp of every block
      mbar_init(&xempty[i], n);
    }
    fence_barrier_init();
  }
  __syncthreads();
  cluster_arrive();  // every block's barriers are initialized before any arrives remotely
  cluster_wait();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  if (wg == 2) {
    // ---------------- producer ----------------
    setmaxnreg_dec<24>();
    if (warp > 0) return;  // one producer warp
    const float* bias_b = bias ? bias + (size_t)b * Lk : nullptr;
    // hidden tiles are passed over only in a batch row that sees some key
    int sees = 0;
    if (bias_b)
      for (int i = lane; i < Lk; i += 32) sees |= bias_b[i] > kHiddenBias;
    const bool may_skip = __any_sync(0xffffffffu, sees);
    if (lane == 0) {
      tma_prefetch_desc(&q_map);
      tma_prefetch_desc(&k_map);
      tma_prefetch_desc(&v_map);
      mbar_arrive_expect_tx(own, 2 * lay.piece);
      load_slice(sQ, &q_map, own, out_idx, SL, h, q0, b);
      load_slice(sQ + lay.piece, &q_map, own, out_idx, SL, h, q0 + kRows, b);
    }
    for (int kt = 0; kt < n_kv; ++kt) {
      const int k0 = kt * kRows, i = kt % kInfoSlots;
      float w[2];
      bool hidden = true;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + lane + 32 * e;
        const float x = key < Lk && bias_b ? bias_b[key] : 0.f;
        hidden = hidden && (key >= Lk || x <= kHiddenBias);
        w[e] = key >= Lk ? -INFINITY : x * kLog2e;
      }
      const bool skip = may_skip && __all_sync(0xffffffffu, hidden);
      mbar_wait(&iempty[i], ((kt / kInfoSlots) & 1) ^ 1);
      float* words = reinterpret_cast<float*>(info + i * kInfoBytes);
      words[lane] = w[0];
      words[lane + 32] = w[1];
      if (lane == 0) reinterpret_cast<int*>(words)[2 * kRows] = skip;
      mbar_arrive(&ifull[i]);
      if (skip) continue;
      if constexpr (EXTRA) {
        for (int jj = 0; jj < groups; ++jj) {  // the other depth slices
          if (jj == g) continue;
          ring.put(&q_map, rank + n * jj, q0, lane);
          ring.put(&q_map, rank + n * jj, q0 + kRows, lane);
          ring.put(&k_map, rank + n * jj, k0, lane);
        }
      }
      ring.put(&k_map, out_idx, k0, lane);
      ring.put(&v_map, out_idx, k0, lane);
    }
    return;
  }

  // ---------------- consumers: warpgroup wg owns query rows q0 + 64 wg.. ----------------
  setmaxnreg_inc<240>();
  const int t = threadIdx.x % 128;
  const int c2 = 2 * (lane % 4);
  const uint32_t ring0 = smem_u32(ring.base);
  const uint64_t q_desc = gmma_desc(smem_u32(sQ + wg * lay.piece), 16, 1024, kSwizzle128B);
  const uint64_t kmajor0 = gmma_desc(ring0, 16, 1024, kSwizzle128B);
  // V as B, MN-major: LBO between 64-column boxes, SBO between 8-key atoms
  const uint64_t mnmajor0 = gmma_desc(ring0, kBoxBytes, 1024, kSwizzle128B);
  const int piece16 = lay.piece >> 4;
  float* my_xbuf = xbuf + wg * xbufs * (kXBytes / 4);
  uint64_t* my_xfull = xfull + wg * xbufs * 4 + warp;
  uint64_t* my_xempty = xempty + wg * xbufs * 4 + warp;

  float o[SL / 2];
#pragma unroll
  for (int i = 0; i < SL / 2; ++i) o[i] = 0.f;
  float m_row[2] = {-INFINITY, -INFINITY};  // running max, scaled log2 units
  float l_row[2] = {0.f, 0.f};              // partial sums over this lane's columns
  const bool has_bias = bias != nullptr;

  mbar_wait(own, 0);
  int xi = 0;  // exchanges so far
  for (int kt = 0; kt < n_kv; ++kt) {
    const int i = kt % kInfoSlots;
    mbar_wait(&ifull[i], (kt / kInfoSlots) & 1);
    const float* bt = reinterpret_cast<const float*>(info + i * kInfoBytes);
    if (reinterpret_cast<const int*>(bt)[2 * kRows]) {  // a hidden tile, not loaded
      __syncwarp();
      if (lane == 0) mbar_arrive(&iempty[i]);
      continue;
    }

    // S_c = Q_c K_c^T over this block's depth slices (64 rows x 64 keys)
    float sc[32];
    if constexpr (EXTRA) {
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = 0.f;
      for (int jj = 0; jj < groups; ++jj) {
        if (jj == g) continue;
        const int sq0 = ring.take(), sq1 = ring.take(), sk = ring.take();
        wgmma_fence();
        partial_product<SL>(sc, kmajor0 + (wg == 0 ? sq0 : sq1) * piece16,
                            kmajor0 + sk * piece16, true);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        ring.release(sq0, lane);
        ring.release(sq1, lane);
        ring.release(sk, lane);
      }
    }
    {
      const int sk = ring.take();
      wgmma_fence();
      partial_product<SL>(sc, q_desc, kmajor0 + sk * piece16, EXTRA);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      ring.release(sk, lane);
    }
    // S = the cluster's partials summed in rank order
    const int xb = xi % xbufs;
    exchange(sc, my_xbuf + xb * (kXBytes / 4), my_xfull + xb * 4, my_xempty + xb * 4,
             xi / xbufs, xbufs, n, rank, t, lane);
    ++xi;

    // the online softmax of flash_fwd_kernel, in place: sc[4j + e] (key
    // 8j + c2 + (e & 1) of row g + 8 * (e >> 1)) becomes p
    const bool use_bias = has_bias || (kt + 1) * kRows > Lk;
    float mx[2] = {-INFINITY, -INFINITY};
    if (use_bias) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bb = *reinterpret_cast<const float2*>(bt + 8 * j + c2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[4 * j + e] = fmaf(sc[4 * j + e], scale_log2, (e & 1) ? bb.y : bb.x);
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 32; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
      mx[0] *= scale_log2;  // scale > 0: the max commutes with it
      mx[1] *= scale_log2;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&iempty[i]);  // the bias is read
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
    const float mul = use_bias ? 1.f : scale_log2;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      sc[j] = fast_exp2(fmaf(sc[j], mul, -m_use[(j >> 1) & 1]));
      l_row[(j >> 1) & 1] += sc[j];
    }
    // bf16 P: n8 blocks 2t and 2t+1 form the A fragment of the 16-key step t
    uint32_t p[4][4];
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) p[tt][e] = pack_bf16x2(sc[8 * tt + 2 * e], sc[8 * tt + 2 * e + 1]);
    }
    // O *= alpha, in the warps where a row max moved
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < SL / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
    }

    // O_c += P V_c
    const int sv = ring.take();
    wgmma_fence();
#pragma unroll
    for (int tt = 0; tt < 4; ++tt)
      WgmmaRS<SL>::run(o, p[tt], mnmajor0 + sv * piece16 + ((tt * 2048) >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
    ring.release(sv, lane);
  }
  drain(my_xempty, xbufs, xi, n, lane);

  // finish the row sums across the 4 lanes that share a row, then store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 1);
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
  }
  const int C_all = heads * d;
  const int row0 = q0 + kRows * wg + 16 * warp + lane / 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Lq) continue;
    const float inv = 1.f / l_row[r];
    bf16* orow = out + ((size_t)b * Lq + row) * C_all + (size_t)h * d + out_idx * SL;
#pragma unroll
    for (int j = 0; j < SL / 8; ++j) {
      if (8 * j + c2 < out_w) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + c2) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      }
    }
    if (rank == 0 && g == 0 && lane % 4 == 0) {
      lse[((size_t)b * heads + h) * Lq + row] = (m_row[r] + log2f(l_row[r])) * kLn2;
    }
  }
}

template <int SL, bool EXTRA>
int launch_xwide(const void* q, const void* k, const void* v, const void* bias, void* out,
                 void* lse, int B, int Lq, int Lk, int heads, int d, int scale_d,
                 const xwide::Plan& p, cudaStream_t stream) {
  using namespace xwide;
  CUtensorMap maps[3];
  int err = make_head_map(&maps[0], q, d, heads, Lq, B, kBox, kRows);
  if (!err) err = make_head_map(&maps[1], k, d, heads, Lk, B, kBox, kRows);
  if (!err) err = make_head_map(&maps[2], v, d, heads, Lk, B, kBox, kRows);
  if (err) return err;
  auto kernel = flash_fwd_xwide_kernel<SL, EXTRA>;
  cudaError_t e = host_cache.reserve_smem(reinterpret_cast<const void*>(kernel), p.smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)((Lq + 2 * kRows - 1) / (2 * kRows)) * p.cluster * p.groups;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, heads, B);
  cfg.blockDim = dim3(384, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, maps[0], maps[1], maps[2],
                         static_cast<const float*>(bias), static_cast<bf16*>(out),
                         static_cast<float*>(lse), Lq, Lk, heads, d, p.cluster, p.groups,
                         p.stages, p.xbufs, kLog2e / sqrtf((float)scale_d));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---- 128 < d < 512: the forward at the head's own width ---------------------
//
// Between 128 and 512 columns the d <= 128 tiles no longer fit, and the
// d = 512 kernel on a head zero-padded to 512 would multiply zero columns
// (2.7x the work at d = 192, 1.6x at 320) and compute S twice, after the
// wrapper's pad copies. Here the head is read through 4-D maps (d, heads,
// L, B) (`make_head_map`): 64-column swizzled boxes whose columns past the
// head's last read zeros, never the next head's, so no width of the band
// needs a copy, and the products run over the width rounded up to 64
// (DQK). A block is two consumer warpgroups and a producer warp, in one of
// two layouts (`mid_plan` in ops/flash_attention.py picks it):
//   rows (DQK = 192, 256: FlashAttention-3's head-dim-256 point; and 320):
//     the warpgroups own two 64-row query tiles (BQ = 128) and share each K
//     and V tile; the whole depth of O stays in a warpgroup's registers (64
//     x 256 fp32: 128 a thread; at 320, 160 a thread, its product in a
//     256- and a 64-column wgmma, as wgmma's N stops at 256); S is computed
//     once: 2 DQK units of product work. 64-key tiles in 2 stages up to
//     256 (Q 64 KB + 2 x (K 32 + V 32) KB), 32-key tiles in 3 stages at
//     320 (Q 80 KB + 3 x (K 20 + V 20) KB).
//   columns (DQK = 384, 448, and 512 for 448 < d < 512, where O no longer
//     fits a warpgroup's registers; 320 only in the variants' ablation,
//     built there in place of the rows layout):
//     the d = 512 kernel's split at the head's width. Both warpgroups take
//     the same 64 query rows, each computes S over DQK and owns DV = DQK /
//     2 columns of O (160, 192, 224, 256): 3 DQK units of product work
//     where the pad to 512 took 3 x 512.
//     A warpgroup's V columns start at DV * wg, no multiple of 64 at 320
//     and 448, so each warpgroup's V is loaded by boxes of its own from its
//     first column (the second set's last box reads zeros past d). 64-key
//     tiles at 320 (Q 40 + 2 x (K 40 + V 48) KB), 32 above.
// The softmax is flash_fwd_kernel's (log2 domain, the scale of the true d,
// the bias folded into one FMA, P rounded to bf16 unnormalized), the LSE
// natural-log at the true width. A key tile whose bias hides every key
// (<= -1e9, or past Lk) is neither loaded nor multiplied, in a batch row
// that sees some key: the xwide kernel's rule, which gives the same bits
// as computing it. Such a tile takes no stage of the ring either: the
// producer fills stages with the tiles to compute only, each naming its
// first key, and ends with a stage that names none (turning the ring once
// a hidden tile, long_wide's batched-CFG call took 16.4 ms on the H100;
// with this ring and the bias read below, 14.2). No atomics: the same
// inputs give the same bits.
// What bounds it: the tensor cores (long_wide's level-0 cond call, 48 x
// 6144 x 12288 x 320: 4.6e12 operations against 0.9 GB).
template <int DQK_, bool ROWS_>
struct MidCfg {
  static constexpr int DQK = DQK_;
  static constexpr bool ROWS = ROWS_;
  static constexpr int DV = ROWS ? DQK : DQK / 2;  // O columns of one consumer warpgroup
  static constexpr int BQ = ROWS ? 128 : 64;       // query rows per block
  static constexpr int BK = DQK <= 256 || (!ROWS && DQK <= 320) ? 64 : 32;
  static constexpr int STAGES = ROWS && DQK > 256 ? 3 : 2;
  static constexpr int THREADS = 384;
  static constexpr int QBOX = DQK / 64;        // 64-column boxes of a Q or K row
  static constexpr int VBOX = (DV + 63) / 64;  // of one warpgroup's V columns
  static constexpr int VSETS = ROWS ? 1 : 2;   // V column sets of a stage
  static constexpr int Q_BYTES = BQ * DQK * 2;
  static constexpr int K_BYTES = BK * DQK * 2;
  static constexpr int V_BYTES = VSETS * VBOX * BK * 128;
  static constexpr int INFO_BYTES = BK * 4 + 16;  // the tile's bias words, its skip flag
  // shared memory: Q, K ring, V ring, words ring, barriers (1024-aligned tiles)
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * K_BYTES;
  static constexpr int OFF_INFO = OFF_V + STAGES * V_BYTES;
  static constexpr int OFF_BAR = OFF_INFO + STAGES * INFO_BYTES;
  static constexpr int SMEM = OFF_BAR + (3 * STAGES + 1) * 8 + 1024;  // + alignment
  // O in one wgmma's N, or (rows past 256) in a 256 and a 64 piece
  static_assert(DQK % 64 == 0 && (DV <= 256 || DV == 320), "wgmma's N");
  static_assert(Q_BYTES % 1024 == 0 && K_BYTES % 1024 == 0 && V_BYTES % 1024 == 0, "");
  static_assert(SMEM <= 232448, "shared memory");
};

// The byte offset of 16-deep step kk in a K-major tile of `rows` rows in
// 64-column swizzled boxes.
__device__ __forceinline__ uint32_t swizzled_step(int kk, int rows) {
  return (kk / 4) * rows * 128 + (kk % 4) * 32;
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, 1)
flash_fwd_mid_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map, const float* __restrict__ bias,
                     bf16* __restrict__ out, float* __restrict__ lse, int Lq, int Lk, int heads,
                     int d, float scale_log2) {
  constexpr int BQ = C::BQ, BK = C::BK, STAGES = C::STAGES, DV = C::DV;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sQ = smem;
  unsigned char* sK = smem + C::OFF_K;
  unsigned char* sV = smem + C::OFF_V;
  unsigned char* sInfo = smem + C::OFF_INFO;
  uint64_t* full_k = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);  // K and the words
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty = full_v + STAGES;
  uint64_t* full_q = empty + STAGES;

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_kv = (Lk + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 32);  // the producer warp's lanes (the words)
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init(full_q, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------- producer ----------------
    setmaxnreg_dec<24>();
    if (warp > 0) return;  // one producer warp
    const float* bias_b = bias ? bias + (size_t)b * Lk : nullptr;
    // hidden tiles are passed over only in a batch row that sees some key:
    // the scan stops at the first 32 keys that hold one (a scan of the
    // whole row, 12288 keys at long_wide's level 0, delayed every block's
    // first loads)
    bool may_skip = false;
    if (bias_b)
      for (int i = 0; i < Lk && !may_skip; i += 32)
        may_skip = __any_sync(0xffffffffu, i + lane < Lk && bias_b[i + lane] > kHiddenBias);
    if (lane == 0) {
      tma_prefetch_desc(&q_map);
      tma_prefetch_desc(&k_map);
      tma_prefetch_desc(&v_map);
      mbar_arrive_expect_tx(full_q, C::Q_BYTES);
      for (int i = 0; i < C::QBOX; ++i)
        tma_load_4d(sQ + i * BQ * 128, &q_map, full_q, i * 64, h, q0, b);
    }
    // the ring holds only the tiles some key of the batch row sees; each
    // stage's words name its tile's first key, and a last stage with -1
    // ends the consumers' loop. The bias is read 128 keys a round, 4 a
    // lane, all loads in flight together: one load's latency a hidden tile
    // (192 of them a block on the batched-CFG call's uncond rows) added
    // 1.5 ms to that call on the H100
    int n = 0;  // stages filled
    for (int base = 0; base <= n_kv * BK; base += 128) {
      float x[4];
      bool hid = true;  // this lane's 4 keys hidden
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = base + 4 * lane + e;
        x[e] = key < Lk && bias_b ? bias_b[key] : 0.f;
        hid = hid && (key >= Lk || x[e] <= kHiddenBias);
      }
      const unsigned hidden = __ballot_sync(0xffffffffu, hid);
#pragma unroll
      for (int t = 0; t < 128 / BK; ++t) {
        const int k0 = base + t * BK < n_kv * BK ? base + t * BK : -1;
        constexpr int LANES = BK / 4;  // lanes that hold a tile's keys
        const unsigned mine = (LANES == 32 ? 0xffffffffu : (1u << LANES) - 1u) << (t * LANES);
        if (k0 >= 0 && may_skip && (hidden & mine) == mine) continue;
        const int s = n % STAGES;
        mbar_wait(&empty[s], ((n / STAGES) & 1) ^ 1);
        ++n;
        float* words = reinterpret_cast<float*>(sInfo + s * C::INFO_BYTES);
        if (k0 >= 0 && (mine >> lane) & 1u) {
          // the bias words, log2 units; keys >= Lk are masked here
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = base + 4 * lane + e;
            words[key - k0] = key >= Lk ? -INFINITY : x[e] * kLog2e;
          }
        }
        if (lane == 0) {
          reinterpret_cast<int*>(words)[BK] = k0;
          if (k0 < 0) {  // the end: nothing loaded
            mbar_arrive(&full_k[s]);
          } else {
            mbar_arrive_expect_tx(&full_k[s], C::K_BYTES);
            for (int i = 0; i < C::QBOX; ++i)
              tma_load_4d(sK + s * C::K_BYTES + i * BK * 128, &k_map, &full_k[s], i * 64, h, k0,
                          b);
            mbar_arrive_expect_tx(&full_v[s], C::V_BYTES);
            for (int g = 0; g < C::VSETS; ++g)
              for (int i = 0; i < C::VBOX; ++i)
                tma_load_4d(sV + s * C::V_BYTES + (g * C::VBOX + i) * BK * 128, &v_map,
                            &full_v[s], g * DV + i * 64, h, k0, b);
          }
        } else {
          mbar_arrive(&full_k[s]);
        }
        if (k0 < 0) break;
      }
    }
    return;
  }

  // ---------------- consumers ----------------
  setmaxnreg_inc<240>();
  const int qoff = C::ROWS ? 64 * wg : 0;  // this warpgroup's first query row
  const int voff = C::ROWS ? 0 : DV * wg;  // and first column of O
  const int c2 = 2 * (lane % 4);
  const uint64_t q_desc = gmma_desc(smem_u32(sQ) + qoff * 128, 16, 1024, kSwizzle128B);
  const uint64_t k_desc0 = gmma_desc(smem_u32(sK), 16, 1024, kSwizzle128B);
  // V as B, MN-major: LBO between 64-column boxes, SBO between 8-key atoms
  const uint64_t v_desc0 = gmma_desc(smem_u32(sV) + (C::ROWS ? 0 : wg * C::VBOX * BK * 128),
                                     BK * 128, 1024, kSwizzle128B);

  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  float m_row[2] = {-INFINITY, -INFINITY};  // running max, scaled log2 units
  float l_row[2] = {0.f, 0.f};              // partial sums over this lane's columns
  const bool has_bias = bias != nullptr;

  mbar_wait(full_q, 0);  // this block's Q tiles
  for (int n = 0;; ++n) {
    const int s = n % STAGES;
    const uint32_t phase = (n / STAGES) & 1;
    mbar_wait(&full_k[s], phase);
    const float* bt = reinterpret_cast<const float*>(sInfo + s * C::INFO_BYTES);
    const int k0 = reinterpret_cast<const int*>(bt)[BK];
    if (k0 < 0) break;  // every tile the block computes is done

    // S = Q K^T (64 rows x BK keys) over DQK
    float sc[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::DQK / 16; ++kk)
      WgmmaSS<BK>::run(sc, q_desc + (swizzled_step(kk, BQ) >> 4),
                       k_desc0 + ((s * C::K_BYTES + swizzled_step(kk, BK)) >> 4), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // the online softmax of flash_fwd_kernel, in place: sc[4j + e] (key 8j
    // + c2 + (e & 1) of row g + 8 * (e >> 1)) becomes p
    const bool use_bias = has_bias || k0 + BK > Lk;
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
    const float mul = use_bias ? 1.f : scale_log2;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      sc[j] = fast_exp2(fmaf(sc[j], mul, -m_use[(j >> 1) & 1]));
      l_row[(j >> 1) & 1] += sc[j];
    }
    // bf16 P: n8 blocks 2t and 2t+1 form the A fragment of the 16-key step t
    uint32_t p[BK / 16][4];
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) p[t][e] = pack_bf16x2(sc[8 * t + 2 * e], sc[8 * t + 2 * e + 1]);
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

    // O += P V (16 keys: two 8-key atoms)
    mbar_wait(&full_v[s], phase);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      const uint64_t vd = v_desc0 + ((s * C::V_BYTES + t * 2048) >> 4);
      if constexpr (DV <= 256) {
        WgmmaRS<DV>::run(o, p[t], vd);
      } else {  // columns 0..255, then 256..319 (four boxes on)
        WgmmaRS<256>::run(*reinterpret_cast<float(*)[128]>(o), p[t], vd);
        WgmmaRS<64>::run(*reinterpret_cast<float(*)[32]>(o + 128), p[t],
                         vd + ((4 * BK * 128) >> 4));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // finish the row sums across the 4 lanes that share a row, then store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 1);
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
  }
  const int row0 = q0 + qoff + 16 * warp + lane / 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Lq) continue;
    const float inv = 1.f / l_row[r];
    bf16* orow = out + ((size_t)b * Lq + row) * ((size_t)heads * d) + (size_t)h * d + voff;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      if (voff + 8 * j < d) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + c2) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      }
    }
    if (voff == 0 && lane % 4 == 0) {
      lse[((size_t)b * heads + h) * Lq + row] = (m_row[r] + log2f(l_row[r])) * kLn2;
    }
  }
}

template <class C>
int launch_mid(const void* q, const void* k, const void* v, const void* bias, void* out,
               void* lse, int B, int Lq, int Lk, int heads, int d, int scale_d,
               cudaStream_t stream) {
  CUtensorMap maps[3];
  int err = make_head_map(&maps[0], q, d, heads, Lq, B, 64, C::BQ);
  if (!err) err = make_head_map(&maps[1], k, d, heads, Lk, B, 64, C::BK);
  if (!err) err = make_head_map(&maps[2], v, d, heads, Lk, B, 64, C::BK);
  if (err) return err;
  auto kernel = flash_fwd_mid_kernel<C>;
  cudaError_t e = host_cache.reserve_smem(reinterpret_cast<const void*>(kernel), C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Lq + C::BQ - 1) / C::BQ, heads, B);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const float*>(bias), static_cast<bf16*>(out),
      static_cast<float*>(lse), Lq, Lk, heads, d, kLog2e / sqrtf((float)scale_d));
  return (int)cudaGetLastError();
}

// ---- d = 64 and 80 < d <= 128: the forward at the head's own width ---------
//
// The d <= 80 tiles padded a 64-wide head's QK^T depth and PV's N to 80
// (25% more products), and 88 <= d < 128 to 128 (33% more at d = 96), on
// 8-column boxes without swizzle. Here the products run over W = d rounded
// up to 16 (64, 96, 112, 128; 88, 104 and 120 run in the next one's tiles,
// QK^T's depth padded by zeroed slabs, PV's columns past d not stored), and
// each head arrives in the widest TMA box that divides d: 64 columns in the
// 128-byte swizzle at 64 and 128, 32 in the 64-byte swizzle at 96, 16 in
// the 32-byte swizzle at 112, 8 without swizzle at 88, 104 and 120. The box
// divides d, so no box reads the next head's columns or past C. A tile is
// [W / CW boxes][rows][CW]; Q and K K-major (SBO = 8 rows of the box, a
// 16-deep step 32 bytes into a swizzled row or the next box), V MN-major
// (LBO between boxes, SBO between 8-key atoms).
// Tiles (FlashAttention-3's points):
//   W = 64, 96: 3 consumer warpgroups of 64 query rows (BQ = 192) on
//     128-key tiles, 160 registers a consumer thread; 4 stages at 64 (Q 24
//     KB + 4 x (K 16 + V 16) KB), 3 at 96 (Q 36 + 3 x 48 KB).
//   W = 112: 2 consumer warpgroups (BQ = 128), 240 registers, 3 stages (Q
//     28 + 3 x 56 KB).
//   W = 128: 2 consumer warpgroups (BQ = 128), 3 stages (Q 32 + 3 x 64 KB
//     = 224 KB of 227), FA3's intra-warpgroup overlap (S of tile n issued
//     before PV of tile n - 1, the softmax of tile n under PV's product) and
//     its ping-pong: the two warpgroups issue their products in turns on two
//     named barriers, so that one warpgroup's softmax runs under the other's
//     products.
// What bounds it on the H100 (`flash_variants --own`): at d = 64 the
// consumers' instruction issue, as at d <= 80 (one more FMA and bias word a
// logit cost the level-0 call about 30%); at d = 128 the K and V loads from L2
// (each 128-row block reads its head's whole K and V, 128 flops a byte):
// two stages instead of three took 1.5x as long (K released apart from V,
// V loaded a tile behind K, gained nothing measurable and spilled the
// producer's 24 registers).
// A key tile whose bias hides every key (<= -1e9, or past Lk) is neither
// loaded nor multiplied and takes no stage of the ring, in a batch row that
// sees some key: the mid kernel's rule and ring (each stage's words name
// its first key, a last stage names none), the same bits as computing it.
// The softmax and stores are flash_fwd_kernel's; a tile whose keys are all
// below Lk with a zero bias (the producer's flag in its words) takes the
// softmax's path without the bias, as a call without one does: one FMA and
// a bias word a logit fewer on the batched-CFG calls' cond rows and on the
// uncond rows' keys they see. No atomics: the same inputs give the same
// bits.

// W: the products' width; CW: columns of one TMA box; NC: consumer
// warpgroups; OVERLAP: S of the next tile before PV of this one; PP: the two
// consumer warpgroups' products in turns.
template <int W_, int CW_, int NC_, int STAGES_, bool OVERLAP_, bool PP_>
struct OwnCfg {
  static constexpr int W = W_;
  static constexpr int CW = CW_;
  static constexpr int NC = NC_;
  static constexpr int STAGES = STAGES_;
  static constexpr bool OVERLAP = OVERLAP_;
  static constexpr bool PP = PP_;
  static_assert(W % 16 == 0 && W % CW == 0 && (CW == 8 || CW % 16 == 0) && CW <= 64, "boxes");
  static_assert(!PP || (NC == 2 && OVERLAP), "ping-pong: two overlapped consumer warpgroups");
  static constexpr int THREADS = 128 * (NC + 1);  // + the producer warpgroup
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = NC == 2 ? 240 : 160;
  static_assert(128 * (PRODUCER_REGS + NC * CONSUMER_REGS) <= 65536, "registers");
  static constexpr int BQ = 64 * NC;  // query rows per block
  static constexpr int BK = 128;      // keys per stage: one bias round of the producer
  static constexpr uint32_t LAYOUT =
      CW == 64 ? kSwizzle128B : CW == 32 ? kSwizzle64B : CW == 16 ? kSwizzle32B : kNoSwizzle;
  static constexpr CUtensorMapSwizzle TMA_SWIZZLE =
      CW == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
      : CW == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
      : CW == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
                 : CU_TENSOR_MAP_SWIZZLE_NONE;
  static constexpr int Q_BYTES = BQ * W * 2;
  static constexpr int K_BYTES = BK * W * 2;  // and V's
  static constexpr int INFO_BYTES = BK * 4 + 16;  // the tile's bias words, its first key
  // shared memory: Q, K ring, V ring, words ring, barriers (1024-aligned tiles)
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * K_BYTES;
  static constexpr int OFF_INFO = OFF_V + STAGES * K_BYTES;
  static constexpr int OFF_BAR = OFF_INFO + STAGES * INFO_BYTES;
  static constexpr int SMEM = OFF_BAR + (3 * STAGES + 1) * 8 + 1024;  // + alignment
  static_assert(Q_BYTES % 1024 == 0 && K_BYTES % 1024 == 0, "tile alignment");
  static_assert(SMEM <= 232448, "shared memory");
};

// The byte offset of the 16-deep step kk in an own-width K-major tile of
// `rows` rows.
template <class C>
__device__ __forceinline__ uint32_t own_kstep(int kk, int rows) {
  if constexpr (C::CW == 8) return kk * rows * 32;  // two 8-column slabs
  else return (kk / (C::CW / 16)) * rows * C::CW * 2 + (kk % (C::CW / 16)) * 32;
}

// K-major operand of a tile of `rows` rows from `addr` (its first row).
template <class C>
__device__ __forceinline__ uint64_t own_kmajor(uint32_t addr, int rows) {
  if constexpr (C::CW == 8) return gmma_desc(addr, rows * 16, 128, C::LAYOUT);
  else return gmma_desc(addr, 16, 16 * C::CW, C::LAYOUT);
}

// MN-major operand: the tile's rows contracted, its columns along N.
template <class C>
__device__ __forceinline__ uint64_t own_mnmajor(uint32_t addr, int rows) {
  if constexpr (C::CW == 8) return gmma_desc(addr, 128, rows * 16, C::LAYOUT);
  else return gmma_desc(addr, rows * C::CW * 2, 16 * C::CW, C::LAYOUT);
}

// flash_fwd_kernel's online softmax of one key tile, in place: sc[4j + e]
// (key 8j + c2 + (e & 1) of row g + 8 * (e >> 1)) becomes p, unnormalized,
// the running max and this lane's partial sums move, and alpha is O's
// factor.
template <int BK>
__device__ __forceinline__ void online_softmax(float (&sc)[BK / 2], const float* bt,
                                               bool use_bias, float scale_log2, int c2,
                                               float (&m_row)[2], float (&l_row)[2],
                                               float (&alpha)[2]) {
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
  float m_use[2];
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
    const int r = (i >> 1) & 1;
    sc[i] = fast_exp2(fmaf(sc[i], mul, -m_use[r]));
    l_row[r] += sc[i];
  }
}

// P as bf16: the accumulators' n8 blocks 2t and 2t+1 form the A fragment of
// the 16-key step t.
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&p)[BK / 16][4], const float (&sc)[BK / 2]) {
#pragma unroll
  for (int t = 0; t < BK / 16; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[t][e] = pack_bf16x2(sc[8 * t + 2 * e], sc[8 * t + 2 * e + 1]);
}

// O *= alpha, in the warps where a row max moved.
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&alpha)[2]) {
  if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
  }
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, 1)
flash_fwd_own_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map, const float* __restrict__ bias,
                     bf16* __restrict__ out, float* __restrict__ lse, int Lq, int Lk, int heads,
                     int d, float scale_log2) {
  constexpr int BQ = C::BQ, BK = C::BK, STAGES = C::STAGES, W = C::W, CW = C::CW;
  constexpr int NC = C::NC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sQ = smem;
  unsigned char* sK = smem + C::OFF_K;
  unsigned char* sV = smem + C::OFF_V;
  unsigned char* sInfo = smem + C::OFF_INFO;
  uint64_t* full_k = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);  // K and the words
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty = full_v + STAGES;
  uint64_t* full_q = empty + STAGES;

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_kv = (Lk + BK - 1) / BK;
  const int n_box = d / CW;  // boxes of a head; W / CW - n_box pad slabs

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 32);  // the producer warp's lanes (the words)
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], 4 * NC);  // one arrival per consumer warp
    }
    mbar_init(full_q, 1);
    fence_barrier_init();
  }
  if constexpr (CW == 8) {
    // 88, 104, 120: QK^T's contracted pad must read zeros. TMA writes only
    // the d/8 slabs of a head; the pad slab of Q and of every K stage is
    // zeroed here once and never written again.
    for (int s = -1; s < STAGES; ++s) {
      unsigned char* tile = s < 0 ? sQ : sK + s * C::K_BYTES;
      const int rows = s < 0 ? BQ : BK;
      uint4* pad = reinterpret_cast<uint4*>(tile + n_box * rows * 16);
      const int n = (W / 8 - n_box) * rows;
      for (int i = threadIdx.x; i < n; i += C::THREADS) pad[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    fence_proxy_async();
  }
  __syncthreads();

  if (wg == NC) {
    // ---------------- producer ----------------
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (warp > 0) return;  // one producer warp
    const float* bias_b = bias ? bias + (size_t)b * Lk : nullptr;
    const int col0 = h * d;
    // hidden tiles are passed over only in a batch row that sees some key
    // (the scan stops at the first 32 keys that hold one)
    bool may_skip = false;
    if (bias_b)
      for (int i = 0; i < Lk && !may_skip; i += 32)
        may_skip = __any_sync(0xffffffffu, i + lane < Lk && bias_b[i + lane] > kHiddenBias);
    if (lane == 0) {
      tma_prefetch_desc(&q_map);
      tma_prefetch_desc(&k_map);
      tma_prefetch_desc(&v_map);
      mbar_arrive_expect_tx(full_q, BQ * n_box * CW * 2);
      for (int i = 0; i < n_box; ++i)
        tma_load_3d(sQ + i * BQ * CW * 2, &q_map, full_q, col0 + i * CW, q0, b);
    }
    // the ring holds only the tiles some key of the batch row sees; each
    // stage's words name its tile's first key, and a last stage with -1
    // ends the consumers' loop. A tile's 128 bias words are read 4 a lane,
    // all loads in flight together.
    int n = 0;  // stages filled
    for (int k0 = 0;; k0 += BK) {
      const bool end = k0 >= n_kv * BK;
      float x[4];
      bool hid = true;    // this lane's 4 keys hidden
      bool plain = true;  // and all four below Lk with a zero bias
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 4 * lane + e;
        x[e] = key < Lk && bias_b ? bias_b[key] : 0.f;
        hid = hid && (key >= Lk || x[e] <= kHiddenBias);
        plain = plain && key < Lk && x[e] == 0.f;
      }
      plain = __all_sync(0xffffffffu, plain);
      if (!end && may_skip && __all_sync(0xffffffffu, hid)) continue;
      const int s = n % STAGES;
      mbar_wait(&empty[s], ((n / STAGES) & 1) ^ 1);
      ++n;
      float* words = reinterpret_cast<float*>(sInfo + s * C::INFO_BYTES);
      if (!end) {
        // the bias words, log2 units; keys >= Lk are masked here
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 4 * lane + e;
          words[4 * lane + e] = key >= Lk ? -INFINITY : x[e] * kLog2e;
        }
      }
      if (lane == 0) {
        reinterpret_cast<int*>(words)[BK] = end ? -1 : k0;
        reinterpret_cast<int*>(words)[BK + 1] = plain;
        if (end) {  // nothing loaded
          mbar_arrive(&full_k[s]);
        } else {
          mbar_arrive_expect_tx(&full_k[s], BK * n_box * CW * 2);
          for (int i = 0; i < n_box; ++i)
            tma_load_3d(sK + s * C::K_BYTES + i * BK * CW * 2, &k_map, &full_k[s],
                        col0 + i * CW, k0, b);
          mbar_arrive_expect_tx(&full_v[s], BK * n_box * CW * 2);
          for (int i = 0; i < n_box; ++i)
            tma_load_3d(sV + s * C::K_BYTES + i * BK * CW * 2, &v_map, &full_v[s],
                        col0 + i * CW, k0, b);
        }
      } else {
        mbar_arrive(&full_k[s]);
      }
      if (end) break;
    }
    return;
  }

  // ---------------- consumers ----------------
  setmaxnreg_inc<C::CONSUMER_REGS>();
  const int qoff = 64 * wg;  // this warpgroup's first query row
  const int c2 = 2 * (lane % 4);
  const uint64_t q_desc = own_kmajor<C>(smem_u32(sQ) + qoff * CW * 2, BQ);
  const uint64_t k_desc0 = own_kmajor<C>(smem_u32(sK), BK);
  const uint64_t v_desc0 = own_mnmajor<C>(smem_u32(sV), BK);
  // a tile takes the softmax's bias path unless every key of it is below Lk
  // with a zero bias (the producer's flag beside its first key)
  auto biased = [&](const float* bt) { return !reinterpret_cast<const int*>(bt)[BK + 1]; };

  // S = Q K^T (64 rows x BK keys) from stage s; O += P V from stage s
  auto qk = [&](float (&sc)[BK / 2], int s) {
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk)
      WgmmaSS<BK>::run(sc, q_desc + (own_kstep<C>(kk, BQ) >> 4),
                       k_desc0 + ((s * C::K_BYTES + own_kstep<C>(kk, BK)) >> 4), kk > 0);
  };
  auto pv = [&](float (&o)[W / 2], const uint32_t (&p)[BK / 16][4], int s) {
#pragma unroll
    for (int t = 0; t < BK / 16; ++t)
      WgmmaRS<W>::run(o, p[t], v_desc0 + ((s * C::K_BYTES + t * 32 * CW) >> 4));
  };
  // ping-pong: a warpgroup issues its products in its turn (named barrier
  // 1 + wg, both warpgroups' 256 threads), then hands the turn over
  auto turn_begin = [&] {
    if constexpr (C::PP) named_bar_sync(1 + wg, 256);
  };
  auto turn_end = [&] {
    if constexpr (C::PP) named_bar_arrive(2 - wg, 256);
  };
  if constexpr (C::PP) {
    if (wg == 1) named_bar_arrive(1, 256);  // warpgroup 0 takes the first turn
  }

  float o[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) o[i] = 0.f;
  float m_row[2] = {-INFINITY, -INFINITY};  // running max, scaled log2 units
  float l_row[2] = {0.f, 0.f};              // partial sums over this lane's columns
  uint32_t p[BK / 16][4];

  mbar_wait(full_q, 0);  // this block's Q tile
  if constexpr (!C::OVERLAP) {
    for (int n = 0;; ++n) {
      const int s = n % STAGES;
      const uint32_t phase = (n / STAGES) & 1;
      mbar_wait(&full_k[s], phase);
      const float* bt = reinterpret_cast<const float*>(sInfo + s * C::INFO_BYTES);
      const int k0 = reinterpret_cast<const int*>(bt)[BK];
      if (k0 < 0) break;  // every tile the block computes is done
      float sc[BK / 2];
      wgmma_fence();
      qk(sc, s);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      float alpha[2];
      online_softmax<BK>(sc, bt, biased(bt), scale_log2, c2, m_row, l_row, alpha);
      pack_p<BK>(p, sc);
      rescale(o, alpha);
      mbar_wait(&full_v[s], phase);
      wgmma_fence();
      pv(o, p, s);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  } else {
    // tile 0: S, the softmax, P (a row computes at least one tile: every
    // tile where no key of its batch row is seen)
    int n = 0;
    {
      mbar_wait(&full_k[0], 0);
      const float* bt = reinterpret_cast<const float*>(sInfo);
      float sc[BK / 2];
      turn_begin();
      wgmma_fence();
      qk(sc, 0);
      wgmma_commit();
      turn_end();
      wgmma_wait<0>();
      fence_regs(sc);
      float alpha[2];  // O is still 0
      online_softmax<BK>(sc, bt, biased(bt), scale_log2, c2, m_row, l_row, alpha);
      pack_p<BK>(p, sc);
    }
    // tile n: S_n and PV_{n-1} issued together, the softmax of S_n under
    // PV's product, then O = alpha_n (O + P_{n-1} V_{n-1})
    for (n = 1;; ++n) {
      const int s = n % STAGES, sp = (n - 1) % STAGES;
      mbar_wait(&full_k[s], (n / STAGES) & 1);
      const float* bt = reinterpret_cast<const float*>(sInfo + s * C::INFO_BYTES);
      const int k0 = reinterpret_cast<const int*>(bt)[BK];
      if (k0 < 0) break;
      float sc[BK / 2];
      turn_begin();
      // O's rescale and P's pack are done before the fence (else ptxas
      // waits for the products it finds them beside, C7519)
      fence_regs(o);
      fence_regs(p);
      wgmma_fence();
      qk(sc, s);
      wgmma_commit();
      mbar_wait(&full_v[sp], ((n - 1) / STAGES) & 1);
      pv(o, p, sp);
      wgmma_commit();
      turn_end();
      wgmma_wait<1>();
      fence_regs(sc);
      float alpha[2];
      online_softmax<BK>(sc, bt, biased(bt), scale_log2, c2, m_row, l_row, alpha);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      rescale(o, alpha);
      pack_p<BK>(p, sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[sp]);
    }
    // the last tile's PV
    const int sp = (n - 1) % STAGES;
    turn_begin();
    mbar_wait(&full_v[sp], ((n - 1) / STAGES) & 1);
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
    pv(o, p, sp);
    wgmma_commit();
    turn_end();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
    if constexpr (C::PP) {
      if (wg == 0) named_bar_sync(1, 256);  // warpgroup 1's last hand-over
    }
  }

  // finish the row sums across the 4 lanes that share a row, then store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 1);
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
  }
  const int row0 = q0 + qoff + 16 * warp + lane / 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Lq) continue;
    const float inv = 1.f / l_row[r];
    bf16* orow = out + ((size_t)b * Lq + row) * ((size_t)heads * d) + (size_t)h * d;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      if (8 * j < d) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + c2) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      }
    }
    if (lane % 4 == 0) {
      lse[((size_t)b * heads + h) * Lq + row] = (m_row[r] + log2f(l_row[r])) * kLn2;
    }
  }
}

template <class C>
int launch_own(const void* q, const void* k, const void* v, const void* bias, void* out,
               void* lse, int B, int Lq, int Lk, int heads, int d, int scale_d,
               cudaStream_t stream) {
  CUtensorMap maps[3];
  const int C_all = heads * d;
  int err = make_map(&maps[0], q, C_all, Lq, B, C::CW, C::BQ, C::TMA_SWIZZLE);
  if (!err) err = make_map(&maps[1], k, C_all, Lk, B, C::CW, C::BK, C::TMA_SWIZZLE);
  if (!err) err = make_map(&maps[2], v, C_all, Lk, B, C::CW, C::BK, C::TMA_SWIZZLE);
  if (err) return err;
  auto kernel = flash_fwd_own_kernel<C>;
  cudaError_t e = host_cache.reserve_smem(reinterpret_cast<const void*>(kernel), C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Lq + C::BQ - 1) / C::BQ, heads, B);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const float*>(bias), static_cast<bf16*>(out),
      static_cast<float*>(lse), Lq, Lk, heads, d, kLog2e / sqrtf((float)scale_d));
  return (int)cudaGetLastError();
}

// The configurations by width (W, and the box for widths that W's box does
// not divide: 88, 104 and 120 take 8-column boxes).
template <int W, int CW>
using Own = OwnCfg<W, CW, W <= 96 ? 3 : 2, W == 64 ? 4 : 3, W == 128, W == 128>;

}  // namespace

// Head widths the kernel takes: d a multiple of 8 with d <= 128 (SD's UNet
// heads, d = 40 and 80, QK^T's depth padded to 48 / 80; the 64- and
// 128-wide heads of other head counts, and every d from 88 to 128, at the
// head's own width in the own-width kernel) or d = 512 (the VAE's one head). The
// logits are scaled by scale_d^-1/2, 1 <= scale_d <= d: the wrapper passes
// the true width of a head it zero-pads (ops/flash_attention.py,
// `flash_plan`), else d. Any d > 512 (a multiple of 8) runs in the xwide
// kernel, on the plan x_* (`xwide_plan`: slice, cluster, groups, key tile,
// ring stages, exchange buffers, shared-memory bytes) that the wrapper
// computes. 128 < d < 512 runs at its own width in the mid kernel, on the
// plan `mid_plan` passes as x_slice (the products' depth DQK >= d) and
// x_cluster (1: the rows layout, 2: the columns layout), the other five
// zero. The widths <= 128 and 512 ignore the plan.
extern "C" int hv_flash_fwd(const void* q, const void* k, const void* v,
                            const void* bias, void* out, void* lse, int B,
                            int Lq, int Lk, int heads, int d, int scale_d, int x_slice,
                            int x_cluster, int x_groups, int x_key_tile, int x_stages,
                            int x_exchange, int x_smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d % 8 != 0 || scale_d < 1 || scale_d > d) return (int)cudaErrorInvalidValue;
  if (d <= 40)
    return launch<Cfg<48, 40, false, 3>>(q, k, v, bias, out, lse, B, Lq, Lk, heads, d, scale_d,
                                         s);
#define OWN(W, CW) \
  launch_own<Own<W, CW>>(q, k, v, bias, out, lse, B, Lq, Lk, heads, d, scale_d, s)
  if (d == 64) return OWN(64, 64);
  if (d <= 80)
    return launch<Cfg<80, 80, false, 3>>(q, k, v, bias, out, lse, B, Lq, Lk, heads, d, scale_d,
                                         s);
  if (d <= 96) return d == 96 ? OWN(96, 32) : OWN(96, 8);
  if (d <= 112) return d == 112 ? OWN(112, 16) : OWN(112, 8);
  if (d <= 128) return d == 128 ? OWN(128, 64) : OWN(128, 8);
#undef OWN
  if (d == 512)
    return launch<Cfg<512, 256, true, 2>>(q, k, v, bias, out, lse, B, Lq, Lk, heads, d,
                                          scale_d, s);
  if (d < 512) {
    if (x_slice < d || x_groups || x_key_tile || x_stages || x_exchange || x_smem)
      return (int)cudaErrorInvalidValue;
#define MID(DQK, ROWS) \
  launch_mid<MidCfg<DQK, ROWS>>(q, k, v, bias, out, lse, B, Lq, Lk, heads, d, scale_d, s)
    if (x_cluster == 1 && x_slice == 192) return MID(192, true);
    if (x_cluster == 1 && x_slice == 256) return MID(256, true);
    if (x_cluster == 1 && x_slice == 320) return MID(320, true);
    if (x_cluster == 2 && x_slice == 384) return MID(384, false);
    if (x_cluster == 2 && x_slice == 448) return MID(448, false);
    if (x_cluster == 2 && x_slice == 512) return MID(512, false);
#undef MID
    return (int)cudaErrorInvalidValue;
  }
  if (d > 512) {
    const xwide::Plan p{x_slice, x_cluster, x_groups, x_key_tile, x_stages, x_exchange, x_smem};
    // past one cluster a warpgroup holds three pieces at once (both Q slices and K)
    if (!xwide::plan_ok(p, d) || (p.groups > 1 && p.stages < 3))
      return (int)cudaErrorInvalidValue;
#define XWIDE(SL, EXTRA) \
  launch_xwide<SL, EXTRA>(q, k, v, bias, out, lse, B, Lq, Lk, heads, d, scale_d, p, s)
    if (p.slice == 256) return p.groups > 1 ? XWIDE(256, true) : XWIDE(256, false);
    return p.groups > 1 ? XWIDE(128, true) : XWIDE(128, false);
#undef XWIDE
  }
  return (int)cudaErrorInvalidValue;
}

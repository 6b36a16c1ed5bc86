// Orientation probe: which way round should a narrow head (d = 40) enter the
// tensor-core product? For Hopper (sm_90a): kernel 8.
//
// Replaces: tools/microbench.py, `probe_dmajor`'s Pallas kernels (`run`'s
// `pallas_call`), one (lq x lk x d) product per grid step, of which only a
// slice is stored so that device-memory traffic cannot hide the product's
// cost. The arms, per problem g of G (bf16 in, fp32 accumulate, bf16 out),
// each with the JAX arm it replaces:
//   0 qk_d_on_lanes    (`qk_lanes`)    q (lq, d), k (lk, d)  -> (q k^T)[:, :128]  (lq, 128)
//   1 qk_d_on_sublanes (`qk_sublanes`) q (d, lq), k (d, lk)  -> the same product
//   2 pv_d_on_lanes    (`pv_lanes`)    p (lq, lk), v (lk, d) -> p v, zero-padded  (lq, 128)
//   3 pv_dmajor_out    (`pv_dmajor`)   v (d, lk), p (lq, lk) -> v p^T             (d, lq)
// and the control is arm 0 at d = 128 (the JAX `qk_d128_lanes` run).
//
// On Hopper the question becomes: do `wgmma`'s K-major and MN-major
// shared-memory operands, loaded by TMA, run at the same rate? Every arm is
// `wgmma` on operands that one producer warp loads by TMA into an mbarrier
// ring, and the arms differ only in operand layout, which the descriptors'
// transpose bits carry:
//   - QK arms: S (64 rows x kQkKeys keys per consumer warpgroup) = Q K^T.
//     qk_d_on_lanes: Q and K both K-major (d contiguous), 64-column boxes
//     of d in the 128-byte swizzle (two boxes at d = 128; at d <= 48 the
//     box runs past the extent d and TMA fills it with zeros, so the
//     contracted depth is d padded to 16). qk_d_on_sublanes: Q (d, lq) and
//     K (d, lk) are MN-major A and B (rows or keys contiguous), 64-wide
//     boxes of the rows, DP deep (rows past d zero-filled). The same
//     m64 x kQkKeys x 16 products either way.
//   - pv_d_on_lanes: O (64-row tiles, d) += P V, A = P K-major in 64-key
//     boxes (128-byte swizzle), B = V MN-major with N = d (exact in
//     `wgmma`'s steps of 8), one 64-column box of V's rows in the 128-byte
//     swizzle (columns past d zero-filled; kPvVSwizzled = false takes d / 8
//     8-column boxes without swizzle, as kernel A takes V at d = 40).
//   - pv_dmajor_out: O^T (64 rows, 128 queries) += V^T P^T, A = V^T K-major
//     (d rows of a 64-row tile loaded, rows d..63 zeroed once), B = P^T read
//     K-major straight from P (lq, lk); only rows < d are stored.
//
// What bounds it on the H100: the QK arms, operations (2 * G * lq * lk * d:
// 10.7 GFLOP at G = 64, 1024 x 2048, d = 40, 10.9 us at 989 TFLOP/s; 34.4
// GFLOP at d = 128); their 15.7 MB of inputs stay in the 50 MB L2 cache
// between calls, but each block reads all of its problem's K from L2 and
// the stored slice is 16.8 MB to write. The PV arms, bytes: reading p
// (G * lq * lk * 2 = 268 MB, 80 us at 3.35 TB/s), so they measure memory,
// not the tensor cores.
//
// Design against those bounds. QK: a block is kQkConsumers = 4 consumer
// warpgroups of 64 query rows (256 rows, so that K is read from L2 once per
// 256 rows) and a producer warpgroup whose first warp keeps 128-key tiles
// of K in flight (a 4-stage ring at d <= 48, 3 at d = 128); Q is loaded
// once; `setmaxnreg` gives the producer's registers to the consumers'
// 64-float accumulators. Each tile is d/16 `wgmma`s of N = 128; the first
// tile's 128 stored columns are staged per warp in shared memory and written
// as whole 256-byte rows (4-byte stores straight from the accumulators,
// each spanning 8 rows, took longer than the products at d = 40), and
// every other tile's products are consumed by folding one accumulator
// register into a sum that is written only through `sink`, a pointer no
// caller sets, so the products of the unstored tiles are computed at the
// cost of one add a tile. PV: a block is one consumer warpgroup and one
// producer warp, 128 rows (or queries) over 64-key stages of 16 KB of P in
// a 6-stage ring, one block an SM; the output is staged in shared memory
// and written in 16-byte rows. No atomics: the same inputs give the same
// bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int STORED = 128;        // stored columns of the QK and pv_d_on_lanes outputs
constexpr int kQkKeys = 128;       // keys of a QK stage: the accumulator's N
constexpr int kQkConsumers = 4;    // QK consumer warpgroups of 64 query rows
constexpr int kQkStagesNarrow = 4;  // QK ring depth at d <= 48
constexpr int kQkStagesWide = 3;    // and at d = 128
constexpr int kPvRows = 128;       // rows (pv_d_on_lanes) or queries (pv_dmajor_out) of a block
constexpr int kPvStages = 6;       // PV ring depth
constexpr int kPvKeys = 64;        // keys of a PV stage: one 128-byte swizzle row
// pv_d_on_lanes' V: one 64-column box in the 128-byte swizzle (rows of d
// read whole, columns past d zero-filled) instead of d / 8 8-column boxes
constexpr bool kPvVSwizzled = true;

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                          ~uintptr_t(1023));
}

// ---- arms 0 and 1: S = Q K^T -------------------------------------------------

// DP: the contracted depth (d padded to 16); DMAJOR: q and k are (d, l).
template <int DP_, bool DMAJOR_>
struct QkCfg {
  static constexpr int DP = DP_;
  static constexpr bool DMAJOR = DMAJOR_;
  static constexpr int NC = kQkConsumers;
  static constexpr int THREADS = 128 * (NC + 1);  // + the producer warpgroup
  static constexpr int PRODUCER_REGS = 24;
  // setmaxnreg moves registers only within the block's allocation at
  // launch, 65536 / THREADS a thread in steps of 8: a consumer count above
  // it would wait forever
  static constexpr int ALLOC = THREADS * ((65536 / THREADS) / 8 * 8);
  static constexpr int CONSUMER_REGS_MAX = (ALLOC - 128 * PRODUCER_REGS) / (128 * NC) / 8 * 8;
  static constexpr int CONSUMER_REGS = CONSUMER_REGS_MAX < 240 ? CONSUMER_REGS_MAX : 240;
  static constexpr int BQ = 64 * NC;  // query rows of a block
  static constexpr int BK = kQkKeys;
  static_assert(BK % 64 == 0 && BK >= STORED && BK <= 256, "key tile");
  static_assert(CONSUMER_REGS >= BK / 2 + 32, "registers for the accumulators");
  static constexpr int STAGES = DP > 64 ? kQkStagesWide : kQkStagesNarrow;
  static constexpr int KSTEPS = DP / 16;
  static constexpr int NBOX = (DP + 63) / 64;  // K-major: 64-column boxes of d
  // K-major: [box of d][rows][64]; MN-major: [64-row box][DP][64]
  static constexpr int Q_BYTES = DMAJOR ? NC * DP * 128 : NBOX * BQ * 128;
  static constexpr int K_BYTES = DMAJOR ? (BK / 64) * DP * 128 : NBOX * BK * 128;
  static constexpr int OFF_K = Q_BYTES;
  // the stored columns of the first tile, 16 rows of 256 bytes per warp
  static constexpr int OFF_O = OFF_K + STAGES * K_BYTES;
  static constexpr int OFF_BAR = OFF_O + BQ * STORED * 2;
  static constexpr int SMEM = OFF_BAR + (2 * STAGES + 1) * 8 + 1024;  // + alignment
  static_assert(Q_BYTES % 1024 == 0 && K_BYTES % 1024 == 0, "swizzle atoms");
  static_assert(SMEM <= 232448, "shared memory");
  // byte offset of the 16-deep step kk in a Q or K tile of `rows` rows
  __device__ __forceinline__ static uint32_t step(int kk, int rows) {
    return DMAJOR ? kk * 2048 : (kk / 4) * rows * 128 + (kk % 4) * 32;
  }
};

template <class C>
__global__ void __launch_bounds__(C::THREADS, 1)
probe_dmajor_qk_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map, bf16* __restrict__ out,
                       float* __restrict__ sink, int lq, int lk) {
  constexpr int BQ = C::BQ, BK = C::BK, STAGES = C::STAGES, DP = C::DP, NC = C::NC;
  constexpr bool DMAJOR = C::DMAJOR;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sQ = smem;
  unsigned char* sK = smem + C::OFF_K;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* full_q = empty + STAGES;

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * BQ;
  const int g = blockIdx.y;
  const int n_kt = (lk + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NC);  // one arrival per consumer warp
    }
    mbar_init(full_q, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == NC) {
    // ---------------- producer ----------------
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (warp != 0 || lane != 0) return;
    tma_prefetch_desc(&q_map);
    tma_prefetch_desc(&k_map);
    if constexpr (DMAJOR) {
      // one 64-row box per consumer warpgroup whose rows start inside lq
      const int boxes = min(NC, (lq - q0 + 63) / 64);
      mbar_arrive_expect_tx(full_q, boxes * DP * 128);
      for (int w = 0; w < boxes; ++w)
        tma_load_3d(sQ + w * DP * 128, &q_map, full_q, q0 + 64 * w, 0, g);
    } else {
      mbar_arrive_expect_tx(full_q, C::Q_BYTES);
      for (int i = 0; i < C::NBOX; ++i)
        tma_load_3d(sQ + i * BQ * 128, &q_map, full_q, 64 * i, q0, g);
    }
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % STAGES;
      const int k0 = kt * BK;
      unsigned char* tile = sK + s * C::K_BYTES;
      mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
      if constexpr (DMAJOR) {
        // the 64-key boxes that start inside lk (the rest keep an earlier
        // tile's keys: products of columns that are never stored)
        const int boxes = min(BK / 64, (lk - k0 + 63) / 64);
        mbar_arrive_expect_tx(&full[s], boxes * DP * 128);
        for (int i = 0; i < boxes; ++i)
          tma_load_3d(tile + i * DP * 128, &k_map, &full[s], k0 + 64 * i, 0, g);
      } else {
        mbar_arrive_expect_tx(&full[s], C::K_BYTES);
        for (int i = 0; i < C::NBOX; ++i)
          tma_load_3d(tile + i * BK * 128, &k_map, &full[s], 64 * i, k0, g);
      }
    }
    return;
  }

  // ---------------- consumers ----------------
  setmaxnreg_inc<C::CONSUMER_REGS>();
  // K-major (lanes): SBO = 1024 between 8-row atoms, 16-deep steps 32 bytes
  // apart inside a 128-byte row. MN-major (sublanes): LBO = DP * 128 between
  // 64-wide atoms of rows or keys, SBO = 1024 between 8-deep atoms.
  const uint32_t lbo = DMAJOR ? DP * 128 : 16;
  const uint64_t a_desc =
      gmma_desc(smem_u32(sQ) + wg * (DMAJOR ? DP * 128 : 64 * 128), lbo, 1024, kSwizzle128B);
  const uint64_t b_desc = gmma_desc(smem_u32(sK), lbo, 1024, kSwizzle128B);

  // S (64 rows x BK keys): element 4j + e is row 16 warp + lane/4 + 8 (e >> 1),
  // key 8j + 2 (lane % 4) + (e & 1)
  float acc[BK / 2];
  float live = 0.f;
  mbar_wait(full_q, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::KSTEPS; ++kk)
      WgmmaSSt<BK>::template run<DMAJOR, DMAJOR>(
          acc, a_desc + (C::step(kk, BQ) >> 4),
          b_desc + ((s * C::K_BYTES + C::step(kk, BK)) >> 4), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (kt == 0) {
      // the stored columns, keys 0..127 of the first tile: each warp stages
      // its 16 rows in shared memory (the 16-byte chunk c of row r at chunk
      // c ^ (r % 8), so that the 8 rows a store instruction spans fall in
      // different banks) and writes them back as whole 256-byte rows
      unsigned char* stage = smem + C::OFF_O + (4 * wg + warp) * 16 * STORED * 2;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = lane / 4 + 8 * r;
#pragma unroll
        for (int j = 0; j < STORED / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(stage + row * STORED * 2 + ((j ^ (row % 8)) * 16) +
                                             4 * (lane % 4)) =
              __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 16 * STORED / 8 / 32; ++i) {
        const int row = 2 * i + lane / 16, c = lane % 16;
        const int q = q0 + 64 * wg + 16 * warp + row;
        if (q < lq)
          *reinterpret_cast<uint4*>(out + ((size_t)g * lq + q) * STORED + 8 * c) =
              *reinterpret_cast<const uint4*>(stage + row * STORED * 2 + ((c ^ (row % 8)) * 16));
      }
    } else {
      live += acc[0];  // keeps the tile's products: one add, not BK / 2
    }
  }
  if (sink) sink[((size_t)g * gridDim.x + blockIdx.x) * (128 * NC) + threadIdx.x] = live;
}

template <class C>
int launch_qk(const void* q, const void* k, void* out, void* sink, int G, int lq, int lk, int d,
              cudaStream_t stream) {
  CUtensorMap maps[2];
  int err;
  if (C::DMAJOR) {
    err = make_map(&maps[0], q, lq, d, G, 64, C::DP, true);
    if (!err) err = make_map(&maps[1], k, lk, d, G, 64, C::DP, true);
  } else {
    err = make_map(&maps[0], q, d, lq, G, 64, C::BQ, true);
    if (!err) err = make_map(&maps[1], k, d, lk, G, 64, C::BK, true);
  }
  if (err) return err;
  auto kernel = probe_dmajor_qk_kernel<C>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       C::SMEM);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((lq + C::BQ - 1) / C::BQ, G), C::THREADS, C::SMEM, stream>>>(
      maps[0], maps[1], static_cast<bf16*>(out), static_cast<float*>(sink), lq, lk);
  return (int)cudaGetLastError();
}

template <bool DMAJOR>
int launch_qk_d(const void* q, const void* k, void* out, void* sink, int G, int lq, int lk,
                int d, cudaStream_t s) {
  if (d <= 16) return launch_qk<QkCfg<16, DMAJOR>>(q, k, out, sink, G, lq, lk, d, s);
  if (d <= 32) return launch_qk<QkCfg<32, DMAJOR>>(q, k, out, sink, G, lq, lk, d, s);
  if (d <= 48) return launch_qk<QkCfg<48, DMAJOR>>(q, k, out, sink, G, lq, lk, d, s);
  if (d == 128) return launch_qk<QkCfg<128, DMAJOR>>(q, k, out, sink, G, lq, lk, d, s);
  return (int)cudaErrorInvalidValue;
}

// ---- the PV arms ----------------------------------------------------------

// Shared by both PV arms: 64-key stages of A and B, the staged output.
// A_BYTES, B_BYTES: one stage of each operand; O_BYTES: the staged output.
template <int A_BYTES_, int B_BYTES_, int O_BYTES_>
struct PvCfg {
  static constexpr int THREADS = 128 + 32;  // a consumer warpgroup, a producer warp
  static constexpr int BR = kPvRows;
  static constexpr int STAGES = kPvStages;
  static constexpr int A_BYTES = A_BYTES_;
  static constexpr int B_BYTES = B_BYTES_;
  static constexpr int OFF_B = STAGES * A_BYTES;
  static constexpr int OFF_O = OFF_B + STAGES * B_BYTES;
  static constexpr int OFF_BAR = OFF_O + O_BYTES_;
  static constexpr int SMEM = OFF_BAR + 2 * STAGES * 8 + 1024;  // + alignment
  static_assert(A_BYTES % 1024 == 0 && B_BYTES % 1024 == 0 && O_BYTES_ % 16 == 0, "");
  static_assert(SMEM <= 232448, "shared memory");
};

// Arm 2: O (BR rows, D) = P V. A = P: [BR rows][64 keys], 128-byte swizzle;
// B = V: [64 keys][64], 128-byte swizzle (or [D / 8 slabs][64 keys][8], no
// swizzle); O staged as [BR][D].
template <int D>
using PvLanesCfg = PvCfg<kPvRows * 128, kPvVSwizzled ? kPvKeys * 128 : (D / 8) * kPvKeys * 16,
                         kPvRows * D * 2>;

template <int D>
__global__ void __launch_bounds__(PvLanesCfg<D>::THREADS, 2)
probe_dmajor_pv_kernel(const __grid_constant__ CUtensorMap p_map,
                       const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ out,
                       int lq, int lk) {
  using C = PvLanesCfg<D>;
  constexpr int BR = C::BR, STAGES = C::STAGES, MT = BR / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sP = smem;
  unsigned char* sV = smem + C::OFF_B;
  bf16* sO = reinterpret_cast<bf16*>(smem + C::OFF_O);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* empty = full + STAGES;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * BR;
  const int g = blockIdx.y;
  const int n_kt = lk / kPvKeys;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {
    // ---------------- producer ----------------
    if (lane != 0) return;
    tma_prefetch_desc(&p_map);
    tma_prefetch_desc(&v_map);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % STAGES;
      const int k0 = kt * kPvKeys;
      mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
      mbar_arrive_expect_tx(&full[s], C::A_BYTES + C::B_BYTES);
      tma_load_3d(sP + s * C::A_BYTES, &p_map, &full[s], k0, q0, g);
      if (kPvVSwizzled)
        tma_load_3d(sV + s * C::B_BYTES, &v_map, &full[s], 0, k0, g);
      else
        for (int i = 0; i < D / 8; ++i)
          tma_load_3d(sV + s * C::B_BYTES + i * kPvKeys * 16, &v_map, &full[s], 8 * i, k0, g);
    }
    return;
  }

  // ---------------- consumer ----------------
  // A = P K-major (SBO 1024, 16-deep steps 32 bytes apart); B = V MN-major
  // in the 128-byte swizzle (one 64-column atom; SBO = 1024 between 8-key
  // atoms, 16-key steps 2048 bytes apart) or without swizzle (LBO = 128
  // between 8-key groups, SBO = 64 keys * 16 between 8-column slabs; 16-key
  // steps 256 bytes apart)
  const uint64_t p_desc = gmma_desc(smem_u32(sP), 16, 1024, kSwizzle128B);
  const uint64_t v_desc = kPvVSwizzled
                              ? gmma_desc(smem_u32(sV), kPvKeys * 128, 1024, kSwizzle128B)
                              : gmma_desc(smem_u32(sV), 128, kPvKeys * 16, kNoSwizzle);
  constexpr int V_STEP = kPvVSwizzled ? 2048 : 256;
  // O: element 4j + e of tile mt is row 64 mt + 16 warp + lane/4 + 8 (e >> 1),
  // column 8j + 2 (lane % 4) + (e & 1)
  float o[MT][D / 2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[mt][i] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int t = 0; t < kPvKeys / 16; ++t)
        WgmmaSSt<D>::template run<0, 1>(
            o[mt], p_desc + ((s * C::A_BYTES + mt * 64 * 128 + t * 32) >> 4),
            v_desc + ((s * C::B_BYTES + t * V_STEP) >> 4), 1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_regs(o[mt]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // O to shared memory, then 16-byte rows of 128 columns, zeros past d
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      bf16* orow = sO + (64 * mt + 16 * warp + lane / 4 + 8 * r) * D + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(o[mt][4 * j + 2 * r], o[mt][4 * j + 2 * r + 1]);
    }
  named_bar_sync(1, 128);
  for (int e = threadIdx.x; e < BR * (STORED / 8); e += 128) {
    const int r = e / (STORED / 8), c = 8 * (e % (STORED / 8));
    if (q0 + r >= lq) continue;
    const uint4 val =
        c < D ? *reinterpret_cast<const uint4*>(sO + r * D + c) : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(out + ((size_t)g * lq + q0 + r) * STORED + c) = val;
  }
}

template <int D>
int launch_pv(const void* p, const void* v, void* out, int G, int lq, int lk, cudaStream_t s) {
  using C = PvLanesCfg<D>;
  CUtensorMap maps[2];
  int err = make_map(&maps[0], p, lk, lq, G, kPvKeys, C::BR, true);
  if (!err) err = make_map(&maps[1], v, D, lk, G, kPvVSwizzled ? 64 : 8, kPvKeys, kPvVSwizzled);
  if (err) return err;
  auto kernel = probe_dmajor_pv_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       C::SMEM);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((lq + C::BR - 1) / C::BR, G), C::THREADS, C::SMEM, s>>>(
      maps[0], maps[1], static_cast<bf16*>(out), lq, lk);
  return (int)cudaGetLastError();
}

// Arm 3: O^T (64 rows, BR queries) = V^T P^T, rows < d stored. A = V^T:
// [64 rows][64 keys], 128-byte swizzle, the d rows by TMA and the rest
// zeroed once; B = P^T read K-major from P: [BR queries][64 keys]; O^T
// staged as [48][BR].
using PvDmajorCfg = PvCfg<64 * 128, kPvRows * 128, 48 * kPvRows * 2>;

__global__ void __launch_bounds__(PvDmajorCfg::THREADS, 2)
probe_dmajor_pvt_kernel(const __grid_constant__ CUtensorMap v_map,
                        const __grid_constant__ CUtensorMap p_map, bf16* __restrict__ out,
                        int lq, int lk, int d) {
  using C = PvDmajorCfg;
  constexpr int BR = C::BR, STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sV = smem;
  unsigned char* sP = smem + C::OFF_B;
  bf16* sO = reinterpret_cast<bf16*>(smem + C::OFF_O);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* empty = full + STAGES;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * BR;
  const int g = blockIdx.y;
  const int n_kt = lk / kPvKeys;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    fence_barrier_init();
  }
  // rows d..63 of every V^T stage, which TMA never writes: zeros
  for (int s = 0; s < STAGES; ++s) {
    uint4* pad = reinterpret_cast<uint4*>(sV + s * C::A_BYTES + d * 128);
    for (int i = threadIdx.x; i < (64 - d) * 8; i += C::THREADS)
      pad[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  fence_proxy_async();
  __syncthreads();

  if (warp == 4) {
    // ---------------- producer ----------------
    if (lane != 0) return;
    tma_prefetch_desc(&v_map);
    tma_prefetch_desc(&p_map);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % STAGES;
      const int k0 = kt * kPvKeys;
      mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
      mbar_arrive_expect_tx(&full[s], d * 128 + C::B_BYTES);
      tma_load_3d(sV + s * C::A_BYTES, &v_map, &full[s], k0, 0, g);
      tma_load_3d(sP + s * C::B_BYTES, &p_map, &full[s], k0, q0, g);
    }
    return;
  }

  // ---------------- consumer ----------------
  // both K-major: SBO 1024, 16-deep steps 32 bytes apart
  const uint64_t a_desc = gmma_desc(smem_u32(sV), 16, 1024, kSwizzle128B);
  const uint64_t b_desc = gmma_desc(smem_u32(sP), 16, 1024, kSwizzle128B);
  // O^T: element 4j + e is row 16 warp + lane/4 + 8 (e >> 1), query
  // 8j + 2 (lane % 4) + (e & 1)
  float acc[BR / 2];
#pragma unroll
  for (int i = 0; i < BR / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < kPvKeys / 16; ++t)
      WgmmaSSt<BR>::template run<0, 0>(acc, a_desc + ((s * C::A_BYTES + t * 32) >> 4),
                                       b_desc + ((s * C::B_BYTES + t * 32) >> 4), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // rows < d to shared memory, then 16-byte pieces of each (d, lq) row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + lane / 4 + 8 * r;
    if (row >= d) continue;
#pragma unroll
    for (int j = 0; j < BR / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(sO + row * BR + 8 * j + 2 * (lane % 4)) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
  named_bar_sync(1, 128);
  for (int e = threadIdx.x; e < d * (BR / 8); e += 128) {
    const int row = e / (BR / 8), c = 8 * (e % (BR / 8));
    if (q0 + c >= lq) continue;
    *reinterpret_cast<uint4*>(out + ((size_t)g * d + row) * lq + q0 + c) =
        *reinterpret_cast<const uint4*>(sO + row * BR + c);
  }
}

int launch_pvt(const void* v, const void* p, void* out, int G, int lq, int lk, int d,
               cudaStream_t s) {
  using C = PvDmajorCfg;
  CUtensorMap maps[2];
  int err = make_map(&maps[0], v, lk, d, G, kPvKeys, d, true);
  if (!err) err = make_map(&maps[1], p, lk, lq, G, kPvKeys, C::BR, true);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(probe_dmajor_pvt_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  probe_dmajor_pvt_kernel<<<dim3((lq + C::BR - 1) / C::BR, G), C::THREADS, C::SMEM, s>>>(
      maps[0], maps[1], static_cast<bf16*>(out), lq, lk, d);
  return (int)cudaGetLastError();
}

}  // namespace

// arm: 0 qk_lanes, 1 qk_sublanes, 2 pv_lanes, 3 pv_dmajor (see above); a and
// b are the arm's two inputs in that order, G problems each, contiguous.
// lq and lk are multiples of 64; the QK arms take d <= 48 or d = 128 and
// lk >= 128, the PV arms d <= 48; d is a multiple of 8. `sink` is null in
// every real call.
extern "C" int hv_probe_dmajor(int arm, const void* a, const void* b, void* out, void* sink,
                               int G, int lq, int lk, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G <= 0 || G > 65535 || lq <= 0 || lk <= 0 || lq % 64 || lk % 64 || d <= 0 || d % 8)
    return (int)cudaErrorInvalidValue;
  switch (arm) {
    case 0:
    case 1:
      if (lk < STORED) return (int)cudaErrorInvalidValue;
      return arm == 0 ? launch_qk_d<false>(a, b, out, sink, G, lq, lk, d, s)
                      : launch_qk_d<true>(a, b, out, sink, G, lq, lk, d, s);
    case 2:
      switch (d) {
        case 8: return launch_pv<8>(a, b, out, G, lq, lk, s);
        case 16: return launch_pv<16>(a, b, out, G, lq, lk, s);
        case 24: return launch_pv<24>(a, b, out, G, lq, lk, s);
        case 32: return launch_pv<32>(a, b, out, G, lq, lk, s);
        case 40: return launch_pv<40>(a, b, out, G, lq, lk, s);
        case 48: return launch_pv<48>(a, b, out, G, lq, lk, s);
        default: return (int)cudaErrorInvalidValue;
      }
    case 3:
      if (d > 48) return (int)cudaErrorInvalidValue;
      return launch_pvt(a, b, out, G, lq, lk, d, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Frame-axis (temporal) multi-head attention forward, bf16, for Hopper (sm_90a).
//
// Replaces: humanvid_tpu/ops/temporal_attention.py, the Pallas kernel
// `_fwd_kernel`, launched by `_call_fwd` through `_temporal` /
// `temporal_attention`.
//
// Computes, on q/k/v/out of shape (b, f, l, c) with heads packed in c
// (head h at column offset h*d), for each (b, position l, head h):
//   out[b, :, l, h] = softmax_over_frames(q[b, :, l, h] k[b, :, l, h]^T * d^-1/2)
//                     v[b, :, l, h]
// with f <= 32 frames (more: the long kernel at the end of this file), in
// the UNet's native spatial layout: there is no
// (b f) l c <-> (b l) f c rearrange and the output has the input's layout.
//
// What bounds it on the H100: device-memory bytes. Each position's f x f
// attention is tiny (24 x 24 x d): at the motion modules' level 0 a call is
// 4.5 GFLOP (4.6 us at the bf16 peak) against 377 MB of q/k/v/out (113 us),
// and the products stay under 5% of the byte bound at every level. The
// first design (a warp per (position, head), synchronous 16-byte loads of
// one head's 80-byte row pieces, loads and stores not overlapped, 4 warps
// an SM at d = 160) reached a third of the bound.
//
// What this design does about it:
// - A work item is the TPU kernel's block: P positions (kPositions) x all f
//   frames x a chunk of whole heads (the wrapper's `temporal_plan`: as many
//   heads as fit 160 columns, the whole 320-byte row piece of the UNet's 8
//   heads at every level). It is one TMA load per tensor from a 4-D map
//   (c, l, f, b): frames past f and positions past l read zeros, so a box
//   never crosses into the next sample's frames. The box runs 8 (or 16)
//   columns past the chunk so that a frame row in shared memory is an odd
//   number of 16-byte units: the ldmatrix rows of one (position, head),
//   f frames apart, then fall in distinct banks. The extra columns are the
//   next chunk's first ones (read at the same time by the block that owns
//   them, so from L2) or zeros past c.
// - One producer thread keeps a ring of kStages such items in flight
//   (mbarriers with transaction counts); the grid is persistent over the
//   items, so one item's loads run under another's products and stores.
// - kConsumers consumer warps each take one (position, head) of an item at
//   a time with `mma.sync.m16n8k16` (bf16 in, fp32 accumulate): S = Q K^T,
//   the softmax in the log2 domain in registers (fp32 logits scaled in
//   fp32, keys >= f masked, P normalized before its bf16 rounding, as the
//   plain version does), O = P V. The mma tiles run to 32 frames; a tile in
//   shared memory holds only the f frames TMA writes, so the rows past f
//   that ldmatrix reads are the next tile's: their S rows never reach a
//   stored O, their keys are masked, and V's are zeroed in the fragments.
//   The columns past d of a head's last 16-deep step (the next head's, or
//   the next chunk's) are zeroed in both Q's and K's fragments, by a
//   select: zeroing only one operand would turn an Inf or NaN of the next
//   head into a NaN of this head's S (0 x Inf). `wgmma` is not used: its 64-row M would pad f = 24 by 2.7x,
//   and the products are not what bounds the kernel.
// - O is staged densely in an O tile ([f][positions][chunk columns]) and
//   written by one 4-D TMA store per item, issued by the producer when the
//   item's (position, head) pairs are done; the O tiles form a ring one
//   longer than the stages, so the producer waits only for the read of a
//   store issued an item earlier. (A bulk copy per frame row, 24 an item,
//   from the Q tile measured the same: PERF.md section 6.)
// - Shared memory is per item, not per warp: 3 stages of Q, K and V tiles of
//   24 x 168 bf16 and 4 O tiles of 24 x 160 are 103 KB at f = 24, two
//   blocks an SM at every level.
// - On the host a launch encodes the four maps and launches. The function's
//   shared memory limit and the persistent grid (SMs x blocks an SM) are
//   asked of the runtime once per item size and kept (`HostCache`), so the
//   small shapes, where a call's host time exceeds its device time, pay
//   for no runtime query.
// Measured on the H100 (PERF.md section 6): level 0 at ~80% of the byte
// bound; fewer stages move it by a few percent, more positions an item,
// a deeper ring (one block an SM) or fewer consumer warps cost 25-55%, and
// without either the loads or the stores it runs within 10% of the bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_tiles.cuh"
#include "warp_mma.cuh"

namespace {

using namespace hopper;

constexpr int kMaxFrames = 32;  // frames the two 16-row mma tiles cover
constexpr int kConsumers = 4;   // consumer warps
constexpr int kStages = 3;      // items in flight
constexpr int kPositions = 1;   // positions per item
constexpr int kOTiles = kStages + 1;  // O tiles: one item's store drains under the next
constexpr int kThreads = 32 * (kConsumers + 1);
constexpr float kLog2e = 1.4426950408889634f;

// Elements of one stage's Q, K or V tile ([F][kPositions][cwp]) and of its
// O tile ([F][kPositions][cw]), each rounded to 128 bytes (TMA's alignment).
__host__ __device__ inline int tile_elems(int F, int cols) {
  return (F * kPositions * cols + 63) / 64 * 64;
}

// The stages' Q, K and V tiles, the O tiles, then room for the mma tiles'
// rows past F (read, never used), then the mbarriers.
__host__ __device__ inline size_t smem_bytes(int F, int cw, int cwp) {
  return 128 + ((size_t)kStages * 3 * tile_elems(F, cwp) + (size_t)kOTiles * tile_elems(F, cw)) * 2 +
         (size_t)(kMaxFrames - F) * kPositions * cwp * 2 + 2 * kStages * 8;
}

// Zero the halves of a bf16 pair that hold frames >= F.
__device__ __forceinline__ uint32_t mask_frames(uint32_t v, int frame, int F) {
  return v & ((frame < F ? 0x0000ffffu : 0u) | (frame + 1 < F ? 0xffff0000u : 0u));
}

// S += Q K^T over one head's (or one chunk's) d columns: 2 row tiles
// (query frames) x 4 column tiles (key frames); sq/sk point at the first
// column of frame 0, LDF is the stride between frames, in elements. The
// columns past d of the last 16-deep step (the next head's, or the next
// chunk's) are zeroed in both Q's and K's fragments.
template <int DP>
__device__ __forceinline__ void qk_accumulate(float (&s)[2][4][4], const bf16* sq,
                                              const bf16* sk, int LDF, int d, int lane) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    if (16 * kk >= d) break;
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      ldmatrix_x4(a[mt], sq + (mt * 16 + lane % 16) * LDF + kk * 16 + (lane / 16) * 8);
      if (16 * kk + 8 >= d) a[mt][2] = a[mt][3] = 0u;  // columns past the head
    }
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      uint32_t bk[4];
      ldmatrix_x4(bk, sk + (jp * 16 + (lane % 8) + (lane / 16) * 8) * LDF + kk * 16 +
                          ((lane / 8) % 2) * 8);
      if (16 * kk + 8 >= d) bk[1] = bk[3] = 0u;  // K's columns past the head too
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16(s[mt][2 * jp], a[mt], bk[0], bk[1]);
        mma_bf16(s[mt][2 * jp + 1], a[mt], bk[2], bk[3]);
      }
    }
  }
}

// The softmax over key frames of S (scaled here, keys >= F masked), P
// normalized and packed as the A fragments of O = P V: pa[row tile][16-key
// step]. Element e of tile (mt, j) is key frame 8j + 2*(lane%4) + (e&1) of
// query frame 16mt + lane/4 + 8*(e>>1).
__device__ __forceinline__ void softmax_p(float (&s)[2][4][4], uint32_t (&pa)[2][2][4], int F,
                                          float scale_log2, int lane) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * j + 2 * (lane % 4) + (e & 1);
        s[mt][j][e] = key < F ? s[mt][j][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][j][e]);
      }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[mt][j][e] = exp2f(s[mt][j][e] - mx[e >> 1]);
        sum[e >> 1] += s[mt][j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      sum[r] = 1.f / sum[r];
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      pa[mt][t][0] = pack_bf16(s[mt][2 * t][0] * sum[0], s[mt][2 * t][1] * sum[0]);
      pa[mt][t][1] = pack_bf16(s[mt][2 * t][2] * sum[1], s[mt][2 * t][3] * sum[1]);
      pa[mt][t][2] = pack_bf16(s[mt][2 * t + 1][0] * sum[0], s[mt][2 * t + 1][1] * sum[0]);
      pa[mt][t][3] = pack_bf16(s[mt][2 * t + 1][2] * sum[1], s[mt][2 * t + 1][3] * sum[1]);
    }
  }
}

// O = P V over d columns in chunks of 64, written to the O tile `so` (frames
// < F only, LDO elements apart); sv points at V's first column of frame 0.
// V's rows past F are zeroed in the fragments.
template <int DP>
__device__ __forceinline__ void pv_store(const uint32_t (&pa)[2][2][4], const bf16* sv,
                                         bf16* so, int LDF, int LDO, int F, int d, int lane) {
#pragma unroll
  for (int n0 = 0; n0 < DP; n0 += 64) {
    if (n0 >= d) break;
    constexpr int kMaxTiles = 8;
    float o[2][kMaxTiles][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int n = 0; n < kMaxTiles; ++n) o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int np = 0; np < kMaxTiles / 2; ++np) {
        if (n0 + 16 * np >= DP || n0 + 16 * np >= d) break;
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, sv + (t * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LDF + n0 +
                                  np * 16 + (lane / 16) * 8);
        // registers 0 and 2 hold frames t*16 + 2*(lane%4) (+1), 1 and 3 eight later
        const int fr = t * 16 + 2 * (lane % 4);
        bv[0] = mask_frames(bv[0], fr, F);
        bv[2] = mask_frames(bv[2], fr, F);
        bv[1] = mask_frames(bv[1], fr + 8, F);
        bv[3] = mask_frames(bv[3], fr + 8, F);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(o[mt][2 * np], pa[mt][t], bv[0], bv[1]);
          mma_bf16(o[mt][2 * np + 1], pa[mt][t], bv[2], bv[3]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int n = 0; n < kMaxTiles; ++n) {
        if (n0 + 8 * n >= DP || n0 + 8 * n >= d) break;
        const int col = n0 + 8 * n + 2 * (lane % 4);
        const int row = 16 * mt + lane / 4;
        if (row < F)
          *reinterpret_cast<__nv_bfloat162*>(so + row * LDO + col) =
              __floats2bfloat162_rn(o[mt][n][0], o[mt][n][1]);
        if (row + 8 < F)
          *reinterpret_cast<__nv_bfloat162*>(so + (row + 8) * LDO + col) =
              __floats2bfloat162_rn(o[mt][n][2], o[mt][n][3]);
      }
  }
}

// One (position p, head h) of the item in a stage: S = Q K^T, softmax, O =
// P V, O written to the O tile (frames < F only). sq/sk/sv/so point at the
// head's first column of frame 0; LDF and LDO are the strides between
// frames, in elements. The mma tiles run to 32 frames: rows past F are read
// (the next tile's), their S rows and columns never reach a stored O, and
// V's are zeroed in the fragments.
template <int DP>
__device__ __forceinline__ void attend(const bf16* sq, const bf16* sk, const bf16* sv, bf16* so,
                                       int LDF, int LDO, int F, int d, float scale_log2,
                                       int lane) {
  float s[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
  qk_accumulate<DP>(s, sq, sk, LDF, d, lane);
  uint32_t pa[2][2][4];
  softmax_p(s, pa, F, scale_log2, lane);
  pv_store<DP>(pa, sv, so, LDF, LDO, F, d, lane);
}

// The item's coordinates: (chunk, first position, sample).
struct Item {
  int chunk, pos0, b;
};

__device__ __forceinline__ Item item_of(int it, int chunks, int pblocks) {
  Item r;
  r.chunk = it % chunks;
  r.pos0 = ((it / chunks) % pblocks) * kPositions;
  r.b = it / (chunks * pblocks);
  return r;
}

// grid: persistent, at most one block per item; block kThreads.
template <int DP>
__global__ void __launch_bounds__(kThreads)
temporal_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap o_map, int B, int F, int L, int C, int d,
                    int CW, int CWP, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  bf16* tiles = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~static_cast<uintptr_t>(127));
  const int TILE = tile_elems(F, CWP), OTILE = tile_elems(F, CW);
  const int STAGE = 3 * TILE;  // Q, K, V
  bf16* otiles = tiles + (size_t)kStages * STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(otiles + (size_t)kOTiles * OTILE +
                                               (size_t)(kMaxFrames - F) * kPositions * CWP);
  uint64_t* empty = full + kStages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunks = C / CW;
  const int heads_per_item = CW / d;
  const int tasks = kPositions * heads_per_item;  // (position, head) pairs of an item
  const int pblocks = (L + kPositions - 1) / kPositions;
  const int items = B * pblocks * chunks;
  const int LDF = kPositions * CWP, LDO = kPositions * CW;  // elements between frames

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 2);  // the loads' bytes, and the O tile free again
      mbar_init(&empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers) {
    // producer (one thread): the stage's previous item is stored, the next
    // loaded; the stage is full once its loads have landed and the O tile
    // its item will write has been read by the store of its last item
    if (lane != 0) return;
    const uint32_t bytes = 3u * kPositions * F * CWP * 2;
    int n = 0;
    for (int it = blockIdx.x; it < items; it += gridDim.x, ++n) {
      const int s = n % kStages;
      bf16* t = tiles + (size_t)s * STAGE;
      if (n >= kStages) {
        mbar_wait(&empty[s], ((n / kStages) - 1) & 1);
        const Item w = item_of(it - kStages * gridDim.x, chunks, pblocks);
        tma_store_4d(&o_map, otiles + (size_t)((n - kStages) % kOTiles) * OTILE, w.chunk * CW,
                     w.pos0, 0, w.b);
        bulk_commit();
      }
      const Item w = item_of(it, chunks, pblocks);
      mbar_arrive_expect_tx(&full[s], bytes);
      tma_load_4d(t, &q_map, &full[s], w.chunk * CW, w.pos0, 0, w.b);
      tma_load_4d(t + TILE, &k_map, &full[s], w.chunk * CW, w.pos0, 0, w.b);
      tma_load_4d(t + 2 * TILE, &v_map, &full[s], w.chunk * CW, w.pos0, 0, w.b);
      // every store but the one just issued has read its tile: so has that
      // of item n - kOTiles, whose tile item n writes
      bulk_wait<1, true>();
      mbar_arrive(&full[s]);
    }
    for (int m = n > kStages ? n - kStages : 0; m < n; ++m) {
      const int s = m % kStages;
      mbar_wait(&empty[s], (m / kStages) & 1);
      const Item w = item_of(blockIdx.x + m * gridDim.x, chunks, pblocks);
      tma_store_4d(&o_map, otiles + (size_t)(m % kOTiles) * OTILE, w.chunk * CW, w.pos0, 0, w.b);
      bulk_commit();
    }
    bulk_wait<0, false>();
    return;
  }

  // consumers: task g = n * tasks + t of this block goes to warp g %
  // kConsumers; every warp waits for every item and frees it, so no warp
  // can be lapped by the ring
  int n = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x, ++n) {
    const int s = n % kStages;
    mbar_wait(&full[s], (n / kStages) & 1);
    const bf16* tq = tiles + (size_t)s * STAGE;
    bf16* to = otiles + (size_t)(n % kOTiles) * OTILE;
    for (int t = (warp - (n * tasks) % kConsumers + kConsumers) % kConsumers; t < tasks;
         t += kConsumers) {
      const int p = t / heads_per_item, h = t % heads_per_item;
      const size_t off = (size_t)p * CWP + (size_t)h * d;
      attend<DP>(tq + off, tq + TILE + off, tq + 2 * TILE + off,
                 to + (size_t)p * CW + (size_t)h * d, LDF, LDO, F, d, scale_log2, lane);
    }
    fence_proxy_async();  // O's writes before the TMA store reads them
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
}

HostCache host_cache;

template <int DP>
int launch(const void* q, const void* k, const void* v, void* out, int B, int F, int L,
           int heads, int d, int CW, int CWP, int scale_d, cudaStream_t stream) {
  const int C = heads * d;
  CUtensorMap maps[4];
  int err = make_map_4d(&maps[0], q, C, L, F, B, CWP, kPositions, F);
  if (!err) err = make_map_4d(&maps[1], k, C, L, F, B, CWP, kPositions, F);
  if (!err) err = make_map_4d(&maps[2], v, C, L, F, B, CWP, kPositions, F);
  if (!err) err = make_map_4d(&maps[3], out, C, L, F, B, CW, kPositions, F);
  if (err) return err;
  const int bytes = (int)smem_bytes(F, CW, CWP);
  auto kernel = temporal_fwd_kernel<DP>;
  const void* fn = reinterpret_cast<const void*>(kernel);
  cudaError_t e = host_cache.reserve_smem(fn, bytes);
  if (e != cudaSuccess) return (int)e;
  int slots = 0;  // blocks the card holds at once: the persistent grid
  e = host_cache.get(fn, bytes, 0, &slots, [&](int* v) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t q = cudaGetDevice(&dev);
    if (q == cudaSuccess) q = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (q == cudaSuccess)
      q = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes);
    *v = sms * per_sm;
    return q;
  });
  if (e != cudaSuccess) return (int)e;
  if (slots < 1) return (int)cudaErrorInvalidConfiguration;
  const long long items = (long long)B * ((L + kPositions - 1) / kPositions) * (C / CW);
  const int grid = (int)(items < slots ? items : slots);
  kernel<<<grid, kThreads, bytes, stream>>>(maps[0], maps[1], maps[2], maps[3], B, F, L, C, d,
                                           CW, CWP, kLog2e / sqrtf((float)scale_d));
  return (int)cudaGetLastError();
}

// ---- heads wider than 160 columns: one head walked in column chunks --------
//
// An item is kWidePositions positions x all F frames x one head of d > 160
// columns, walked in `chunks` chunks of CW columns (the last d - (chunks -
// 1) * CW). A stage of the ring holds one chunk of the item in two slots of
// kWidePositions tiles [F][CWP] each, one tile a position and a consumer
// warp a position. The producer walks each item in 2 * chunks steps:
//   steps 0 .. chunks-1: Q and K of chunk c (slots 0 and 1); each warp adds
//     Q_c K_c^T to its position's S (f x f, in registers: the whole head's
//     logits accumulate over the chunks before the softmax);
//   then the softmax, once an item, to P in registers;
//   steps chunks .. 2*chunks-1: V of chunk c (slot 0); each warp writes
//     O_c = P V_c to slot 1, which the producer stores by one bulk copy per
//     (position, frame row) when the stage comes back, before reloading it.
// A chunk's box is CWP columns from the chunk's first: its columns past the
// chunk are the next chunk's, the next head's or zeros past C, removed from
// the last 16-deep step by a select as at d <= 160, so an Inf in another
// head reaches no output of this one. Positions past L are neither loaded
// nor stored. No atomics: the same inputs give the same bits.
constexpr int kWidePositions = kConsumers;  // positions of a wide item: one a consumer warp
constexpr int kWideStages = 2;
constexpr int kChunkColumns = 160;  // the widest chunk (the wrapper's CHUNK_COLUMNS)
constexpr int kPiece = 64;          // columns of one partial sum of S

// The stages' two slots of kWidePositions tiles, the room for the mma tiles'
// rows past F, the mbarriers.
__host__ __device__ inline size_t wide_smem_bytes(int F, int cwp) {
  return 128 +
         ((size_t)kWideStages * 2 * kWidePositions * tile_elems(F, cwp) +
          (size_t)(kMaxFrames - F) * cwp) * 2 +
         2 * kWideStages * 8;
}

__global__ void __launch_bounds__(kThreads)
temporal_fwd_wide_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ out,
                         int B, int F, int L, int C, int d, int CW, int CWP, int chunks,
                         float scale_log2) {
  constexpr int P = kWidePositions, S = kWideStages;
  extern __shared__ unsigned char smem_raw[];
  bf16* tiles = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~static_cast<uintptr_t>(127));
  const int TILE = tile_elems(F, CWP);
  const int SLOT = P * TILE, STAGE = 2 * SLOT;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(tiles + (size_t)S * STAGE + (size_t)(kMaxFrames - F) * CWP);
  uint64_t* empty = full + S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int heads = C / d;
  const int pblocks = (L + P - 1) / P;
  const int items = B * pblocks * heads;
  const int steps = 2 * chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers) {
    // producer (one thread)
    if (lane != 0) return;
    // the O of step m (a V step) leaves slot 1 of its stage, one bulk copy
    // per (position, frame row)
    auto store = [&](int m) {
      const int it = blockIdx.x + (m / steps) * gridDim.x, c = m % steps - chunks;
      const int h = it % heads, pos0 = ((it / heads) % pblocks) * P, b = it / (heads * pblocks);
      const bf16* o = tiles + (size_t)(m % S) * STAGE + SLOT;
      const int dc = min(CW, d - c * CW);
      for (int p = 0; p < P && pos0 + p < L; ++p)
        for (int r = 0; r < F; ++r)
          bulk_store(out + (((size_t)b * F + r) * L + pos0 + p) * C + (size_t)h * d + c * CW,
                     o + (size_t)p * TILE + (size_t)r * CWP, (uint32_t)dc * 2);
    };
    int n = 0;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int h = it % heads, pos0 = ((it / heads) % pblocks) * P, b = it / (heads * pblocks);
      const int valid = min(P, L - pos0);
      for (int j = 0; j < steps; ++j, ++n) {
        const int s = n % S;
        bf16* t = tiles + (size_t)s * STAGE;
        if (n >= S) {
          mbar_wait(&empty[s], ((n / S) - 1) & 1);
          if ((n - S) % steps >= chunks) {
            store(n - S);
            bulk_commit();
            bulk_wait<0, true>();  // slot 1 is read before it is loaded again
          }
        }
        const bool qk = j < chunks;
        const int col = h * d + (j % chunks) * CW;
        mbar_arrive_expect_tx(&full[s], (qk ? 2u : 1u) * valid * F * CWP * 2);
        for (int p = 0; p < valid; ++p) {
          if (qk) {
            tma_load_4d(t + (size_t)p * TILE, &q_map, &full[s], col, pos0 + p, 0, b);
            tma_load_4d(t + SLOT + (size_t)p * TILE, &k_map, &full[s], col, pos0 + p, 0, b);
          } else {
            tma_load_4d(t + (size_t)p * TILE, &v_map, &full[s], col, pos0 + p, 0, b);
          }
        }
      }
    }
    for (int m = n > S ? n - S : 0; m < n; ++m) {
      mbar_wait(&empty[m % S], (m / S) & 1);
      if (m % steps >= chunks) {
        store(m);
        bulk_commit();
      }
    }
    bulk_wait<0, false>();
    return;
  }

  // consumers: warp p takes position p of every item (past L: stale tiles,
  // never stored), and frees every stage
  int n = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    float sacc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sacc[mt][j][0] = sacc[mt][j][1] = sacc[mt][j][2] = sacc[mt][j][3] = 0.f;
    for (int c = 0; c < chunks; ++c, ++n) {
      const int s = n % S;
      mbar_wait(&full[s], (n / S) & 1);
      const bf16* t = tiles + (size_t)s * STAGE + (size_t)warp * TILE;
      // the sums over each kPiece columns start from zero and are added in
      // fp32 after: the tensor cores' accumulation, not rounded to nearest,
      // then spans at most 4 16-deep steps (at d = 1280 one accumulator over
      // the head read 2x the d <= 160 kernel's error against the plain
      // version)
      const int dc = min(CW, d - c * CW);
      for (int off = 0; off < dc; off += kPiece) {
        float sc[2][4][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[mt][j][0] = sc[mt][j][1] = sc[mt][j][2] = sc[mt][j][3] = 0.f;
        qk_accumulate<kPiece>(sc, t + off, t + SLOT + off, CWP, min(kPiece, dc - off), lane);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sacc[mt][j][e] += sc[mt][j][e];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    uint32_t pa[2][2][4];
    softmax_p(sacc, pa, F, scale_log2, lane);
    for (int c = 0; c < chunks; ++c, ++n) {
      const int s = n % S;
      mbar_wait(&full[s], (n / S) & 1);
      bf16* t = tiles + (size_t)s * STAGE + (size_t)warp * TILE;
      pv_store<kChunkColumns>(pa, t, t + SLOT, CWP, CWP, F, min(CW, d - c * CW), lane);
      fence_proxy_async();  // O's writes before the bulk copies read them
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }
}

int launch_wide(const void* q, const void* k, const void* v, void* out, int B, int F, int L,
                int heads, int d, int CW, int CWP, int chunks, int scale_d,
                cudaStream_t stream) {
  const int C = heads * d;
  CUtensorMap maps[3];
  int err = make_map_4d(&maps[0], q, C, L, F, B, CWP, 1, F);
  if (!err) err = make_map_4d(&maps[1], k, C, L, F, B, CWP, 1, F);
  if (!err) err = make_map_4d(&maps[2], v, C, L, F, B, CWP, 1, F);
  if (err) return err;
  const int bytes = (int)wide_smem_bytes(F, CWP);
  const void* fn = reinterpret_cast<const void*>(temporal_fwd_wide_kernel);
  cudaError_t e = host_cache.reserve_smem(fn, bytes);
  if (e != cudaSuccess) return (int)e;
  int slots = 0;  // blocks the card holds at once: the persistent grid
  e = host_cache.get(fn, bytes, 0, &slots, [&](int* value) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t r = cudaGetDevice(&dev);
    if (r == cudaSuccess) r = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (r == cudaSuccess)
      r = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, temporal_fwd_wide_kernel,
                                                        kThreads, bytes);
    *value = sms * per_sm;
    return r;
  });
  if (e != cudaSuccess) return (int)e;
  if (slots < 1) return (int)cudaErrorInvalidConfiguration;
  const long long items = (long long)B * ((L + kWidePositions - 1) / kWidePositions) * heads;
  const int grid = (int)(items < slots ? items : slots);
  temporal_fwd_wide_kernel<<<grid, kThreads, bytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(out), B, F, L, C, d, CW, CWP, chunks,
      kLog2e / sqrtf((float)scale_d));
  return (int)cudaGetLastError();
}

// ---- more than 32 frames: the long kernel -----------------------------------
//
// Past 32 frames a whole item (all f frames of a position) no longer fits
// the two 16-row mma tiles, and its Q, K and V grow with f (at f = 96 and
// 160 columns, 3 x 31 KB a stage). So the long kernel takes f in tiles: a
// warp's work item is (sample, position, head, query tile of 16 frames,
// output slab of kPiece columns), and it walks the key frames in tiles of
// 16 twice:
//   pass 1: S = Q K^T over the head's depth in kPiece-column pieces (each
//     piece of Q and K copied to the warp's tiles by cp.async, zeros past f
//     and past the piece), scaled in the log2 domain, keys >= f at -inf;
//     the running row max and the row sum rescaled to it;
//   pass 2: the same S again, P = exp2(S - max) / sum, normalized before
//     its bf16 rounding as the plain version rounds it, and O += P V over
//     the slab's columns of V.
// Shared memory is per warp (3 tiles of 16 x kLd), so warps never wait for
// one another; the warps of a block take neighbouring items (the query
// tiles and slabs of one head), which read the same K and V from L1.
// No atomics: the same inputs give the same bits. What bounds it is still
// the bytes (at f = 48 a call at level 0 is 4 x 189 MB against 1.8e10
// operations), but this design reads Q and K once per query tile, slab and
// pass (from L1 and L2) and overlaps little: simple and right first.
constexpr int kLongWarps = 4;

__global__ void __launch_bounds__(32 * kLongWarps)
temporal_fwd_long_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ out, int B, int F, int L,
                         int heads, int d, float scale_log2) {
  __shared__ __align__(128) bf16 smem[kLongWarps][3][16 * tiles::kLd];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int QT = (F + 15) / 16, slabs = (d + tiles::kPiece - 1) / tiles::kPiece;
  const long long item = (long long)blockIdx.x * kLongWarps + warp;
  if (item >= (long long)B * L * heads * slabs * QT) return;
  const int qt = (int)(item % QT);
  long long rest = item / QT;
  const int slab = (int)(rest % slabs);
  rest /= slabs;
  const int h = (int)(rest % heads);
  rest /= heads;
  const int l = (int)(rest % L), b = (int)(rest / L);
  const int C = heads * d;
  const size_t fs = (size_t)L * C;                                  // elements between frames
  const size_t base = ((size_t)b * F * L + l) * C + (size_t)h * d;  // (b, frame 0, l, head h)
  bf16* sq = smem[warp][0];
  bf16* sk = smem[warp][1];
  bf16* sv = smem[warp][2];

  // S of key tile kt, scaled to the log2 domain, keys >= F at -inf
  auto logits = [&](float (&s)[2][4], int kt) {
    tiles::frames_product(s, q + base, qt, k + base, kt, fs, F, d, sq, sk, lane);
    tiles::scale_mask_keys(s, kt, F, scale_log2, lane);
  };

  // pass 1: row max and sum
  float m[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f};
  for (int kt = 0; kt < QT; ++kt) {
    float s[2][4];
    logits(s, kt);
    tiles::row_stats(s, m, lsum);
  }
  const float inv[2] = {1.f / tiles::quad_sum(lsum[0]), 1.f / tiles::quad_sum(lsum[1])};

  // pass 2: O over the slab's columns
  const int c0 = slab * tiles::kPiece, w = min(tiles::kPiece, d - c0);
  float o[tiles::kPiece / 8][4];
  tiles::zero(o);
  for (int kt = 0; kt < QT; ++kt) {
    // V's tile lands under the logits' loads (their wait covers it)
    tiles::load_rows_async<16>(sv, tiles::kLd, v + base + c0, fs, kt * 16, F, w, lane, 32);
    float s[2][4];
    logits(s, kt);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = exp2f(s[j][e] - m[e >> 1]) * inv[e >> 1];
    uint32_t a[4];
    tiles::pack_a(a, s[0], s[1]);
    tiles::mma_av<tiles::kPiece / 8>(o, a, sv, tiles::kLd, tiles::round16(w) / 16, lane);
    __syncwarp();
  }
  const float one[2] = {1.f, 1.f};
  tiles::store_acc<tiles::kPiece / 8>(out + base + c0, fs, o, qt * 16, F, w, one, lane);
}

int launch_long(const void* q, const void* k, const void* v, void* out, int B, int F, int L,
                int heads, int d, int scale_d, cudaStream_t stream) {
  const int QT = (F + 15) / 16, slabs = (d + tiles::kPiece - 1) / tiles::kPiece;
  const long long items = (long long)B * L * heads * slabs * QT;
  const long long blocks = (items + kLongWarps - 1) / kLongWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  temporal_fwd_long_kernel<<<(unsigned)blocks, 32 * kLongWarps, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), B, F, L, heads, d, kLog2e / sqrtf((float)scale_d));
  return (int)cudaGetLastError();
}

}  // namespace

// Head widths the kernel takes: d a multiple of 8, d <= 160 (the motion
// modules' d = 40/80/160, QK^T's depth padded to 48 / 80 / 160), as items of
// `heads_per_item` whole heads (CW = heads_per_item * d columns, chunks =
// 1); and 160 < d <= 1280, one head an item walked in `chunks` chunks of CW
// = ceil(d / chunks) rounded up to 8 columns (heads_per_item = 1). Either is
// loaded `cwp` columns wide (the wrapper's `temporal_plan`). The logits are
// scaled by scale_d^-1/2, 1 <= scale_d <= d (the true width of a head the
// wrapper zero-pads, else d). Past kMaxFrames frames (any f), every d a
// multiple of 8 up to 1280 runs in the long kernel: the wrapper's plan is
// then one head an item (heads_per_item = 1) in pieces of tiles::kPiece
// columns (chunks = ceil(d / kPiece)), tiles tiles::kLd wide (cwp).
extern "C" int hv_temporal_fwd(const void* q, const void* k, const void* v, void* out, int B,
                               int F, int L, int heads, int d, int heads_per_item, int cwp,
                               int chunks, int scale_d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F > kMaxFrames) {
    if (B < 1 || L < 1 || d <= 0 || d % 8 != 0 || d > 8 * kChunkColumns || heads < 1 ||
        heads_per_item != 1 || cwp != tiles::kLd ||
        chunks != (d + tiles::kPiece - 1) / tiles::kPiece || scale_d < 1 || scale_d > d ||
        (long long)B * heads * d * F * L >= (1LL << 40))
      return (int)cudaErrorInvalidValue;
    return launch_long(q, k, v, out, B, F, L, heads, d, scale_d, s);
  }
  if (chunks < 1 || (chunks > 1 && heads_per_item != 1)) return (int)cudaErrorInvalidValue;
  const int CW = chunks == 1 ? heads_per_item * d : ((d + chunks - 1) / chunks + 7) / 8 * 8;
  if (B < 1 || L < 1 || F < 1 || d <= 0 || d % 8 != 0 || heads < 1 ||
      heads_per_item < 1 || heads % heads_per_item != 0 || cwp > 256 || cwp % 8 != 0 ||
      cwp < CW + 8 || (cwp / 8) % 2 != 1 || scale_d < 1 || scale_d > d ||
      (long long)B * heads * d * F * L >= (1LL << 40))
    return (int)cudaErrorInvalidValue;
  if (chunks > 1) {
    if (d <= kChunkColumns || d > 8 * kChunkColumns || CW > kChunkColumns ||
        (chunks - 1) * CW >= d)
      return (int)cudaErrorInvalidValue;
    return launch_wide(q, k, v, out, B, F, L, heads, d, CW, cwp, chunks, scale_d, s);
  }
  if (d <= 48) return launch<48>(q, k, v, out, B, F, L, heads, d, CW, cwp, scale_d, s);
  if (d <= 80) return launch<80>(q, k, v, out, B, F, L, heads, d, CW, cwp, scale_d, s);
  if (d <= 160) return launch<160>(q, k, v, out, B, F, L, heads, d, CW, cwp, scale_d, s);
  return (int)cudaErrorInvalidValue;
}

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
#include "temporal_split.cuh"
#include "warp_mma.cuh"

namespace {

using namespace hopper;

constexpr int kMaxFrames = 32;  // frames the two 16-row mma tiles cover
constexpr int kConsumers = 4;   // consumer warps
constexpr int kStages = 3;      // items in flight
constexpr int kPositions = 1;   // positions per item
constexpr int kOTiles = kStages + 1;  // O tiles: one item's store drains under the next
constexpr int kChunkColumns = 160;  // the widest item (the wrapper's CHUNK_COLUMNS)
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

// ---- heads wider than 160 columns: one head split in column slices ---------
//
// Replaces, for 160 < d <= 1280 at f <= 32: the same Pallas kernel
// `_fwd_kernel` (humanvid_tpu/ops/temporal_attention.py:81), whose block
// holds a head of any width.
//
// What bounds it on the H100: device-memory bytes, as at d <= 160. At the
// heads64 motion modules' level 2 (1,24,384,1280), d = 256, a call reads q,
// k and v and writes out, 94 MB (28 us at 3.35 TB/s), against 0.6 GFLOP.
// The first design of these heads (column chunks: 4 consumer warps a position
// each, one warp walking all of a head's chunks in sequence, O stored by a
// bulk copy a frame row from one producer thread that waited for its own
// stores before every reload) reached 47-64% of that bound.
//
// What this design does about it (csrc/temporal_split.cuh):
// - The head's columns are spread over split::kWarps consumer warps: an
//   item is `positions` positions x one head in `slices` slices of at most
//   160 columns, a warp a (position, slice), so at d = 1280 the chain of
//   one head's 8 slices runs in 8 warps at once and the grid has a
//   position a head as items (384 at level 2).
// - Each warp's S part is summed through shared memory in slice order
//   (split::exchange); each warp then takes the softmax and O = P V of its
//   slice.
// - The ring's unit is one tensor of an item: Q's and K's slots go back as
//   soon as S's parts are taken, so the next item's Q and K load under this
//   item's exchange, softmax and P V; V's slot goes back once O, written
//   over V, has been read by its TMA stores.
// - O leaves by one 5-D TMA store a warp (split::make_store_maps), issued by
//   a store warp once every consumer has written its tile, so that no
//   consumer waits for a store: nothing past the slice, the head or frame
//   F is written.
// - Loads come from maps whose columns past the head read zeros, and the
//   columns past a slice (the next slice's) are removed from S by a select,
//   so an Inf in another head or position reaches no output of this one.
// No atomics: the same inputs give the same bits. At one frame P = 1
// exactly, so the output is V.

// The softmax over key frames of S (scaled here, keys >= F masked), P
// normalized and packed as the A fragments of O = P V: pa[row tile][16-key
// step]. Element e of tile (mt, j) is key frame 8j + 2*(lane%4) + (e&1) of
// query frame 16mt + lane/4 + 8*(e>>1).
template <int MT>
__device__ __forceinline__ void softmax_rows(float (&s)[MT][2 * MT][4],
                                             uint32_t (&pa)[MT][MT][4], int F, float scale_log2,
                                             int lane) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2 * MT; ++j)
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
    for (int j = 0; j < 2 * MT; ++j)
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
    for (int t = 0; t < MT; ++t) {
      pa[mt][t][0] = pack_bf16(s[mt][2 * t][0] * sum[0], s[mt][2 * t][1] * sum[0]);
      pa[mt][t][1] = pack_bf16(s[mt][2 * t][2] * sum[1], s[mt][2 * t][3] * sum[1]);
      pa[mt][t][2] = pack_bf16(s[mt][2 * t + 1][0] * sum[0], s[mt][2 * t + 1][1] * sum[0]);
      pa[mt][t][3] = pack_bf16(s[mt][2 * t + 1][2] * sum[1], s[mt][2 * t + 1][3] * sum[1]);
    }
  }
}

// Threads of a block: the consumers, the producer and the store warp (a
// store warp, not each consumer, stores O: on the H100 1-4% faster in
// turns at four of the five wide shapes: PERF.md section 6, the split
// kernels' finding).
constexpr int kSplitThreads = 32 * (split::kWarps + 2);

// grid: persistent, at most one block per item; block kSplitThreads.
// Items are (sample, block of `positions` positions, head), tiles 16 MT
// frames tall in the mma (MT = 1 at f <= 16).
template <int MT>
__global__ void __launch_bounds__(kSplitThreads, 1)
temporal_fwd_split_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap o_map,
                          const __grid_constant__ CUtensorMap o_last_map, int B, int F, int L,
                          int heads, int d, int CW, int CWP, int slices, int positions,
                          int stages, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const int warps = slices * positions;  // the working consumer warps
  const split::Layout m = split::layout<MT>(smem_raw, F, CWP, stages, warps);
  const int TILE = split::tile_elems(F, CWP);
  const size_t SLOT = (size_t)warps * TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pblocks = (L + positions - 1) / positions;
  const long long items = (long long)B * pblocks * heads;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&m.full[s], 1);
      mbar_init(&m.empty[s], warps);
    }
    for (int k = 0; k < split::kReady; ++k) mbar_init(&m.ready[k], warps);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == split::kWarps) {
    // producer (one thread): Q, K and V of each item, a slot each; a slot
    // is loaded once every warp has freed its previous tensor
    if (lane != 0) return;
    const CUtensorMap* maps[3] = {&q_map, &k_map, &v_map};
    const uint32_t slot_bytes = (uint32_t)warps * F * CWP * 2;
    int n = 0;
    for (long long it = blockIdx.x; it < items; it += gridDim.x) {
      const int h = (int)(it % heads), l0 = (int)((it / heads) % pblocks) * positions;
      const int b = (int)(it / heads / pblocks);
      for (int t = 0; t < 3; ++t, ++n) {
        const int s = n % stages;
        if (n >= stages) mbar_wait(&m.empty[s], ((n / stages) - 1) & 1);
        bf16* slot = m.tiles + (size_t)s * SLOT;
        mbar_arrive_expect_tx(&m.full[s], slot_bytes);
        for (int w = 0; w < warps; ++w) {
          // a position past L loads the last one (computed, never stored)
          const int l = min(l0 + w / slices, L - 1);
          tma_load_4d(slot + (size_t)w * TILE, maps[t], &m.full[s], (w % slices) * CW,
                      l * heads + h, 0, b);
        }
      }
    }
    return;
  }
  if (warp == split::kWarps + 1) {
    // store warp (one thread): each item's O, written over V's slot
    if (lane != 0) return;
    int k = 0;
    for (long long it = blockIdx.x; it < items; it += gridDim.x, ++k) {
      const int h = (int)(it % heads), l0 = (int)((it / heads) % pblocks) * positions;
      const int b = (int)(it / heads / pblocks);
      split::store_output(m, k, (3 * k + 2) % stages, TILE, warps, slices, &o_map, &o_last_map,
                          l0, L, heads, h, b);
    }
    bulk_wait<0, false>();
    return;
  }
  if (warp >= warps) return;

  // consumers: warp (p, sl) takes slice sl of position p of every item
  const int p = warp / slices, sl = warp % slices;
  const int dc = min(CW, d - sl * CW);  // the slice's columns
  int n = 0, k = 0;                     // the item's first tensor, its output
  for (long long it = blockIdx.x; it < items; it += gridDim.x, n += 3, ++k) {
    const int sq = n % stages, sk = (n + 1) % stages, sv = (n + 2) % stages;
    mbar_wait(&m.full[sq], (n / stages) & 1);
    mbar_wait(&m.full[sk], ((n + 1) / stages) & 1);
    __syncwarp();
    float s[MT][2 * MT][4];
    split::partial_abt<MT>(s, m.tiles + sq * SLOT + (size_t)warp * TILE,
                           m.tiles + sk * SLOT + (size_t)warp * TILE, CWP, dc, lane);
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(&m.empty[sq]);
      mbar_arrive(&m.empty[sk]);
    }
    split::exchange<MT>(s, m.xbuf, warp, p * slices, slices, 1 + p, lane);
    uint32_t pa[MT][MT][4];
    softmax_rows<MT>(s, pa, F, scale_log2, lane);
    mbar_wait(&m.full[sv], ((n + 2) / stages) & 1);
    __syncwarp();
    bf16* tv = m.tiles + sv * SLOT + (size_t)warp * TILE;
    split::product_stage<MT>(pa, tv, CWP, tv, CWP, F, dc, 1.f, lane);  // O = P V, over V
    fence_proxy_async();  // O's writes before the TMA store reads them
    __syncwarp();
    if (lane == 0) mbar_arrive(&m.ready[k % split::kReady]);  // the store warp takes O
  }
}

template <int MT>
int launch_split(const void* q, const void* k, const void* v, void* out, int B, int F, int L,
                 int heads, int d, int CW, int CWP, int slices, int positions, int stages,
                 int smem, int scale_d, cudaStream_t stream) {
  CUtensorMap maps[3], omaps[2];
  int err = split::make_load_map(&maps[0], q, d, heads, L, F, B, CWP);
  if (!err) err = split::make_load_map(&maps[1], k, d, heads, L, F, B, CWP);
  if (!err) err = split::make_load_map(&maps[2], v, d, heads, L, F, B, CWP);
  if (!err) err = split::make_store_maps(omaps, out, d, heads, L, F, B, slices, CW, CWP);
  if (err) return err;
  auto kernel = temporal_fwd_split_kernel<MT>;
  const void* fn = reinterpret_cast<const void*>(kernel);
  cudaError_t e = host_cache.reserve_smem(fn, smem);
  if (e != cudaSuccess) return (int)e;
  int slots = 0;  // blocks the card holds at once: the persistent grid
  e = host_cache.get(fn, smem, 0, &slots, [&](int* value) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t r = cudaGetDevice(&dev);
    if (r == cudaSuccess) r = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (r == cudaSuccess)
      r = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kSplitThreads, smem);
    *value = sms * per_sm;
    return r;
  });
  if (e != cudaSuccess) return (int)e;
  if (slots < 1) return (int)cudaErrorInvalidConfiguration;
  const long long items = (long long)B * ((L + positions - 1) / positions) * heads;
  const int grid = (int)(items < slots ? items : slots);
  kernel<<<grid, kSplitThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], omaps[0], omaps[1], B, F, L, heads, d, CW, CWP, slices,
      positions, stages, kLog2e / sqrtf((float)scale_d));
  return (int)cudaGetLastError();
}

// ---- more than 32 frames: the long kernel -----------------------------------
//
// Replaces, past 32 frames: humanvid_tpu/ops/temporal_attention.py, the
// Pallas kernel `_fwd_kernel` (:81), which takes any frame count.
//
// What bounds it on the H100: device-memory bytes. At f = 48 the long_wide
// path's level 0 (1,48,6144,320) reads q, k and v and writes out, 755 MB
// (225 us at 3.35 TB/s), against 1.8e10 operations (18 us at the bf16
// peak). The earlier long kernel (a warp a 16-frame query tile and a 64-column
// slab, its operands copied by cp.async into the warp's own tiles for
// every product) read Q and K again for every slab and sweep and reached
// 5-23% of that bound.
//
// What this design does about it:
// - A work item is one whole position, as in the frames kernel: all f
//   frames of `per` whole heads (a chunk of at most 160 columns), Q, K and V each read by
//   one 4-D TMA box from the (c, l, f, b) maps, FP = f rounded up to 16
//   frames tall (the box's frames past f read zeros). A producer warp keeps
//   `stages` such items in flight in a ring (mbarriers with transaction
//   counts) over a persistent grid of as many blocks as the card holds at
//   once. Each tensor leaves device memory once.
// - kLongConsumers consumer warps, however many frames: a task is one
//   16-frame query tile of one head, and a warp takes the block's tasks in
//   turn (across items, so that none idles at an item's end). It computes
//   S against the 16-frame key tiles from shared memory with
//   `mma.sync.m16n8k16` (bf16 in, fp32 accumulate; `wgmma`'s 64-row tiles
//   would pad a head's 48 frames to 64 and its products are not what
//   bounds the kernel), keys >= f at -inf; a first sweep keeps the running
//   row max and sum, a second forms P = exp2(S - max) / sum, normalized
//   before its bf16 rounding as `temporal_attention_plain` rounds it, and
//   O += P V. Both sweeps read shared memory only, and a thread holds one
//   16 x 16 tile of S, the row words and O (16 x d). The products are
//   straight-line code over the head's 16-deep steps (a template constant)
//   and kLongUnroll key tiles are unrolled together, so that neighbouring
//   tiles' products overlap (runtime loops there cost 1.6x at f = 200).
// - O is staged in the warp's own tile [16][d] and written by one 5-D TMA
//   store (d, heads, l, f, b), which writes nothing past frame f; a warp
//   waits for its last store's read only when it stages the next one.
// - Large items (the plan's streamed mode, where Q, K and V of one head do
//   not fit one stage with the staging tiles, as at f = 256 and d = 160,
//   or for heads wider than 160 columns): one head an item, its frames in panels of kPanel frames
//   and its columns in chunks of at most kLongChunk, Q and K of one (query
//   panel, key panel, chunk) a stage and, in the second sweep, V of the
//   output chunk with the last one. Warp w < kPanel / 16 owns query tile w
//   of the panel and sums S of its 64 keys over the chunks in registers;
//   the other warps leave. Shared memory and registers do not grow with f
//   or d; Q and K are read again (from L2) for every key panel and chunk.
// No atomics: the same inputs give the same bits.
constexpr int kLongConsumers = 8;  // consumer warps
constexpr int kLongThreads = 32 * (kLongConsumers + 1);
constexpr int kPanel = 64;         // frames of a streamed panel
constexpr int kStreamWarps = kPanel / 16;  // consumer warps of a streamed item
constexpr int kLongMaxStages = 4;
// Key tiles of a resident task's sweep unrolled together.
constexpr int kLongUnroll = 2;
constexpr int kLongChunk = 160;    // the widest column chunk of a streamed item
// The plan's modes (`mode` of the entry point): the item kernels, the long
// kernel with whole items, with streamed panels.
constexpr int kModeItems = 0, kModeResident = 2, kModeStreamed = 3;

// Bytes of shared memory the long forward lays out: `stages` x the Q, K
// and V tiles ([rows][cwp] bf16: FP rows, or kPanel streamed), the
// consumer warps' staging tiles ([16][ow]), the barriers and 128 bytes of
// alignment. `long_fwd_smem` in ops/temporal_attention.py reckons the same.
__host__ __device__ inline size_t long_fwd_smem(int rows, int cwp, int ow, int stages) {
  return 128 + (size_t)stages * 3 * rows * cwp * 2 + (size_t)kLongConsumers * 16 * ow * 2 +
         (size_t)stages * 16;
}

// o (16 rows x w columns) times mul to the warp's staging tile buf
// ([16][w]), then one TMA store of it to the box at (c0, head, l, f0, b);
// the tile is written again only after its last store has read it.
template <int NT>
__device__ __forceinline__ void store_tile(bf16* buf, const CUtensorMap* map,
                                           const float (&o)[NT][4], int w, float mul, int c0,
                                           int head, int l, int f0, int b, int lane) {
  if (lane == 0) bulk_wait<0, true>();
  __syncwarp();
  tiles::stage_rows<NT>(buf, o, w, mul, lane);
  fence_proxy_async();  // the staging writes before the TMA store reads them
  __syncwarp();
  if (lane == 0) {
    tma_store_5d(map, buf, c0, head, l, f0, b);
    bulk_commit();
  }
}

// P = exp2(s - m) / sum (the inverse sum `inv`) as the A fragment a.
__device__ __forceinline__ void probs(uint32_t (&a)[4], float (&s)[2][4], const float (&m)[2],
                                      const float (&inv)[2]) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = exp2f(s[j][e] - m[e >> 1]) * inv[e >> 1];
  tiles::pack_a(a, s[0], s[1]);
}

// A resident item's task: O (16 x d, d <= 16 KS) of the query tile at q
// against KT 16-frame key tiles from k and v (each at the head's first
// column of frame 0, rows ld apart), in two sweeps.
template <int KS>
__device__ __forceinline__ void fwd_resident_task(float (&o)[2 * KS][4], const bf16* q,
                                                  const bf16* k, const bf16* v, int ld, int KT,
                                                  int F, int d, float scale_log2, int lane) {
  float m[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f};
#pragma unroll kLongUnroll
  for (int kt = 0; kt < KT; ++kt) {
    float s[2][4];
    tiles::tile_abt_k<KS>(s, q, ld, k + (size_t)kt * 16 * ld, ld, d, lane);
    tiles::scale_mask_keys(s, 16 * kt, F, scale_log2, lane);
    tiles::row_stats(s, m, lsum);
  }
  const float inv[2] = {1.f / tiles::quad_sum(lsum[0]), 1.f / tiles::quad_sum(lsum[1])};
  tiles::zero(o);
#pragma unroll kLongUnroll
  for (int kt = 0; kt < KT; ++kt) {
    float s[2][4];
    tiles::tile_abt_k<KS>(s, q, ld, k + (size_t)kt * 16 * ld, ld, d, lane);
    tiles::scale_mask_keys(s, 16 * kt, F, scale_log2, lane);
    uint32_t a[4];
    probs(a, s, m, inv);
    tiles::tile_av_k<KS>(o, a, v + (size_t)kt * 16 * ld, ld, lane);
  }
}

// grid: persistent, at most one block per item; block kLongThreads. Items
// are (sample, position, group of `per` heads), resident (K: the 16-deep
// steps of a head, ceil(d / 16) or one more) or streamed (per = 1, chunks
// of CW columns; K: O's 8-column tiles a chunk); every tile is `rows` x
// CWP.
template <bool STREAMED, int K>
__global__ void __launch_bounds__(kLongThreads)
temporal_fwd_long_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap o_map, int B, int F, int L,
                         int heads, int d, int per, int CW, int CWP, int chunks, int stages,
                         float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  bf16* tiles_ = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~static_cast<uintptr_t>(127));
  const int FP = (F + 15) / 16 * 16;
  const int ROWS = STREAMED ? kPanel : FP;
  const int TILE = ROWS * CWP, STAGE = 3 * TILE;
  const int OW = STREAMED ? CW : d;  // columns a warp's output tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* staging = tiles_ + (size_t)stages * STAGE + (size_t)warp * 16 * OW;
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles_ + (size_t)stages * STAGE +
                                               (size_t)kLongConsumers * 16 * OW);
  uint64_t* empty = full + stages;
  const int groups = heads / per;  // items of a position
  const long long items = (long long)B * L * groups;
  const int NP = (F + kPanel - 1) / kPanel;  // panels of a streamed item

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], STREAMED ? kStreamWarps : kLongConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kLongConsumers) {
    // producer (one thread): each step waits for its stage to be freed,
    // then loads it
    if (lane != 0) return;
    int n = 0;
    for (long long it = blockIdx.x; it < items; it += gridDim.x) {
      const int g = (int)(it % groups), l = (int)((it / groups) % L), b = (int)(it / groups / L);
      auto step = [&](int qf, int kf, int col, int vcol) {
        const int s = n % stages;
        if (n >= stages) mbar_wait(&empty[s], ((n / stages) - 1) & 1);
        bf16* t = tiles_ + (size_t)s * STAGE;
        mbar_arrive_expect_tx(&full[s], (vcol >= 0 ? 3u : 2u) * TILE * 2);
        tma_load_4d(t, &q_map, &full[s], col, l, qf, b);
        tma_load_4d(t + TILE, &k_map, &full[s], col, l, kf, b);
        if (vcol >= 0) tma_load_4d(t + 2 * TILE, &v_map, &full[s], vcol, l, kf, b);
        ++n;
      };
      if constexpr (!STREAMED) {
        step(0, 0, g * CW, g * CW);
      } else {
        const int col0 = g * d;
        for (int qp = 0; qp < NP; ++qp) {
          for (int kp = 0; kp < NP; ++kp)
            for (int c = 0; c < chunks; ++c) step(qp * kPanel, kp * kPanel, col0 + c * CW, -1);
          for (int oc = 0; oc < chunks; ++oc)
            for (int kp = 0; kp < NP; ++kp)
              for (int c = 0; c < chunks; ++c)
                step(qp * kPanel, kp * kPanel, col0 + c * CW,
                     c == chunks - 1 ? col0 + oc * CW : -1);
        }
      }
    }
    return;
  }

  int n = 0;
  auto wait_step = [&]() -> const bf16* {
    const int s = n % stages;
    mbar_wait(&full[s], (n / stages) & 1);
    return tiles_ + (size_t)s * STAGE;
  };
  auto free_step = [&]() {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[n % stages]);
    ++n;
  };

  if constexpr (!STREAMED) {
    // task g = base + t of an item goes to warp g % kLongConsumers
    const int QT = FP / 16, tasks = QT * per;
    int base = 0;
    for (long long it = blockIdx.x; it < items; it += gridDim.x) {
      const int g = (int)(it % groups), l = (int)((it / groups) % L), b = (int)(it / groups / L);
      const bf16* tq = wait_step();
      for (int t = (warp - base + kLongConsumers) % kLongConsumers; t < tasks;
           t += kLongConsumers) {
        const int qt = t / per, h = t % per;
        float o[2 * K][4];
        fwd_resident_task<K>(o, tq + (size_t)qt * 16 * CWP + h * d, tq + TILE + h * d,
                             tq + 2 * TILE + h * d, CWP, QT, F, d, scale_log2, lane);
        store_tile<2 * K>(staging, &o_map, o, d, 1.f, 0, g * per + h, l, 16 * qt, b, lane);
      }
      base = (base + tasks) % kLongConsumers;
      free_step();
    }
  } else {
    // warp w owns query tile w of each query panel
    if (warp >= kStreamWarps) return;
    for (long long it = blockIdx.x; it < items; it += gridDim.x) {
      const int h = (int)(it % heads), l = (int)((it / heads) % L), b = (int)(it / heads / L);
      for (int qp = 0; qp < NP; ++qp) {
        const int q0 = qp * kPanel + 16 * warp;  // the tile's first frame
        float m[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f};
        float sacc[kStreamWarps][2][4];
        // one key panel's S, summed over the chunks; `last` gets each key
        // tile once it is whole, while the last chunk's stage is held
        auto panel = [&](int kp, auto&& last) {
          for (int c = 0; c < chunks; ++c) {
            const bf16* t = wait_step();
            const int wc = min(CW, d - c * CW);
#pragma unroll
            for (int j = 0; j < kStreamWarps; ++j) {
              float part[2][4];
              tiles::tile_abt(part, t + (size_t)warp * 16 * CWP, CWP, t + TILE + (size_t)j * 16 * CWP,
                              CWP, wc, lane);
#pragma unroll
              for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int e = 0; e < 4; ++e) sacc[j][i][e] = (c ? sacc[j][i][e] : 0.f) + part[i][e];
            }
            if (c == chunks - 1) {
#pragma unroll
              for (int j = 0; j < kStreamWarps; ++j) {
                tiles::scale_mask_keys(sacc[j], kp * kPanel + 16 * j, F, scale_log2, lane);
                last(j, t);
              }
            }
            free_step();
          }
        };
        for (int kp = 0; kp < NP; ++kp)
          panel(kp, [&](int j, const bf16*) { tiles::row_stats(sacc[j], m, lsum); });
        const float inv[2] = {1.f / tiles::quad_sum(lsum[0]), 1.f / tiles::quad_sum(lsum[1])};
        for (int oc = 0; oc < chunks; ++oc) {
          const int wo = min(CW, d - oc * CW);
          float o[K][4];
          tiles::zero(o);
          for (int kp = 0; kp < NP; ++kp)
            panel(kp, [&](int j, const bf16* t) {
              uint32_t a[4];
              probs(a, sacc[j], m, inv);
              tiles::tile_av<K>(o, a, t + 2 * TILE + (size_t)j * 16 * CWP, CWP, wo, lane);
            });
          if (q0 < F) store_tile<K>(staging, &o_map, o, CW, 1.f, oc * CW, h, l, q0, b, lane);
        }
      }
    }
  }
  if (lane == 0) bulk_wait<0, false>();
}

template <bool STREAMED, int K>
int launch_long(const void* q, const void* k, const void* v, void* out, int B, int F, int L,
                int heads, int d, int per, int CW, int CWP, int chunks, int stages, int smem,
                int scale_d, cudaStream_t stream) {
  const int C = heads * d;
  const int rows = STREAMED ? kPanel : (F + 15) / 16 * 16;
  const int ow = STREAMED ? CW : d;
  CUtensorMap maps[4];
  int err = make_map_4d(&maps[0], q, C, L, F, B, CWP, 1, rows);
  if (!err) err = make_map_4d(&maps[1], k, C, L, F, B, CWP, 1, rows);
  if (!err) err = make_map_4d(&maps[2], v, C, L, F, B, CWP, 1, rows);
  if (!err) err = make_frames_head_map(&maps[3], out, d, heads, L, F, B, ow, 16);
  if (err) return err;
  const int bytes = (int)long_fwd_smem(rows, CWP, ow, stages);
  if (bytes != smem || bytes > 232448) return (int)cudaErrorInvalidValue;
  auto kernel = temporal_fwd_long_kernel<STREAMED, K>;
  const void* fn = reinterpret_cast<const void*>(kernel);
  cudaError_t e = host_cache.reserve_smem(fn, bytes);
  if (e != cudaSuccess) return (int)e;
  int slots = 0;  // blocks the card holds at once: the persistent grid
  e = host_cache.get(fn, bytes, 0, &slots, [&](int* value) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t r = cudaGetDevice(&dev);
    if (r == cudaSuccess) r = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (r == cudaSuccess)
      r = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kLongThreads, bytes);
    *value = sms * per_sm;
    return r;
  });
  if (e != cudaSuccess) return (int)e;
  if (slots < 1) return (int)cudaErrorInvalidConfiguration;
  const long long items = (long long)B * L * (heads / per);
  const int grid = (int)(items < slots ? items : slots);
  kernel<<<grid, kLongThreads, bytes, stream>>>(maps[0], maps[1], maps[2], maps[3], B, F, L,
                                                heads, d, per, CW, CWP, chunks, stages,
                                                kLog2e / sqrtf((float)scale_d));
  return (int)cudaGetLastError();
}

}  // namespace

// Head widths the kernel takes: d a multiple of 8, d <= 160 (the motion
// modules' d = 40/80/160, QK^T's depth padded to 48 / 80 / 160), as items of
// `heads_per_item` whole heads (CW = heads_per_item * d columns, chunks =
// 1); and 160 < d <= 1280, one head in `chunks` column slices of CW =
// ceil(d / chunks) rounded up to 8 columns. Either is loaded `cwp` columns
// wide (the wrapper's `temporal_plan`). The logits are scaled by
// scale_d^-1/2, 1 <= scale_d <= d (the true width of a head the wrapper
// zero-pads, else d). Up to kMaxFrames frames `mode` is kModeItems for
// whole heads (`stages` and `smem` not read), and split::kModeSplit for a
// head in slices: the split kernel with `heads_per_item` positions an item,
// a ring of `stages` tensor slots and `smem` the bytes the wrapper's
// `split_plan` reckons for them (checked against the kernel's own). Past
// kMaxFrames (any f) the long kernel runs the wrapper's `long_fwd_plan`:
// `mode` kModeResident (whole heads of d <= 160, CW = heads_per_item * d, f
// rounded up to 16 at most 256) or kModeStreamed (one head in `chunks`
// chunks of at most kLongChunk columns), a ring of `stages` stages and
// `smem` the bytes the plan reckons for them (the kernel checks them
// against its own).
extern "C" int hv_temporal_fwd(const void* q, const void* k, const void* v, void* out, int B,
                               int F, int L, int heads, int d, int heads_per_item, int cwp,
                               int chunks, int scale_d, int mode, int stages, int smem,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a head in slices at f <= kMaxFrames takes heads_per_item as its positions an item
  const bool sliced = F <= kMaxFrames && chunks > 1;
  const int per = sliced ? 1 : heads_per_item;  // heads an item
  if (chunks < 1 || (chunks > 1 && per != 1)) return (int)cudaErrorInvalidValue;
  const int CW = chunks == 1 ? per * d : ((d + chunks - 1) / chunks + 7) / 8 * 8;
  if (B < 1 || L < 1 || F < 1 || d <= 0 || d % 8 != 0 || d > 8 * kChunkColumns || heads < 1 ||
      per < 1 || heads % per != 0 || cwp > 256 || cwp % 8 != 0 ||
      cwp < CW + 8 || (cwp / 8) % 2 != 1 || scale_d < 1 || scale_d > d ||
      (chunks > 1 && (chunks - 1) * CW >= d) || (long long)B * heads * d * F * L >= (1LL << 40))
    return (int)cudaErrorInvalidValue;
  if (F > kMaxFrames) {
    if (stages < 1 || stages > kLongMaxStages) return (int)cudaErrorInvalidValue;
    if (mode == kModeResident) {
      if (chunks != 1 || CW > kChunkColumns || (F + 15) / 16 * 16 > 256)
        return (int)cudaErrorInvalidValue;
#define RESIDENT(KS)                                                                  \
  launch_long<false, KS>(q, k, v, out, B, F, L, heads, d, heads_per_item, CW, cwp, chunks, \
                         stages, smem, scale_d, s)
      switch ((d + 15) / 16) {  // the head's 16-deep steps (7 and 9 take one more)
        case 1: return RESIDENT(1);
        case 2: return RESIDENT(2);
        case 3: return RESIDENT(3);
        case 4: return RESIDENT(4);
        case 5: return RESIDENT(5);
        case 6: return RESIDENT(6);
        case 7: case 8: return RESIDENT(8);
        default: return RESIDENT(10);
      }
#undef RESIDENT
    }
    if (mode != kModeStreamed || heads_per_item != 1 || CW > kLongChunk)
      return (int)cudaErrorInvalidValue;
    if (CW <= 64)
      return launch_long<true, 8>(q, k, v, out, B, F, L, heads, d, 1, CW, cwp, chunks, stages,
                                  smem, scale_d, s);
    return launch_long<true, 20>(q, k, v, out, B, F, L, heads, d, 1, CW, cwp, chunks, stages,
                                 smem, scale_d, s);
  }
  if (sliced) {
    if (mode != split::kModeSplit || d <= kChunkColumns ||
        !split::plan_ok(F, d, chunks, heads_per_item, CW, cwp, stages, 2, smem))
      return (int)cudaErrorInvalidValue;
#define SPLIT(MT)                                                                         \
  launch_split<MT>(q, k, v, out, B, F, L, heads, d, CW, cwp, chunks, heads_per_item, stages, \
                   smem, scale_d, s)
    return F <= 16 ? SPLIT(1) : SPLIT(2);
#undef SPLIT
  }
  if (mode != kModeItems) return (int)cudaErrorInvalidValue;
  if (d <= 48) return launch<48>(q, k, v, out, B, F, L, heads, d, CW, cwp, scale_d, s);
  if (d <= 80) return launch<80>(q, k, v, out, B, F, L, heads, d, CW, cwp, scale_d, s);
  if (d <= 160) return launch<160>(q, k, v, out, B, F, L, heads, d, CW, cwp, scale_d, s);
  return (int)cudaErrorInvalidValue;
}
